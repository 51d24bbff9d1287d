"""vpt_tpu_torch.core against vpt_tpu.core: the PCG generator bit for bit,
primary rays to float32 rounding, and the tiled pixel order exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.core import camera as jcam
from vpt_tpu.core import rng as jrng
from vpt_tpu.core import tiling as jtiling
from vpt_tpu_torch.core import camera as tcam
from vpt_tpu_torch.core import rng as trng
from vpt_tpu_torch.core import tiling as ttiling

torch.set_num_threads(1)


def _states(seed, n=100_000):
    r = np.random.default_rng(seed)
    x = r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return x


def test_pcg_hash_bit_exact():
    x = _states(0)
    want = np.asarray(jrng.pcg_hash(jnp.asarray(x)))
    got = trng.pcg_hash(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("sample_index,frame_seed", [(0, 1), (3, 0xFFFFFFFF), (7, 2654435761)])
def test_seed_and_float_chain_bit_exact(sample_index, frame_seed):
    pix = _states(1)
    js = jrng.seed(jnp.asarray(pix), sample_index, jnp.uint32(frame_seed))
    ts = trng.seed(torch.as_tensor(pix.astype(np.int64)), sample_index, frame_seed)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for _ in range(3):
        js, ju = jrng.next_float(js)
        ts, tu = trng.next_float(ts)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    js, j3 = jrng.next_float3(js)
    ts, t3 = trng.next_float3(ts)
    np.testing.assert_array_equal(t3.numpy(), np.asarray(j3))


@pytest.mark.parametrize("width,height", [(16, 16), (20, 13)])
def test_tiled_pixel_order_matches(width, height):
    j = jtiling.tiled_pixel_order(width, height)
    t = ttiling.tiled_pixel_order(width, height)
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_array_equal(a, b)
    assert j[3] == t[3]
    rad = np.random.default_rng(2).normal(size=(j[0].shape[0], 3)).astype(np.float32)
    want = np.asarray(jtiling.scatter_to_image(jnp.asarray(rad), jnp.asarray(j[2]), j[3], width, height))
    got = ttiling.scatter_to_image(torch.as_tensor(rad), torch.as_tensor(t[2]), t[3], width, height).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dof", [0.0, 0.3])
def test_generate_primary_rays(dof):
    w, h = 24, 16
    view = jcam.look_at((1.0, 2.0, 5.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0))
    proj = jcam.perspective(np.radians(50.0), w / h)
    np.testing.assert_array_equal(tcam.look_at((1.0, 2.0, 5.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0)), view)
    np.testing.assert_array_equal(tcam.perspective(np.radians(50.0), w / h), proj)
    vi = np.linalg.inv(view).astype(np.float32)
    pi = np.linalg.inv(proj).astype(np.float32)
    pxy, pidx, _, _ = jtiling.tiled_pixel_order(w, h)
    js = jrng.seed(jnp.asarray(pidx), 0, jnp.uint32(99))
    ts = trng.seed(torch.as_tensor(pidx.astype(np.int64)), 0, 99)
    js, jo, jd = jcam.generate_primary_rays(jnp.asarray(vi), jnp.asarray(pi), jnp.asarray(pxy), (w, h), js,
                                            jnp.float32(2.0), jnp.float32(dof))
    ts, to, td = tcam.generate_primary_rays(torch.as_tensor(vi), torch.as_tensor(pi), torch.as_tensor(pxy),
                                            (w, h), ts, 2.0, dof)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
