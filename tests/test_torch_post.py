"""The port's post-processing (vpt_tpu_torch.post) against vpt_tpu.post on the
same seeded HDR images: tonemap in every mode and look, and the bloom chain
step by step.  Both sides compute in float32 in the same operation order.

Tolerances: atol 1e-5; bloom outputs reach ~10, so their bound adds rtol
1e-6 (a few float32 ulps).  The AGX modes take atol 1e-4: the AGX contrast
curve is a degree-7 polynomial whose terms reach ~100 and cancel to [0, 1],
so its float32 value moves by ~1e-5 when its input moves by one ulp, and
log2 differs by an ulp between XLA and ATen on ~30% of inputs.  Measured on
these images: the JAX package's float32 AGX differs from a float64
evaluation of the same formula by up to 4.7e-5, the port's from JAX's by
up to 1.8e-5; the ACES and clamp modes agree to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.post import bloom as jbloom
from vpt_tpu.post import tonemap as jtonemap
from vpt_tpu_torch.post import bloom as tbloom
from vpt_tpu_torch.post import tonemap as ttonemap

torch.set_num_threads(1)


def _hdr(shape=(37, 50, 3), seed=0):
    """A random HDR image: mostly [0, 2), some pixels up to ~60, a few zeros."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    hot = rng.uniform(size=shape[:2]) < 0.05
    img[hot] *= rng.uniform(5.0, 30.0, (int(hot.sum()), 1)).astype(np.float32)
    img[rng.uniform(size=shape[:2]) < 0.02] = 0.0
    return img


def _close(got, want, rtol=0.0, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


AGX_ATOL = 1e-4  # float32 cancellation in the AGX contrast polynomial (see above)


@pytest.mark.parametrize("mode", ["aces", "agx", "agx:golden", "agx:punchy", "agx:unknown", "clamp"])
@pytest.mark.parametrize("with_bloom", [False, True])
def test_tonemap_matches_jax(mode, with_bloom):
    img = _hdr()
    bl = _hdr(seed=1) * 0.3 if with_bloom else None
    kw = dict(exposure=1.7, gamma=2.2, mode=mode)
    want = jtonemap.tonemap(jnp.asarray(img), bloom=None if bl is None else jnp.asarray(bl), **kw)
    got = ttonemap.tonemap(torch.tensor(img), bloom=None if bl is None else torch.tensor(bl), **kw)
    _close(got, want, atol=AGX_ATOL if mode.startswith("agx") else 1e-5)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("look", ["default", "golden", "punchy"])
def test_agx_curve_matches_jax(look):
    img = _hdr(seed=2)
    _close(ttonemap.agx_tonemap(torch.tensor(img), look), jtonemap.agx_tonemap(jnp.asarray(img), look),
           atol=AGX_ATOL)


def test_aces_curve_matches_jax():
    img = _hdr(seed=3)
    _close(ttonemap.aces_fitted(torch.tensor(img)), jtonemap.aces_fitted(jnp.asarray(img)))


@pytest.mark.parametrize("shape", [(64, 48, 3), (37, 50, 3), (1, 9, 3)])
def test_bloom_steps_match_jax(shape):
    img = _hdr(shape, seed=4)
    t, j = torch.tensor(img), jnp.asarray(img)
    _close(tbloom.threshold_extract(t, 1.5, 0.5), jbloom.threshold_extract(j, 1.5, 0.5), rtol=1e-6)
    lo_t, lo_j = tbloom.downsample(t, 0.8), jbloom.downsample(j, 0.8)
    _close(lo_t, lo_j, rtol=1e-6)
    _close(tbloom.upsample_add(lo_t, t, 0.8), jbloom.upsample_add(lo_j, j, 0.8), rtol=1e-6)


@pytest.mark.parametrize("mip_levels", [1, 4, 10])
def test_bloom_chain_matches_jax(mip_levels):
    img = _hdr((64, 80, 3), seed=5)
    kw = dict(threshold=1.2, strength=0.6, falloff_range=0.4, mip_levels=mip_levels)
    want = jbloom.bloom(jnp.asarray(img), **kw)
    got = tbloom.bloom(torch.tensor(img), **kw)
    _close(got, want, rtol=1e-6)
    assert got.shape == img.shape and float(got.sum()) > 0
