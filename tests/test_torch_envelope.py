"""The port's plain envelope versions against the JAX Pallas kernels in
interpret mode, exactly, on test_envelope.py's inputs: duplicate boxes
(entry ties), axis-aligned directions, a ray starting inside a box and an
inactive block.  The group count is cut to 29 (Gp = 32) to keep the
interpret-mode compile short."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_envelope import T_MIN, _scene
from vpt_tpu.accel import envelope as jenv
from vpt_tpu_torch.accel import envelope as tenv

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("seed", [0, 2])
def test_ray_keys_exact(levels, seed):
    o, _, inv, tmax, gmin, gmax, _ = _scene(seed, g=29, gp=32)
    want = np.asarray(jenv.ray_keys(
        jnp.asarray(o), jnp.asarray(inv), jnp.asarray(tmax), jnp.asarray(gmin), jnp.asarray(gmax),
        t_min=T_MIN, levels=levels, interpret=True,
    ))
    got = tenv.ray_keys(*_t(o, inv, tmax, gmin, gmax), t_min=T_MIN, levels=levels).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 3])
def test_supertile_tables_exact(seed):
    o, _, inv, tmax, gmin, gmax, _ = _scene(seed, g=29, gp=32)
    want = np.asarray(jenv.supertile_tables(
        jnp.asarray(o), jnp.asarray(inv), jnp.asarray(tmax), jnp.asarray(gmin), jnp.asarray(gmax),
        t_min=T_MIN, interpret=True,
    ))
    got = tenv.supertile_tables(*_t(o, inv, tmax, gmin, gmax), t_min=T_MIN).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
