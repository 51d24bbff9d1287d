"""The port's envelope (ray_keys, supertile_tables) on the CPU, where the
wrappers run their plain versions (dense slab reductions).

- Against the JAX Pallas kernels in interpret mode, on test_envelope.py's
  inputs (duplicate boxes, axis-aligned directions, a ray starting inside a
  box and an inactive block; the group count cut to 29, Gp = 32, the last
  chunk part padding, to keep the interpret-mode compile short), and on
  sphere_garden's adversarial bounce wavefront at 32x32 as the main path
  hands it over (tests/envelope_rays.py: NaN-origin inactive rays, entry
  ties at t_min, box-face origins, axis-parallel directions; Gp = 128, the
  last real chunk part padding).
- The kernels' two-level walk: on the primary, bounce and shadow rays of
  cornell_box, sphere_garden and a reduced colonnade at 32x32 with the
  adversarial rays, band-padded, root-bounded, unsorted for ray_keys and
  key-sorted for supertile_tables, every entered group lies in an entered
  union box of 8 groups at an entry no lower than the union's (so the cull
  is exact), and the wrappers equal dense `slab_entry` reductions.

Tolerance: none.  Keys and tables must be equal, entries bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envelope_rays import SCENES, dense_keys, wavefronts
from test_envelope import T_MIN, _scene
from vpt_tpu.accel import envelope as jenv
from vpt_tpu_torch.accel import envelope as tenv
from vpt_tpu_torch.accel import stream
from vpt_tpu_torch.accel.cluster import pad_groups
from vpt_tpu_torch.accel.traverse import guarded_inverse

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


@pytest.mark.parametrize("call", ["ray_keys-1", "ray_keys-2", "supertile_tables"])
def test_adversarial_rays_equal_jax(call):
    cl, t_min, waves = wavefronts("sphere_garden")
    gmin, gmax = pad_groups(cl)
    origin, direction, t_max, active = waves["bounce"]
    w = stream.pad_wavefront(origin, direction, cl, t_min, t_max, active)
    args = (w.origin, w.inv, w.tmax, gmin, gmax)
    jargs = [jnp.asarray(a.numpy()) for a in args]
    if call == "supertile_tables":
        want = np.asarray(jenv.supertile_tables(*jargs, t_min=t_min, interpret=True))
        got = tenv.supertile_tables(*args, t_min).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        levels = int(call[-1])
        want = np.asarray(jenv.ray_keys(*jargs, t_min=t_min, levels=levels, interpret=True))
        np.testing.assert_array_equal(tenv.ray_keys(*args, t_min, levels).numpy(), want)
    # The inputs hold what they claim: NaN origins, a tie at t_min, a last
    # real chunk that is part padding.
    dense = tenv.slab_entry(*args, t_min)
    assert bool(w.origin.isnan().any()) and bool((dense == t_min).sum(dim=1).gt(1).any())
    assert cl.group_min.shape[0] % tenv.CHUNK != 0


@pytest.mark.parametrize("kind", ["primary", "bounce", "shadow"])
@pytest.mark.parametrize("name", list(SCENES))
def test_walk_equals_dense_reductions(name, kind):
    cl, t_min, waves = wavefronts(name)
    origin, direction, t_max, active = waves[kind]
    gmin, gmax = pad_groups(cl)
    w = stream.pad_wavefront(origin, direction, cl, t_min, t_max, active)
    dense = tenv.slab_entry(w.origin, w.inv, w.tmax, gmin, gmax, t_min)
    # The kernels' cull is exact: a ray enters a group only inside an
    # entered union box, at an entry no lower than the union's.
    union = tenv.slab_entry(w.origin, w.inv, w.tmax, *tenv.union_boxes(gmin, gmax), t_min)
    union = union.repeat_interleave(tenv.CHUNK, dim=1)
    entered = torch.isfinite(dense)
    assert bool((torch.isfinite(union) | ~entered).all())
    assert bool((dense[entered] >= union[entered]).all())
    for levels in (1, 2):
        keys = tenv.ray_keys(w.origin, w.inv, w.tmax, gmin, gmax, t_min, levels)
        assert torch.equal(keys, dense_keys(dense, levels)), levels

    b = stream.prepare_bands(origin, direction, cl, t_min, t_max, active, levels=2 if kind != "shadow" else 1)
    args = (b.origin, guarded_inverse(b.direction), b.tmax, gmin, gmax)
    tables = tenv.supertile_tables(*args, t_min)
    want = tenv.slab_entry(*args, t_min).reshape(-1, tenv.SUPERTILE, gmin.shape[1]).amin(dim=1)
    assert torch.equal(tables.view(torch.int32), want.view(torch.int32))
    assert bool(torch.isfinite(tables).any())

    # The inputs hold what they claim: NaN origins, an entry tie between
    # groups at t_min and a first-entry tie, a last real chunk that is part
    # padding.
    if kind == "bounce":
        assert bool(w.origin.isnan().any()) and bool((dense == t_min).sum(dim=1).gt(1).any())
        best = dense.amin(dim=1, keepdim=True)
        assert bool(((dense == best) & torch.isfinite(best)).sum(dim=1).gt(1).any())
    if name != "cornell_box":
        assert cl.group_min.shape[0] % tenv.CHUNK != 0


@pytest.mark.parametrize("kind", ["bounce", "shadow"])
def test_envelope_work_culls_on_colonnade(kind):
    cl, t_min, waves = wavefronts("colonnade")
    gmin, gmax = pad_groups(cl)
    origin, direction, t_max, active = waves[kind]
    w = stream.pad_wavefront(origin, direction, cl, t_min, t_max, active)
    work = tenv.envelope_work(w.origin, w.inv, w.tmax, gmin, gmax, t_min)
    gp, n_chunks = gmin.shape[1], gmin.shape[1] // tenv.CHUNK
    act = w.active
    assert float(work.slabs[act].float().mean()) < gp / 2
    assert bool((work.slabs == n_chunks + tenv.CHUNK * work.chunks).all())
    assert bool((work.groups <= tenv.CHUNK * work.chunks).all()) and bool((work.chunks[work.groups > 0] > 0).all())
    assert bool((work.warp_chunks >= work.chunks).all()) and bool((work.warp_chunks <= n_chunks).all())
    assert int(work.groups.sum()) == int(torch.isfinite(tenv.slab_entry(w.origin, w.inv, w.tmax, gmin, gmax,
                                                                         t_min)).sum())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Any t_min is taken: at t_min 0 and below, the tables equal the JAX
    kernel's in interpret mode (values: a -0.0 entry equals +0.0).  Refused:
    a group count that is not a multiple of 8, levels other than 1 and 2,
    tiles other than 512 and 1024, and a ray count that is not a multiple
    of the tile."""
    o, _, inv, tmax, gmin, gmax, _ = _scene(0, n=1024, g=29, gp=32)
    args = _t(o, inv, tmax, gmin, gmax)
    for t_min in (0.0, -1e-4):
        want = np.asarray(jenv.supertile_tables(*(jnp.asarray(a) for a in (o, inv, tmax, gmin, gmax)), t_min=t_min,
                                                interpret=True))
        got = tenv.supertile_tables_plain(*args, t_min, tile=1024).numpy()
        np.testing.assert_array_equal(got, want)
        assert torch.equal(tenv.supertile_tables(*args, t_min=t_min), torch.as_tensor(got))
        assert np.isfinite(got).any() and (got <= 0).any(), t_min  # entries at or below 0 were taken
    with pytest.raises(ValueError, match="multiple of 8"):
        tenv.ray_keys(*args[:3], args[3][:, :30], args[4][:, :30], t_min=T_MIN, levels=2)
    with pytest.raises(ValueError, match="levels"):
        tenv.ray_keys(*args, t_min=T_MIN, levels=3)
    with pytest.raises(ValueError, match="tiles of 128, 256, 512 or 1024"):
        tenv.supertile_tables(*args, t_min=T_MIN, tile=384)
    with pytest.raises(ValueError, match="multiple of 512"):
        tenv.supertile_tables(*(a[:768] for a in args[:3]), *args[3:], t_min=T_MIN, tile=512)
