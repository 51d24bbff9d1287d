"""vpt_tpu_torch's volumes against vpt_tpu's: the volume table build, the
procedural grids, the sampling and phase functions the media use, and
every function of render/volumes.py on 4,096 rays through a 24^3 cloud, a
homogeneous slab and a temperature-grid volume.

The same inputs, made from a numpy seed, go through both packages.  Integer
outputs (RNG states, volume indices) must be equal and floats within
rtol 1e-5 / atol 1e-6 on every lane but at most 0.1% of them (float32
transcendentals differ by ulps between XLA:CPU and ATen, which can flip a
rare decision), and each stochastic loop must run the JAX package's number
of iterations, which decides every lane's later draws.

The JAX functions run op by op, their `lax.while_loop`s as Python loops
(`jax_eager_loops`).  Compiled, XLA:CPU rewrites the loop body's float32
arithmetic: it contracts multiply-adds such as `origin + direction * t`
into FMAs (on two of the three components) and divides by constants as
multiplies by reciprocals.  That moves a lane's position by an ulp, and in
delta tracking near a block or box boundary a moved lane can exit a step
earlier or later; when it is the last live lane, the loop's count and so
every lane's later draws change.  Op by op, the JAX function is the same
algorithm in plain IEEE float32, as torch evaluates it."""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.core import rng as jrng
from vpt_tpu.core import vecmath as jvec
from vpt_tpu.render import sampling as jsamp
from vpt_tpu.render import volumes as jvol
from vpt_tpu.scene import build as jbuild
from vpt_tpu.scene import vdb as jvdb
from vpt_tpu.scene.types import Volume as JVolume
from vpt_tpu_torch.core import rng as trng
from vpt_tpu_torch.core import vecmath as tvec
from vpt_tpu_torch.render import loop
from vpt_tpu_torch.render import sampling as tsamp
from vpt_tpu_torch.render import volumes as tvol
from vpt_tpu_torch.scene import build as tbuild
from vpt_tpu_torch.scene import vdb as tvdb
from vpt_tpu_torch.scene.convert import _pick
from vpt_tpu_torch.scene.types import Volume, VolumeTable, tree_to_device
from vpt_tpu_torch.scene.vdb_reader import write_vdb

torch.set_num_threads(1)
N = 4096


# ---------------------------------------------------------------- helpers


def _t(x):
    """numpy -> torch on the CPU, uint32 held in int64 as the port holds it."""
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype == np.uint32 else x)


def _lane_flips(pairs, n=N):
    """Lanes where any (port, jax) output pair disagrees, integers compared
    exactly and floats within rtol 1e-5 / atol 1e-6; and the count of
    differing lanes per pair."""
    bad = np.zeros(n, bool)
    per_pair = []
    for got, want in pairs:
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        want = np.asarray(want)
        assert got.shape == want.shape, (got.shape, want.shape)
        if want.dtype.kind in "biu":
            diff = got.astype(np.int64) != want.astype(np.int64)
        else:
            diff = ~np.isclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)
        diff = diff.reshape(n, -1).any(axis=1)
        per_pair.append(int(diff.sum()))
        bad |= diff
    return bad, per_pair


def assert_agree(*pairs, n=N):
    bad, per_pair = _lane_flips(pairs, n)
    assert bad.sum() <= 1e-3 * n, f"{bad.sum()} of {n} lanes differ (per output: {per_pair})"


@contextlib.contextmanager
def jax_eager_loops():
    """Run every `lax.while_loop` whose carry is concrete as a Python loop of
    eager ops, and record the iteration count of each media loop (its carry
    has a "live" mask), in the order the loops end.  Loops inside a jit
    (their carry is traced) stay compiled."""
    counts = []
    real = jax.lax.while_loop

    def eager(cond, body, init):
        if any(isinstance(x, jax.core.Tracer) for x in jax.tree.leaves(init)):
            return real(cond, body, init)
        c, n = init, 0
        while bool(cond(c)):
            c, n = body(c), n + 1
        if "live" in c:
            counts.append(n)
        return c

    with mock.patch.object(jax.lax, "while_loop", eager):
        yield counts


def _volumes(with_temperature=True):
    cloud = jvdb.procedural_cloud((24, 24, 24), coverage=0.6, seed=1)
    temp = np.random.default_rng(2).uniform(0.0, 900.0, (20, 24, 28)).astype(np.float32)
    spec = [
        dict(corner_min=(-1.0, -1.0, -1.0), corner_max=(1.0, 1.0, 1.0), density=8.0, anisotropy=0.3,
             density_grid=cloud, approximated_scattering_for_clouds=True, alpha=0.7, droplet_size=12.0),
        dict(corner_min=(-2.5, -2.0, -2.5), corner_max=(2.5, -1.2, 2.5), density=0.6, anisotropy=-0.2,
             color=(0.9, 0.8, 0.7), emissive_color=(0.1, 0.0, 0.0)),
    ]
    if with_temperature:
        spec.append(dict(corner_min=(1.5, 0.0, -1.0), corner_max=(2.5, 1.2, 0.4), position=(0.1, 0.2, 0.0),
                         scale=(1.0, 1.5, 1.0), density=3.0, anisotropy=0.6, use_blackbody=False,
                         density_grid=np.random.default_rng(3).uniform(0.0, 2.0, (20, 24, 28)).astype(np.float32),
                         temperature_grid=temp, temperature_gamma=1.5, temperature_scale=2.0, kelvin_min=900))
    return [JVolume(**s) for s in spec], [Volume(**s) for s in spec]


@pytest.fixture(scope="module")
def tables():
    jv, _ = _volumes()
    jt = jbuild.build_volume_table(jv)
    return jt, tree_to_device(_pick(VolumeTable, jax.tree.map(np.asarray, jt)), "cpu")


@pytest.fixture(scope="module")
def rays():
    r = np.random.default_rng(7)
    origin = r.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    origin[: N // 8] = r.uniform(-0.9, 0.9, (N // 8, 3))  # starts inside the cloud
    target = r.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    d = target - origin
    d[N // 4 : N // 4 + 8] = [[1.0, 0.0, 0.0]] * 8  # axis-aligned
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    state = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    depth = r.integers(0, 4, N).astype(np.int32)
    active = r.random(N) < 0.9
    return origin, d, state, depth, active


def _jargs(rays):
    o, d, s, depth, a = rays
    return jnp.asarray(o), jnp.asarray(d), jnp.asarray(s), jnp.asarray(depth), jnp.asarray(a)


def _targs(rays):
    o, d, s, depth, a = rays
    return _t(o), _t(d), _t(s), _t(depth.astype(np.int64)), _t(a)


# ---------------------------------------------------------------- tables and grids


@pytest.mark.parametrize("shape,with_temp", [((24, 24, 24), False), ((20, 24, 28), True)])
def test_build_volume_table_equals_jax(shape, with_temp):
    grid = np.random.default_rng(11).gamma(0.5, 1.0, shape).astype(np.float32)
    temp = np.random.default_rng(12).uniform(200.0, 800.0, shape).astype(np.float32) if with_temp else None
    kw = dict(corner_min=(-1.0, 0.0, -2.0), corner_max=(1.0, 3.0, 2.0), position=(0.5, 0.0, 0.0), scale=(2.0, 1.0, 1.0),
              density=3.0, anisotropy=0.4, density_grid=grid, temperature_grid=temp)
    extra = dict(corner_min=(-5.0, -1.0, -5.0), corner_max=(5.0, 0.0, 5.0), density=0.2, use_blackbody=False)
    want = jbuild.build_volume_table([JVolume(**kw), JVolume(**extra)])
    got = tbuild.build_volume_table([Volume(**kw), Volume(**extra)])
    for f in VolumeTable._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.max_density_blocks[0].max() == 1.0  # normalised blocks


def test_empty_volume_table_equals_jax():
    want, got = jbuild.empty_volume_table(), tbuild.empty_volume_table()
    for f in VolumeTable._fields:
        assert getattr(got, f).shape == np.asarray(getattr(want, f)).shape, f


@pytest.mark.parametrize("fn,kw", [("procedural_cloud", dict(shape=(20, 24, 28), coverage=0.6, seed=4)),
                                   ("procedural_smoke_plume", dict(shape=(24, 16, 20), seed=3)),
                                   ("fbm_noise", dict(shape=(12, 10, 8), octaves=3, seed=5))])
def test_procedural_grids_equal_jax(fn, kw):
    np.testing.assert_array_equal(getattr(tvdb, fn)(**kw), getattr(jvdb, fn)(**kw))


def test_load_grid(tmp_path):
    g = np.random.default_rng(0).random((4, 5, 6)).astype(np.float32)
    np.save(tmp_path / "g.npy", g)
    np.savez(tmp_path / "g.npz", density=g)
    write_vdb(str(tmp_path / "g.vdb"), g, compress="blosc")
    for name in ("g.npy", "g.npz", "g.vdb"):
        np.testing.assert_array_equal(tvdb.load_grid(str(tmp_path / name)), jvdb.load_grid(str(tmp_path / name)))
    np.testing.assert_array_equal(tvdb.load_grid(str(tmp_path / "g.vdb"))[:4, :5, :6], g)  # one whole 8^3 leaf
    with pytest.raises(ValueError):
        tvdb.load_grid(str(tmp_path / "cloud.raw"))


# ---------------------------------------------------------------- core and sampling


def test_next_uint_blackbody_and_sphere():
    r = np.random.default_rng(1)
    s = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    js, jd = jrng.next_uint(jnp.asarray(s))
    ts, td = trng.next_uint(_t(s))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).astype(np.int64))

    kelvin = r.uniform(0.0, 15000.0, N).astype(np.float32)
    kelvin[:4] = [1900.0, 6600.0, 1000.0, 0.0]
    np.testing.assert_allclose(tvec.blackbody_rgb(_t(kelvin)).numpy(),
                               np.asarray(jvec.blackbody_rgb(jnp.asarray(kelvin))), rtol=1e-5, atol=1e-6)

    o = r.uniform(-5, 5, (N, 3)).astype(np.float32)
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.array([0.5, -0.2, 1.0], np.float32)
    for radius in (2.0, 6.5):
        want = jvec.intersect_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.float32(radius))
        got = tvec.intersect_sphere(_t(o), _t(d), _t(c), radius)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _dirs(seed, n=N):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d[:3] = [[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]]  # the basis's up-vector switch
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_phase_samplers_match_jax():
    r = np.random.default_rng(2)
    inc = _dirs(3)
    s = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    g = r.uniform(-0.95, 0.95, N).astype(np.float32)
    g[:8] = 0.0  # the isotropic branch
    a = r.uniform(0.0, 2.0, N).astype(np.float32)
    a[8:16] = 0.0  # Draine with alpha 0 is HG
    dsz = r.uniform(5.0, 50.0, N).astype(np.float32)
    depth = r.integers(0, 4, N)
    js, jd = jsamp.sample_rayleigh(jnp.asarray(s), jnp.asarray(inc))
    ts, td = tsamp.sample_rayleigh(_t(s), _t(inc))
    assert_agree((ts, js), (td, jd))
    js, jd = jsamp.sample_draine(jnp.asarray(s), jnp.asarray(inc), jnp.asarray(g), jnp.asarray(a))
    ts, td = tsamp.sample_draine(_t(s), _t(inc), _t(g), _t(a))
    assert_agree((ts, js), (td, jd))
    js, jd = jsamp.sample_hg_plus_draine(jnp.asarray(s), jnp.asarray(inc), jnp.asarray(dsz), jnp.asarray(depth))
    ts, td = tsamp.sample_hg_plus_draine(_t(s), _t(inc), _t(dsz), _t(depth))
    # The mixture's parameters pass through exp, which XLA:CPU and ATen
    # round differently on ~9% of inputs, and its lobes are peaked
    # (1 - g ~ 0.005), which turns a 1-ulp g into ~1e-4 in the direction.
    # Lanes whose parameters agree bit for bit must agree as everywhere
    # else; the others to 1e-3 (unit vectors), and all states exactly.
    same = np.ones(N, bool)
    for w, t in zip(jsamp.hg_plus_draine_params(jnp.asarray(dsz)), tsamp.hg_plus_draine_params(_t(dsz))):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5)
        same &= t.numpy() == np.asarray(w)
    assert same.mean() > 0.7
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    assert_agree((td[same], np.asarray(jd)[same]), n=int(same.sum()))
    np.testing.assert_allclose(td.numpy()[~same], np.asarray(jd)[~same], atol=1e-3)
    js, jd = jsamp.sample_henyey_greenstein(jnp.asarray(s), jnp.asarray(inc), 0.85)
    ts, td = tsamp.sample_henyey_greenstein(_t(s), _t(inc), 0.85)
    assert_agree((ts, js), (td, jd))


def test_phase_functions_match_jax():
    r = np.random.default_rng(4)
    v, l = _dirs(5), _dirs(6)
    g = r.uniform(-0.95, 0.95, N).astype(np.float32)
    g[:8] = 0.0
    a = r.uniform(0.0, 2.0, N).astype(np.float32)
    dsz = r.uniform(5.0, 50.0, N).astype(np.float32)
    depth = r.integers(0, 4, N)
    jv, jl, tv, tl = jnp.asarray(v), jnp.asarray(l), _t(v), _t(l)
    pairs = [
        (tsamp.phase_rayleigh(tv, tl), jsamp.phase_rayleigh(jv, jl)),
        (tsamp.phase_mie_approx(tv, tl), jsamp.phase_mie_approx(jv, jl)),
        (tsamp.phase_mie_approx(tv, tl, 0.95), jsamp.phase_mie_approx(jv, jl, 0.95)),
        (tsamp.phase_henyey_greenstein(tv, tl, _t(g)), jsamp.phase_henyey_greenstein(jv, jl, jnp.asarray(g))),
        (tsamp.phase_henyey_greenstein(tv, tl, 0.85), jsamp.phase_henyey_greenstein(jv, jl, 0.85)),
        (tsamp.phase_draine(tv, tl, _t(g), _t(a)), jsamp.phase_draine(jv, jl, jnp.asarray(g), jnp.asarray(a))),
        (tsamp.phase_hg_plus_draine(tv, tl, _t(dsz), _t(depth)),
         jsamp.phase_hg_plus_draine(jv, jl, jnp.asarray(dsz), jnp.asarray(depth))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    u = r.random(N).astype(np.float32)
    gs = np.where(np.abs(g) < 1e-5, 1e-5, g).astype(np.float32)
    a_safe = np.maximum(a, 1e-3).astype(np.float32)
    want = np.asarray(jsamp._draine_cos_theta(jnp.asarray(u), jnp.asarray(gs), jnp.asarray(a_safe)))
    got = tsamp._draine_cos_theta(_t(u), _t(gs), _t(a_safe)).numpy()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4)  # a cubic root of a cancelling sum
    assert close.mean() >= 0.999, f"{(~close).sum()} of {N} Draine cosines differ"


# ---------------------------------------------------------------- render/volumes.py


def test_intersect_aabb_and_density_match_jax(tables, rays):
    jt, tt = tables
    jo, jd, js, jdep, _ = _jargs(rays)
    to, td, ts, tdep, _ = _targs(rays)
    for vi in range(3):
        want = jvol.intersect_aabb(jo, jd, jt.corner_min[vi], jt.corner_max[vi])
        got = tvol.intersect_aabb(to, td, tt.corner_min[vi : vi + 1], tt.corner_max[vi : vi + 1])
        assert_agree(*zip(got, want))
    # Density at points spread over and around the volumes, one volume
    # index per lane (the merged march's form) and one per call.
    x = rays[0] * 0.5
    vi = np.random.default_rng(8).integers(0, 3, N)
    js2, jdens = jvol.density_at_point(js, jt, jnp.asarray(vi), jnp.asarray(x), jdep)
    ts2, tdens = tvol.density_at_point(ts, tt, _t(vi), _t(x), tdep)
    assert_agree((ts2, js2), (tdens, jdens))
    js2, jdens = jvol.density_at_point(js, jt, 0, jnp.asarray(x), jdep)
    ts2, tdens = tvol.density_at_point(ts, tt, slice(0, 1), _t(x), tdep)
    assert_agree((ts2, js2), (tdens, jdens))


@pytest.mark.parametrize("vi", [0, 1, 2])
def test_scatter_distance_in_volume_matches_jax(tables, rays, vi):
    jt, tt = tables
    with jax_eager_loops() as counts:
        js, jres = jvol.scatter_distance_in_volume(*_jargs(rays)[2:3], jt, vi, *_jargs(rays)[:2], *_jargs(rays)[3:])
    stats = loop.LoopStats()
    ts, tres = tvol.scatter_distance_in_volume(*_targs(rays)[2:3], tt, vi, *_targs(rays)[:2], *_targs(rays)[3:],
                                               stats)
    assert_agree((ts, js), (tres, jres))
    assert stats.steps == sum(counts) and stats.loops == len(counts) == 1
    if vi == 0:
        assert sum(counts) > 20 and (np.asarray(jres) >= 0).sum() > N // 8  # the cloud is marched and hit


def test_scatter_distance_merged_matches_jax(tables, rays):
    jt, tt = tables
    jo, jd, js, jdep, ja = _jargs(rays)
    to, td, ts, tdep, ta = _targs(rays)
    with jax_eager_loops() as counts:
        jout = jvol.scatter_distance_merged(js, jt, 3, jo, jd, jdep, ja)
    stats = loop.LoopStats()
    tout = tvol.scatter_distance_merged(ts, tt, 3, to, td, tdep, ta, stats)
    assert_agree(*zip(tout, jout))
    assert stats.steps == counts[0] > 20 and stats.loops == 1
    assert len(set(np.asarray(jout[2]).tolist())) == 4  # every volume and "none" occur
    # The chunked schedule runs the simple one's steps: one step per chunk.
    with mock.patch.object(loop, "CHUNK", 1):
        simple = loop.LoopStats()
        again = tvol.scatter_distance_merged(ts, tt, 3, to, td, tdep, ta, simple)
    for a, b in zip(again, tout):
        assert torch.equal(a, b)
    assert simple.steps == stats.steps and simple.syncs == stats.steps + 1 > stats.syncs


@pytest.mark.parametrize("merged", [False, True])
def test_volumes_transmittance_matches_jax(tables, rays, merged):
    jt, tt = tables
    jo, jd, js, jdep, ja = _jargs(rays)
    to, td, ts, tdep, ta = _targs(rays)
    jfn = jvol.volumes_transmittance_merged if merged else jvol.volumes_transmittance
    tfn = tvol.volumes_transmittance_merged if merged else tvol.volumes_transmittance
    with jax_eager_loops() as counts:
        jout = jfn(js, jt, 3, jo, jd, jdep, ja)
    stats = loop.LoopStats()
    tout = tfn(ts, tt, 3, to, td, tdep, ta, stats)
    assert_agree(*zip(tout, jout))
    assert stats.steps == sum(counts) > 20 and stats.loops == len(counts)
    tr = np.asarray(jout[1])
    assert (tr == 0.0).any() and ((tr > 0.0) & (tr < 1.0)).any()


def test_homogeneous_only_volumes_match_jax(rays):
    """No density grid at all: the single and merged functions take their
    grid-free branches (no jitter draws, one draw per merged step)."""
    jv, tv = _volumes(with_temperature=False)
    jv, tv = jv[1:], tv[1:]
    jv.append(JVolume(corner_min=(-0.5, -0.5, -0.5), corner_max=(0.5, 0.5, 0.5), density=2.0))
    tv.append(Volume(corner_min=(-0.5, -0.5, -0.5), corner_max=(0.5, 0.5, 0.5), density=2.0))
    jt, tt = jbuild.build_volume_table(jv), tree_to_device(tbuild.build_volume_table(tv), "cpu")
    jo, jd, js, jdep, ja = _jargs(rays)
    to, td, ts, tdep, ta = _targs(rays)
    stats = loop.LoopStats()
    with jax_eager_loops() as counts:
        pairs = list(zip(tvol.scatter_distance_merged(ts, tt, 2, to, td, tdep, ta, stats),
                         jvol.scatter_distance_merged(js, jt, 2, jo, jd, jdep, ja)))
        pairs += zip(tvol.volumes_transmittance_merged(ts, tt, 2, to, td, tdep, ta, stats),
                     jvol.volumes_transmittance_merged(js, jt, 2, jo, jd, jdep, ja))
        pairs += zip(tvol.scatter_distance_in_volume(ts, tt, 1, to, td, tdep, ta, stats),
                     jvol.scatter_distance_in_volume(js, jt, 1, jo, jd, jdep, ja))
        pairs += zip(tvol.volumes_transmittance(ts, tt, 2, to, td, tdep, ta, stats),
                     jvol.volumes_transmittance(js, jt, 2, jo, jd, jdep, ja))
    assert_agree(*pairs)
    assert stats.steps == sum(counts) and stats.loops == len(counts) == 2


@pytest.mark.parametrize("phase", ["hg", "draine", "hg_draine"])
def test_scatter_event_functions_match_jax(tables, rays, phase):
    """temperature_emission, phase_sample and phase_eval at per-lane volumes."""
    jt, tt = tables
    _, jd, js, jdep, _ = _jargs(rays)
    _, td, ts, tdep, _ = _targs(rays)
    vi = np.random.default_rng(9).integers(0, 3, N)
    x = rays[0] * 0.6
    js2, jemit = jvol.temperature_emission(js, jt, jnp.asarray(vi), jnp.asarray(x))
    ts2, temit = tvol.temperature_emission(ts, tt, _t(vi), _t(x))
    js3, jdir = jvol.phase_sample(js2, jt, jnp.asarray(vi), jd, jdep, phase)
    ts3, tdir = tvol.phase_sample(ts2, tt, _t(vi), td, tdep, phase)
    l = _dirs(10)
    jp = jvol.phase_eval(jt, jnp.asarray(vi), jd, jnp.asarray(l), jdep, phase)
    tp = tvol.phase_eval(tt, _t(vi), td, _t(l), tdep, phase)
    assert_agree((ts2, js2), (temit, jemit), (ts3, js3), (tdir, jdir), (tp, jp))
    assert (np.asarray(jemit)[vi == 2] > 0).any()
