"""The port's plain stream and occlusion traces against the JAX package's CPU
references: `cluster.intersect_clusters(use_pallas=False)` for closest hits
and `render.integrator.occlude` (a closest-hit trace plus an id compare)
for shadow rays, on a random scene and an instanced one built by the JAX
package's own cluster builders.

Closest hits: t to rtol 1e-5 / atol 1e-6, triangle ids equal except where
two hits lie at the same t (the two sides may visit tied groups in another
order), u/v to rtol 1e-4 where the ids agree.  A barycentric near 0 is a
difference of products of the local-space ray, which XLA may round
differently (fused multiply-adds), so u/v also take atol 1e-4."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_stream_kernel import _rays, _scene
from vpt_tpu.accel import traverse as jtraverse
from vpt_tpu.accel.bvh import LEAF_SIZE, build_bvh
from vpt_tpu.accel.cluster import assemble_clusters, build_mesh_clusters, intersect_clusters
from vpt_tpu.render import integrator as jint
from vpt_tpu_torch.accel import bvh as tbvh
from vpt_tpu_torch.accel.occlude import nearest_blocker_plain, occlude_stream, occlude_trace_plain, shadow_bands
from vpt_tpu_torch.accel.stream import intersect_stream, stream_trace_plain, trace_bands, trace_work
from vpt_tpu_torch.accel.traverse import intersect_brute
from vpt_tpu_torch.scene.convert import clusters_from_numpy
from vpt_tpu_torch.scene.types import tree_to_device

torch.set_num_threads(1)


def use_native_jax_bvh():
    """Make the JAX package build its BVHs with its C++ builder, never with
    its NumPy fallback, before a test compares them with the port's C++ build.

    `vpt_tpu.accel.native` compiles its library in place and, if loading
    fails once, keeps the NumPy builder for the life of the process.  Under
    parallel test workers one worker can meet the library half written by
    another.  So: retry once (the other build has likely finished), and
    failing that, load the port's build of the same source with the same
    flags, which is written to a temporary file and renamed into place."""
    from vpt_tpu.accel import native

    if native.available():
        return
    native._tried = False
    if native.available():
        return
    native._lib = tbvh._library()
    native._tried = True


def _port_clusters(cl):
    return tree_to_device(clusters_from_numpy(cl), "cpu")


def _instanced_scene():
    use_native_jax_bvh()
    rng = np.random.default_rng(25)
    v0 = rng.uniform(-2, 2, (900, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (900, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (900, 3)).astype(np.float32)
    bvh = build_bvh(v0, v1, v2)
    order = bvh.tri_order

    def pad(a):
        return np.concatenate([a, np.zeros((LEAF_SIZE,) + a.shape[1:], a.dtype)])

    mc = build_mesh_clusters(bvh, pad(v0[order]), pad((v1 - v0)[order]), pad((v2 - v0)[order]))
    m2 = np.diag([0.7, 1.4, 0.9, 1.0]).astype(np.float32)
    m2[:3, 3] = [6.0, -1.0, 2.0]
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0] = rot[2, 2] = np.cos(0.6)
    rot[0, 2] = np.sin(0.6)
    rot[2, 0] = -np.sin(0.6)
    cl = assemble_clusters([mc, mc], [(0, np.eye(4, dtype=np.float32), 0), (1, m2 @ rot, int(mc.start.max()) + 10000)])
    return cl, rng


SCENES = {
    "random": lambda: _scene(4000, 21)[3:],
    "instanced": _instanced_scene,
}


def _case(name, n=1500):
    """Random rays, two thirds of them aimed at points inside random
    cluster boxes so that most of those hit."""
    cl, rng = SCENES[name]()
    org, d = (np.asarray(x) for x in _rays(rng, n, spread=9.0))
    boxes = np.asarray(cl.aabbs)[np.asarray(cl.count) > 0]
    box = boxes[rng.integers(0, boxes.shape[0], n)]
    target = box[:, :3] + rng.uniform(size=(n, 3)).astype(np.float32) * (box[:, 3:] - box[:, :3])
    aim = (target - org) / np.linalg.norm(target - org, axis=-1, keepdims=True)
    d = np.where((np.arange(n) % 3 != 0)[:, None], aim, d).astype(np.float32)
    active = rng.uniform(size=n) < 0.9
    return cl, rng, jnp.asarray(org), jnp.asarray(d), active


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_hit_matches_jax(name):
    cl, _, org, d, active = _case(name)
    want = intersect_clusters(org, d, cl, active=jnp.asarray(active), use_pallas=False)
    got = intersect_stream(_t(org), _t(d), _port_clusters(cl), active=_t(active))
    got = types.SimpleNamespace(**{k: v.numpy() for k, v in got._asdict().items()})
    tw = np.asarray(want.t)
    np.testing.assert_allclose(got.t, tw, rtol=1e-5, atol=1e-6)
    same = got.tri == np.asarray(want.tri)
    tie = np.abs(got.t - tw) <= 1e-5 + 1e-5 * np.abs(tw)
    assert np.all(same | (tie & (tw >= 0))), f"{(~(same | tie)).sum()} rays disagree beyond t ties"
    np.testing.assert_allclose(got.u[same], np.asarray(want.u)[same], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.v[same], np.asarray(want.v)[same], rtol=1e-4, atol=1e-4)
    assert np.all(got.t[~active] == -1.0) and np.all(got.tri[~active] == -1)
    assert (got.t >= 0).sum() > 500  # the rays do hit the scene


@pytest.mark.parametrize("name", sorted(SCENES))
def test_anyhit_finds_a_hit_iff_one_exists(name):
    cl, rng, org, d, active = _case(name)
    tmax = rng.uniform(0.5, 20.0, org.shape[0]).astype(np.float32)
    want = intersect_clusters(org, d, cl, t_max=jnp.asarray(tmax), active=jnp.asarray(active), use_pallas=False)
    anyhit = np.arange(org.shape[0]) % 2 == 1
    got = intersect_stream(_t(org), _t(d), _port_clusters(cl), t_max=_t(tmax), active=_t(active), anyhit=_t(anyhit))
    np.testing.assert_array_equal(got.t.numpy() >= 0, np.asarray(want.t) >= 0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_occlusion_matches_jax(name):
    cl, rng, org, d, active = _case(name)
    n = org.shape[0]
    first = intersect_clusters(org, d, cl, use_pallas=False)
    t_hit, tri_hit = np.asarray(first.t), np.asarray(first.tri)
    tmax = rng.uniform(0.5, 25.0, n).astype(np.float32)
    # A third of the hitting rays exclude their own first hit, with tmax just
    # beyond it: visible for the light-NEE semantics, blocked if not excluded.
    excl = (t_hit >= 0) & (np.arange(n) % 3 == 0)
    tmax = np.where(excl, t_hit * 1.001, tmax).astype(np.float32)
    extri = np.where(excl, tri_hit, -1).astype(np.int32)
    scene = types.SimpleNamespace(clusters=cl)
    meta = types.SimpleNamespace(use_brute_force=False)
    want = np.asarray(jint.occlude(scene, meta, org, d, jnp.asarray(active), t_min=1e-4,
                                   t_max=jnp.asarray(tmax), exclude_tri=jnp.asarray(extri)))
    got = occlude_stream(_t(org), _t(d), _port_clusters(cl), 1e-4, _t(tmax), active=_t(active),
                         exclude_tri=_t(extri)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[~active].any()
    assert (excl & active & ~got).sum() > 20  # the exclusion mattered
    assert got.sum() > 300


def _sub_boxes(cl, box, blocks=slice(None)):
    """The same tables with the sub-block boxes of `blocks` set to `box`."""
    sub_aabbs = cl.sub_aabbs.clone()
    sub_aabbs[blocks] = torch.tensor(box, dtype=torch.float32)
    return cl._replace(sub_aabbs=sub_aabbs)


_EVERYWHERE = [-3e9] * 3 + [3e9] * 3  # a sub-block box every ray enters: no cull
_FAR_AWAY = [1e6] * 3 + [1e6 + 1.0] * 3  # a sub-block box no test ray enters


def _port_case(name):
    """The port's bands of _case's rays: closest-hit ones and shadow ones
    (tmax, exclude ids) as test_occlusion_matches_jax makes them."""
    cl, rng, org, d, active = _case(name)
    tcl = _port_clusters(cl)
    o, dd, act = _t(org), _t(d), _t(active)
    n = o.shape[0]
    b = trace_bands(o, dd, tcl, 1e-4, 1e8, act, torch.zeros_like(act))
    tmax = torch.tensor(rng.uniform(0.5, 25.0, n).astype(np.float32))
    extri = torch.tensor(np.where(np.arange(n) % 3 == 0, rng.integers(0, 3000, n), -1).astype(np.int32))
    return tcl, b, shadow_bands(o, dd, tcl, 1e-4, tmax, act, extri)


def _assert_tie_rule(got, want):
    tk, trk, uk, vk = got
    tp, trp, up, vp = want
    torch.testing.assert_close(tk, tp, rtol=1e-5, atol=1e-6)
    same = trk == trp
    tie = (tk - tp).abs() <= 1e-5 + 1e-5 * tp.abs()
    assert bool((same | (tie & (trp >= 0))).all())
    assert torch.equal(uk[same], up[same]) and torch.equal(vk[same], vp[same])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sub_block_cull_keeps_the_unculled_answer(name):
    """The plain traces with the sub-block cull against the same traces with
    every sub-block box made the whole space: closest hits by the tie rule,
    occlusion bit for bit."""
    tcl, b, sb = _port_case(name)
    unculled = _sub_boxes(tcl, _EVERYWHERE)
    got = stream_trace_plain(b, tcl, 1e-4)
    _assert_tie_rule(got, stream_trace_plain(b, unculled, 1e-4))
    assert int((got[1] >= 0).sum()) > 500
    blocked = occlude_trace_plain(sb, tcl, 1e-4)
    assert torch.equal(blocked, occlude_trace_plain(sb, unculled, 1e-4))
    assert int(blocked.sum()) > 300


def test_sub_block_cull_halves_the_triangle_tests():
    """On the instanced scene the cull at least halves the triangle tests,
    both out to tmax and out to each ray's final hit."""
    tcl, b, sb = _port_case("instanced")
    act = (b.payload[0] & 1) > 0
    t_hit = stream_trace_plain(b, tcl, 1e-4)[0]
    near = nearest_blocker_plain(sb, tcl, 1e-4)
    for bands, active, tf in ((b, act, b.tmax), (b, act, t_hit), (sb, sb.payload[0] > 0, sb.tmax),
                              (sb, sb.payload[0] > 0, torch.minimum(near, sb.tmax))):
        work = trace_work(bands, tcl, 1e-4, active, tf)
        tests, unculled = int(work.tests.sum()), int(work.tests_unculled.sum())
        assert 0 < 2 * tests <= unculled, (tests, unculled)
        assert int(work.sub_blocks.sum()) <= int(work.sub_slabs.sum()) <= 8 * int(work.clusters.sum())
        assert int(work.clusters[~active].sum()) == 0


def test_no_hit_from_a_cluster_whose_sub_block_boxes_the_ray_misses():
    """Rays that enter a cluster's world box but none of its sub-block boxes
    get no hit from it, though they would hit its triangles without the cull."""
    tcl, b, sb = _port_case("instanced")
    t, tri, _, _ = stream_trace_plain(b, tcl, 1e-4)
    block_of = torch.full((int((tcl.start + tcl.count).max()),), -1, dtype=torch.int64)
    for c in torch.nonzero(tcl.count > 0)[:, 0].tolist():
        block_of[int(tcl.start[c]) : int(tcl.start[c] + tcl.count[c])] = int(tcl.block_id[c])

    def hit_block(ids):
        return torch.where(ids >= 0, block_of[ids.clamp(min=0).long()], -1)

    # The block (shared by both instances) that the most rays hit first.
    blk = int(torch.mode(hit_block(tri)[tri >= 0]).values)
    t2, tri2, _, _ = stream_trace_plain(b, _sub_boxes(tcl, _FAR_AWAY, blk), 1e-4)
    in_blk = hit_block(tri) == blk
    assert int(in_blk.sum()) > 20
    assert not bool((hit_block(tri2) == blk).any())
    keep = ~in_blk
    assert torch.equal(tri2[keep], tri[keep]) and torch.equal(t2[keep], t[keep])
    # Every sub-block box out of reach: the cluster boxes are still entered,
    # but nothing blocks.
    nowhere = _sub_boxes(tcl, _FAR_AWAY)
    assert int(trace_work(sb, nowhere, 1e-4, sb.payload[0] > 0, sb.tmax).clusters.sum()) > 1000
    assert int(occlude_trace_plain(sb, nowhere, 1e-4).sum()) == 0
    assert int(occlude_trace_plain(sb, tcl, 1e-4).sum()) > 300


def test_brute_force_matches_jax():
    p0, e1, e2, _, rng = _scene(300, 3)
    org, d = _rays(rng, 400, spread=6.0)
    tmax = rng.uniform(1.0, 15.0, 400).astype(np.float32)
    want = jtraverse.intersect_brute(org, d, jnp.asarray(p0[:300]), jnp.asarray(e1[:300]), jnp.asarray(e2[:300]),
                                     t_max=jnp.asarray(tmax))
    got = intersect_brute(_t(org), _t(d), _t(p0[:300]), _t(e1[:300]), _t(e2[:300]), t_max=_t(tmax))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), rtol=1e-4, atol=1e-5)
    assert (got.t.numpy() >= 0).sum() > 20
