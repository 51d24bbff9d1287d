"""The port's packet trace (vpt_tpu_torch.accel.cluster.intersect_clusters,
with the plain version of kernel 5 on the CPU) against the JAX package's
`intersect_clusters`: its interpret-mode Pallas visit kernel at
test_visit_kernel.py's interpret size (500 triangles, 128 rays), and its XLA
visit loop at multi-cluster and instanced sizes, over the cases
test_visit_kernel.py covers.  Also the cluster tables carried from the JAX
package, and the sort key.

Tolerances: t to rtol 1e-5 / atol 1e-6; triangle ids equal except where
the ray meets both sides' triangles at the same t (rtol / atol 1e-5, by a
float64 Moller-Trumbore on the geometry: the two sides may visit tied
candidates in another order, as JAX's entry sort is not stable); u/v to
rtol 1e-4 / atol 1e-4 where
the ids agree (XLA may contract the barycentric products into FMAs).  The
XLA loop has no sub-block box test, which the port and the Pallas kernel
both run; a ray grazing a sub-block box could then differ.  The tie rule
above is the only exemption, and it holds on the grazing case too."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trace import _instanced_scene
from test_visit_kernel import _rays, _scene
from vpt_tpu.accel import cluster as jcluster
from vpt_tpu.accel import traverse as jtraverse
from vpt_tpu.accel.bvh import LEAF_SIZE, build_bvh
from vpt_tpu.accel.cluster import build_clusters, intersect_clusters
from vpt_tpu_torch.accel import cluster as tcluster
from vpt_tpu_torch.accel import envelope, visit
from vpt_tpu_torch.accel.bvh import build_bvh as tbuild_bvh
from vpt_tpu_torch.accel.traverse import KERNEL_GROUP, KERNEL_N_SUB, guarded_inverse
from vpt_tpu_torch.scene.convert import clusters_from_numpy
from vpt_tpu_torch.scene.types import tree_to_device

torch.set_num_threads(1)


def _grazing_scene():
    """test_visit_kernel.py's axis-aligned quad grid and rays: straight down
    onto the z = 0 grid, eight of them in its plane along +x."""
    xs = np.linspace(-4, 4, 16, dtype=np.float32)
    tris = [([x, y, 0.0], [x + 0.5, y, 0.0], [x, y + 0.5, 0.0]) for x in xs for y in xs[:8]]
    v0, v1, v2 = (np.array([t[i] for t in tris], np.float32) for i in range(3))
    order = build_bvh(v0, v1, v2).tri_order

    def pad(a):
        return np.concatenate([a, np.zeros((LEAF_SIZE,) + a.shape[1:], a.dtype)])

    cl = build_clusters(build_bvh(v0, v1, v2), pad(v0[order]), pad((v1 - v0)[order]), pad((v2 - v0)[order]))
    rng = np.random.default_rng(16)
    n = 128
    org = np.zeros((n, 3), np.float32)
    d = np.zeros((n, 3), np.float32)
    org[:, 0] = rng.uniform(-4, 4.5, n)
    org[:, 1] = rng.uniform(-4, 0.5, n)
    org[:, 2] = 1.0
    d[:, 2] = -1.0
    org[:8, 2] = 0.0
    d[:8] = [1.0, 0.0, 0.0]
    return cl, org, d


def _aimed(cl, rng, n):
    """Random rays, two thirds of them aimed into random cluster boxes."""
    org, d = (np.asarray(x) for x in _rays(rng, n, spread=9.0))
    boxes = np.asarray(cl.aabbs)[np.asarray(cl.count) > 0]
    box = boxes[rng.integers(0, boxes.shape[0], n)]
    target = box[:, :3] + rng.uniform(size=(n, 3)).astype(np.float32) * (box[:, 3:] - box[:, :3])
    aim = (target - org) / np.linalg.norm(target - org, axis=-1, keepdims=True)
    return org, np.where((np.arange(n) % 3 != 0)[:, None], aim, d).astype(np.float32)


def _case(name):
    """(JAX clusters, origins, directions, active) of a named case."""
    if name == "grazing":
        cl, org, d = _grazing_scene()
        return cl, org, d, np.ones(org.shape[0], bool)
    if name == "instanced":
        cl, rng = _instanced_scene()
        n = 1200
    else:
        n_tris, seed, n = {"pallas": (500, 10, 128), "random": (4000, 11, 1200), "partial": (1025, 17, 640)}[name]
        _, _, _, cl, rng = _scene(n_tris, seed)
    org, d = _aimed(cl, rng, n)
    active = rng.uniform(size=n) < 0.9
    return cl, org, d, active


def _port(cl, org, d, **kw):
    tcl = tree_to_device(clusters_from_numpy(cl), "cpu")
    kw = {k: torch.tensor(np.asarray(v)) if isinstance(v, (np.ndarray, jnp.ndarray)) else v for k, v in kw.items()}
    hit = tcluster.intersect_clusters(torch.tensor(org), torch.tensor(d), tcl, **kw)
    return types.SimpleNamespace(**{k: v.numpy() for k, v in hit._asdict().items()})


def _hit_t(ncl, ids, org, d):
    """The t at which each ray meets triangle `ids` (virtual ids of the
    cluster tables `ncl`), by float64 Moller-Trumbore in the triangle's
    instance space with barycentrics allowed 1e-4 outside the triangle
    (tied hits lie on shared edges); nan where the ray misses it."""
    c = np.array([np.flatnonzero((ncl.start <= i) & (i < ncl.start + ncl.count))[0] for i in ids], np.int64)
    tri = ncl.tris[ncl.block_id[c], :9, ids - ncl.start[c]].astype(np.float64)  # (n, 9)
    p0, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    aff = ncl.inv_rows[ncl.inst[c]].reshape(-1, 3, 4).astype(np.float64)
    lo = np.einsum("nij,nj->ni", aff[:, :, :3], org) + aff[:, :, 3]
    ld = np.einsum("nij,nj->ni", aff[:, :, :3], d)
    pv = np.cross(ld, e2)
    inv_det = 1.0 / np.sum(e1 * pv, axis=1)
    tv = lo - p0
    qv = np.cross(tv, e1)
    u = np.sum(tv * pv, axis=1) * inv_det
    v = np.sum(ld * qv, axis=1) * inv_det
    t = np.sum(e2 * qv, axis=1) * inv_det
    return np.where((u >= -1e-4) & (v >= -1e-4) & (u + v <= 1 + 1e-4), t, np.nan)


def _assert_hits_agree(got, want, cl, org, d, min_hits):
    """t within tolerance; ids equal, except where both triangles are hit at
    that t (a real tie, checked on the geometry); u/v where the ids agree."""
    tw = np.asarray(want.t)
    np.testing.assert_allclose(got.t, tw, rtol=1e-5, atol=1e-6)
    tri_w = np.asarray(want.tri)
    same = got.tri == tri_w
    differ = np.flatnonzero(~same)
    assert np.all(got.tri[differ] >= 0) and np.all(tri_w[differ] >= 0), "a hit on one side only"
    ncl = clusters_from_numpy(cl)
    for side, ids in (("port", got.tri[differ]), ("JAX", tri_w[differ])):
        t_geo = _hit_t(ncl, ids, org[differ].astype(np.float64), d[differ].astype(np.float64))
        off = ~(np.abs(t_geo - tw[differ]) <= 1e-5 + 1e-5 * np.abs(tw[differ]))
        assert not off.any(), f"{off.sum()} of {differ.size} differing ids: the {side} triangle is not hit at t"
    np.testing.assert_allclose(got.u[same], np.asarray(want.u)[same], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.v[same], np.asarray(want.v)[same], rtol=1e-4, atol=1e-4)
    assert (got.t >= 0).sum() >= min_hits


@pytest.mark.parametrize("sort_rays", [False, True])
def test_matches_pallas_interpret(sort_rays):
    cl, org, d, active = _case("pallas")
    want = intersect_clusters(jnp.asarray(org), jnp.asarray(d), cl, active=jnp.asarray(active), use_pallas=True,
                              interpret=True, sort_rays=sort_rays)
    got = _port(cl, org, d, active=active, sort_rays=sort_rays)
    _assert_hits_agree(got, want, cl, org, d, min_hits=30)
    assert np.all(got.t[~active] == -1.0) and np.all(got.tri[~active] == -1)


@pytest.mark.parametrize("name,sort_rays", [
    ("random", False), ("random", True), ("instanced", False), ("instanced", True),
    ("partial", False), ("grazing", False), ("grazing", True),
])
def test_matches_xla_fallback(name, sort_rays):
    cl, org, d, active = _case(name)
    want = intersect_clusters(jnp.asarray(org), jnp.asarray(d), cl, active=jnp.asarray(active), use_pallas=False)
    got = _port(cl, org, d, active=active, sort_rays=sort_rays)
    _assert_hits_agree(got, want, cl, org, d, min_hits=60)
    assert np.all(got.t[~active] == -1.0) and np.all(got.tri[~active] == -1)


def test_mixed_active_lanes():
    _, _, _, cl, rng = _scene(800, 15)
    org, d = (np.asarray(x) for x in _rays(rng, 256))
    active = np.arange(256) % 3 == 0
    want = intersect_clusters(jnp.asarray(org), jnp.asarray(d), cl, active=jnp.asarray(active), use_pallas=False)
    got = _port(cl, org, d, active=active)
    _assert_hits_agree(got, want, cl, org, d, min_hits=1)
    assert np.all(got.t[~active] < 0)


def test_all_dead_packet():
    _, _, _, cl, rng = _scene(800, 14)
    org, d = (np.asarray(x) for x in _rays(rng, 256))
    got = _port(cl, org, d, active=np.zeros(256, bool))
    assert np.all(got.t < 0) and np.all(got.tri == -1)


@pytest.mark.parametrize("name", ["random", "instanced"])
def test_any_hit_per_ray_tmax(name):
    """test_visit_kernel.py's any-hit case: tmax just below / above each
    ray's closest hit; a hit must be found iff one lies before tmax."""
    cl, org, d, active = _case(name)
    closest = intersect_clusters(jnp.asarray(org), jnp.asarray(d), cl, use_pallas=False)
    t_true = np.asarray(closest.t)
    has = t_true >= 0
    below = np.where(has, t_true * 0.5, 1e-3).astype(np.float32)
    above = np.where(has, t_true * 1.01 + 1e-4, 1e8).astype(np.float32)
    for tmax in (below, above):
        want = intersect_clusters(jnp.asarray(org), jnp.asarray(d), cl, t_max=jnp.asarray(tmax),
                                  active=jnp.asarray(active), any_hit=True, use_pallas=False)
        got = _port(cl, org, d, t_max=tmax, active=active, any_hit=True)
        np.testing.assert_array_equal(got.t >= 0, np.asarray(want.t) >= 0)
    assert not np.any(_port(cl, org, d, t_max=below, any_hit=True).t[has] >= 0), "hit beyond per-ray tmax"
    got = _port(cl, org, d, t_max=above, any_hit=True)
    assert np.all(got.t[has] >= 0), "missed a hit inside per-ray tmax"
    assert np.all(got.t[has] <= above[has] + 1e-4) and np.all(got.t[has] >= t_true[has] * (1 - 1e-4))


def test_sort_key_is_first_and_second_group():
    """envelope.ray_keys(levels=2) equals cluster.py:494-519's fs key on the
    padded, root-bounded wavefront, before inactive rays are overridden."""
    cl, org, d, _ = _case("instanced")
    tcl = tree_to_device(clusters_from_numpy(cl), "cpu")
    o, dt = torch.tensor(org), torch.tensor(d)
    inv = tcluster.guarded_inverse(dt)
    tmax = tcluster.root_exit_tmax(o, inv, torch.full((o.shape[0],), 1e8), tcl, 1e-4)
    gmin_pad, gmax_pad = tcluster.pad_groups(tcl)
    got = envelope.ray_keys(o, inv, tmax, gmin_pad, gmax_pad, t_min=1e-4, levels=2).numpy()
    gp = gmin_pad.shape[1]
    n = o.shape[0]
    tn0, tf0 = jcluster._slab_tn_tf(jnp.asarray(org)[None], jnp.asarray(d)[None], jnp.asarray(tmax.numpy())[None],
                                    jnp.asarray(gmin_pad.numpy()), jnp.asarray(gmax_pad.numpy()), 1e-4)
    ent = jnp.where(tn0 <= tf0, tn0, jnp.inf).reshape(n, gp)
    first = jnp.argmin(ent, axis=1)
    ent2 = jnp.where(jnp.arange(gp)[None, :] == first[:, None], jnp.inf, ent)
    second = jnp.argmin(ent2, axis=1)
    first = jnp.where(jnp.isfinite(jnp.min(ent, axis=1)), first, gp)
    second = jnp.where(jnp.isfinite(jnp.min(ent2, axis=1)), second, gp)
    np.testing.assert_array_equal(got, np.asarray(first * (gp + 1) + second))
    assert (got // (gp + 1) < gp).sum() > 500  # most rays enter a group


def test_clusters_from_numpy_equals_the_port_build():
    """The tables carried from a JAX ClusterData (sub_aabbs from tris_rk's
    metadata rows) equal the port's own build of the same instanced scene."""
    jcl, _ = _instanced_scene()
    rng = np.random.default_rng(25)  # _instanced_scene's triangles
    v0 = rng.uniform(-2, 2, (900, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.4, 0.4, (900, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.4, 0.4, (900, 3)).astype(np.float32)
    order = tbuild_bvh(v0, v1, v2).tri_order

    def pad(a):
        return np.concatenate([a, np.zeros((LEAF_SIZE,) + a.shape[1:], a.dtype)])

    mc = tcluster.build_mesh_clusters(tbuild_bvh(v0, v1, v2), pad(v0[order]), pad((v1 - v0)[order]),
                                      pad((v2 - v0)[order]))
    m2 = np.diag([0.7, 1.4, 0.9, 1.0]).astype(np.float32)
    m2[:3, 3] = [6.0, -1.0, 2.0]
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0] = rot[2, 2] = np.cos(0.6)
    rot[0, 2] = np.sin(0.6)
    rot[2, 0] = -np.sin(0.6)
    own = tcluster.assemble_clusters([mc, mc], [(0, np.eye(4, dtype=np.float32), 0),
                                                (1, m2 @ rot, int(mc.start.max()) + 10000)])
    carried = clusters_from_numpy(jcl)
    for f in own._fields:
        np.testing.assert_array_equal(getattr(carried, f), getattr(own, f), err_msg=f)
    empty = own.sub_aabbs[..., 0] > own.sub_aabbs[..., 3]
    assert empty.any() and (~empty).any()  # the partial last cluster has empty sub-blocks


def test_visit_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    """On CPU tensors the wrapper is the plain version and counts no launch."""
    cl, org, d, active = _case("partial")
    tcl = tree_to_device(clusters_from_numpy(cl), "cpu")
    pk = tcluster.prepare_packets(torch.tensor(org), torch.tensor(d), tcl, 1e-4, 1e8, torch.tensor(active), True)
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, tcl, 1e-4)
    before = visit.kernels.LAUNCHES["visit"]
    for a, b in zip(visit.visit_trace(*args), visit.visit_trace_plain(*args)):
        assert torch.equal(a, b)
    assert visit.kernels.LAUNCHES["visit"] == before
    assert pk.nvis.dtype == torch.int32 and pk.order.dtype == torch.int32
    assert int(pk.nvis.max()) > 1


def test_brute_force_agrees_on_the_grazing_grid():
    """The grazing grid's closest hits against brute force: the sub-block
    skips lose no hit."""
    cl, org, d = _grazing_scene()
    got = _port(cl, org, d)
    p0, e1, e2 = (np.asarray(x) for x in (cl.p0, cl.e1, cl.e2))
    tris = [x.transpose(0, 2, 1).reshape(-1, 3) for x in (p0, e1, e2)]
    brute = jtraverse.intersect_brute(jnp.asarray(org), jnp.asarray(d), *(jnp.asarray(x) for x in tris))
    np.testing.assert_allclose(got.t, np.asarray(brute.t), rtol=1e-5, atol=1e-6)
    assert (got.t[8:] > 0).sum() > 20 and np.all(got.t[:8] < 0)


@pytest.mark.parametrize("t_min", [1e-4, 0.0])
def test_packet_cull_equals_jax(t_min):
    """prepare_packets' cull (supertile_tables at 512-ray tiles, tmax -inf on
    inactive rays) against JAX's on the same key-sorted packets
    (cluster._slab_tn_tf and cluster.py:541-553): entry and nvis exactly,
    entry_sorted equal, order JAX's entries sorted stably.  Mixed active
    lanes; inactive rays start at group box centres, which a tmax of t_min
    would enter at t_min."""
    jcl, org, d, active = _case("instanced")
    org, active = org.copy(), active.copy()
    centres = (np.asarray(jcl.group_min) + np.asarray(jcl.group_max)) / 2
    org[:40] = centres[np.arange(40) % centres.shape[0]]
    active[:40] = np.arange(40) % 2 == 0
    tcl = tree_to_device(clusters_from_numpy(jcl), "cpu")
    pk = tcluster.prepare_packets(torch.tensor(org), torch.tensor(d), tcl, t_min, 1e8, torch.tensor(active), True)
    gmin_pad, gmax_pad = tcluster.pad_groups(tcl)
    tn, tf = jcluster._slab_tn_tf(*(jnp.asarray(x.numpy()) for x in (pk.origin, pk.direction, pk.tmax, gmin_pad,
                                                                       gmax_pad)), t_min)
    enter = (tn <= tf) & jnp.asarray(pk.active.numpy())[:, :, None]
    entry = np.asarray(jnp.min(jnp.where(enter, tn, jnp.inf), axis=1))
    nvis = np.asarray(jnp.sum(jnp.any(enter, axis=1), axis=1))
    ids = jnp.broadcast_to(jnp.arange(entry.shape[1], dtype=jnp.int32)[None, :], entry.shape)
    entry_sorted, _ = jax.lax.sort((jnp.asarray(entry), ids), dimension=1, num_keys=1)
    got = np.empty_like(entry)
    np.put_along_axis(got, pk.order.numpy().astype(np.int64), pk.entry_sorted.numpy(), axis=1)
    np.testing.assert_array_equal(got, entry)
    np.testing.assert_array_equal(pk.nvis.numpy(), nvis)
    np.testing.assert_array_equal(pk.entry_sorted.numpy(), np.asarray(entry_sorted))
    np.testing.assert_array_equal(pk.order.numpy(), np.argsort(entry, axis=1, kind="stable"))
    # The case holds what it claims: packets that mix active and inactive
    # rays, and inactive rays that a tmax of t_min would let into a box.
    act = pk.active.numpy()
    assert (act.any(axis=1) & ~act.all(axis=1)).any()
    o, inv = pk.origin.reshape(-1, 3), guarded_inverse(pk.direction.reshape(-1, 3))
    at_t_min = envelope.slab_entry(o, inv, torch.full((o.shape[0],), t_min), gmin_pad, gmax_pad, t_min)
    assert bool((torch.isfinite(at_t_min).any(dim=1) & ~pk.active.reshape(-1)).sum() >= 10)


def test_visit_work_counts_the_walk():
    """visit_work on the instanced case: each count bounds the next, the
    walk to tmax does at least the walk to the final hit, and nearly every
    hit lies in a cluster and sub-block the walk to the hit enters."""
    cl, org, d, active = _case("instanced")
    tcl = tree_to_device(clusters_from_numpy(cl), "cpu")
    pk = tcluster.prepare_packets(torch.tensor(org), torch.tensor(d), tcl, 1e-4, 1e8, torch.tensor(active), True)
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active)
    t, tri, _, _ = visit.visit_trace_plain(*args, pk.tmax, tcl, 1e-4)
    need = visit.visit_work(*args, t, tcl, 1e-4)
    most = visit.visit_work(*args, pk.tmax, tcl, 1e-4)
    for w in (need, most):
        assert bool((w.walked <= pk.nvis[:, None]).all()) and bool((w.groups <= w.walked).all())
        assert bool((w.steps * visit.WARP >= w.walked).all())
        assert bool((w.clusters <= KERNEL_GROUP * w.groups).all())
        assert bool((w.sub_blocks <= w.sub_slabs).all()) and bool((w.sub_slabs <= KERNEL_N_SUB * w.clusters).all())
        assert bool((w.tests <= 16 * w.sub_blocks).all()) and not bool(w.walked[~pk.active].any())
    for a, b in zip(need, most):
        assert bool((a <= b).all())
    hit = tri >= 0
    assert int(hit.sum()) > 300
    assert float(((need.clusters > 0) & (need.sub_blocks > 0))[hit].float().mean()) > 0.99
