"""The five hand-written CUDA trace kernels of vpt_tpu_torch against their
plain torch versions, on a CUDA device at small shapes and at the cluster
and packet layouts of the layout knobs (VPT_CLUSTER_SIZE, VPT_GROUP_SIZE,
VPT_PACKET_SIZE, VPT_SORT_KEY, VPT_SORT_RAYS; groups above a warp's 32
members, packets of any size), the wrappers' layout checks, the probe
kernels of csrc/probe.cu (tools/hopper_probe.py) and the shared-memory
boundary, and the captured loop (render/graphs.py) against the eager one.  These tests skip where
there is no CUDA device; they import no JAX, so on a GPU machine without
JAX run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from envelope_rays import SCENES, wavefronts
from unittest import mock

from vpt_tpu_torch.accel import cluster, envelope, kernels, occlude, stream, visit
from vpt_tpu_torch.accel.bvh import LEAF_SIZE, build_bvh
from vpt_tpu_torch.accel.cluster import assemble_clusters, build_mesh_clusters, prepare_packets
from vpt_tpu_torch.scene.types import tree_to_device

pytestmark = pytest.mark.gpu
T_MIN = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _clusters(dev, instanced: bool, n_tris: int = 3000, cluster_size: int = 128, group_size: int = 8):
    rng = np.random.default_rng(5)
    v0 = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (n_tris, 3)).astype(np.float32)
    order = build_bvh(v0, v1, v2).tri_order

    def pad(a):
        return np.concatenate([a, np.zeros((LEAF_SIZE, 3), np.float32)])

    specs = [(0, np.eye(4, dtype=np.float32), 0)]
    if instanced:
        m = np.diag([0.8, 1.3, 1.0, 1.0]).astype(np.float32)
        m[:3, 3] = [7.0, 0.5, -1.0]
        specs.append((1, m, 10000))
    with mock.patch.object(cluster, "GROUP_SIZE", group_size):  # the builders read it when called
        mc = build_mesh_clusters(build_bvh(v0, v1, v2), pad(v0[order]), pad((v1 - v0)[order]),
                                 pad((v2 - v0)[order]), cluster_size=cluster_size)
        tables = assemble_clusters([mc, mc] if instanced else [mc], specs)
    return tree_to_device(tables, dev), rng


def _rays(rng, dev, n=5000):
    org = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = rng.uniform(-3, 3, (n, 3)).astype(np.float32) - org
    d = np.where((np.arange(n) % 2 == 0)[:, None], aim, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = (1.0, 0.0, 0.0)  # axis-aligned
    return torch.tensor(org, device=dev), torch.tensor(d, device=dev)


@pytest.mark.parametrize("levels", [1, 2])
def test_envelope_kernels_match_plain(cuda, levels):
    """Five supertiles: ray_keys on the unsorted wavefront as prepare_bands
    hands it over and on the sorted rays, supertile_tables on the sorted."""
    cl, rng = _clusters(cuda, instanced=False)
    org, d = _rays(rng, cuda)
    active = torch.tensor(rng.uniform(size=org.shape[0]) < 0.9, device=cuda)
    w = stream.pad_wavefront(org, d, cl, T_MIN, 1e8, active)
    b = stream.prepare_bands(org, d, cl, T_MIN, 1e8, active, levels=levels)
    assert b.sent.shape[0] * b.sent.shape[1] == 5
    gmin, gmax = stream.pad_groups(cl)
    unsorted = (w.origin, w.inv, w.tmax, gmin, gmax, T_MIN)
    assert torch.equal(envelope.ray_keys(*unsorted, levels), envelope.ray_keys_plain(*unsorted, levels))
    args = (b.origin, stream.guarded_inverse(b.direction), b.tmax, gmin, gmax, T_MIN)
    assert torch.equal(envelope.ray_keys(*args, levels), envelope.ray_keys_plain(*args, levels))
    assert torch.equal(envelope.supertile_tables(*args), envelope.supertile_tables_plain(*args))


@pytest.mark.parametrize("kind", ["primary", "bounce", "shadow"])
@pytest.mark.parametrize("name", list(SCENES))
def test_envelope_kernels_on_adversarial_rays(cuda, name, kind):
    """tests/envelope_rays.py's rays (NaN origins, box faces, axis-parallel
    directions, starts inside boxes, entry ties; one supertile, two for the
    shadow batch): both kernels equal their plain versions, levels 1 and 2,
    ray_keys on unsorted and sorted input."""
    cl, t_min, waves = wavefronts(name)
    cl = tree_to_device(cl, cuda)
    origin, direction, t_max, active = (x.to(cuda) if torch.is_tensor(x) else x for x in waves[kind])
    gmin, gmax = stream.pad_groups(cl)
    w = stream.pad_wavefront(origin, direction, cl, t_min, t_max, active)
    before = dict(kernels.LAUNCHES)
    for levels in (1, 2):
        unsorted = (w.origin, w.inv, w.tmax, gmin, gmax, t_min, levels)
        assert torch.equal(envelope.ray_keys(*unsorted), envelope.ray_keys_plain(*unsorted)), levels
        b = stream.prepare_bands(origin, direction, cl, t_min, t_max, active, levels=levels)
        args = (b.origin, stream.guarded_inverse(b.direction), b.tmax, gmin, gmax, t_min)
        assert torch.equal(envelope.ray_keys(*args, levels), envelope.ray_keys_plain(*args, levels)), levels
        tables = envelope.supertile_tables(*args)
        assert torch.equal(tables.view(torch.int32), envelope.supertile_tables_plain(*args).view(torch.int32))
    assert kernels.LAUNCHES["ray_keys"] == before["ray_keys"] + 6
    assert kernels.LAUNCHES["supertile_tables"] == before["supertile_tables"] + 4


@pytest.mark.parametrize("tile", [128, 256, 512, 1024])
@pytest.mark.parametrize("t_min", [0.0, -1e-4])
def test_supertile_tables_match_plain_at_any_t_min(cuda, t_min, tile):
    """The kernel orders entries by an order-preserving key, so it equals its
    plain version at t_min 0 and below too (as values: -0.0 equals +0.0),
    at every tile size; a third of the rays are inactive (tmax -inf) and
    some start inside a group box."""
    cl, rng = _clusters(cuda, instanced=False)
    org, d = _rays(rng, cuda, n=4096)
    org[::7] = torch.tensor(rng.uniform(-3, 3, (len(range(0, 4096, 7)), 3)).astype(np.float32), device=cuda)
    gmin, gmax = stream.pad_groups(cl)
    tmax = torch.tensor(rng.uniform(0.5, 20.0, 4096).astype(np.float32), device=cuda)
    tmax = torch.where(torch.arange(4096, device=cuda) % 3 == 0, -torch.inf, tmax)
    args = (org, stream.guarded_inverse(d), tmax, gmin, gmax, t_min, tile)
    before = kernels.LAUNCHES["supertile_tables"]
    got = envelope.supertile_tables(*args)
    assert kernels.LAUNCHES["supertile_tables"] == before + 1
    want = envelope.supertile_tables_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (4096 // tile, gmin.shape[1])
    assert torch.equal(got, want)
    assert bool((want <= 0).any()) and bool(torch.isfinite(want).any())


def test_packet_cull_kernel_matches_the_dense_cull(cuda):
    """prepare_packets on the card (supertile_tables at 512-ray tiles, tmax
    -inf on inactive rays) gives the candidate lists of the dense (rays, Gp)
    cull on the same sorted packets."""
    cl, rng = _clusters(cuda, instanced=True)
    org, d = _rays(rng, cuda, n=6000)
    active = torch.tensor(rng.uniform(size=6000) < 0.7, device=cuda)
    before = kernels.LAUNCHES["supertile_tables"]
    pk = prepare_packets(org, d, cl, T_MIN, 1e8, active, sort_rays=True)
    assert kernels.LAUNCHES["supertile_tables"] == before + 1
    gmin, gmax = stream.pad_groups(cl)
    ent = envelope.slab_entry(pk.origin.reshape(-1, 3), stream.guarded_inverse(pk.direction.reshape(-1, 3)),
                              pk.tmax.reshape(-1), gmin, gmax, T_MIN)
    entry = torch.where(pk.active.reshape(-1, 1), ent, torch.inf).reshape(-1, 512, gmin.shape[1]).amin(dim=1)
    entry_sorted, order = torch.sort(entry, dim=1, stable=True)
    assert torch.equal(pk.order, order.to(torch.int32)) and torch.equal(pk.entry_sorted, entry_sorted)
    assert torch.equal(pk.nvis, torch.isfinite(entry).sum(dim=1).to(torch.int32))


@pytest.mark.parametrize("instanced", [False, True])
def test_stream_kernel_matches_plain(cuda, instanced):
    cl, rng = _clusters(cuda, instanced)
    org, d = _rays(rng, cuda)
    n = org.shape[0]
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    b = stream.trace_bands(org, d, cl, T_MIN, 1e8, active, torch.tensor(np.arange(n) % 4 == 0, device=cuda))
    tk, trk, uk, vk = stream.stream_trace(b, cl, T_MIN)
    tp, trp, up, vp = stream.stream_trace_plain(b, cl, T_MIN)
    torch.cuda.synchronize()
    closest = (b.payload[0] & 2) == 0
    assert torch.allclose(tk[closest], tp[closest], rtol=1e-5, atol=1e-6)
    same = trk == trp
    tie = (tk - tp).abs() <= 1e-5 + 1e-5 * tp.abs()
    assert bool((same | (tie & (trp >= 0)) | ~closest).all())
    assert torch.allclose(uk[same & closest], up[same & closest], rtol=1e-4, atol=1e-5)
    assert torch.equal(trk >= 0, trp >= 0)  # any-hit rays: a hit iff one exists
    assert int((trk >= 0).sum()) > 500


def test_occlude_kernel_matches_plain(cuda):
    cl, rng = _clusters(cuda, instanced=True)
    org, d = _rays(rng, cuda)
    n = org.shape[0]
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    extri = torch.tensor(rng.integers(-1, 3000, n).astype(np.int32), device=cuda)
    tmax = torch.tensor(rng.uniform(0.5, 20.0, n).astype(np.float32), device=cuda)
    b = occlude.shadow_bands(org, d, cl, T_MIN, tmax, active, extri)
    blocked = occlude.occlude_trace(b, cl, T_MIN)
    assert torch.equal(blocked, occlude.occlude_trace_plain(b, cl, T_MIN))
    assert int(blocked.sum()) > 200


@pytest.mark.parametrize("instanced", [False, True])
def test_trace_kernels_match_plain_with_empty_sub_blocks(cuda, instanced):
    """A small scene whose partial clusters hold empty sub-blocks (inverted
    boxes): the stream kernel by the tie rule, occlusion exactly."""
    cl, rng = _clusters(cuda, instanced, n_tris=700)
    empty = cl.sub_aabbs[..., 0] > cl.sub_aabbs[..., 3]
    assert bool(empty.any()) and bool((~empty).any())
    org, d = _rays(rng, cuda, n=3000)
    n = org.shape[0]
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    b = stream.trace_bands(org, d, cl, T_MIN, 1e8, active, torch.zeros_like(active))
    tk, trk, uk, vk = stream.stream_trace(b, cl, T_MIN)
    tp, trp, up, vp = stream.stream_trace_plain(b, cl, T_MIN)
    torch.cuda.synchronize()
    assert torch.allclose(tk, tp, rtol=1e-5, atol=1e-6)
    same = trk == trp
    tie = (tk - tp).abs() <= 1e-5 + 1e-5 * tp.abs()
    assert bool((same | (tie & (trp >= 0))).all())
    assert torch.equal(uk[same], up[same]) and torch.equal(vk[same], vp[same])
    assert int((trk >= 0).sum()) > 300
    tmax = torch.tensor(rng.uniform(0.5, 20.0, n).astype(np.float32), device=cuda)
    extri = torch.tensor(rng.integers(-1, 700, n).astype(np.int32), device=cuda)
    sb = occlude.shadow_bands(org, d, cl, T_MIN, tmax, active, extri)
    blocked = occlude.occlude_trace(sb, cl, T_MIN)
    assert torch.equal(blocked, occlude.occlude_trace_plain(sb, cl, T_MIN))
    assert int(blocked.sum()) > 100


def _refused(dev, shape):
    """Cluster tables of a layout outside the default: groups of 33 (a
    partial second chunk of 32 members, which the kernels take) or 4
    sub-blocks (which they refuse)."""
    if shape == "groups of 33":
        return _clusters(dev, instanced=False, group_size=33)
    cl, rng = _clusters(dev, instanced=False)
    return cl._replace(sub_aabbs=cl.sub_aabbs[:, :4].contiguous()), rng


@pytest.mark.parametrize("shape", ["groups of 33", "4 sub-blocks"])
def test_trace_wrappers_raise_on_other_cluster_shapes(cuda, shape):
    """vpt_stream / vpt_occlude take any K that is a multiple of 8 in 8
    sub-blocks and groups of any size: groups of 33 equal the plain
    versions (stream by the tie rule, occlusion exactly); on 4 sub-blocks
    the wrappers raise, naming the layout, and launch nothing."""
    cl, rng = _refused(cuda, shape)
    org, d = _rays(rng, cuda, n=1000)
    active = torch.ones(org.shape[0], dtype=torch.bool, device=cuda)
    b = stream.trace_bands(org, d, cl, T_MIN, 1e8, active, torch.zeros_like(active))
    sb = occlude.shadow_bands(org, d, cl, T_MIN, 1e8, active, torch.full_like(active, -1, dtype=torch.int32))
    before = dict(kernels.LAUNCHES)
    if shape == "groups of 33":
        tk, trk, _, _ = stream.stream_trace(b, cl, T_MIN)
        tp, trp, _, _ = stream.stream_trace_plain(b, cl, T_MIN)
        torch.cuda.synchronize()
        assert torch.allclose(tk, tp, rtol=1e-5, atol=1e-6)
        tie = (tk - tp).abs() <= 1e-5 + 1e-5 * tp.abs()
        assert bool(((trk == trp) | (tie & (trp >= 0))).all()) and int((trk >= 0).sum()) > 100
        assert torch.equal(occlude.occlude_trace(sb, cl, T_MIN), occlude.occlude_trace_plain(sb, cl, T_MIN))
        assert kernels.LAUNCHES["stream"] == before["stream"] + 1
        return
    with pytest.raises(ValueError, match="a multiple of 8 triangles per cluster in 8 sub-blocks and at least one"):
        stream.stream_trace(b, cl, T_MIN)
    with pytest.raises(ValueError, match="a multiple of 8 triangles per cluster in 8 sub-blocks and at least one"):
        occlude.occlude_trace(sb, cl, T_MIN)
    assert kernels.LAUNCHES == before


# The cluster layouts beside the default (K = 128, groups of 8): the compiled
# K of 64, 256 and 1024, a K taken at run time (40), and groups of 4, 16 and
# 3, and above a warp's 32 members: 48 (a partial second chunk), 64 (two
# full chunks) and 33 at K = 64.
LAYOUTS = [(64, 8), (256, 8), (1024, 8), (40, 8), (128, 4), (128, 16), (64, 3), (128, 48), (128, 64), (64, 33)]


@pytest.mark.parametrize("k,g", LAYOUTS)
def test_trace_kernels_match_plain_at_layouts(cuda, k, g):
    """vpt_stream by the tie rule and vpt_occlude exactly, instanced, at the
    cluster layouts of VPT_CLUSTER_SIZE and VPT_GROUP_SIZE."""
    cl, rng = _clusters(cuda, instanced=True, cluster_size=k, group_size=g)
    assert cl.tris.shape[2] == k and cl.count.shape[0] == g * cl.group_min.shape[0]
    org, d = _rays(rng, cuda)
    n = org.shape[0]
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    b = stream.trace_bands(org, d, cl, T_MIN, 1e8, active, torch.zeros_like(active))
    before = dict(kernels.LAUNCHES)
    tk, trk, uk, vk = stream.stream_trace(b, cl, T_MIN)
    tp, trp, up, vp = stream.stream_trace_plain(b, cl, T_MIN)
    torch.cuda.synchronize()
    assert torch.allclose(tk, tp, rtol=1e-5, atol=1e-6)
    same = trk == trp
    tie = (tk - tp).abs() <= 1e-5 + 1e-5 * tp.abs()
    assert bool((same | (tie & (trp >= 0))).all())
    assert torch.equal(uk[same], up[same]) and torch.equal(vk[same], vp[same])
    assert int((trk >= 0).sum()) > 500
    extri = torch.tensor(rng.integers(-1, 3000, n).astype(np.int32), device=cuda)
    tmax = torch.tensor(rng.uniform(0.5, 20.0, n).astype(np.float32), device=cuda)
    sb = occlude.shadow_bands(org, d, cl, T_MIN, tmax, active, extri)
    blocked = occlude.occlude_trace(sb, cl, T_MIN)
    assert torch.equal(blocked, occlude.occlude_trace_plain(sb, cl, T_MIN))
    assert int(blocked.sum()) > 200
    assert kernels.LAUNCHES["stream"] == before["stream"] + 1 and kernels.LAUNCHES["occlude"] == before["occlude"] + 1


@pytest.mark.parametrize("k,g", LAYOUTS)
@pytest.mark.parametrize("any_hit", [False, True])
def test_visit_kernel_matches_plain_at_layouts(cuda, k, g, any_hit):
    """vpt_visit equals visit_trace_plain exactly at the cluster layouts."""
    cl, rng = _clusters(cuda, instanced=True, cluster_size=k, group_size=g)
    org, d = _rays(rng, cuda, n=3000)
    active = torch.tensor(rng.uniform(size=3000) < 0.9, device=cuda)
    tmax = torch.tensor(rng.uniform(0.5, 20.0, 3000).astype(np.float32), device=cuda)
    pk = prepare_packets(org, d, cl, T_MIN, tmax if any_hit else 1e8, active, sort_rays=True)
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, cl, T_MIN)
    got = visit.visit_trace(*args, any_hit=any_hit)
    want = visit.visit_trace_plain(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert int((got[1] >= 0).sum()) > 300


@pytest.mark.parametrize("size,key,sort", [(128, "fs", True), (256, "fs", True), (1024, "fs", True),
                                           (512, "fe", True), (256, "fe", True), (512, "fs", False),
                                           (1024, "fs", False), (64, "fs", True), (384, "fs", True),
                                           (2048, "fs", True), (100, "fe", False)])
def test_packet_layouts_match_plain(cuda, size, key, sort):
    """VPT_PACKET_SIZE, VPT_SORT_KEY and VPT_SORT_RAYS on the card: the
    keys (fe through ray_keys' mode 3), the packet cull at `size`-ray tiles
    against the dense cull, and vpt_visit against its plain version."""
    cl, rng = _clusters(cuda, instanced=True)
    org, d = _rays(rng, cuda, n=5000)
    active = torch.tensor(rng.uniform(size=5000) < 0.8, device=cuda)
    with mock.patch.object(cluster, "PACKET_SIZE", size), mock.patch.object(cluster, "_SORT_KEY", key):
        before = dict(kernels.LAUNCHES)
        pk = prepare_packets(org, d, cl, T_MIN, 1e8, active, sort_rays=sort)
        assert kernels.LAUNCHES["ray_keys"] == before["ray_keys"] + int(sort)
    assert pk.active.shape[1] == size and (pk.perm is None) == (not sort)
    gmin, gmax = stream.pad_groups(cl)
    o, inv = pk.origin.reshape(-1, 3), stream.guarded_inverse(pk.direction.reshape(-1, 3))
    ent = envelope.slab_entry(o, inv, pk.tmax.reshape(-1), gmin, gmax, T_MIN)
    entry = torch.where(pk.active.reshape(-1, 1), ent, torch.inf).reshape(-1, size, gmin.shape[1]).amin(dim=1)
    entry_sorted, order = torch.sort(entry, dim=1, stable=True)
    assert torch.equal(pk.order, order.to(torch.int32)) and torch.equal(pk.entry_sorted, entry_sorted)
    if key == "fe":
        diag = cluster.root_diagonal(cl)
        w_inv = stream.guarded_inverse(d)
        tmax = cluster.root_exit_tmax(org, w_inv, torch.full((5000,), 1e8, device=cuda), cl, T_MIN)
        keys = (org, w_inv, tmax, gmin, gmax, T_MIN, 1)
        assert torch.equal(envelope.ray_keys(*keys, diag=diag), envelope.ray_keys_plain(*keys, diag=diag))
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, cl, T_MIN)
    got = visit.visit_trace(*args)
    want = visit.visit_trace_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert int((got[1] >= 0).sum()) > 500


@pytest.mark.parametrize("instanced", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_visit_kernel_matches_plain(cuda, instanced, any_hit):
    """vpt_visit equals visit_trace_plain exactly, ties included: the same
    packets, the same gates, the same arithmetic (--fmad=false)."""
    cl, rng = _clusters(cuda, instanced)
    org, d = _rays(rng, cuda, n=6000)
    n = org.shape[0]
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    tmax = torch.tensor(rng.uniform(0.5, 20.0, n).astype(np.float32), device=cuda)
    pk = prepare_packets(org, d, cl, T_MIN, tmax if any_hit else 1e8, active, sort_rays=True)
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, cl, T_MIN)
    before = kernels.LAUNCHES["visit"]
    got = visit.visit_trace(*args, any_hit=any_hit)
    assert kernels.LAUNCHES["visit"] == before + 1
    want = visit.visit_trace_plain(*args, any_hit=any_hit)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert int((got[1] >= 0).sum()) > 500


@pytest.mark.parametrize("t_min", [0.0, -1e-4])
def test_visit_kernel_matches_plain_at_any_t_min(cuda, t_min):
    """The visit's closest hit is picked on an order-preserving key of t, so
    it equals the plain version at t_min 0 and below too."""
    cl, rng = _clusters(cuda, instanced=True)
    org, d = _rays(rng, cuda, n=3000)
    active = torch.tensor(rng.uniform(size=3000) < 0.9, device=cuda)
    pk = prepare_packets(org, d, cl, t_min, 1e8, active, sort_rays=True)
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, cl, t_min)
    got = visit.visit_trace(*args)
    want = visit.visit_trace_plain(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "tri", "u", "v"), got, want):
        assert torch.equal(a, b), name
    assert int((got[1] >= 0).sum()) > 300


@pytest.mark.parametrize("shape", ["groups of 33", "4 sub-blocks", "384-ray packets"])
def test_visit_wrapper_raises_on_other_cluster_shapes(cuda, shape):
    """vpt_visit takes the layouts the trace kernels take and packets of any
    size: groups of 33 and 384-ray packets equal the plain version; on 4
    sub-blocks the wrapper raises, naming the layout, and launches
    nothing."""
    cl, rng = _refused(cuda, shape) if shape != "384-ray packets" else _clusters(cuda, instanced=False)
    org, d = _rays(rng, cuda, n=1536)
    pk = prepare_packets(org, d, cl, T_MIN, 1e8, None, sort_rays=False)
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax)
    if shape == "384-ray packets":
        with mock.patch.object(cluster, "PACKET_SIZE", 384):
            pk = prepare_packets(org, d, cl, T_MIN, 1e8, None, sort_rays=False)
        args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax)
        assert pk.active.shape == (4, 384)
    before = dict(kernels.LAUNCHES)
    if shape != "4 sub-blocks":
        got = visit.visit_trace(*args, cl, T_MIN)
        want = visit.visit_trace_plain(*args, cl, T_MIN)
        torch.cuda.synchronize()
        for name, a, b in zip(("t", "tri", "u", "v"), got, want):
            assert torch.equal(a, b), name
        assert int((got[1] >= 0).sum()) > 100 and kernels.LAUNCHES["visit"] == before["visit"] + 1
        return
    with pytest.raises(ValueError, match="at least one cluster per group"):
        visit.visit_trace(*args, cl, T_MIN)
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("probe", kernels.PROBES)
def test_probe_kernels_match_plain(cuda, probe):
    """Each kernel of csrc/probe.cu equals its plain version at its probe's
    shapes (tools.hopper_probe.cases: the JAX probes' inputs, a random tile
    where a sum's order decides its rounding): bitwise, probe2's bins as
    sets and its counts exactly; one launch counted."""
    from vpt_tpu_torch.tools import hopper_probe as hp

    case = hp.cases(cuda)[probe]
    before = kernels.LAUNCHES[probe]
    got = case.fn(*case.args)
    assert kernels.LAUNCHES[probe] == before + 1
    want = case.plain(*case.args)
    torch.cuda.synchronize()
    assert hp.same_result(probe, got, want)


def test_shared_memory_boundary(cuda):
    """probe8 and smem_probe run at 227 KB (232,448 bytes) of dynamic shared
    memory and are refused 16 bytes above it, with the CUDA error named and
    cleared: a launch after the refusal succeeds."""
    from vpt_tpu_torch.tools import hopper_probe as hp

    x8 = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    limit = hp.SMEM_LIMIT // 4
    assert int(hp.probe8(x8, limit)[0, 0]) == 3
    xs = torch.arange(limit + 4, dtype=torch.float32, device=cuda).reshape(1, -1)
    assert float(hp.smem_probe(xs[:, :limit].contiguous())[0, 0]) == float(limit - 1)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(hp.Refused) as refused:
        hp.probe8(x8, limit + 4)
    assert refused.value.name.startswith("cuda")
    with pytest.raises(hp.Refused):
        hp.smem_probe(xs)
    assert kernels.LAUNCHES == before
    assert int(hp.probe8(x8, 16)[0, 0]) == 3
    torch.cuda.synchronize()


def test_one_rank_nccl_render_sharded_equals_render_samples(cuda, tmp_path):
    """render_sharded on a (1, 1) mesh of one nccl rank (sphere_garden 64^2,
    the cluster path) equals the one-process render_samples over the same
    row-major pixels, image and segments."""
    import torch.distributed as dist

    from vpt_tpu_torch.core.camera import perspective
    from vpt_tpu_torch.dist import mesh
    from vpt_tpu_torch.render import integrator
    from vpt_tpu_torch.render.params import RenderFlags, default_params
    from vpt_tpu_torch.scene.build import compile_scene
    from vpt_tpu_torch.scene.procedural import sphere_garden

    data, meta, aux = compile_scene(sphere_garden(), device=cuda)
    assert not meta.use_brute_force
    params = default_params(np.linalg.inv(aux["camera_view"]),
                            np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0)), device=cuda)
    flags = RenderFlags(max_depth=4, max_medium_events=2)
    pxy, pidx = mesh.pixel_grid(64, 64)
    want, want_segs, _ = integrator.render_samples(data, meta, flags, params, torch.as_tensor(pxy, device=cuda),
                                                   torch.as_tensor(pidx, device=cuda), (64, 64), 77, 2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        before = dict(kernels.LAUNCHES)
        img, segs = mesh.render_sharded(data, meta, flags, params, (64, 64), 77, 2, mesh.make_mesh())
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert kernels.LAUNCHES["stream"] > before["stream"] and kernels.LAUNCHES["occlude"] > before["occlude"]
    assert torch.equal(img, want.reshape(64, 64, 3)) and int(segs) == int(want_segs)


def _dispatches(dev, compiled, size: int, capture: bool, mode: str):
    """Two render_step dispatches of the `compiled` scene at size^2, 2 spp,
    depth 4, with another camera, sky rotation, seed and frame count the
    second time, with the loop captured or eager: [(image, segments,
    LoopStats as a tuple)], launches."""
    import dataclasses

    from unittest import mock

    from vpt_tpu_torch.api import render_step
    from vpt_tpu_torch.core.camera import look_at, perspective
    from vpt_tpu_torch.render import graphs, integrator
    from vpt_tpu_torch.render.params import RenderFlags, default_params, scalar

    data, meta, aux = compiled
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0))
    views = [np.linalg.inv(aux["camera_view"]), np.linalg.inv(look_at((1.5, 3.0, 14.0), (0.0, 2.0, 0.0), (0, 1, 0)))]
    flags = RenderFlags(max_depth=4, max_medium_events=4)
    accum, out = torch.zeros((size, size, 3), device=dev), []
    kernels.reset_launches()
    with mock.patch.object(graphs, "CAPTURE", capture), mock.patch.object(integrator, "TRACE_MODE", mode):
        for i, (view_inv, seed) in enumerate(zip(views, (2654435761, 99))):
            params = default_params(view_inv, proj_inv, device=dev)._replace(sky_rotation_azimuth=scalar(25.0 * i, dev))
            accum, segs, stats = render_step(data, meta, flags, params, seed, (size, size), accum, i, 2)
            out.append((accum.clone(), int(segs), dataclasses.astuple(stats)))
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES)


def _check_captured_against_eager(eager, captured, eager_launches, captured_launches):
    """Images bitwise, segments, media loops and steps equal; the captured
    loop reads nothing on the host once its graph is built (the first
    dispatch runs its first iteration eagerly) and reads the graph's
    tallies once after each launch; kernel launches equal, the loop
    condition launched on the captured path only."""
    for (a, sa, la), (b, sb, lb) in zip(eager, captured):
        assert torch.equal(a, b) and sa == sb and la[:2] == lb[:2]
        assert la[3] == 0 and lb[3] == 1
    assert captured[1][2][2] == 0 < captured[0][2][2] < eager[0][2][2]
    assert eager_launches.pop("loop_cond") == 0 and captured_launches.pop("loop_cond") > 0
    assert eager_launches == captured_launches


@pytest.mark.parametrize("name,size,mode", [("cornell_box", 64, "stream"), ("colonnade", 128, "stream"),
                                            ("colonnade", 128, "packet")])
def test_captured_dispatches_equal_eager_ones(cuda, name, size, mode):
    """The captured loop (render/graphs.py, one dispatch graph) against the
    eager one over two dispatches with different parameters
    (`_check_captured_against_eager`); one capture serves both
    dispatches."""
    from vpt_tpu_torch.render import graphs
    from vpt_tpu_torch.scene import procedural
    from vpt_tpu_torch.scene.build import compile_scene

    graphs.clear()
    compiled = compile_scene(getattr(procedural, name)(), device=cuda)
    eager, eager_launches = _dispatches(cuda, compiled, size, False, mode)
    captured, captured_launches = _dispatches(cuda, compiled, size, True, mode)
    steps = graphs.steps()
    graphs.clear()
    assert name == "cornell_box" or captured_launches["supertile_tables"] > 0
    _check_captured_against_eager(eager, captured, eager_launches, captured_launches)
    assert not torch.equal(eager[0][0], eager[1][0])
    assert len(steps) == 1 and steps[0].captures == 1 and steps[0].replays == 2


@pytest.mark.parametrize("case", ["cloud_and_haze", "atmosphere", "both"])
def test_captured_media_dispatches_equal_eager_ones(cuda, case):
    """A configuration with volumes, the atmosphere or both, captured (a
    segment graph between its media loops and a nested WHILE node over one
    step per loop) against the eager loop over two dispatches with
    different parameters (`_check_captured_against_eager`); one capture
    serves both dispatches."""
    import dataclasses
    from unittest import mock

    from vpt_tpu_torch.api import render_step
    from vpt_tpu_torch.core.camera import look_at, perspective
    from vpt_tpu_torch.render import graphs
    from vpt_tpu_torch.render.params import RenderFlags, default_params, scalar, vec3
    from vpt_tpu_torch.scene.build import build_volume_table, compile_scene
    from vpt_tpu_torch.scene.procedural import colonnade
    from vpt_tpu_torch.scene.types import Volume
    from vpt_tpu_torch.scene.vdb import procedural_cloud

    data, meta, aux = compile_scene(colonnade(n_columns=2, column_res=(24, 8)), device=cuda)
    if case != "atmosphere":
        vols = [Volume(corner_min=(-6, 3, -4), corner_max=(6, 9, 4), density=8.0, anisotropy=0.3,
                       density_grid=procedural_cloud((32, 32, 32), coverage=0.6)),
                Volume(corner_min=(-17, 0, -7), corner_max=(17, 1.5, 7), density=0.05, color=(0.9, 0.9, 0.9))]
        data = data._replace(volumes=tree_to_device(build_volume_table(vols), cuda))
        meta = dataclasses.replace(meta, n_volumes=2, n_het_volumes=1)
    flags = RenderFlags(max_depth=3, max_medium_events=4, enable_atmosphere=case != "cloud_and_haze")
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0))
    views = [np.linalg.inv(aux["camera_view"]), np.linalg.inv(look_at((3.0, 4.0, 18.0), (0.0, 3.0, 0.0), (0, 1, 0)))]

    def dispatches(capture: bool):
        accum, out = torch.zeros((64, 64, 3), device=cuda), []
        kernels.reset_launches()
        with mock.patch.object(graphs, "CAPTURE", capture):
            for i, (view_inv, seed) in enumerate(zip(views, (2654435761, 99))):
                params = default_params(view_inv, proj_inv, device=cuda)._replace(
                    planet_position=vec3((0.0, -6360e3, 0.0), cuda), sky_rotation_altitude=scalar(30.0, cuda))
                accum, segs, stats = render_step(data, meta, flags, params, seed, (64, 64), accum, i, 2)
                out.append((accum.clone(), int(segs), dataclasses.astuple(stats)))
        torch.cuda.synchronize()
        return out, dict(kernels.LAUNCHES)

    graphs.clear()
    try:
        eager, eager_launches = dispatches(False)
        captured, captured_launches = dispatches(True)
        (step,) = graphs.steps()
    finally:
        graphs.clear()
    assert captured_launches["stream"] > 0
    _check_captured_against_eager(eager, captured, eager_launches, captured_launches)
    assert not torch.equal(eager[0][0], eager[1][0]) and eager[0][2][1] > 0
    assert step.captures == 1 and step.replays == 2
    assert len(step.sites) == {"cloud_and_haze": 5, "atmosphere": 7, "both": 16}[case]
    assert len(step.segments) == len(step.sites) + 1


@pytest.mark.parametrize("name", ["cap0", "all_dead", "alive_at_cap", "random_a", "wavefront"])
def test_loop_cond_kernel_counts_as_its_plain_version(cuda, name):
    """vpt_loop_cond_kernel (csrc/graph_loop.cu) in a dispatch graph of
    tests/while_toys.py: the WHILE node runs the plain loop's count of
    steps, twice, and a nested pair counts its loops and steps."""
    import while_toys
    from vpt_tpu_torch.render import graphs

    death, cap = while_toys.deaths(name)
    d = torch.as_tensor(death, device=cuda)
    want = while_toys.plain_count(d, cap)
    assert want == while_toys.expected(death, cap)
    nodes, (live, steps, counts) = while_toys.single(d, cap, graphs.Recorder())
    toy = graphs.DispatchGraph(nodes, cuda)
    for _ in range(2):
        counts.zero_()
        graphs.launch(toy)
        torch.cuda.synchronize()
        assert int(steps) == want and counts.tolist() == [1, want]
        assert torch.equal(live, d > want)
    rng = np.random.default_rng(7)
    d_out, d_in = rng.integers(0, 9, 300), rng.integers(0, 14, 5000)
    nodes, (c_out, c_in) = while_toys.nested(torch.as_tensor(d_out, device=cuda), 6,
                                             torch.as_tensor(d_in, device=cuda), 5, graphs.Recorder())
    graphs.launch(graphs.DispatchGraph(nodes, cuda))
    torch.cuda.synchronize()
    k, entered, inner = while_toys.expected_nested(d_out, 6, d_in, 5)
    assert c_out.tolist() == [1, k] and c_in.tolist() == [entered, inner]


def test_a_sync_in_the_body_makes_the_capture_raise(cuda):
    """A host synchronisation inside the loop body cannot be captured: the
    dispatch raises, and nothing falls back to an eager loop.  (Last in the
    file: the failed capture is left to the process.)"""
    from unittest import mock

    from vpt_tpu_torch.api import render_step
    from vpt_tpu_torch.render import graphs, integrator
    from vpt_tpu_torch.render.params import RenderFlags, default_params
    from vpt_tpu_torch.scene.build import compile_scene
    from vpt_tpu_torch.scene.procedural import cornell_box

    data, meta, _ = compile_scene(cornell_box(), device=cuda)
    body = integrator.body

    def syncing_body(*args):
        out = body(*args)
        bool(out["alive"].any())
        return out

    graphs.clear()
    try:
        with mock.patch.object(integrator, "body", syncing_body), pytest.raises(RuntimeError):
            render_step(data, meta, RenderFlags(max_depth=2), default_params(device=cuda), 7, (16, 16),
                        torch.zeros((16, 16, 3), device=cuda), 0, 1)
        assert not graphs.steps()[0].segments
    finally:
        graphs.clear()
