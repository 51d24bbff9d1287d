"""The layout knobs of the port (VPT_CLUSTER_SIZE, VPT_GROUP_SIZE,
VPT_PACKET_SIZE, VPT_SORT_KEY, VPT_SORT_RAYS) against the JAX package at
the same layouts, on the CPU with the kernels' plain versions.

The cluster size and the sort key are read when called on both sides, so
they are set in this process (monkeypatch); the JAX package binds the group
size at import in four modules, so tests/jax_layouts.py builds its tables,
traces and render in a process of its own per group size (groups of 4, 16
and 48, the last above the 32 members one warp tests at a time).  Packets
of 64, 384 and 2048 rays are neither a warp's multiple of a block nor at
most 1024 rays: the sizes the CUDA kernels took last.  Inputs come from
seeded numpy (tests/jax_layouts.py).

Tolerances: cluster tables and sort permutations bitwise; closest hits by
tests/test_torch_trace.py's tie rule (t to rtol 1e-5 / atol 1e-6, ids equal
except at equal t, u/v to rtol 1e-4 / atol 1e-4 where the ids agree and the
ray meets its triangle at more than ~1 degree from its plane: u and v are
ratios by a determinant that goes to 0 at grazing incidence, which
magnifies XLA's fused multiply-adds; at most 1% of the hits graze) and,
for the packet trace, tests/test_torch_visit.py's (a differing id must be
hit at the same t, checked on the geometry); shadow queries equal; renders
at tests/test_torch_render.py's bars (PSNR > 40 dB, 99% of pixels within
rtol 1e-3 / atol 1e-4)."""

import os
import subprocess
import sys
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_layouts as jl
from test_torch_render import _assert_images_agree
from test_torch_trace import use_native_jax_bvh
from test_torch_visit import _hit_t
from vpt_tpu import envguard as jenvguard
from vpt_tpu.accel import cluster as jcluster
from vpt_tpu.scene import build as jbuild
from vpt_tpu.scene import procedural as jproc
from vpt_tpu_torch import envguard
from vpt_tpu_torch.accel import cluster
from vpt_tpu_torch.accel.bvh import LEAF_SIZE, build_bvh
from vpt_tpu_torch.accel.occlude import occlude_stream
from vpt_tpu_torch.accel.stream import intersect_stream
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.render import graphs, integrator
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.core.camera import perspective
from vpt_tpu_torch.scene import build as tbuild
from vpt_tpu_torch.scene import procedural as tproc
from vpt_tpu_torch.scene.convert import clusters_from_numpy
from vpt_tpu_torch.scene.types import ClusterData, tree_to_device

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CLUSTER_SIZES = [40, 64, 256]
GROUP_SIZES = [4, 16, 48]  # 48: a warp's 32 members and a partial second chunk of 16


@pytest.fixture(scope="module")
def jax_groups(tmp_path_factory):
    """{group size: tests/jax_layouts.py's arrays}, the processes run at once."""
    out = tmp_path_factory.mktemp("jax_layouts")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join([REPO, TESTS]))
    procs = {g: subprocess.Popen([sys.executable, os.path.join(TESTS, "jax_layouts.py"), str(out / f"g{g}.npz")]
                                 + (["--render"] if g == 4 else []),
                                 env=dict(env, VPT_GROUP_SIZE=str(g)), cwd=REPO, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for g in GROUP_SIZES}
    arrays = {}
    for g, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        with np.load(out / f"g{g}.npz") as z:
            arrays[g] = dict(z)
        assert int(arrays[g]["group_size"]) == g
    return arrays


def _fields(arrays, prefix):
    """A ClusterData-like namespace of the arrays under `prefix`/."""
    return types.SimpleNamespace(**{k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith(prefix + "/")})


def _port_tables(**kw):
    """The port's own tables of tests/jax_layouts.py's scene."""
    return jl.clusters(build_bvh, cluster.build_mesh_clusters, cluster.assemble_clusters, LEAF_SIZE, **kw)


def _assert_tables_equal(own: ClusterData, carried: ClusterData):
    for f in ClusterData._fields:
        a, b = np.asarray(getattr(own, f)), np.asarray(getattr(carried, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _colonnade_tables_equal(want_clusters):
    got, _, _ = tbuild.compile_scene(jl.reduced_colonnade(tproc), "cpu")
    want = tree_to_device(clusters_from_numpy(want_clusters), "cpu")
    for f in ClusterData._fields:
        assert torch.equal(getattr(got.clusters, f), getattr(want, f)), f
    return got.clusters


@pytest.mark.parametrize("k", CLUSTER_SIZES)
def test_cluster_tables_equal_jax_at_cluster_sizes(k, monkeypatch):
    """K = k: the instanced scene's tables through each package's builders,
    and compile_scene's, with CLUSTER_SIZE set on both sides (each reads it
    when called): bitwise, K / 8 triangles per sub-block."""
    jcl = jl.jax_clusters(cluster_size=k)
    own = _port_tables(cluster_size=k)
    _assert_tables_equal(own, clusters_from_numpy(jcl))
    assert own.tris.shape[2] == k and own.sub_aabbs.shape[1] == 8
    use_native_jax_bvh()
    monkeypatch.setattr(jcluster, "CLUSTER_SIZE", k)
    monkeypatch.setattr(cluster, "CLUSTER_SIZE", k)
    jdata, _, _ = jbuild.compile_scene(jl.reduced_colonnade(jproc))
    tables = _colonnade_tables_equal(jax.tree.map(np.asarray, jdata.clusters))
    assert tables.tris.shape[2] == k


def test_cluster_size_not_a_multiple_of_8_raises_jax_error():
    with pytest.raises(AssertionError, match="cluster_size must be a multiple of 8"):
        jl.jax_clusters(cluster_size=12)
    with pytest.raises(ValueError, match="cluster_size must be a multiple of 8"):
        _port_tables(cluster_size=12)


@pytest.mark.parametrize("g", GROUP_SIZES)
def test_cluster_tables_equal_jax_at_group_sizes(g, jax_groups, monkeypatch):
    """Groups of g: JAX's tables from a process with VPT_GROUP_SIZE=g against
    the port's, GROUP_SIZE set here (the port reads it when called)."""
    arrays = jax_groups[g]
    monkeypatch.setattr(cluster, "GROUP_SIZE", g)
    own = _port_tables()
    _assert_tables_equal(own, clusters_from_numpy(_fields(arrays, "inst")))
    assert own.count.shape[0] == g * own.group_min.shape[0]
    tables = _colonnade_tables_equal(_fields(arrays, "col"))
    assert tables.count.shape[0] == g * tables.group_min.shape[0]


def _reference(layout, jax_groups):
    """(JAX's tables, JAX's hits and shadow queries) at a layout."""
    kind, size = layout[0], int(layout[1:])
    if kind == "K":
        jcl = jl.jax_clusters(cluster_size=size)
        return jcl, jl.jax_hits(jcl)
    arrays = jax_groups[size]
    return _fields(arrays, "inst"), {k: arrays[f"hit/{k}"] for k in ("t", "tri", "u", "v", "blocked")}


def _t(x):
    return torch.tensor(np.asarray(x))


def _grazing(ncl, ids, d):
    """Per id (a virtual triangle id of the tables `ncl`): does the ray of
    direction d meet the triangle within ~1 degree of its plane (|cos| <
    0.02 between the local direction and the normal, in float64)?"""
    c = np.array([np.flatnonzero((ncl.start <= i) & (i < ncl.start + ncl.count))[0] for i in ids], np.int64)
    tri = ncl.tris[ncl.block_id[c], :9, ids - ncl.start[c]].astype(np.float64)
    aff = ncl.inv_rows[ncl.inst[c]].reshape(-1, 3, 4).astype(np.float64)
    ld = np.einsum("nij,nj->ni", aff[:, :, :3], d.astype(np.float64))
    nrm = np.cross(tri[:, 3:6], tri[:, 6:9])
    cos = np.sum(nrm * ld, axis=1) / (np.linalg.norm(nrm, axis=1) * np.linalg.norm(ld, axis=1))
    return np.abs(cos) < 0.02


@pytest.mark.parametrize("layout", [f"K{k}" for k in CLUSTER_SIZES] + [f"G{g}" for g in GROUP_SIZES])
def test_plain_traces_match_jax_at_layouts(layout, jax_groups):
    """The port's plain stream trace (tie rule), occlusion (equal) and packet
    trace (geometric tie rule) against JAX's CPU trace at the layout."""
    jcl, want = _reference(layout, jax_groups)
    ncl = clusters_from_numpy(jcl)
    tcl = tree_to_device(ncl, "cpu")
    org, d, active, tmax, extri = jl.rays()
    got = intersect_stream(_t(org), _t(d), tcl, active=_t(active))
    got = types.SimpleNamespace(**{k: v.numpy() for k, v in got._asdict().items()})
    tw = want["t"]
    np.testing.assert_allclose(got.t, tw, rtol=1e-5, atol=1e-6)
    same = got.tri == want["tri"]
    tie = np.abs(got.t - tw) <= 1e-5 + 1e-5 * np.abs(tw)
    assert np.all(same | (tie & (tw >= 0))), f"{(~(same | tie)).sum()} rays disagree beyond t ties"
    hits = np.flatnonzero(same & (tw >= 0))
    graze = _grazing(ncl, want["tri"][hits], d[hits])
    assert graze.sum() <= 0.01 * hits.size
    keep = hits[~graze]
    np.testing.assert_allclose(got.u[keep], want["u"][keep], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.v[keep], want["v"][keep], rtol=1e-4, atol=1e-4)
    assert (got.t >= 0).sum() > 600
    blocked = occlude_stream(_t(org), _t(d), tcl, 1e-4, _t(tmax), active=_t(active), exclude_tri=_t(extri))
    np.testing.assert_array_equal(blocked.numpy(), want["blocked"])
    assert 300 < blocked.sum() < active.sum()
    hit = cluster.intersect_clusters(_t(org), _t(d), tcl, active=_t(active), sort_rays=True)
    hit = types.SimpleNamespace(**{k: v.numpy() for k, v in hit._asdict().items()})
    _assert_packet_hits(hit, types.SimpleNamespace(**want), jcl, org, d)


def _assert_packet_hits(got, want, jcl, org, d):
    """tests/test_torch_visit.py's rule: t within tolerance; ids equal except
    where both triangles are hit at that t (checked on the geometry); u/v
    where the ids agree and the ray does not graze the triangle."""
    tw, tri_w = np.asarray(want.t), np.asarray(want.tri)
    np.testing.assert_allclose(got.t, tw, rtol=1e-5, atol=1e-6)
    same = got.tri == tri_w
    differ = np.flatnonzero(~same)
    assert np.all(got.tri[differ] >= 0) and np.all(tri_w[differ] >= 0), "a hit on one side only"
    ncl = clusters_from_numpy(jcl)
    for side, ids in (("port", got.tri[differ]), ("JAX", tri_w[differ])):
        t_geo = _hit_t(ncl, ids, org[differ].astype(np.float64), d[differ].astype(np.float64))
        off = ~(np.abs(t_geo - tw[differ]) <= 1e-5 + 1e-5 * np.abs(tw[differ]))
        assert not off.any(), f"{off.sum()} of {differ.size} differing ids: the {side} triangle is not hit at t"
    hits = np.flatnonzero(same & (tw >= 0))
    graze = _grazing(ncl, tri_w[hits], d[hits])
    assert graze.sum() <= 0.01 * hits.size
    keep = hits[~graze]
    np.testing.assert_allclose(got.u[keep], np.asarray(want.u)[keep], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.v[keep], np.asarray(want.v)[keep], rtol=1e-4, atol=1e-4)
    assert (got.t >= 0).sum() >= 600


class _RaySort:
    """Records the permutation of the JAX trace's ray sort: the lax.sort of
    the key, the lane ids and the eight payload columns (cluster.py:520-526)."""

    def __init__(self):
        self.perms = []
        self._sort = jax.lax.sort

    def __call__(self, operands, *args, **kw):
        out = self._sort(operands, *args, **kw)
        if isinstance(operands, tuple) and len(operands) == 10:
            self.perms.append(np.asarray(out[1]))
        return out


@pytest.mark.parametrize("packet,key,sort", [(256, "fs", True), (1024, "fs", True), (512, "fe", True),
                                             (256, "fe", True), (512, "fs", False), (1024, "fe", False),
                                             (64, "fs", True), (384, "fs", True), (2048, "fs", True)])
def test_packet_layouts_match_jax(packet, key, sort):
    """VPT_PACKET_SIZE, VPT_SORT_KEY and VPT_SORT_RAYS: the port's packets
    against JAX's intersect_clusters(packet=..., sort_rays=...) with its
    _SORT_KEY set: the ray permutation equal (none unsorted), the hits by
    the geometric tie rule."""
    jcl = jl.jax_clusters()
    ncl = clusters_from_numpy(jcl)
    tcl = tree_to_device(ncl, "cpu")
    org, d, active, _, _ = jl.rays()
    spy = _RaySort()
    with mock.patch.object(jcluster, "_SORT_KEY", key), mock.patch.object(jax.lax, "sort", spy):
        want = jcluster.intersect_clusters(jnp.asarray(org), jnp.asarray(d), jcl, active=jnp.asarray(active),
                                           use_pallas=False, packet=packet, sort_rays=sort)
    with mock.patch.object(cluster, "PACKET_SIZE", packet), mock.patch.object(cluster, "_SORT_KEY", key):
        pk = cluster.prepare_packets(_t(org), _t(d), tcl, 1e-4, 1e8, _t(active), sort)
        got = cluster.intersect_clusters(_t(org), _t(d), tcl, active=_t(active), sort_rays=sort)
    assert pk.active.shape[1] == packet
    if sort:
        assert len(spy.perms) == 1
        np.testing.assert_array_equal(pk.perm.numpy(), spy.perms[0])
        assert not np.array_equal(spy.perms[0], np.arange(spy.perms[0].size))
    else:
        assert pk.perm is None and not spy.perms
    got = types.SimpleNamespace(**{k: v.numpy() for k, v in got._asdict().items()})
    _assert_packet_hits(got, want, jcl, org, d)


def test_fe_key_matches_jax():
    """ray_keys' fe key (plain) against cluster.py:504-511 evaluated with
    JAX's ops on the same padded, root-bounded rays, before inactive rays
    are overridden: first entered group * 1024 + quantised entry depth."""
    jcl = jl.jax_clusters()
    tcl = tree_to_device(clusters_from_numpy(jcl), "cpu")
    org, d, _, _, _ = jl.rays()
    o, dt = _t(org), _t(d)
    inv = cluster.guarded_inverse(dt)
    tmax = cluster.root_exit_tmax(o, inv, torch.full((o.shape[0],), 1e8), tcl, 1e-4)
    gmin, gmax = cluster.pad_groups(tcl)
    with mock.patch.object(cluster, "_SORT_KEY", "fe"):
        got = cluster.sort_keys(o, inv, tmax, tcl, gmin, gmax, 1e-4).numpy()
    gp, n = gmin.shape[1], o.shape[0]
    tn, tf = jcluster._slab_tn_tf(jnp.asarray(org)[None], jnp.asarray(d)[None], jnp.asarray(tmax.numpy())[None],
                                  jnp.asarray(gmin.numpy()), jnp.asarray(gmax.numpy()), 1e-4)
    ent = jnp.where(tn <= tf, tn, jnp.inf).reshape(n, gp)
    first, v1 = jnp.argmin(ent, axis=1).astype(jnp.int32), jnp.min(ent, axis=1)
    root_min, root_max = jnp.min(jcl.group_min, axis=0), jnp.max(jcl.group_max, axis=0)
    diag = jnp.linalg.norm(root_max - root_min)
    q = jnp.clip(v1 / jnp.maximum(diag, 1e-20) * 256.0, 0.0, 1023.0)
    want = jnp.where(jnp.isfinite(v1), first, gp) * 1024 + jnp.where(jnp.isfinite(v1), q, 0.0).astype(jnp.int32)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(np.unique(got % 1024)) > 50 and (got // 1024 < gp).sum() > 1000  # depths spread, most rays enter


def _render_port(data, meta, aux):
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0))
    img, segs, _ = render_step(data, meta, RenderFlags(max_depth=jl.DEPTH, max_medium_events=8),
                               default_params("cpu", view_inv, proj_inv), jl.SEED, (jl.SIZE, jl.SIZE),
                               torch.zeros((jl.SIZE, jl.SIZE, 3)), 0, 1)
    return img.numpy(), int(segs)


@pytest.mark.parametrize("layout", ["K64", "G4"])
def test_render_matches_jax_at_layouts(layout, jax_groups, monkeypatch):
    """One dispatch of the reduced colonnade at K = 64 and at groups of 4,
    each package compiling its own scene at that layout."""
    if layout == "K64":
        use_native_jax_bvh()
        monkeypatch.setattr(jcluster, "CLUSTER_SIZE", 64)
        monkeypatch.setattr(cluster, "CLUSTER_SIZE", 64)
        want, want_segs = jl.jax_render(*jbuild.compile_scene(jl.reduced_colonnade(jproc)))
    else:
        monkeypatch.setattr(cluster, "GROUP_SIZE", 4)
        want, want_segs = jax_groups[4]["img"], float(jax_groups[4]["segs"])
    data, meta, aux = tbuild.compile_scene(jl.reduced_colonnade(tproc), "cpu")
    assert not meta.use_brute_force
    assert data.clusters.tris.shape[2] == (64 if layout == "K64" else 128)
    assert data.clusters.count.shape[0] == (4 if layout == "G4" else 8) * data.clusters.group_min.shape[0]
    got, segs = _render_port(data, meta, aux)
    _assert_images_agree(got, want)
    assert abs(segs - want_segs) <= 0.01 * want_segs


@pytest.fixture(scope="module")
def small_scene():
    return tbuild.compile_scene(jl.reduced_colonnade(tproc), "cpu")


@pytest.mark.parametrize("knob,value", [("PACKET_SIZE", 256), ("_SORT_KEY", "fe"), ("_SORT_RAYS", False)])
def test_step_key_holds_the_trace_knobs(knob, value, small_scene):
    """Two packet-mode dispatches that differ only in one trace knob make two
    cached steps (a captured step bakes the knob in); the same knob again
    reuses its step."""
    data, meta, aux = small_scene
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0))
    params = default_params("cpu", view_inv, proj_inv)
    flags = RenderFlags(max_depth=2, max_medium_events=8)

    def dispatch():
        render_step(data, meta, flags, params, 7, (8, 8), torch.zeros((8, 8, 3)), 0, 1)
        return {id(s) for s in graphs.steps()}

    owner = integrator if knob == "_SORT_RAYS" else cluster
    graphs.clear()
    with mock.patch.object(integrator, "TRACE_MODE", "packet"):
        first = dispatch()
        with mock.patch.object(owner, knob, value):
            second = dispatch()
            assert dispatch() == second
        assert dispatch() == second
    assert len(first) == 1 and len(second) == 2 and first < second
    graphs.clear()


def test_ablation_defaults_match_jax():
    """The port fences the knobs the JAX package fences, among those it reads:
    VPT_TRACE and VPT_SORT_RAYS, with the JAX defaults."""
    assert envguard.ABLATION_DEFAULTS == {k: jenvguard.ABLATION_DEFAULTS[k] for k in ("VPT_TRACE", "VPT_SORT_RAYS")}


def test_guard_refuses_unsorted_rays_under_goldens(monkeypatch):
    """VPT_SORT_RAYS=0 under VPT_REQUIRE_GOLDENS: guard_ablations raises, and
    the modules that read a knob refuse to import."""
    monkeypatch.setenv("VPT_REQUIRE_GOLDENS", "1")
    monkeypatch.setenv("VPT_SORT_RAYS", "0")
    with pytest.raises(RuntimeError, match="VPT_SORT_RAYS"):
        envguard.guard_ablations()
    with pytest.raises(RuntimeError, match="VPT_SORT_RAYS"):
        jenvguard.guard_ablations()
    proc = subprocess.run([sys.executable, "-c", "import vpt_tpu_torch.accel.cluster"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "VPT_SORT_RAYS" in proc.stderr


def test_knobs_bind_at_import():
    """The five knobs are read from the environment once, at import, into
    the JAX package's names; the defaults are JAX's."""
    code = ("from vpt_tpu_torch.accel import cluster; from vpt_tpu_torch.render import integrator; "
            "print(cluster.CLUSTER_SIZE, cluster.GROUP_SIZE, cluster.PACKET_SIZE, cluster._SORT_KEY, "
            "integrator._SORT_RAYS)")
    env = {k: v for k, v in os.environ.items() if not k.startswith("VPT_")}
    knobs = dict(VPT_CLUSTER_SIZE="64", VPT_GROUP_SIZE="4", VPT_PACKET_SIZE="256", VPT_SORT_KEY="fe", VPT_SORT_RAYS="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(env, **knobs), capture_output=True,
                         text=True, timeout=300, check=True).stdout.split()
    assert out == ["64", "4", "256", "fe", "False"]
    assert (cluster.CLUSTER_SIZE, cluster.GROUP_SIZE, cluster.PACKET_SIZE, cluster._SORT_KEY) == (
        jcluster.CLUSTER_SIZE, jcluster.GROUP_SIZE, jcluster.PACKET_SIZE, jcluster._SORT_KEY) == (128, 8, 512, "fs")
    assert integrator._SORT_RAYS is True
