"""The port takes the JAX package's calls.

An AST walk over both packages (parsing only, importing neither): every
public function, method and class of a JAX module has its counterpart in
the port's module of the same path, whose positional parameters begin with
JAX's, under JAX's names and in JAX's order, with a default wherever JAX has
one; the port's further parameters all have defaults.  So a call written for
the JAX package runs against the port.  The walk's one allowlist is
ROADMAP.md's "Not ported, by decision" and "Known, kept", each name with its
reason beside it.

Beside it, value tests against the JAX package on the CPU, on numpy inputs
made from a seed, called in JAX's positional order: floats to rtol 1e-5 /
atol 1e-6 (tests/test_torch_public_names.py's tolerances; XLA:CPU and ATen
transcendentals differ by ulps), RNG states and integers exactly; the
traces by tests/test_torch_layouts.py's tie and grazing rules."""

import ast
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_layouts as jl
from test_torch_layouts import _assert_packet_hits, _grazing
from test_torch_scene import _leaves
from test_torch_trace import use_native_jax_bvh
from test_torch_visit import _hit_t
from vpt_tpu.accel import cluster as jcluster
from vpt_tpu.accel import traverse as jtraverse
from vpt_tpu.core import vecmath as jvec
from vpt_tpu.render import bsdf as jbsdf
from vpt_tpu.render import integrator as jint
from vpt_tpu.render import lights as jlights
from vpt_tpu.render import params as jparams
from vpt_tpu.render import sampling as jsampling
from vpt_tpu.render import surface as jsurface
from vpt_tpu.scene import build as jbuild
from vpt_tpu.scene import procedural as jproc
from vpt_tpu_torch.accel import cluster
from vpt_tpu_torch.accel import traverse as ttraverse
from vpt_tpu_torch.core import vecmath
from vpt_tpu_torch.render import bsdf, integrator, lights, params, surface
from vpt_tpu_torch.scene import build as tbuild
from vpt_tpu_torch.scene import procedural as tproc
from vpt_tpu_torch.scene.convert import clusters_from_numpy, scene_from_numpy
from vpt_tpu_torch.scene.types import tree_to_device

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 512

# ROADMAP.md, "Not ported, by decision": JAX names the port does without.
NOT_PORTED = {
    "accel.native": "loads the JAX package's build of its C++ builder; the port builds csrc/bvh_builder.cpp in "
                    "accel/bvh.py",
    "accel.visit_kernel": "the Pallas visit kernel; the port's is csrc/visit.cu behind accel/visit.py",
    "accel.stream.stream_pallas": "the Pallas stream kernel; the port's is csrc/trace.cu behind accel/stream.py",
    "accel.occlude.occlude_pallas": "the Pallas occlusion kernel; the port's is csrc/trace.cu behind "
                                    "accel/occlude.py",
    "accel.stream.BAND": "a TPU schedule constant (32,768-ray bands) the CUDA kernels do not have",
    "accel.stream.SUPER_ROWS": "a TPU schedule constant the CUDA kernels do not have",
    "accel.cluster.GROUPS_PER_STEP": "a TPU schedule constant the CUDA kernels do not have",
    "accel.cluster.build_clusters": "the packed single-mesh builder; the port builds every scene through "
                                    "build_mesh_clusters and assemble_clusters",
    "core.vecmath.jax_rsqrt": "lax.rsqrt by name; the port calls torch.rsqrt",
    "scene.build.build_material_table": "the packed MaterialTable; the port carries material_attr alone",
    "scene.types.MaterialTable": "the packed material table; the port carries material_attr alone",
    "scene.types.BVHData": "the device BVH of the JAX package's TPU layout; the port traces the cluster tables",
    "render.lookup.REFERENCE_TABLE_DIR": "JAX's default table directory is absent here; the port takes "
                                         "table_dir or VPT_REFERENCE_TABLES",
}

# ROADMAP.md, "Known, kept": JAX parameters the port does not take.
DROPPED = {
    # interpret / use_pallas choose Pallas's interpret mode; the port picks the
    # kernel or its plain version by the tensors' device.
    ("accel.stream", "intersect_stream"): {"interpret"},
    ("accel.occlude", "occlude_stream"): {"interpret"},
    ("accel.cluster", "intersect_clusters"): {"use_pallas", "interpret"},
    ("accel.envelope", "ray_keys"): {"interpret"},
    ("accel.envelope", "supertile_tables"): {"interpret"},
    # The port's ranks are the processes of a torch.distributed group, not a
    # list of JAX devices.
    ("dist.mesh", "make_mesh"): {"devices"},
}


def _modules(pkg):
    out = {}
    base = os.path.join(ROOT, pkg)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                mod = os.path.relpath(path, base)[:-3].replace(os.sep, ".")
                mod = mod[: -len(".__init__")] if mod.endswith(".__init__") else mod
                with open(path) as fh:
                    out[mod] = ast.parse(fh.read())
    return out


JAX_MODULES = _modules("vpt_tpu")
PORT_MODULES = _modules("vpt_tpu_torch")


def _defined(tree):
    """Public names a module's body defines: functions, classes, assignments."""
    names = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names[n.id] = node
    return {k: v for k, v in names.items() if not k.startswith("_")}


def _port_name(mod, name):
    """The port's node for `name` in module `mod`, following a
    `from vpt_tpu_torch.x import name` there; None when absent."""
    tree = PORT_MODULES.get(mod)
    if tree is None:
        return None
    found = _defined(tree).get(name)
    if found is not None:
        return found
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("vpt_tpu_torch."):
            if any((a.asname or a.name) == name for a in node.names):
                return _port_name(node.module[len("vpt_tpu_torch."):], name)
    return None


def _is_property(fn):
    return any(isinstance(d, ast.Name) and d.id == "property" for d in fn.decorator_list)


def _methods(cls):
    return {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)
            and (n.name == "__init__" or not n.name.startswith("_"))}


def _self_attributes(cls):
    """Attributes the class's methods assign on self."""
    return {t.attr for n in ast.walk(cls) if isinstance(n, ast.Assign) for t in n.targets
            if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and t.value.id == "self"}


def _signature_faults(qual, want, got, dropped=frozenset()):
    """Why the port's `got` cannot take a call written for JAX's `want`."""
    wa, ga = want.args, got.args
    w_pos = [a.arg for a in wa.posonlyargs + wa.args]
    w_defaults = set(w_pos[len(w_pos) - len(wa.defaults):])
    kept = [a for a in w_pos if a not in dropped]
    g_pos = [a.arg for a in ga.posonlyargs + ga.args]
    g_defaults = set(g_pos[len(g_pos) - len(ga.defaults):])
    g_kw_defaults = {a.arg for a, d in zip(ga.kwonlyargs, ga.kw_defaults) if d is not None}
    faults = []
    if g_pos[: len(kept)] != kept:
        faults.append(f"{qual}: positional parameters {g_pos}, JAX's {kept}")
    missing_defaults = sorted((w_defaults - set(dropped)) - g_defaults)
    if missing_defaults:
        faults.append(f"{qual}: no default for {missing_defaults}, which JAX's has")
    extra = [a for a in g_pos[len(kept):] if a not in g_defaults]
    extra += [a.arg for a in ga.kwonlyargs if a.arg not in g_kw_defaults and a.arg not in
              {b.arg for b in wa.kwonlyargs}]
    if extra:
        faults.append(f"{qual}: the port's own parameters {extra} take no default")
    w_kw = [a.arg for a in wa.kwonlyargs]
    if not set(w_kw) <= {a.arg for a in ga.kwonlyargs} | set(g_pos):
        faults.append(f"{qual}: keyword-only parameters {w_kw} missing")
    return faults


def test_allowlist_names_exist_in_jax():
    """Every allowlisted name is a JAX name (the list holds no stale entry)."""
    for qual in NOT_PORTED:
        mod, _, name = qual.rpartition(".")
        if qual in JAX_MODULES:
            continue
        assert name in _defined(JAX_MODULES[mod]), qual
    for (mod, fn), names in DROPPED.items():
        node = _defined(JAX_MODULES[mod])[fn]
        assert names <= {a.arg for a in node.args.args}, (mod, fn)


@pytest.mark.parametrize("mod", sorted(m for m in JAX_MODULES if m not in NOT_PORTED))
def test_port_takes_jax_calls(mod):
    assert mod in PORT_MODULES, f"vpt_tpu_torch has no module {mod}"
    faults = []
    for name, node in sorted(_defined(JAX_MODULES[mod]).items()):
        qual = f"{mod}.{name}"
        if qual in NOT_PORTED:
            continue
        got = _port_name(mod, name)
        if got is None:
            faults.append(f"{qual}: missing")
            continue
        if isinstance(node, ast.FunctionDef):
            if not isinstance(got, ast.FunctionDef):
                faults.append(f"{qual}: not a function in the port")
            else:
                faults += _signature_faults(qual, node, got, DROPPED.get((mod, name), frozenset()))
        elif isinstance(node, ast.ClassDef):
            if not isinstance(got, ast.ClassDef):
                faults.append(f"{qual}: not a class in the port")
                continue
            mine, attrs = _methods(got), _self_attributes(got)
            for m, fn in sorted(_methods(node).items()):
                if m in mine:
                    faults += _signature_faults(f"{qual}.{m}", fn, mine[m])
                elif not (_is_property(fn) and m in attrs):
                    faults.append(f"{qual}.{m}: missing")
    assert not faults, "\n".join(faults)


# ----------------------------------------------------------- value tests


def _state(g, shape=(N,)):
    return g.integers(0, 2**32, shape, dtype=np.uint64)


def _dirs(g, n=N):
    d = g.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _t(x):
    return torch.as_tensor(np.array(x))


def _check(exact, close):
    for got, want in exact:
        np.testing.assert_array_equal(np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64))
    for got, want in close:
        got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


ROTATIONS = {
    "x axis, 0-d angle": ((1.0, 0.0, 0.0), 0.3),
    "y axis, per-lane angles": ((0.0, 1.0, 0.0), "lanes"),
    "z axis, a Python float": ((0.0, 0.0, 1.0), 0.3),
    "unnormalised axis, 0-d angle": ((1.0, 2.0, -0.5), -1.1),
    "unnormalised axis, per-lane angles": ((0.3, -0.2, 0.9), "lanes"),
    "axis tensor, per-lane angles": ("tensor", "lanes"),
    "per-lane axes and angles": ("lanes", "lanes"),
}


@pytest.mark.parametrize("case", list(ROTATIONS))
def test_rotate_axis_angle(case):
    g = np.random.default_rng(list(ROTATIONS).index(case))
    v = g.normal(size=(N, 3)).astype(np.float32)
    axis, theta = ROTATIONS[case]
    if axis == "tensor":
        axis = g.normal(size=3).astype(np.float32)
    elif axis == "lanes":
        axis = g.normal(size=(N, 3)).astype(np.float32)
    if theta == "lanes":
        theta = g.uniform(-3, 3, N).astype(np.float32)
    elif "0-d" in case:
        theta = np.float32(theta)
    t_axis = _t(axis) if isinstance(axis, np.ndarray) else axis
    t_theta = theta if isinstance(theta, float) else _t(theta)
    got = vecmath.rotate_axis_angle(_t(v), t_axis, t_theta)
    want = jvec.rotate_axis_angle(jnp.asarray(v), axis, theta)
    _check([], [(got, want)])


def test_unit_axes_rotate_bitwise_as_indices():
    """X_AXIS / Y_AXIS are JAX's tuples now; their rotations keep the bits
    of the index axes the port's lights rotated by before, so no image moves."""
    g = np.random.default_rng(11)
    v, theta = _t(g.normal(size=(N, 3)).astype(np.float32)), _t(np.float32(0.7))
    assert lights.X_AXIS == jlights.X_AXIS and lights.Y_AXIS == jlights.Y_AXIS
    for i, axis in enumerate((lights.X_AXIS, lights.Y_AXIS, (0.0, 0.0, 1.0))):
        a, b = vecmath.rotate_axis_angle(v, axis, theta), vecmath.rotate_axis_angle(v, i, theta)
        assert torch.equal(a, b)
        want = v * torch.cos(theta) + vecmath.cross(vecmath.unit_axis(i, v).expand(v.shape), v) * torch.sin(theta)
        want = want + vecmath.unit_axis(i, v) * vecmath.dot(vecmath.unit_axis(i, v).expand(v.shape), v,
                                                            keepdims=True) * (1.0 - torch.cos(theta))
        assert torch.equal(a, want)


def test_dot_and_length_keepdims():
    g = np.random.default_rng(12)
    a, b = (g.normal(size=(N, 3)).astype(np.float32) for _ in range(2))
    close = []
    for keepdims in (False, True):
        close += [(vecmath.dot(_t(a), _t(b), keepdims), jvec.dot(jnp.asarray(a), jnp.asarray(b), keepdims)),
                  (vecmath.dot(_t(a), _t(b), keepdims=keepdims), jvec.dot(jnp.asarray(a), jnp.asarray(b),
                                                                          keepdims=keepdims)),
                  (vecmath.length(_t(a), keepdims=keepdims), jvec.length(jnp.asarray(a), keepdims=keepdims))]
    _check([], close)


@pytest.fixture(scope="module")
def colonnade():
    """The reduced colonnade compiled by the JAX package, and the port's
    scene converted from it (the same tables on both sides)."""
    use_native_jax_bvh()
    jdata, jmeta, aux = jbuild.compile_scene(jl.reduced_colonnade(jproc))
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, jdata), jmeta, "cpu")
    return jdata, jmeta, tdata, tmeta, aux


def _surface_hits(g, n_tris, shape=(N,)):
    tri = g.integers(0, n_tris, shape).astype(np.int32)
    u = g.uniform(0, 1, shape).astype(np.float32)
    v = (g.uniform(0, 1, shape) * (1 - u)).astype(np.float32)
    return tri, u, v


@pytest.mark.parametrize("geometry_normals", [False, True])
def test_make_surface_takes_a_hit(colonnade, geometry_normals):
    jdata, jmeta, tdata, tmeta, _ = colonnade
    g = np.random.default_rng(13)
    tri, u, v = _surface_hits(g, jmeta.n_tris)
    d = _dirs(g)
    want = jsurface.make_surface(jdata, jtraverse.Hit(jnp.zeros(N), jnp.asarray(tri), jnp.asarray(u),
                                                      jnp.asarray(v)), jnp.asarray(d), geometry_normals)
    got = surface.make_surface(tdata, types.SimpleNamespace(tri=_t(tri).long(), u=_t(u), v=_t(v)), _t(d),
                               geometry_normals)
    exact = [(got.hit_from_inside, want.hit_from_inside)]
    close = [(getattr(got, f), getattr(want, f)) for f in
             ("world_pos", "uv", "normal", "tangent", "bitangent", "geom_normal", "mat_row", "area", "em_tcount")]
    _check(exact, close)


def _props(g):
    """Random materials as both packages' make_material builds them from the
    same packed rows: every lobe mix, rough to smooth, inside and outside."""
    row = np.zeros((N, 32), np.float32)
    row[:, 0:3] = g.uniform(0.05, 1, (N, 3))
    row[:, 6:9] = g.uniform(0.05, 1, (N, 3))
    row[:, 9:12] = g.uniform(0.05, 1, (N, 3))
    row[:, 15] = np.where(g.uniform(size=N) < 0.3, 1.0, g.uniform(0, 1, N) * (g.uniform(size=N) < 0.5))
    row[:, 16] = g.uniform(0.2, 1.0, N)
    row[:, 17] = g.uniform(1.1, 2.0, N)
    row[:, 18] = np.where(g.uniform(size=N) < 0.4, 1.0, 0.0)
    row[:, 19] = g.uniform(0, 0.8, N)
    inside = g.uniform(size=N) < 0.3
    uv = np.zeros((N, 2), np.float32)
    want = jbsdf.make_material(None, jnp.asarray(row), jnp.asarray(uv), jnp.asarray(inside), False, False)
    got = bsdf.make_material(None, _t(row), _t(uv), _t(inside), False, False)
    return got, want


def _fits(g):
    """Chebyshev fits near 0.8 (the energy terms), the same on both sides."""
    out = []
    for shape in ((7, 11, 13), (5, 7, 9), (5, 7, 9)):
        c = (g.uniform(-0.01, 0.01, shape)).astype(np.float32)
        c[0, 0, 0] = 0.8
        out.append(c)
    return (types.SimpleNamespace(**{k: jnp.asarray(c) for k, c in zip(("lookup_reflect", "lookup_refract_out",
                                                                           "lookup_refract_in"), out)}),
            types.SimpleNamespace(**{k: _t(c) for k, c in zip(("lookup_reflect", "lookup_refract_out",
                                                                  "lookup_refract_in"), out)}))


def _upper(g):
    d = _dirs(g)
    d[:, 2] = np.abs(d[:, 2]) + 0.2
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("comp", ["computed", "given"])
def test_evaluate_bsdf_in_jax_order(energy, comp):
    g = np.random.default_rng(14)
    got_p, want_p = _props(g)
    jscene, tscene = _fits(g)
    v, l = _upper(g), _dirs(g)
    jc = jbsdf.energy_comp_terms(want_p, jscene, jnp.asarray(v[:, 2]), energy) if comp == "given" else None
    tc = bsdf.energy_comp_terms(got_p, tscene, _t(v[:, 2]), energy) if comp == "given" else None
    want = jbsdf.evaluate_bsdf(want_p, jscene, jnp.asarray(v), jnp.asarray(l), energy, jc)
    got = bsdf.evaluate_bsdf(got_p, tscene, _t(v), _t(l), energy, tc)
    _check([], list(zip(got, want)))
    assert float(np.asarray(want[1]).max()) > 0.0


@pytest.mark.parametrize("energy", [False, True])
def test_sample_bsdf_returns_jax_five(energy):
    g = np.random.default_rng(15)
    got_p, want_p = _props(g)
    jscene, tscene = _fits(g)
    v, s = _upper(g), _state(g)
    # The half-vector from JAX's VNDF sample, the same on both sides.
    _, h = jsampling.sample_ggx_vndf(jnp.asarray(s ^ 0x9E3779B9, jnp.uint32), jnp.asarray(v), want_p.ax, want_p.ay)
    h = np.asarray(h)
    want = jbsdf.sample_bsdf(jnp.asarray(s, jnp.uint32), want_p, jscene, jnp.asarray(v), jnp.asarray(h), energy)
    got = bsdf.sample_bsdf(_t(s.astype(np.int64)), got_p, tscene, _t(v), _t(h), energy)
    assert len(got) == len(want) == 5
    assert got[4].dtype == torch.int32
    _check([(got[0], want[0]), (got[4], want[4])], list(zip(got[1:4], want[1:4])))
    assert set(np.unique(np.asarray(want[4]))) == {jbsdf.METALLIC, jbsdf.DIFFUSE, jbsdf.SPECULAR_DIELECTRIC,
                                                   jbsdf.GLASS_REFLECT, jbsdf.GLASS_REFRACT}
    assert (bsdf.METALLIC, bsdf.DIFFUSE, bsdf.SPECULAR_DIELECTRIC, bsdf.GLASS_REFLECT, bsdf.GLASS_REFRACT) == \
        (jbsdf.METALLIC, jbsdf.DIFFUSE, jbsdf.SPECULAR_DIELECTRIC, jbsdf.GLASS_REFLECT, jbsdf.GLASS_REFRACT)


def test_importance_sample_env_takes_shape(colonnade):
    jdata, _, tdata, _, _ = colonnade
    g = np.random.default_rng(16)
    s = _state(g)
    az, al = np.float32(25.0), np.float32(-10.0)
    want = jlights.importance_sample_env(jnp.asarray(s, jnp.uint32), jdata.env, az, al, (N,))
    got = lights.importance_sample_env(_t(s.astype(np.int64)), tdata.env, _t(az), _t(al), (N,))
    _check([(got[0], want[0])], list(zip(got[1:], want[1:])))


@pytest.mark.parametrize("shape", [(N,), (8, N // 8)])
def test_sample_sun_disk_takes_shape(shape):
    g = np.random.default_rng(17)
    s = _state(g, shape)
    sun = np.float32([1.0, 0.956, 0.88])
    args = (np.float32(1.5), np.float32(40.0), np.float32(20.0))
    want = jlights.sample_sun_disk(jnp.asarray(s, jnp.uint32), jnp.asarray(sun), *map(jnp.float32, args), shape)
    got = lights.sample_sun_disk(_t(s.astype(np.int64)), _t(sun), *map(_t, args), shape)
    assert got[1].shape == (*shape, 3) and got[3].shape == shape
    _check([(got[0], want[0])], list(zip(got[1:], want[1:])))


def test_compile_scene_and_default_params_in_jax_order():
    use_native_jax_bvh()
    jdata, jmeta, jaux = jbuild.compile_scene(jproc.cornell_box(), None)
    want, want_meta = scene_from_numpy(jax.tree.map(np.asarray, jdata), jmeta, "cpu")
    got, meta, aux = tbuild.compile_scene(tproc.cornell_box(), None, device="cpu")
    assert meta == want_meta
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b), path
    vi = np.linalg.inv(aux["camera_view"]).astype(np.float32)
    pi = np.random.default_rng(18).normal(size=(4, 4)).astype(np.float32)
    p_want, p_got = jparams.default_params(vi, pi), params.default_params(vi, pi, device="cpu")
    assert p_got._fields == p_want._fields
    for f in p_want._fields:
        np.testing.assert_array_equal(getattr(p_got, f).numpy(), np.asarray(getattr(p_want, f)), err_msg=f)
        assert getattr(p_got, f).device.type == "cpu"


def _colonnade_rays(jdata, n=1536, seed=19):
    """Rays from inside the scene's box, two thirds aimed at triangle
    centroids, and an active mask."""
    g = np.random.default_rng(seed)
    p0, e1, e2 = (np.asarray(x) for x in (jdata.tri_p0, jdata.tri_e1, jdata.tri_e2))
    lo, hi = p0.min(axis=0), p0.max(axis=0)
    org = g.uniform(lo, hi, (n, 3)).astype(np.float32)
    pick = g.integers(0, p0.shape[0], n)
    aim = p0[pick] + (e1[pick] + e2[pick]) / 3
    d = np.where((np.arange(n) % 3 != 0)[:, None], aim - org, g.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return org, d, g.uniform(size=n) < 0.9


def _assert_closest_hits(got, want, jcl, org, d):
    """tests/test_torch_layouts.py's tie and grazing rules on the colonnade:
    the same rays hit; a ray that meets its triangle within ~1 degree of its
    plane hits the same triangle (t, like u and v, is a ratio by the
    determinant that goes to 0 there: at 0.03 degrees both sides miss
    float64's t by ~1e-4; at most 1% of the hits graze); every other ray's t
    to rtol 1e-5 / atol 1e-6, and a differing id must be hit at that t (on
    the geometry).  u and v, which the any-hit flags do not touch, are held
    to JAX's by test_torch_layouts.py on its scenes: the colonnade's
    centimetre triangles seen from 20 m put float32's u / v 1e-4 apart at
    a few degrees already."""
    ncl = clusters_from_numpy(jcl)
    tg, tri_g = got.t.numpy(), got.tri.numpy()
    tw, tri_w = np.asarray(want.t), np.asarray(want.tri)
    np.testing.assert_array_equal(tg >= 0, tw >= 0)
    hits = np.flatnonzero(tw >= 0)
    graze = _grazing(ncl, tri_w[hits], d[hits])
    assert graze.sum() <= 0.01 * hits.size
    np.testing.assert_array_equal(tri_g[hits[graze]], tri_w[hits[graze]])
    keep = np.setdiff1d(np.arange(org.shape[0]), hits[graze])
    np.testing.assert_allclose(tg[keep], tw[keep], rtol=1e-5, atol=1e-6)
    differ = keep[tri_g[keep] != tri_w[keep]]
    for side, ids in (("port", tri_g[differ]), ("JAX", tri_w[differ])):
        t_geo = _hit_t(ncl, ids, org[differ].astype(np.float64), d[differ].astype(np.float64))
        off = ~(np.abs(t_geo - tw[differ]) <= 1e-5 + 1e-5 * np.abs(tw[differ]))
        assert not off.any(), f"{off.sum()} of {differ.size} differing ids: the {side} triangle is not hit at t"


@pytest.mark.parametrize("mode", ["stream", "packet"])
def test_trace_any_hit_flags(colonnade, mode):
    """integrator.trace's any_hit / anyhit_mask in each trace mode against
    the JAX package's trace on the CPU (its XLA visit loop, which takes
    any_hit and, as a closest hit is an any hit, passes over the mask)."""
    jdata, jmeta, tdata, tmeta, _ = colonnade
    org, d, active = _colonnade_rays(jdata)
    jcl = jax.tree.map(np.asarray, jdata.clusters)
    ncl = clusters_from_numpy(jcl)
    t_min = 1e-4
    jargs = (jdata, jmeta, jnp.asarray(org), jnp.asarray(d), jnp.asarray(active), t_min)
    targs = (tdata, tmeta, _t(org), _t(d), _t(active), t_min)
    mask = np.random.default_rng(20).uniform(size=org.shape[0]) < 0.5
    with mock.patch.object(integrator, "TRACE_MODE", mode):
        closest = integrator.trace(*targs)
        any_all = integrator.trace(*targs, ttraverse.T_MAX, True)
        any_mask = integrator.trace(*targs, anyhit_mask=_t(mask))
    want_closest = jint.trace(*jargs)
    want_any = jint.trace(*jargs, jtraverse.T_MAX, True)
    hits = np.asarray(want_closest.t) >= 0
    assert hits.sum() > 600
    _assert_closest_hits(closest, want_closest, jcl, org, d)
    np.testing.assert_array_equal(np.asarray(want_any.t) >= 0, hits)
    for got in (any_all, any_mask):
        np.testing.assert_array_equal(got.t.numpy() >= 0, hits)
        # A reported any hit lies on its triangle at its t.
        idx = np.flatnonzero(got.t.numpy() >= 0)
        t_geo = _hit_t(ncl, got.tri.numpy()[idx], org[idx].astype(np.float64), d[idx].astype(np.float64))
        np.testing.assert_allclose(t_geo, got.t.numpy()[idx], rtol=1e-4, atol=1e-5)
    # Rays outside the mask keep the closest hit, bit for bit.
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(any_mask, f)[~_t(mask)], getattr(closest, f)[~_t(mask)]), f


@pytest.mark.parametrize("packet", [64, 384, 2048])
def test_intersect_clusters_packet_argument(packet):
    """intersect_clusters(packet=P) against JAX's at P, and bitwise against
    the port's trace with its PACKET_SIZE set to P."""
    jcl = jl.jax_clusters()
    tcl = tree_to_device(clusters_from_numpy(jcl), "cpu")
    org, d, active, _, _ = jl.rays()
    want = jcluster.intersect_clusters(jnp.asarray(org), jnp.asarray(d), jcl, active=jnp.asarray(active),
                                       packet=packet, use_pallas=False, sort_rays=True)
    got = cluster.intersect_clusters(_t(org), _t(d), tcl, active=_t(active), packet=packet, sort_rays=True)
    with mock.patch.object(cluster, "PACKET_SIZE", packet):
        glob = cluster.intersect_clusters(_t(org), _t(d), tcl, active=_t(active), sort_rays=True)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(glob, f)), f
    _assert_packet_hits(types.SimpleNamespace(**{k: v.numpy() for k, v in got._asdict().items()}), want, jcl,
                        org, d)
