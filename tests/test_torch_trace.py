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
from vpt_tpu_torch.accel.occlude import occlude_stream
from vpt_tpu_torch.accel.stream import intersect_stream
from vpt_tpu_torch.accel.traverse import intersect_brute
from vpt_tpu_torch.scene.convert import clusters_from_numpy
from vpt_tpu_torch.scene.types import tree_to_device

torch.set_num_threads(1)


def _port_clusters(cl):
    return tree_to_device(clusters_from_numpy(cl), "cpu")


def _instanced_scene():
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
