"""The JAX package's remaining public helpers in the port, each held to its
JAX original on the same inputs (made with numpy from a seed): the skip-link
BVH walk that tests/test_bvh.py takes as its ground truth, with
Hit.hit_mask; rng.next_float_range; vecmath.direction_to_uv,
balance_heuristic and length; bsdf.ggx_smith_lambda; sampling.sample_disk.
RNG states are compared exactly; floats to rtol 1e-5 / atol 1e-6 (XLA:CPU
and ATen transcendentals differ by ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.accel import traverse as jtraverse
from vpt_tpu.accel.bvh import LEAF_SIZE, build_bvh
from vpt_tpu.core import rng as jrng
from vpt_tpu.core import vecmath as jvec
from vpt_tpu.render import bsdf as jbsdf
from vpt_tpu.render import sampling as jsampling
from vpt_tpu_torch.accel import traverse
from vpt_tpu_torch.core import rng, vecmath
from vpt_tpu_torch.render import bsdf, sampling

N = 512


def _bvh_inputs(seed):
    g = np.random.default_rng(seed)
    base = g.uniform(-5, 5, (300, 3)).astype(np.float32)
    v1 = base + g.uniform(-0.7, 0.7, (300, 3)).astype(np.float32)
    v2 = base + g.uniform(-0.7, 0.7, (300, 3)).astype(np.float32)
    bvh = build_bvh(base, v1, v2)
    order = bvh.tri_order

    def pad(a):
        return np.concatenate([a[order], np.zeros((LEAF_SIZE, 3), np.float32)])

    org = g.uniform(-8, 8, (N, 3)).astype(np.float32)
    d = (g.uniform(-4, 4, (N, 3)) - org).astype(np.float32)  # toward the triangles
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tables = (bvh.aabb_min, bvh.aabb_max, bvh.first_tri, bvh.tri_count, bvh.skip, pad(base), pad(v1 - base),
              pad(v2 - base))
    return org, d, tables, g.uniform(size=N) < 0.7


def _bvh_case(kw):
    def case(seed):
        org, d, tables, active = _bvh_inputs(seed)
        extra = {"active": active} if kw == "active" else {"any_hit": True} if kw == "any_hit" else {}
        want = jtraverse.intersect_bvh(jnp.asarray(org), jnp.asarray(d), *map(jnp.asarray, tables),
                                       **{k: jnp.asarray(v) for k, v in extra.items()})
        got = traverse.intersect_bvh(torch.as_tensor(org), torch.as_tensor(d), *map(torch.as_tensor, tables),
                                     **{k: torch.as_tensor(v) for k, v in extra.items()})
        assert int(want.hit_mask.sum()) > N // 10
        if kw == "any_hit":  # *a* hit, not the closest: the same rays hit
            return [got.hit_mask], [want.hit_mask], []
        return [got.tri, got.hit_mask], [want.tri, want.hit_mask], [(got.t, want.t), (got.u, want.u), (got.v, want.v)]
    return case


def _state(g):
    return g.integers(0, 2**32, N, dtype=np.uint64)


def _rng_case(seed):
    s = _state(np.random.default_rng(seed))
    ws, wu = jrng.next_float_range(jnp.asarray(s, jnp.uint32), -2.5, 7.0)
    gs, gu = rng.next_float_range(torch.as_tensor(s.astype(np.int64)), -2.5, 7.0)
    return [gs], [ws], [(gu, wu)]


def _disk_case(seed):
    s = _state(np.random.default_rng(seed))
    ws, wd = jsampling.sample_disk(jnp.asarray(s, jnp.uint32))
    gs, gd = sampling.sample_disk(torch.as_tensor(s.astype(np.int64)))
    return [gs], [ws], [(gd, wd)]


def _dirs(g):
    d = g.normal(size=(N, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _uv_case(seed):
    d = _dirs(np.random.default_rng(seed))
    wu, wv = jvec.direction_to_uv(jnp.asarray(d))
    gu, gv = vecmath.direction_to_uv(torch.as_tensor(d))
    return [], [], [(gu, wu), (gv, wv)]


def _balance_case(seed):
    g = np.random.default_rng(seed)
    a, b = (g.uniform(0, 4, N).astype(np.float32) * (g.uniform(size=N) > 0.1) for _ in range(2))
    return [], [], [(vecmath.balance_heuristic(torch.as_tensor(a), torch.as_tensor(b)),
                     jvec.balance_heuristic(jnp.asarray(a), jnp.asarray(b)))]


def _length_case(seed):
    v = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32) * 3.0
    return [], [], [(vecmath.length(torch.as_tensor(v)), jvec.length(jnp.asarray(v))),
                    (vecmath.length(torch.as_tensor(v), keepdims=True), jvec.length(jnp.asarray(v), keepdims=True))]


def _lambda_case(seed):
    g = np.random.default_rng(seed)
    v = _dirs(g)
    ax, ay = (g.uniform(0.01, 1.0, N).astype(np.float32) for _ in range(2))
    return [], [], [(bsdf.ggx_smith_lambda(torch.as_tensor(v), torch.as_tensor(ax), torch.as_tensor(ay)),
                     jbsdf.ggx_smith_lambda(jnp.asarray(v), jnp.asarray(ax), jnp.asarray(ay)))]


CASES = {
    "traverse.intersect_bvh closest": _bvh_case(None),
    "traverse.intersect_bvh any_hit": _bvh_case("any_hit"),
    "traverse.intersect_bvh active": _bvh_case("active"),
    "rng.next_float_range": _rng_case,
    "sampling.sample_disk": _disk_case,
    "vecmath.direction_to_uv": _uv_case,
    "vecmath.balance_heuristic": _balance_case,
    "vecmath.length": _length_case,
    "bsdf.ggx_smith_lambda": _lambda_case,
}


@pytest.mark.parametrize("name", list(CASES))
def test_public_name_matches_jax(name):
    exact_got, exact_want, close = CASES[name](seed=list(CASES).index(name))
    for got, want in zip(exact_got, exact_want):
        np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
    for got, want in close:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
