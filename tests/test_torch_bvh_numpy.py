"""The port's NumPy BVH builder, `build_bvh(..., use_native=False)`, against
the JAX package's NumPy builder: the six FlatBVH arrays bitwise equal on
seeded triangle soups (tests/test_native_bvh.py's `_random_tris` at 1, 300
and 5,000 triangles), on triangles whose centroids all coincide, and at leaf
sizes 1, 4 and 8.  Then tests/test_native_bvh.py's checks on the port's two
builders: the structural invariants of each tree, and the NumPy and C++
trees tracing the same hits through the port's traverse.intersect_bvh
(t to rtol 1e-4 / atol 1e-5 and more than 99% of triangle ids equal, that
test's tolerances)."""

import numpy as np
import pytest
import torch

from vpt_tpu.accel import bvh as jbvh
from vpt_tpu_torch.accel import bvh, traverse

torch.set_num_threads(1)


def _random_tris(n, seed=0):
    """tests/test_native_bvh.py's seeded soup (copied: importing that module
    would build the JAX package's native library at import)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    v1 = base + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    v2 = base + rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    return base, v1, v2


FIELDS = ("aabb_min", "aabb_max", "first_tri", "tri_count", "skip", "tri_order")


def _same_centroid(n, seed=4):
    """n triangles of random shapes around one point, each built as
    c + a, c + b, c - a - b, whose centroids round to the same float32."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    c = np.float32([0.5, -2.0, 3.0])
    return c + a, c + b, c - a - b


def _planar(n, seed=6):
    """n triangles in the plane y = 1: one axis with no extent."""
    v0, v1, v2 = _random_tris(n, seed)
    for v in (v0, v1, v2):
        v[:, 1] = 1.0
    return v0, v1, v2


SOUPS = {
    "one": lambda: _random_tris(1, seed=1),
    "soup300": lambda: _random_tris(300, seed=2),
    "soup5000": lambda: _random_tris(5000, seed=0),
    "same_centroid": lambda: _same_centroid(64),
    "planar": lambda: _planar(200),
}


@pytest.mark.parametrize("leaf_size", [1, 4, 8])
@pytest.mark.parametrize("soup", sorted(SOUPS))
def test_numpy_builder_is_bitwise_jax(soup, leaf_size):
    v0, v1, v2 = SOUPS[soup]()
    want = jbvh.build_bvh(v0, v1, v2, leaf_size=leaf_size, use_native=False)
    got = bvh.build_bvh(v0, v1, v2, leaf_size=leaf_size, use_native=False)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=f"{soup}: {f}")
    if soup == "same_centroid":
        assert got.n_nodes > 1  # the median split ran


def test_numpy_constants_are_jax():
    assert (bvh.N_BINS, bvh.LEAF_SIZE, bvh.SENTINEL) == (jbvh.N_BINS, jbvh.LEAF_SIZE, int(jbvh.SENTINEL))


def test_zero_triangles_raise():
    empty = np.zeros((0, 3), np.float32)
    for use_native in (False, True):
        with pytest.raises(ValueError, match="zero triangles"):
            bvh.build_bvh(empty, empty, empty, use_native=use_native)


@pytest.mark.parametrize("use_native", [False, True])
def test_structural_invariants(use_native):
    """tests/test_native_bvh.py::test_native_structural_invariants on each of
    the port's builders."""
    n = 5000
    v0, v1, v2 = _random_tris(n)
    tree = bvh.build_bvh(v0, v1, v2, use_native=use_native)
    assert np.sort(tree.tri_order).tolist() == list(range(n))
    leaf = tree.tri_count > 0
    assert tree.tri_count[leaf].sum() == n
    # Leaves tile the reordered array contiguously in DFS order.
    firsts, counts = tree.first_tri[leaf], tree.tri_count[leaf]
    o = np.argsort(firsts)
    np.testing.assert_array_equal(firsts[o][1:], firsts[o][:-1] + counts[o][:-1])
    # Skip links point strictly forward.
    ids = np.arange(tree.n_nodes)
    assert ((tree.skip > ids) | (tree.skip == bvh.SENTINEL)).all()
    # An inner node's box holds its left child's.
    for nid in np.nonzero(~leaf)[0][:100]:
        assert np.all(tree.aabb_min[nid] <= tree.aabb_min[nid + 1] + 1e-5)
        assert np.all(tree.aabb_max[nid] >= tree.aabb_max[nid + 1] - 1e-5)


@pytest.mark.parametrize("aimed", [False, True])
def test_numpy_and_native_trees_trace_the_same_hits(aimed):
    """tests/test_native_bvh.py::test_native_matches_numpy_traversal_results
    through the port: the two builders may make different (both valid)
    trees, so trace rays through both.  That test's random directions hit 9
    of its 256 rays; the aimed case points each ray at a triangle's
    centroid, so most rays hit."""
    v0, v1, v2 = _random_tris(800, seed=2)
    rng = np.random.default_rng(3)
    org = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    if aimed:
        d = ((v0 + v1 + v2) / 3)[rng.integers(0, 800, 256)] - org
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    def pad(a):
        return np.concatenate([a, np.zeros((bvh.LEAF_SIZE,) + a.shape[1:], a.dtype)])

    results = []
    for use_native in (False, True):
        tree = bvh.build_bvh(v0, v1, v2, use_native=use_native)
        order = tree.tri_order
        hit = traverse.intersect_bvh(
            *map(torch.as_tensor, (org, d, tree.aabb_min, tree.aabb_max, tree.first_tri, tree.tri_count, tree.skip,
                                   pad(v0[order]), pad((v1 - v0)[order]), pad((v2 - v0)[order]))))
        tri = hit.tri.numpy()
        results.append((hit.t.numpy(), np.where(tri >= 0, order[np.clip(tri, 0, 799)], -1)))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-4, atol=1e-5)
    agree = (results[0][1] == results[1][1]) | (results[0][0] < 0)
    assert agree.mean() > 0.99
    assert (results[0][0] >= 0).sum() > (200 if aimed else 0)
