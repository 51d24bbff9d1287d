"""Host-side SAH BVH build (jax-free port of vpt_tpu/accel/bvh.py).

Two builders with one output layout, the JAX package's: nodes in DFS
pre-order (left child of inner node i is i + 1), skip links, and a triangle
order that makes every leaf a contiguous slice.

* `use_native=True` (the default, and what compile_scene runs): the port's
  C++ builder, csrc/bvh_builder.cpp, built with g++ into vpt_tpu_torch/build/
  at first use (kernels.host_library) and called through ctypes.  A failed
  build raises: there is no silent fallback to the other builder.
* `use_native=False`: the binned SAH in NumPy, a copy of the JAX package's
  NumPy builder whose operations run in the same order on the same float32
  arrays, so its trees are bitwise the JAX package's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import sys

import numpy as np

from vpt_tpu_torch.accel.kernels import BUILD_DIR, CSRC_DIR, host_library

LEAF_SIZE = 4
N_BINS = 16  # SAH bins per axis (the C++ builder's N_BINS too)
SENTINEL = 2**31 - 1  # the skip link past the last node

_SRC = os.path.join(CSRC_DIR, "bvh_builder.cpp")
_LIB = os.path.join(BUILD_DIR, "libvpt_bvh.so")
_CMD = ("g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_lib = None


@dataclasses.dataclass
class FlatBVH:
    """Flattened skip-link BVH (SoA)."""

    aabb_min: np.ndarray  # (n_nodes, 3) f32
    aabb_max: np.ndarray  # (n_nodes, 3) f32
    first_tri: np.ndarray  # (n_nodes,) i32 start into the reordered triangles
    tri_count: np.ndarray  # (n_nodes,) i32, 0 for inner nodes
    skip: np.ndarray  # (n_nodes,) i32 next node on miss / after a leaf
    tri_order: np.ndarray  # (n_tris,) i32 reordered slot k holds tri tri_order[k]

    @property
    def n_nodes(self) -> int:
        return int(self.aabb_min.shape[0])


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(host_library(_SRC, _LIB, _CMD, "the BVH builder"))
        f = ctypes.POINTER(ctypes.c_float)
        i = ctypes.POINTER(ctypes.c_int32)
        lib.vpt_build_bvh.restype = ctypes.c_int
        lib.vpt_build_bvh.argtypes = [f, f, f, ctypes.c_int, ctypes.c_int, f, f, i, i, i, i]
        _lib = lib
    return _lib


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = LEAF_SIZE,
              use_native: bool = True) -> FlatBVH:
    """Binned-SAH top-down build over triangles given as (T, 3) corner
    arrays: the C++ builder, or with `use_native=False` the NumPy one."""
    if not use_native:
        return _build_numpy(np.asarray(v0, np.float32), np.asarray(v1, np.float32), np.asarray(v2, np.float32),
                            leaf_size)
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    n = v0.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    cap = 2 * n
    aabb_min = np.empty((cap, 3), np.float32)
    aabb_max = np.empty((cap, 3), np.float32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    skip = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    f, i = ctypes.c_float, ctypes.c_int32
    n_nodes = _library().vpt_build_bvh(
        p(v0, f), p(v1, f), p(v2, f), n, leaf_size,
        p(aabb_min, f), p(aabb_max, f), p(first, i), p(count, i), p(skip, i), p(order, i),
    )
    if n_nodes <= 0:
        raise RuntimeError(f"native BVH build failed ({n_nodes})")
    return FlatBVH(
        aabb_min[:n_nodes].copy(), aabb_max[:n_nodes].copy(), first[:n_nodes].copy(),
        count[:n_nodes].copy(), skip[:n_nodes].copy(), order,
    )


def _build_numpy(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int) -> FlatBVH:
    """The NumPy builder (vpt_tpu/accel/bvh.py:76-138): recursive binned SAH
    in DFS pre-order, then the skip links top-down."""
    n_tris = v0.shape[0]
    if n_tris == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    centroid = (v0 + v1 + v2) / 3.0
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)

    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    nodes_first: list[int] = []
    nodes_count: list[int] = []
    nodes_right: list[int] = []  # right child of an inner node, -1 for a leaf
    tri_order = np.empty(n_tris, dtype=np.int32)
    cursor = [0]

    def emit(idx: np.ndarray) -> int:
        nid = len(nodes_min)
        nmin = tri_min[idx].min(axis=0)
        nmax = tri_max[idx].max(axis=0)
        nodes_min.append(nmin)
        nodes_max.append(nmax)
        nodes_first.append(0)
        nodes_count.append(0)
        nodes_right.append(-1)
        count = idx.shape[0]
        split = _find_split(idx, centroid, tri_min, tri_max, nmin, nmax, count, leaf_size)
        if split is None:
            nodes_first[nid] = cursor[0]
            nodes_count[nid] = count
            tri_order[cursor[0] : cursor[0] + count] = idx
            cursor[0] += count
            return nid
        left_idx, right_idx = split
        emit(left_idx)  # node nid + 1
        nodes_right[nid] = emit(right_idx)
        return nid

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100_000))
    try:
        emit(np.arange(n_tris, dtype=np.int32))
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(nodes_min)
    right = np.asarray(nodes_right, np.int32)
    # Skip links, top-down: skip(left(n)) = right(n); skip(right(n)) = skip(n).
    skip = np.full(n_nodes, SENTINEL, np.int32)
    stack = [0]
    while stack:
        nid = stack.pop()
        rid = right[nid]
        if rid >= 0:
            skip[nid + 1] = rid
            skip[rid] = skip[nid]
            stack.append(nid + 1)
            stack.append(rid)
    return FlatBVH(np.stack(nodes_min).astype(np.float32), np.stack(nodes_max).astype(np.float32),
                   np.asarray(nodes_first, np.int32), np.asarray(nodes_count, np.int32), skip, tri_order)


def _find_split(idx, centroid, tri_min, tri_max, nmin, nmax, count, leaf_size):
    """Binned SAH split (vpt_tpu/accel/bvh.py:141-195): (left_idx,
    right_idx), or None for a leaf."""
    if count <= leaf_size:
        return None
    c = centroid[idx]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    ext = cmax - cmin

    best_cost = np.inf
    split_axis = -1
    split_pos = 0.0
    for axis in range(3):
        if ext[axis] <= 1e-12:
            continue
        bins = np.minimum(((c[:, axis] - cmin[axis]) / ext[axis] * N_BINS).astype(np.int32), N_BINS - 1)
        bin_counts = np.bincount(bins, minlength=N_BINS)
        bmin = np.full((N_BINS, 3), np.inf, np.float32)
        bmax = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(bmin, bins, tri_min[idx])
        np.maximum.at(bmax, bins, tri_max[idx])
        lmin = np.minimum.accumulate(bmin, axis=0)
        lmax = np.maximum.accumulate(bmax, axis=0)
        rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
        lcnt = np.cumsum(bin_counts)
        rcnt = count - lcnt
        la = _aabb_area_vec(lmin[:-1], lmax[:-1])
        ra = _aabb_area_vec(rmin[1:], rmax[1:])
        valid = (lcnt[:-1] > 0) & (rcnt[:-1] > 0)
        cost = np.where(valid, la * lcnt[:-1] + ra * rcnt[:-1], np.inf)
        b = int(np.argmin(cost))
        if cost[b] < best_cost:
            best_cost = cost[b]
            split_axis = axis
            split_pos = cmin[axis] + ext[axis] * (b + 1) / N_BINS

    if split_axis < 0:
        # All centroids coincide: a median split bounds the leaf size.
        half = count // 2
        return idx[:half], idx[half:]

    node_area = _aabb_area(nmin, nmax)
    if best_cost >= node_area * count and count <= 2 * leaf_size:
        return None  # the SAH prefers a leaf, and the leaf stays small

    mask = centroid[idx, split_axis] < split_pos
    left_idx = idx[mask]
    right_idx = idx[~mask]
    if left_idx.shape[0] == 0 or right_idx.shape[0] == 0:
        order = np.argsort(centroid[idx, split_axis], kind="stable")
        half = count // 2
        left_idx = idx[order[:half]]
        right_idx = idx[order[half:]]
    return left_idx, right_idx


def _aabb_area(mn: np.ndarray, mx: np.ndarray) -> float:
    d = np.maximum(mx - mn, 0.0)
    return float(2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]))


def _aabb_area_vec(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    d = np.maximum(mx - mn, 0.0)
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
