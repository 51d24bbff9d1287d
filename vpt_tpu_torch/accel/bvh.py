"""Host-side SAH BVH build (jax-free copy of vpt_tpu/accel/bvh.py's output).

The builder is the JAX package's C++ source, vpt_tpu/accel/cpp/bvh_builder.cpp,
compiled by path with g++ into vpt_tpu_torch/build/ at first use and loaded
with ctypes.  The layout is the JAX package's: nodes in DFS pre-order (left
child of inner node i is i + 1), skip links, and a triangle order that makes
every leaf a contiguous slice.  A build failure raises: there is no silent
fallback to another builder.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess

import numpy as np

from vpt_tpu_torch.accel.kernels import BUILD_DIR, PKG_DIR

LEAF_SIZE = 4
SENTINEL = 2**31 - 1  # the skip link past the last node

_SRC = os.path.join(os.path.dirname(PKG_DIR), "vpt_tpu", "accel", "cpp", "bvh_builder.cpp")
_LIB = os.path.join(BUILD_DIR, "libvpt_bvh.so")
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
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build the BVH builder:\n{proc.stderr}")
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(_LIB)
        f = ctypes.POINTER(ctypes.c_float)
        i = ctypes.POINTER(ctypes.c_int32)
        lib.vpt_build_bvh.restype = ctypes.c_int
        lib.vpt_build_bvh.argtypes = [f, f, f, ctypes.c_int, ctypes.c_int, f, f, i, i, i, i]
        _lib = lib
    return _lib


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Binned-SAH top-down build over triangles given as (T, 3) corner arrays."""
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
