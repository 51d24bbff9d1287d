"""Host-side cluster build (jax-free copy of vpt_tpu/accel/cluster.py:132-395).

The SAH BVH is cut into groups of subtrees (<= GROUP_SIZE * CLUSTER_SIZE
triangles) and each group into clusters of <= CLUSTER_SIZE contiguous
triangles.  `build_mesh_clusters` makes one mesh's cluster blocks in its
local space; `assemble_clusters` lays out the per-instance cluster tables
(world boxes, virtual triangle ids, world->local transforms), padding every
(instance, group) to exactly GROUP_SIZE slots.  The result is numpy; the
JAX package's lane-interleaved TPU blocks are not built.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from vpt_tpu_torch.accel.bvh import FlatBVH
from vpt_tpu_torch.scene.types import ClusterData

CLUSTER_SIZE = 128  # triangles per cluster (K)
GROUP_SIZE = 8  # clusters per group
_BIG = 3e9


class MeshClusters(NamedTuple):
    """Per-mesh cluster set in mesh-local space."""

    cmin: np.ndarray  # (Cm, 3) local cluster boxes
    cmax: np.ndarray  # (Cm, 3)
    start: np.ndarray  # (Cm,) i32 local reordered-slot base
    count: np.ndarray  # (Cm,) i32
    tris: np.ndarray  # (Cm, 16, K) component-major blocks
    gidx: np.ndarray  # (Cm,) i32 group (BVH subtree) index


def _subtree_lohi(bvh: FlatBVH):
    """Subtree triangle ranges [lo, hi) by a reverse sweep over DFS order."""
    n_nodes = bvh.n_nodes
    lo = np.zeros(n_nodes, np.int64)
    hi = np.zeros(n_nodes, np.int64)
    for i in range(n_nodes - 1, -1, -1):
        if bvh.tri_count[i] > 0:
            lo[i] = bvh.first_tri[i]
            hi[i] = bvh.first_tri[i] + bvh.tri_count[i]
        else:
            lo[i] = lo[i + 1]
            hi[i] = hi[bvh.skip[i + 1]]
    return lo, hi


def _subtree_cuts(bvh: FlatBVH, root: int, max_tris: int, lo, hi):
    """DFS-ordered subtree nodes under `root` with <= max_tris each."""
    out = []
    stack = [root]
    while stack:
        i = stack.pop()
        if hi[i] - lo[i] <= max_tris:
            out.append(i)
        else:
            stack.append(i + 1)
            stack.append(bvh.skip[i + 1])
    out.sort(key=lambda i: lo[i])
    return out


def _cut_ranges(bvh: FlatBVH, cluster_size: int, group_size: int = GROUP_SIZE):
    """Two-level cut: groups of (lo, hi, aabb_min, aabb_max) cluster ranges,
    each group at most group_size clusters of one BVH subtree.  Adjacent
    cuts merge only while the union box stays tight."""
    lo, hi = _subtree_lohi(bvh)

    def _area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    groups = []
    for gnode in _subtree_cuts(bvh, 0, cluster_size * group_size, lo, hi):
        ranges = []
        for i in _subtree_cuts(bvh, gnode, cluster_size, lo, hi):
            if ranges and (hi[i] - ranges[-1][0]) <= cluster_size:
                plo, phi, pmn, pmx = ranges[-1]
                mmn = np.minimum(pmn, bvh.aabb_min[i])
                mmx = np.maximum(pmx, bvh.aabb_max[i])
                if _area(mmn, mmx) <= 1.05 * (
                    _area(pmn, pmx) + _area(bvh.aabb_min[i], bvh.aabb_max[i])
                ):
                    ranges[-1] = (plo, hi[i], mmn, mmx)
                    continue
            ranges.append((lo[i], hi[i], bvh.aabb_min[i].copy(), bvh.aabb_max[i].copy()))
        for s in range(0, len(ranges), group_size):
            groups.append(ranges[s : s + group_size])
    return groups


def build_mesh_clusters(
    bvh: FlatBVH, tri_p0: np.ndarray, tri_e1: np.ndarray, tri_e2: np.ndarray,
    cluster_size: int = CLUSTER_SIZE,
) -> MeshClusters:
    """One mesh's cluster blocks over its reordered local triangle arrays."""
    groups = _cut_ranges(bvh, cluster_size)
    ranges = [r for grp in groups for r in grp]
    gidx = np.array([gi for gi, grp in enumerate(groups) for _ in grp], np.int32)
    c = len(ranges)
    k = cluster_size
    cmin = np.stack([r[2] for r in ranges]).astype(np.float32)
    cmax = np.stack([r[3] for r in ranges]).astype(np.float32)
    start = np.array([r[0] for r in ranges], np.int32)
    cnt = np.array([r[1] - r[0] for r in ranges], np.int32)
    p0 = np.zeros((c, k, 3), np.float32)
    e1 = np.zeros((c, k, 3), np.float32)
    e2 = np.zeros((c, k, 3), np.float32)
    for ci, (s, e, _, _) in enumerate(ranges):
        s, e = int(s), int(e)
        p0[ci, : e - s] = tri_p0[s:e]
        e1[ci, : e - s] = tri_e1[s:e]
        e2[ci, : e - s] = tri_e2[s:e]
    tris = np.concatenate(
        [p0.transpose(0, 2, 1), e1.transpose(0, 2, 1), e2.transpose(0, 2, 1),
         np.zeros((c, 7, k), np.float32)],
        axis=1,
    )
    return MeshClusters(
        cmin=cmin, cmax=cmax, start=start, count=cnt, tris=np.ascontiguousarray(tris), gidx=gidx,
    )


def _transform_aabb(lo, hi, m):
    """World box of a transformed local box (8 corners through affine m)."""
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
        np.float64,
    )
    w = corners @ m[:3, :3].T + m[:3, 3]
    return w.min(axis=0).astype(np.float32), w.max(axis=0).astype(np.float32)


def assemble_clusters(
    mesh_clusters: list, instance_specs: list,
) -> ClusterData:
    """Per-instance cluster tables over shared mesh blocks (numpy leaves).

    `instance_specs` is [(mesh_cluster_index, transform (4,4), virt_tri_base)]."""
    block_base = []
    b = 0
    for mc in mesh_clusters:
        block_base.append(b)
        b += mc.cmin.shape[0]

    cmin_l, cmax_l, start_l, cnt_l, blk_l, inst_l, inv_l = [], [], [], [], [], [], []

    def _pad_group():
        fill = (-len(cmin_l)) % GROUP_SIZE
        for _ in range(fill):
            cmin_l.append(np.full(3, _BIG, np.float32))
            cmax_l.append(np.full(3, -_BIG, np.float32))
            start_l.append(0)
            cnt_l.append(0)
            blk_l.append(0)
            inst_l.append(inst_l[-1] if inst_l else 0)

    for ii, (mi, transform, virt_base) in enumerate(instance_specs):
        mc = mesh_clusters[mi]
        m = np.asarray(transform, np.float64)
        inv = np.linalg.inv(m)
        inv_l.append(inv[:3, :4].astype(np.float32).reshape(12))
        prev_g = None
        for c in range(mc.cmin.shape[0]):
            gi = int(mc.gidx[c])
            if prev_g is not None and gi != prev_g:
                _pad_group()
            prev_g = gi
            lo, hi = _transform_aabb(mc.cmin[c], mc.cmax[c], m)
            cmin_l.append(lo)
            cmax_l.append(hi)
            start_l.append(virt_base + int(mc.start[c]))
            cnt_l.append(int(mc.count[c]))
            blk_l.append(block_base[mi] + c)
            inst_l.append(ii)
        _pad_group()

    c = len(cmin_l)
    c_pad = -(-max(c, 1) // GROUP_SIZE) * GROUP_SIZE
    cmin = np.full((c_pad, 3), _BIG, np.float32)
    cmax = np.full((c_pad, 3), -_BIG, np.float32)
    start = np.zeros(c_pad, np.int32)
    cnt = np.zeros(c_pad, np.int32)
    blk = np.zeros(c_pad, np.int32)
    inst = np.zeros(c_pad, np.int32)
    if c:
        cmin[:c] = np.stack(cmin_l)
        cmax[:c] = np.stack(cmax_l)
        start[:c] = np.asarray(start_l, np.int32)
        cnt[:c] = np.asarray(cnt_l, np.int32)
        blk[:c] = np.asarray(blk_l, np.int32)
        inst[:c] = np.asarray(inst_l, np.int32)

    g = c_pad // GROUP_SIZE
    return ClusterData(
        aabbs=np.concatenate([cmin, cmax], axis=1),
        group_min=cmin.reshape(g, GROUP_SIZE, 3).min(axis=1),
        group_max=cmax.reshape(g, GROUP_SIZE, 3).max(axis=1),
        start=start,
        count=cnt,
        block_id=blk,
        inst=inst,
        inv_rows=np.stack(inv_l),
        tris=np.concatenate([mc.tris for mc in mesh_clusters]),
    )

