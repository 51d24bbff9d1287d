"""Cluster tables and the packet trace (port of vpt_tpu/accel/cluster.py).

Host half (jax-free copy of cluster.py:132-395): the SAH BVH is cut into
groups of subtrees (<= GROUP_SIZE * CLUSTER_SIZE triangles) and each group
into clusters of <= CLUSTER_SIZE contiguous triangles.  `build_mesh_clusters`
makes one mesh's cluster blocks in its local space, with the mesh-local box
of each of its 8 sub-blocks (K / 8 triangles each); `assemble_clusters`
lays out the per-instance cluster tables (world boxes, virtual triangle
ids, world->local transforms), padding every (instance, group) to exactly
GROUP_SIZE slots.  The result is numpy; the JAX package's lane-interleaved
TPU blocks are not built.

Device half: `intersect_clusters` (cluster.py:415-587), the packet trace
that `VPT_TRACE=packet` selects.  Rays are padded to whole PACKET_SIZE-ray
packets, bounded by the root box, optionally stable-sorted by a key
(`_SORT_KEY`: "fs", their first two entered groups, or "fe", their first
entered group and its quantised entry depth), culled per packet against
every group box (`entry`, `nvis`: kernel 2, `envelope.supertile_tables`,
at PACKET_SIZE-ray tiles), and each packet's rays walk its entry-sorted
candidate groups in kernel 5, `visit.visit_trace`.

The layout knobs, read from the environment at import with the JAX
package's names and defaults: `VPT_CLUSTER_SIZE` (K, 128; any multiple of
8), `VPT_GROUP_SIZE` (8), `VPT_PACKET_SIZE` (512) and `VPT_SORT_KEY`
("fs").  They change the schedule, not the results (up to hits at equal
t).  The builders and `prepare_packets` read the module constants when
they are called, so code (and a test) may set them; the kernels take every
layout the JAX package takes: K a multiple of 8, groups of any size,
packets of any size.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from vpt_tpu_torch.accel import envelope, visit
from vpt_tpu_torch.accel.bvh import FlatBVH
from vpt_tpu_torch.accel.traverse import T_MAX, T_MIN, Hit, guarded_inverse
from vpt_tpu_torch.envguard import guard_ablations
from vpt_tpu_torch.scene.types import ClusterData

guard_ablations()
CLUSTER_SIZE = int(os.environ.get("VPT_CLUSTER_SIZE", "128"))  # triangles per cluster (K)
GROUP_SIZE = int(os.environ.get("VPT_GROUP_SIZE", "8"))  # clusters per group
PACKET_SIZE = int(os.environ.get("VPT_PACKET_SIZE", "512"))  # rays per packet of the packet trace
_SORT_KEY = os.environ.get("VPT_SORT_KEY", "fs")  # fs = first + second group, fe = first group + entry depth
N_SUB = 8  # sub-blocks per cluster, each with its own mesh-local box
_BIG = 3e9


class MeshClusters(NamedTuple):
    """Per-mesh cluster set in mesh-local space."""

    cmin: np.ndarray  # (Cm, 3) local cluster boxes
    cmax: np.ndarray  # (Cm, 3)
    start: np.ndarray  # (Cm,) i32 local reordered-slot base
    count: np.ndarray  # (Cm,) i32
    tris: np.ndarray  # (Cm, 16, K) component-major blocks
    sub_aabbs: np.ndarray  # (Cm, N_SUB, 6) local sub-block boxes [lo.xyz, hi.xyz]
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


def _cut_ranges(bvh: FlatBVH, cluster_size: int, group_size: Optional[int] = None):
    """Two-level cut: groups of (lo, hi, aabb_min, aabb_max) cluster ranges,
    each group at most group_size (default GROUP_SIZE) clusters of one BVH
    subtree.  Adjacent cuts merge only while the union box stays tight."""
    group_size = GROUP_SIZE if group_size is None else group_size
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
    cluster_size: Optional[int] = None,
) -> MeshClusters:
    """One mesh's cluster blocks over its reordered local triangle arrays;
    K = cluster_size defaults to CLUSTER_SIZE, and the groups take
    GROUP_SIZE, as they stand when called."""
    cluster_size = CLUSTER_SIZE if cluster_size is None else cluster_size
    if cluster_size % N_SUB:
        raise ValueError("cluster_size must be a multiple of 8")
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
        cmin=cmin, cmax=cmax, start=start, count=cnt, tris=np.ascontiguousarray(tris),
        sub_aabbs=sub_block_boxes(p0, e1, e2, cnt), gidx=gidx,
    )


def sub_block_boxes(p0, e1, e2, cnt) -> np.ndarray:
    """(C, N_SUB, 6) box of each sub-block's real triangles (cluster.py:246-268):
    lo = 3e9, hi = -3e9 where a sub-block holds none."""
    c, k, _ = p0.shape
    sub = k // N_SUB
    fill = (np.arange(k)[None, :] < cnt[:, None])[:, :, None]  # (c, k, 1) real-triangle mask
    v1, v2 = p0 + e1, p0 + e2
    lo = np.minimum(np.minimum(np.where(fill, p0, _BIG), np.where(fill, v1, _BIG)), np.where(fill, v2, _BIG))
    hi = np.maximum(np.maximum(np.where(fill, p0, -_BIG), np.where(fill, v1, -_BIG)), np.where(fill, v2, -_BIG))
    lo = lo.reshape(c, N_SUB, sub, 3).min(axis=2)
    hi = hi.reshape(c, N_SUB, sub, 3).max(axis=2)
    empty = ~fill.reshape(c, N_SUB, sub).any(axis=2)
    lo[empty] = _BIG
    hi[empty] = -_BIG
    return np.concatenate([lo, hi], axis=2).astype(np.float32)


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
    """Per-instance cluster tables over shared mesh blocks (numpy leaves),
    each (instance, group) padded to GROUP_SIZE slots as it stands when
    called.

    `instance_specs` is [(mesh_cluster_index, transform (4,4), virt_tri_base)]."""
    group_size = GROUP_SIZE
    block_base = []
    b = 0
    for mc in mesh_clusters:
        block_base.append(b)
        b += mc.cmin.shape[0]

    cmin_l, cmax_l, start_l, cnt_l, blk_l, inst_l, inv_l = [], [], [], [], [], [], []

    def _pad_group():
        fill = (-len(cmin_l)) % group_size
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
    c_pad = -(-max(c, 1) // group_size) * group_size
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

    g = c_pad // group_size
    return ClusterData(
        aabbs=np.concatenate([cmin, cmax], axis=1),
        group_min=cmin.reshape(g, group_size, 3).min(axis=1),
        group_max=cmax.reshape(g, group_size, 3).max(axis=1),
        start=start,
        count=cnt,
        block_id=blk,
        inst=inst,
        inv_rows=np.stack(inv_l),
        tris=np.concatenate([mc.tris for mc in mesh_clusters]),
        sub_aabbs=np.concatenate([mc.sub_aabbs for mc in mesh_clusters]),
    )



# ---------------------------------------------------------------------------
# Device half: the packet trace


def pad_groups(cl: ClusterData):
    """(3, Gp) lo/hi group boxes padded to a multiple of 128 with 3e9 points."""
    g = cl.group_min.shape[0]
    gp = -(-g // 128) * 128
    pad = torch.full((gp - g, 3), 3e9, dtype=torch.float32, device=cl.group_min.device)
    return torch.cat([cl.group_min, pad]).T.contiguous(), torch.cat([cl.group_max, pad]).T.contiguous()


def ray_tmax(t_max, n: int, device) -> torch.Tensor:
    """(n,) float32 per-ray tmax from a tensor or a host scalar (a scalar is
    filled on the device: a host-to-device copy would synchronise)."""
    if torch.is_tensor(t_max):
        return torch.broadcast_to(t_max.to(torch.float32), (n,))
    return torch.full((n,), t_max, dtype=torch.float32, device=device)


def root_box(cl: ClusterData):
    """(lo, hi) (3,) of the scene's root box: the union of the group boxes."""
    return cl.group_min.amin(dim=0), cl.group_max.amax(dim=0)


def root_exit_tmax(origin, inv, tmax, cl: ClusterData, t_min):
    """tmax clipped to the ray's exit from the scene's root box
    (cluster.py:463-479): geometry lies inside it, so no hit lies beyond."""
    root_min, root_max = root_box(cl)
    r0 = (root_min[None, :] - origin) * inv
    r1 = (root_max[None, :] - origin) * inv
    tn_root = torch.minimum(r0, r1).amax(dim=1)
    tf_root = torch.maximum(r0, r1).amin(dim=1)
    exit_bound = torch.where(tn_root <= tf_root, tf_root * 1.0001 + t_min, t_min)
    return torch.minimum(tmax, torch.clamp(exit_bound, min=t_min))


def root_diagonal(cl: ClusterData) -> torch.Tensor:
    """(1,) float32 length of the root box's diagonal, the squares summed x,
    y, z in order (jnp.linalg.norm's order), left on the device."""
    lo, hi = root_box(cl)
    sq = (hi - lo) * (hi - lo)
    return torch.sqrt(sq[0] + sq[1] + sq[2]).reshape(1)


class Packets(NamedTuple):
    """A packet-padded, optionally key-sorted wavefront and its culled,
    entry-sorted candidate groups: the inputs of kernel 5."""

    n_orig: int
    perm: Optional[torch.Tensor]  # (N,) sorted slot -> padded input slot, None unsorted
    nvis: torch.Tensor  # (P,) i32 candidate groups per packet
    order: torch.Tensor  # (P, Gp) i32 group ids by entry distance
    entry_sorted: torch.Tensor  # (P, Gp) f32 nearest entry of any live ray, +inf = none
    origin: torch.Tensor  # (P, pk, 3)
    direction: torch.Tensor  # (P, pk, 3)
    active: torch.Tensor  # (P, pk) bool
    tmax: torch.Tensor  # (P, pk) f32, root-exit bounded


_INACTIVE_KEY = 1 << 30  # above every active key, so inactive rays sort last


def packet_cull_tmax(tmax, active):
    """The tmax the packet cull takes: -inf on inactive rays."""
    return torch.where(active, tmax, -torch.inf)


def sort_keys(origin, inv, tmax, cl: ClusterData, gmin_pad, gmax_pad, t_min):
    """(N,) int32 packet sort key of `_SORT_KEY` (cluster.py:494-519), by
    ray_keys: "fs" the first and second entered group packed as
    first * (Gp + 1) + second; "fe" the first entered group * 1024 + its
    entry depth quantised to 1/256 of the root box's diagonal, clipped to
    1023 (Gp * 1024 for a ray that enters no group)."""
    if _SORT_KEY == "fe":
        return envelope.ray_keys(origin, inv, tmax, gmin_pad, gmax_pad, t_min=t_min, levels=1, diag=root_diagonal(cl))
    if _SORT_KEY == "fs":
        return envelope.ray_keys(origin, inv, tmax, gmin_pad, gmax_pad, t_min=t_min, levels=2)
    raise ValueError(f"VPT_SORT_KEY must be fs or fe, got {_SORT_KEY!r}")


def prepare_packets(origin, direction, cl: ClusterData, t_min, t_max, active, sort_rays: bool) -> Packets:
    """Pad, bound, sort and cull a wavefront (cluster.py:441-553) into
    PACKET_SIZE-ray packets; unsorted (`sort_rays` False) the packets keep
    the wavefront's order."""
    dev = origin.device
    n_orig = origin.shape[0]
    size = PACKET_SIZE
    tmax = ray_tmax(t_max, n_orig, dev)
    if active is None:
        active = torch.ones(n_orig, dtype=torch.bool, device=dev)
    pad = (-n_orig) % size
    if pad:
        origin = torch.cat([origin, torch.full((pad, 3), 1e9, dtype=torch.float32, device=dev)])
        dpad = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
        dpad[:, 0] = 1.0
        direction = torch.cat([direction, dpad])
        tmax = torch.cat([tmax, torch.full((pad,), t_min, dtype=torch.float32, device=dev)])
        active = torch.cat([active, torch.zeros(pad, dtype=torch.bool, device=dev)])
    inv = guarded_inverse(direction)
    tmax = root_exit_tmax(origin, inv, tmax, cl, t_min)
    gmin_pad, gmax_pad = pad_groups(cl)

    perm = None
    if sort_rays:
        key = sort_keys(origin.contiguous(), inv, tmax, cl, gmin_pad, gmax_pad, t_min)
        key = torch.where(active, key, _INACTIVE_KEY)
        _, perm = torch.sort(key, stable=True)
        origin, direction, inv, tmax, active = (x[perm] for x in (origin, direction, inv, tmax, active))

    n_pk = origin.shape[0] // size
    origin = origin.contiguous()
    o_p = origin.reshape(n_pk, size, 3)
    act_p = active.reshape(n_pk, size).contiguous()
    tmax_p = tmax.reshape(n_pk, size).contiguous()
    # The packet cull: per packet and group, the nearest entry of an active
    # ray (cluster.py:540-542).  An inactive ray's tmax lies below t_min, so
    # it enters nothing, not even a box around its origin.
    entry = envelope.supertile_tables(origin, inv.contiguous(), packet_cull_tmax(tmax, active), gmin_pad, gmax_pad,
                                      t_min, tile=size)
    entry_sorted, order = torch.sort(entry, dim=1, stable=True)
    return Packets(
        n_orig=n_orig, perm=perm, nvis=torch.isfinite(entry).sum(dim=1).to(torch.int32),
        order=order.to(torch.int32).contiguous(), entry_sorted=entry_sorted.contiguous(),
        origin=o_p, direction=direction.reshape(n_pk, size, 3).contiguous(), active=act_p, tmax=tmax_p,
    )


def unpack(pk: Packets, values):
    """(P, pk) per-packet values back to (N,) input order, pad rays dropped."""
    values = values.reshape(-1)
    if pk.perm is not None:
        out = torch.empty_like(values)
        out[pk.perm] = values
        values = out
    return values[: pk.n_orig]


def intersect_clusters(origin, direction, cl: ClusterData, t_min=T_MIN, t_max=T_MAX, active=None,
                       any_hit: bool = False, sort_rays: bool = False) -> Hit:
    """Closest-hit (or, with `any_hit`, any-hit) packet trace of a wavefront;
    `t_max` may be per-ray.  With `sort_rays` the rays are regrouped by their
    `_SORT_KEY` first, so packet mates share candidates."""
    pk = prepare_packets(origin, direction, cl, t_min, t_max, active, sort_rays)
    t, tri, u, v = visit.visit_trace(pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active,
                                     pk.tmax, cl, t_min, any_hit=any_hit)
    t = torch.where(tri >= 0, t, -1.0)
    return Hit(t=unpack(pk, t), tri=unpack(pk, tri), u=unpack(pk, u), v=unpack(pk, v))
