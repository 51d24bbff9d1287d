"""Hit record, brute-force and skip-link BVH intersection (port of
vpt_tpu/accel/traverse.py).

Semantics shared by every intersector of the port: Moller-Trumbore is
two-sided, a triangle counts only when |det| > 1e-12 and
t_min < t < t_max, and a miss reports t = -1 and tri = -1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpt_tpu_torch.accel.bvh import LEAF_SIZE, SENTINEL
from vpt_tpu_torch.core.vecmath import cross, dot

T_MIN = 1e-4
T_MAX = 1e8
# The cluster layouts of the warp-per-ray kernels (csrc/trace.cu,
# csrc/visit.cu): the default layout, and the largest group, whose members
# one warp tests in one step.  They take any K that is a multiple of 8.
KERNEL_K = 128  # triangles per cluster block, the default
KERNEL_N_SUB = 8  # sub-blocks per cluster block
KERNEL_GROUP = 8  # member clusters per group, the default
MAX_GROUP = 32  # the largest group the kernels take


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) f32, -1 on a miss
    tri: torch.Tensor  # (N,) i32 virtual triangle id, -1 on a miss
    u: torch.Tensor  # (N,) f32 barycentric of v1
    v: torch.Tensor  # (N,) f32 barycentric of v2

    @property
    def hit_mask(self) -> torch.Tensor:
        return self.t >= 0.0


def _moller_trumbore(origin, direction, p0, e1, e2, t_min, t_max):
    """Batched Moller-Trumbore over (..., 3) operands: (t, u, v, valid)."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = origin - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return t, u, v, valid


def guarded_inverse(d):
    """1 / d with |d| raised to at least 1e-20 (positive where d is 0)."""
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)


def slab(o, inv, lo, hi, t_min: float):
    """Slab entry and geometric exit, (tn, tfg): a ray enters the box before
    a distance t iff tn <= min(t, tfg).  o/inv (..., 3), lo/hi broadcastable."""
    s0 = (lo - o) * inv
    s1 = (hi - o) * inv
    tn = torch.clamp(torch.minimum(s0, s1).amax(dim=-1), min=t_min)
    tfg = torch.maximum(s0, s1).amin(dim=-1)
    return tn, tfg


def instance_space(T, o, d):
    """Ray components (lists of 3) moved to an instance's local space by the
    world->local rows T (..., 12), summed in the CUDA kernels' order.  The
    direction stays unnormalised, so t remains world-parametric."""
    lo = [T[..., 4 * k] * o[0] + T[..., 4 * k + 1] * o[1] + T[..., 4 * k + 2] * o[2] + T[..., 4 * k + 3]
          for k in range(3)]
    ld = [T[..., 4 * k] * d[0] + T[..., 4 * k + 1] * d[1] + T[..., 4 * k + 2] * d[2] for k in range(3)]
    return lo, ld


def moller_trumbore_scalar(ox, oy, oz, dx, dy, dz, blk, t_min):
    """Moller-Trumbore over broadcastable per-component operands in the CUDA
    kernels' operation order, one rounding per product and sum: (t, u, v, ok),
    `ok` without the caller's t < tmax and range tests.  `blk` holds the
    nine triangle components p0.xyz, e1.xyz, e2.xyz along its first axis."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (blk[k] for k in range(9))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return t, u, v, ok


def intersect_brute(origin, direction, tri_p0, tri_e1, tri_e2, t_min=T_MIN, t_max=T_MAX) -> Hit:
    """Closest hit of every ray against every triangle; `t_max` may be (N,).
    Equal t resolves to the lower triangle index."""
    if torch.is_tensor(t_max) and t_max.ndim == 1:
        t_max = t_max[:, None]
    t, u, v, valid = _moller_trumbore(
        origin[:, None, :], direction[:, None, :], tri_p0[None], tri_e1[None], tri_e2[None], t_min, t_max,
    )
    t_masked = torch.where(valid, t, torch.inf)
    best_t, best = torch.min(t_masked, dim=1)
    best = best[:, None]
    hit = torch.isfinite(best_t)
    return Hit(
        t=torch.where(hit, best_t, -1.0),
        tri=torch.where(hit, best[:, 0].to(torch.int32), -1),
        u=torch.where(hit, u.gather(1, best)[:, 0], 0.0),
        v=torch.where(hit, v.gather(1, best)[:, 0], 0.0),
    )


def intersect_bvh(origin, direction, nodes_min, nodes_max, node_first, node_count, node_skip, tri_p0, tri_e1, tri_e2,
                  t_min=T_MIN, t_max=T_MAX, active=None, any_hit: bool = False) -> Hit:
    """Stackless skip-link traversal of a flattened BVH (accel/bvh.py) for a
    whole wavefront: every live ray advances one node per step, a leaf tests
    its LEAF_SIZE-wide triangle slice (the triangle tables are padded by
    LEAF_SIZE), and the loop ends when no ray is live (one host read per
    step).  `active`: (N,) bool, inactive rays skip traversal; `any_hit`
    stops a ray at its first confirmed hit.  The renderer traces through the
    cluster tables; this is the ground truth the BVH tests use."""
    n, dev = origin.shape[0], origin.device
    inv_dir = torch.where(torch.abs(direction) > 1e-20, 1.0 / direction, 1e20)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    if active is not None:
        node = torch.where(active, node, SENTINEL)
    best_t = torch.full((n,), float(t_max), dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    offs = torch.arange(LEAF_SIZE, device=dev)
    rows = torch.arange(n, device=dev)
    while bool((node != SENTINEL).any()):
        live = node != SENTINEL
        nid = torch.where(live, node, 0)
        t0 = (nodes_min[nid] - origin) * inv_dir
        t1 = (nodes_max[nid] - origin) * inv_dir
        t_near = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=t_min)
        t_far = torch.minimum(torch.maximum(t0, t1).amin(dim=-1), best_t)
        aabb_hit = t_near <= t_far
        count = node_count[nid].to(torch.int64)
        is_leaf = count > 0
        # The leaf's fixed-width triangle test, lanes past its count masked.
        do_tris = live & aabb_hit & is_leaf
        tid = torch.where(do_tris, node_first[nid].to(torch.int64), 0)[:, None] + offs[None, :]
        t, u, v, valid = _moller_trumbore(origin[:, None, :], direction[:, None, :], tri_p0[tid], tri_e1[tid],
                                          tri_e2[tid], t_min, t_max)
        valid = valid & do_tris[:, None] & (offs[None, :] < count[:, None]) & (t < best_t[:, None])
        cand_t, j = torch.min(torch.where(valid, t, torch.inf), dim=1)
        better = torch.isfinite(cand_t)
        best_t = torch.where(better, cand_t, best_t)
        best_tri = torch.where(better, tid[rows, j].to(torch.int32), best_tri)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
        # Descend on an inner hit (left child nid + 1), else follow the skip link.
        nxt = torch.where(aabb_hit & ~is_leaf, nid + 1, node_skip[nid].to(torch.int64))
        if any_hit:
            nxt = torch.where(best_tri >= 0, SENTINEL, nxt)
        node = torch.where(live, nxt, SENTINEL)
    return Hit(t=torch.where(best_tri >= 0, best_t, -1.0), tri=best_tri, u=best_u, v=best_v)


def group_size(cl) -> int:
    """Clusters per group of the cluster tables."""
    return cl.count.shape[0] // cl.group_min.shape[0]


def check_kernel_clusters(cl, kernel: str) -> None:
    """Raise unless the kernels take the cluster tables' layout (K a
    multiple of 8 triangles in 8 sub-blocks, at most MAX_GROUP clusters per
    group) and the tables the kernels read in vectors (aabbs, inv_rows,
    sub_aabbs) start on 16-byte boundaries."""
    k_tris, n_sub, group = cl.tris.shape[2], cl.sub_aabbs.shape[1], group_size(cl)
    if (k_tris % KERNEL_N_SUB or k_tris == 0 or n_sub != KERNEL_N_SUB or cl.tris.shape[1] != 16
            or not 1 <= group <= MAX_GROUP):
        raise ValueError(f"{kernel} take K = a multiple of 8 triangles per cluster in {KERNEL_N_SUB} sub-blocks and "
                         f"1 to {MAX_GROUP} clusters per group (VPT_CLUSTER_SIZE, VPT_GROUP_SIZE), got K = {k_tris}, "
                         f"{n_sub} sub-blocks and {group} clusters per group")
    if any(t.data_ptr() % 16 for t in (cl.aabbs, cl.inv_rows, cl.sub_aabbs)):
        raise ValueError(f"{kernel} read aabbs, inv_rows and sub_aabbs in vectors: "
                         "pass tensors that start on a 16-byte boundary")
