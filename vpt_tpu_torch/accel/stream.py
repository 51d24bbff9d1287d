"""Cluster-table closest-hit trace (port of vpt_tpu/accel/stream.py).

`intersect_stream` keeps the JAX wrapper's steps: rays are padded to whole
bands (origin 1e9, direction +x, tmax = t_min), tmax is clipped to the
ray's exit from the scene's root box, rays are stable-sorted by the key of
their first two entered groups, and per band the supertile tables give a
visit mask (`bits`), an entry distance per group and an entry-sorted
candidate list (`order`, `ngrp`).  The trace itself is kernel 3,
`stream_trace`: CUDA csrc/trace.cu vpt_stream (replacing the Pallas
_stream_kernel) for CUDA tensors, `stream_trace_plain` for CPU tensors.

The schedule of the Pallas kernel (1024-ray supertiles walked as 32-bit
masks, SMEM caps, lane-interleaved triangle blocks) is not carried over;
the band tables are, as the CUDA kernel's candidate lists.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpt_tpu_torch.accel import envelope, kernels
from vpt_tpu_torch.accel.cluster import GROUP_SIZE
from vpt_tpu_torch.accel.traverse import T_MAX, T_MIN, Hit
from vpt_tpu_torch.scene.types import ClusterData

F32, I32 = torch.float32, torch.int32
SUPERTILE = envelope.SUPERTILE
TILES_PER_BAND = 32
FLAG_ACTIVE = 1
FLAG_ANYHIT = 2


class Bands(NamedTuple):
    """A key-sorted, band-padded wavefront and its band tables."""

    n_orig: int
    tiles: int  # supertiles per band
    perm: torch.Tensor  # (N,) sorted slot -> padded input slot
    origin: torch.Tensor  # (N, 3) sorted
    direction: torch.Tensor  # (N, 3) sorted
    tmax: torch.Tensor  # (N,) sorted; t_min on inactive and pad rays
    payload: tuple  # the caller's per-ray int32 columns, sorted
    ngrp: torch.Tensor  # (B,) i32 candidate groups per band
    order: torch.Tensor  # (B, Gp) i32 entry-sorted group ids
    entry_sorted: torch.Tensor  # (B, Gp) f32
    bits: torch.Tensor  # (B, Gp) i64: bit j set = supertile j enters the group
    sent: torch.Tensor  # (B, T, Gp) f32 per-supertile entry, +inf = none


def pad_groups(cl: ClusterData):
    """(3, Gp) lo/hi group boxes padded to a multiple of 128 with 3e9 points."""
    g = cl.group_min.shape[0]
    gp = -(-g // 128) * 128
    pad = torch.full((gp - g, 3), 3e9, dtype=torch.float32, device=cl.group_min.device)
    return torch.cat([cl.group_min, pad]).T.contiguous(), torch.cat([cl.group_max, pad]).T.contiguous()


def guarded_inverse(d):
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)


def prepare_bands(origin, direction, cl: ClusterData, t_min, t_max, active, levels: int,
                  payload=(), pad_payload=()) -> Bands:
    """Pad, bound, key, sort and tabulate a wavefront (stream.py:599-698).

    `payload` is a tuple of (N,) int32 columns carried through the sort;
    `pad_payload` their values on pad rays.  Inactive rays take the largest
    key, so they sort last."""
    dev = origin.device
    n_orig = origin.shape[0]
    if torch.is_tensor(t_max):
        tmax = torch.broadcast_to(t_max.to(torch.float32), (n_orig,))
    else:  # a host scalar: no host-to-device copy, which would synchronise
        tmax = torch.full((n_orig,), t_max, dtype=torch.float32, device=dev)
    tiles = min(TILES_PER_BAND, max(1, -(-n_orig // SUPERTILE)))
    band = tiles * SUPERTILE
    pad = (-n_orig) % band
    if pad:
        origin = torch.cat([origin, torch.full((pad, 3), 1e9, dtype=torch.float32, device=dev)])
        dpad = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
        dpad[:, 0] = 1.0
        direction = torch.cat([direction, dpad])
        tmax = torch.cat([tmax, torch.full((pad,), t_min, dtype=torch.float32, device=dev)])
        active = torch.cat([active, torch.zeros(pad, dtype=torch.bool, device=dev)])
        payload = tuple(
            torch.cat([p, torch.full((pad,), v, dtype=p.dtype, device=dev)])
            for p, v in zip(payload, pad_payload)
        )
    n = origin.shape[0]

    # Root-exit bound: no hit lies beyond the ray's exit from the root box.
    root_min = cl.group_min.amin(dim=0)
    root_max = cl.group_max.amax(dim=0)
    inv = guarded_inverse(direction)
    r0 = (root_min[None, :] - origin) * inv
    r1 = (root_max[None, :] - origin) * inv
    tn_root = torch.minimum(r0, r1).amax(dim=1)
    tf_root = torch.maximum(r0, r1).amin(dim=1)
    exit_bound = torch.where(tn_root <= tf_root, tf_root * 1.0001 + t_min, t_min)
    tmax = torch.minimum(tmax, torch.clamp(exit_bound, min=t_min))
    tmax = torch.where(active, tmax, t_min)

    gmin_pad, gmax_pad = pad_groups(cl)
    gp = gmin_pad.shape[1]
    key = envelope.ray_keys(origin, inv, tmax, gmin_pad, gmax_pad, t_min=t_min, levels=levels)
    key = torch.where(active, key, (gp + 1) ** 2 - 1 if levels == 2 else gp)
    _, perm = torch.sort(key, stable=True)

    o_s = origin[perm]
    d_s = direction[perm]
    tm_s = tmax[perm]
    st_entry = envelope.supertile_tables(o_s, guarded_inverse(d_s), tm_s, gmin_pad, gmax_pad, t_min=t_min)
    b = n // band
    st = st_entry.reshape(b, tiles, gp)
    shifts = torch.arange(tiles, dtype=torch.int64, device=dev)
    bits = (torch.isfinite(st).to(torch.int64) << shifts[None, :, None]).sum(dim=1)
    entry_bg = st.amin(dim=1)
    entry_sorted, order = torch.sort(entry_bg, dim=1, stable=True)
    ngrp = torch.isfinite(entry_bg).sum(dim=1).to(torch.int32)
    return Bands(
        n_orig=n_orig, tiles=tiles, perm=perm, origin=o_s, direction=d_s, tmax=tm_s,
        payload=tuple(p[perm].contiguous() for p in payload),
        ngrp=ngrp, order=order.to(torch.int32).contiguous(), entry_sorted=entry_sorted.contiguous(),
        bits=bits.contiguous(), sent=st.contiguous(),
    )


def unsort(bands: Bands, values):
    """Scatter sorted per-ray values back to input order, dropping pad rays."""
    out = torch.empty_like(values)
    out[bands.perm] = values
    return out[: bands.n_orig]


# ---------------------------------------------------------------------------
# Kernel 3 and its plain version


def _pairs(bands: Bands, cl: ClusterData, rows, act, t_min: float):
    """Candidate (ray, cluster) pairs of sorted rays `rows` (a slice): the
    supertile's bit is set for the cluster's group and the world-space slab
    with tf = tmax is entered.  Returns (ray index, cluster index)."""
    dev = bands.origin.device
    band = bands.tiles * SUPERTILE
    idx = torch.arange(rows.start, rows.stop, device=dev)
    b = idx // band
    j = (idx % band) // SUPERTILE
    gbits = (bands.bits[b] >> j[:, None]) & 1  # (R, Gp)
    g_of_c = torch.arange(cl.count.shape[0], device=dev) // GROUP_SIZE
    cand = (gbits[:, g_of_c] > 0) & (cl.count > 0)[None, :] & act[rows][:, None]
    o = bands.origin[rows]
    inv = guarded_inverse(bands.direction[rows])
    tn = torch.full(cand.shape, t_min, dtype=torch.float32, device=dev)
    tf = bands.tmax[rows][:, None].expand(cand.shape)
    for ax in range(3):
        s0 = (cl.aabbs[:, ax][None, :] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        s1 = (cl.aabbs[:, 3 + ax][None, :] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        tn = torch.maximum(tn, torch.minimum(s0, s1))
        tf = torch.minimum(tf, torch.maximum(s0, s1))
    r, c = torch.nonzero(cand & (tn <= tf), as_tuple=True)
    return r + rows.start, c


def _pair_moller_trumbore(bands: Bands, cl: ClusterData, r, c, t_min: float):
    """Moller-Trumbore of each pair's ray against its cluster's K triangles,
    in the CUDA kernel's operation order: (t, u, v, valid) of shape (P, K)."""
    o = bands.origin[r]
    d = bands.direction[r]
    if cl.inv_rows.shape[0] > 1:
        T = cl.inv_rows[cl.inst[c]]  # (P, 12)
        lo = [T[:, 4 * k] * o[:, 0] + T[:, 4 * k + 1] * o[:, 1] + T[:, 4 * k + 2] * o[:, 2] + T[:, 4 * k + 3]
              for k in range(3)]
        ld = [T[:, 4 * k] * d[:, 0] + T[:, 4 * k + 1] * d[:, 1] + T[:, 4 * k + 2] * d[:, 2] for k in range(3)]
    else:
        lo = [o[:, k] for k in range(3)]
        ld = [d[:, k] for k in range(3)]
    ox, oy, oz = (x[:, None] for x in lo)
    dx, dy, dz = (x[:, None] for x in ld)
    blk = cl.tris[cl.block_id[c]]  # (P, 16, K)
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (blk[:, k] for k in range(9))
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
    k = torch.arange(blk.shape[-1], device=blk.device)
    valid = (
        ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
        & (t < bands.tmax[r][:, None]) & (k[None, :] < cl.count[c][:, None])
    )
    return t, u, v, valid


_RAY_CHUNK = 2048
_PAIR_CHUNK = 1 << 16


def pair_results(bands: Bands, cl: ClusterData, act, t_min: float, reduce_pairs):
    """Yield, per block of sorted rays, the candidate pairs (r, c) and
    `reduce_pairs(r, c, t, u, v, valid)` over their triangle tests, the
    tests run in sub-blocks of at most _PAIR_CHUNK pairs to bound memory."""
    n = bands.origin.shape[0]
    for s in range(0, n, _RAY_CHUNK):
        r_all, c_all = _pairs(bands, cl, slice(s, min(s + _RAY_CHUNK, n)), act, t_min)
        parts = []
        for p in range(0, r_all.shape[0], _PAIR_CHUNK):
            r, c = r_all[p : p + _PAIR_CHUNK], c_all[p : p + _PAIR_CHUNK]
            parts.append(reduce_pairs(r, c, *_pair_moller_trumbore(bands, cl, r, c, t_min)))
        if parts:
            yield r_all, c_all, [torch.cat(x) for x in zip(*parts)]


def stream_trace_plain(bands: Bands, cl: ClusterData, t_min: float):
    """Closest hit among every candidate cluster: (t, tri, u, v) per sorted
    ray, t = tmax and tri = -1 where nothing is hit.  Equal t resolves to
    the earlier cluster in the band's visit order, then the lower triangle
    index, as in the kernel.  Any-hit rays get their closest hit, which is
    a valid any-hit answer."""
    n = bands.origin.shape[0]
    dev = bands.origin.device
    act = (bands.payload[0] & FLAG_ACTIVE) > 0
    band = bands.tiles * SUPERTILE
    rank = torch.empty_like(bands.order, dtype=torch.int64)
    rank.scatter_(1, bands.order.to(torch.int64),
                  torch.arange(bands.order.shape[1], device=dev).expand_as(rank).contiguous())

    def closest(r, c, t, u, v, valid):
        tp, kp = torch.min(torch.where(valid, t, torch.inf), dim=1)  # first min: lowest index
        kp = kp[:, None]
        return tp, kp[:, 0], u.gather(1, kp)[:, 0], v.gather(1, kp)[:, 0]

    never = torch.iinfo(torch.int64).max
    best_t = bands.tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    for r, c, (tp, kp, up, vp) in pair_results(bands, cl, act, t_min, closest):
        best_t = best_t.scatter_reduce(0, r, tp, reduce="amin")
        at_best = torch.isfinite(tp) & (tp == best_t[r])
        visit = rank[r // band, c // GROUP_SIZE] * GROUP_SIZE + c % GROUP_SIZE
        visit = torch.where(at_best, visit, never)
        first = torch.full((n,), never, dtype=torch.int64, device=dev).scatter_reduce(0, r, visit, reduce="amin")
        win = at_best & (visit == first[r])  # one winning pair per hit ray
        rw = r[win]
        best_tri[rw] = (cl.start[c[win]] + kp[win]).to(torch.int32)
        best_u[rw] = up[win]
        best_v[rw] = vp[win]
    return best_t, best_tri, best_u, best_v


def stream_trace(bands: Bands, cl: ClusterData, t_min: float):
    """Kernel 3: (t, tri, u, v) per sorted ray.  Payload 0 holds the ray
    flags (bit 0 active, bit 1 any-hit)."""
    if not bands.origin.is_cuda:
        return stream_trace_plain(bands, cl, t_min)
    n = bands.origin.shape[0]
    dev = bands.origin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    kernels.launch(
        "vpt_stream", "stream", *table_pointers(bands, cl, bands.payload[:1]),
        n, bands.tiles, bands.order.shape[1], GROUP_SIZE, cl.tris.shape[2],
        float(t_min), int(cl.inv_rows.shape[0] > 1),
        kernels.ptr(t, F32), kernels.ptr(tri, I32), kernels.ptr(u, F32), kernels.ptr(v, F32),
    )
    return t, tri, u, v


def table_pointers(bands: Bands, cl: ClusterData, payload):
    """Device pointers of the band tables, sorted rays, int32 payload
    columns and cluster tables, in the order vpt_stream / vpt_occlude take them."""
    p = kernels.ptr
    return (
        p(bands.ngrp, I32), p(bands.order, I32), p(bands.entry_sorted, F32), p(bands.bits, torch.int64),
        p(bands.sent, F32), p(bands.origin, F32), p(bands.direction, F32), p(bands.tmax, F32),
        *(p(col, I32) for col in payload),
        p(cl.aabbs, F32), p(cl.count, I32), p(cl.start, I32), p(cl.block_id, I32), p(cl.inst, I32),
        p(cl.inv_rows, F32), p(cl.tris, F32),
    )


def trace_bands(origin, direction, cl: ClusterData, t_min, t_max, active, anyhit) -> Bands:
    """The bands of a closest-hit wavefront: keys of the first two entered
    groups, payload = the ray flags (bit 0 active, bit 1 any-hit)."""
    flags = active.to(torch.int32) * FLAG_ACTIVE + anyhit.to(torch.int32) * FLAG_ANYHIT
    return prepare_bands(origin, direction, cl, t_min, t_max, active, levels=2, payload=(flags,), pad_payload=(0,))


def intersect_stream(origin, direction, cl: ClusterData, t_min=T_MIN, t_max=T_MAX,
                     active=None, anyhit=None) -> Hit:
    """Closest-hit (or per-ray any-hit) intersection of a wavefront.

    `anyhit` (N,) bool marks rays that may stop at their first found hit;
    their hit is *a* hit below t_max, not necessarily the closest."""
    n = origin.shape[0]
    dev = origin.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if anyhit is None:
        anyhit = torch.zeros(n, dtype=torch.bool, device=dev)
    bands = trace_bands(origin, direction, cl, t_min, t_max, active, anyhit)
    bt, btri, bu, bv = stream_trace(bands, cl, t_min)
    hit_t = torch.where(btri >= 0, bt, -1.0)
    return Hit(t=unsort(bands, hit_t), tri=unsort(bands, btri), u=unsort(bands, bu), v=unsort(bands, bv))
