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
the band tables are, as the CUDA kernel's candidate lists, and so is its
sub-block cull: a cluster's K / 8-triangle sub-blocks are tested only where
the ray enters their mesh-local boxes.  The kernel gates clusters and
sub-blocks with the ray's current best t, the plain version with its tmax;
the closer gate skips only tests that cannot win, so the two agree up to
hits at the same t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpt_tpu_torch.accel import envelope, kernels
from vpt_tpu_torch.accel.cluster import pad_groups, ray_tmax, root_exit_tmax
from vpt_tpu_torch.accel.traverse import (T_MAX, T_MIN, Hit, check_kernel_clusters, group_size, guarded_inverse,
                                          instance_space, moller_trumbore_scalar, slab)
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


class Wavefront(NamedTuple):
    """A band-padded, root-bounded wavefront: what ray_keys takes."""

    tiles: int  # supertiles per band
    origin: torch.Tensor  # (N, 3)
    direction: torch.Tensor  # (N, 3)
    inv: torch.Tensor  # (N, 3) guarded reciprocal directions
    tmax: torch.Tensor  # (N,) clipped to the root-box exit; t_min on inactive and pad rays
    active: torch.Tensor  # (N,) bool
    payload: tuple


def pad_wavefront(origin, direction, cl: ClusterData, t_min, t_max, active, payload=(), pad_payload=()) -> Wavefront:
    """Pad a wavefront to whole bands (origin 1e9, direction +x, tmax =
    t_min, inactive; `pad_payload` on the payload columns), take the guarded
    inverse and clip tmax to the ray's root-box exit, t_min on inactive rays
    (stream.py:599-640)."""
    dev = origin.device
    n_orig = origin.shape[0]
    tmax = ray_tmax(t_max, n_orig, dev)
    tiles = min(TILES_PER_BAND, max(1, -(-n_orig // SUPERTILE)))
    pad = (-n_orig) % (tiles * SUPERTILE)
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
    inv = guarded_inverse(direction)
    tmax = torch.where(active, root_exit_tmax(origin, inv, tmax, cl, t_min), t_min)
    return Wavefront(tiles=tiles, origin=origin, direction=direction, inv=inv, tmax=tmax, active=active,
                     payload=tuple(payload))


def prepare_bands(origin, direction, cl: ClusterData, t_min, t_max, active, levels: int,
                  payload=(), pad_payload=()) -> Bands:
    """Pad, bound, key, sort and tabulate a wavefront (stream.py:599-698).

    `payload` is a tuple of (N,) int32 columns carried through the sort;
    `pad_payload` their values on pad rays.  Inactive rays take the largest
    key, so they sort last."""
    dev = origin.device
    n_orig = origin.shape[0]
    w = pad_wavefront(origin, direction, cl, t_min, t_max, active, payload, pad_payload)
    n = w.origin.shape[0]
    gmin_pad, gmax_pad = pad_groups(cl)
    gp = gmin_pad.shape[1]
    key = envelope.ray_keys(w.origin, w.inv, w.tmax, gmin_pad, gmax_pad, t_min=t_min, levels=levels)
    key = torch.where(w.active, key, (gp + 1) ** 2 - 1 if levels == 2 else gp)
    _, perm = torch.sort(key, stable=True)

    o_s = w.origin[perm]
    d_s = w.direction[perm]
    tm_s = w.tmax[perm]
    st_entry = envelope.supertile_tables(o_s, guarded_inverse(d_s), tm_s, gmin_pad, gmax_pad, t_min=t_min)
    tiles = w.tiles
    st = st_entry.reshape(n // (tiles * SUPERTILE), tiles, gp)
    shifts = torch.arange(tiles, dtype=torch.int64, device=dev)
    bits = (torch.isfinite(st).to(torch.int64) << shifts[None, :, None]).sum(dim=1)
    entry_bg = st.amin(dim=1)
    entry_sorted, order = torch.sort(entry_bg, dim=1, stable=True)
    ngrp = torch.isfinite(entry_bg).sum(dim=1).to(torch.int32)
    return Bands(
        n_orig=n_orig, tiles=tiles, perm=perm, origin=o_s, direction=d_s, tmax=tm_s,
        payload=tuple(p[perm].contiguous() for p in w.payload),
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


def _pairs(bands: Bands, cl: ClusterData, rows, act, t_min: float, tf):
    """Candidate (ray, cluster) pairs of sorted rays `rows` (a slice): the
    ray is active, the supertile's bit is set for the cluster's group, the
    cluster holds triangles and the ray enters its world box before tf (N,).
    Returns (ray index, cluster index)."""
    dev = bands.origin.device
    band = bands.tiles * SUPERTILE
    idx = torch.arange(rows.start, rows.stop, device=dev)
    b = idx // band
    j = (idx % band) // SUPERTILE
    gbits = (bands.bits[b] >> j[:, None]) & 1  # (R, Gp)
    g_of_c = torch.arange(cl.count.shape[0], device=dev) // group_size(cl)
    cand = (gbits[:, g_of_c] > 0) & (cl.count > 0)[None, :] & act[rows][:, None]
    o = bands.origin[rows]
    inv = guarded_inverse(bands.direction[rows])
    tn = torch.full(cand.shape, t_min, dtype=torch.float32, device=dev)
    tf = tf[rows][:, None].expand(cand.shape)
    for ax in range(3):
        s0 = (cl.aabbs[:, ax][None, :] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        s1 = (cl.aabbs[:, 3 + ax][None, :] - o[:, ax : ax + 1]) * inv[:, ax : ax + 1]
        tn = torch.maximum(tn, torch.minimum(s0, s1))
        tf = torch.minimum(tf, torch.maximum(s0, s1))
    r, c = torch.nonzero(cand & (tn <= tf), as_tuple=True)
    return r + rows.start, c


def _local_rays(bands: Bands, cl: ClusterData, r, c):
    """Each pair's ray in its cluster's instance space: (origin, direction),
    lists of three (P,) components."""
    o = bands.origin[r]
    d = bands.direction[r]
    lo = [o[:, k] for k in range(3)]
    ld = [d[:, k] for k in range(3)]
    if cl.inv_rows.shape[0] > 1:
        lo, ld = instance_space(cl.inv_rows[cl.inst[c]], lo, ld)
    return lo, ld


def _sub_block_sizes(cl: ClusterData, c):
    """(P, N_SUB) real triangles in each sub-block of each pair's cluster."""
    n_sub = cl.sub_aabbs.shape[1]
    sub = cl.tris.shape[2] // n_sub
    first = torch.arange(n_sub, device=c.device) * sub
    return (cl.count[c][:, None] - first[None, :]).clamp(0, sub)


def _sub_enter(cl: ClusterData, c, lo, ld, tf, t_min: float):
    """(P, N_SUB) bool: the pair's local ray enters a sub-block's mesh-local
    box before tf (P,), with the kernels' local inverse direction.  An empty
    sub-block (its box inverted) is never entered."""
    sb = cl.sub_aabbs[cl.block_id[c]]  # (P, N_SUB, 6)
    tn, tfg = slab(torch.stack(lo, dim=-1)[:, None, :], guarded_inverse(torch.stack(ld, dim=-1))[:, None, :],
                   sb[..., :3], sb[..., 3:], t_min)
    return (tn <= tf[:, None]) & (tn <= tfg) & (_sub_block_sizes(cl, c) > 0)


def _pair_moller_trumbore(bands: Bands, cl: ClusterData, r, c, t_min: float):
    """Moller-Trumbore of each pair's ray against its cluster's K triangles,
    in the CUDA kernel's operation order: (t, u, v, valid) of shape (P, K).
    Only triangles of sub-blocks the ray enters before its tmax are valid
    (the sub-block cull; tf = tmax does not depend on the visit order)."""
    lo, ld = _local_rays(bands, cl, r, c)
    ox, oy, oz = (x[:, None] for x in lo)
    dx, dy, dz = (x[:, None] for x in ld)
    blk = cl.tris[cl.block_id[c]]  # (P, 16, K)
    t, u, v, ok = moller_trumbore_scalar(ox, oy, oz, dx, dy, dz, blk.transpose(0, 1), t_min)
    k_tris = blk.shape[-1]
    k = torch.arange(k_tris, device=blk.device)
    enter = _sub_enter(cl, c, lo, ld, bands.tmax[r], t_min)
    enter = enter.repeat_interleave(k_tris // enter.shape[1], dim=1)
    valid = ok & (t < bands.tmax[r][:, None]) & (k[None, :] < cl.count[c][:, None]) & enter
    return t, u, v, valid


_RAY_CHUNK = 2048
_PAIR_CHUNK = 1 << 16


def pair_results(bands: Bands, cl: ClusterData, act, t_min: float, reduce_pairs):
    """Yield, per block of sorted rays, the candidate pairs (r, c) and
    `reduce_pairs(r, c, t, u, v, valid)` over their triangle tests, the
    tests run in sub-blocks of at most _PAIR_CHUNK pairs to bound memory."""
    n = bands.origin.shape[0]
    for s in range(0, n, _RAY_CHUNK):
        r_all, c_all = _pairs(bands, cl, slice(s, min(s + _RAY_CHUNK, n)), act, t_min, bands.tmax)
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

    gs = group_size(cl)
    never = torch.iinfo(torch.int64).max
    best_t = bands.tmax.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    for r, c, (tp, kp, up, vp) in pair_results(bands, cl, act, t_min, closest):
        best_t = best_t.scatter_reduce(0, r, tp, reduce="amin")
        at_best = torch.isfinite(tp) & (tp == best_t[r])
        visit = rank[r // band, c // gs] * gs + c % gs
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
        *layout_arguments(bands, cl, t_min),
        kernels.ptr(t, F32), kernels.ptr(tri, I32), kernels.ptr(u, F32), kernels.ptr(v, F32),
    )
    return t, tri, u, v


def table_pointers(bands: Bands, cl: ClusterData, payload):
    """Device pointers of the band tables, sorted rays, int32 payload
    columns and cluster tables, in the order vpt_stream / vpt_occlude take
    them.  Raises unless the kernels take the cluster tables' layout
    (traverse.check_kernel_clusters)."""
    check_kernel_clusters(cl, "vpt_stream / vpt_occlude")
    p = kernels.ptr
    return (
        p(bands.ngrp, I32), p(bands.order, I32), p(bands.entry_sorted, F32), p(bands.bits, torch.int64),
        p(bands.sent, F32), p(bands.origin, F32), p(bands.direction, F32), p(bands.tmax, F32),
        *(p(col, I32) for col in payload),
        p(cl.aabbs, F32), p(cl.count, I32), p(cl.start, I32), p(cl.block_id, I32), p(cl.inst, I32),
        p(cl.inv_rows, F32), p(cl.tris, F32), p(cl.sub_aabbs, F32), p(cl.group_min, F32), p(cl.group_max, F32),
    )


def layout_arguments(bands: Bands, cl: ClusterData, t_min: float) -> tuple:
    """The integer and float arguments vpt_stream / vpt_occlude take after
    the pointers: rays, supertiles per band, Gp, the group size, K, t_min,
    and whether the tables are instanced."""
    return (bands.origin.shape[0], bands.tiles, bands.order.shape[1], group_size(cl), cl.tris.shape[2], float(t_min),
            int(cl.inv_rows.shape[0] > 1))


class TraceWork(NamedTuple):
    """Per sorted ray, the traversal work of a trace out to a distance tf."""

    clusters: torch.Tensor  # (N,) i64 world cluster boxes entered
    sub_slabs: torch.Tensor  # (N,) i64 sub-block boxes tested: the non-empty ones of entered clusters
    sub_blocks: torch.Tensor  # (N,) i64 sub-block boxes entered
    tests: torch.Tensor  # (N,) i64 triangle tests with the sub-block cull
    tests_unculled: torch.Tensor  # (N,) i64 triangle tests of every entered cluster


def trace_work(bands: Bands, cl: ClusterData, t_min: float, active, tf) -> TraceWork:
    """The work the kernels' gates admit for active sorted rays that stop at
    tf (N,): with tf = tmax, what a ray that finds nothing does; with tf =
    its final hit t, the least a front-to-back trace must do."""
    n = bands.origin.shape[0]
    dev = bands.origin.device
    acc = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in TraceWork._fields]
    for s in range(0, n, _RAY_CHUNK):
        r, c = _pairs(bands, cl, slice(s, min(s + _RAY_CHUNK, n)), active, t_min, tf)
        for p in range(0, r.shape[0], _PAIR_CHUNK):
            rp, cp = r[p : p + _PAIR_CHUNK], c[p : p + _PAIR_CHUNK]
            sizes = _sub_block_sizes(cl, cp)
            enter = _sub_enter(cl, cp, *_local_rays(bands, cl, rp, cp), tf[rp], t_min)
            counts = (torch.ones_like(rp), (sizes > 0).sum(dim=1), enter.sum(dim=1),
                      (sizes * enter).sum(dim=1), cl.count[cp])
            for a, x in zip(acc, counts):
                a.index_add_(0, rp, x.to(torch.int64))
    return TraceWork(*acc)


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
