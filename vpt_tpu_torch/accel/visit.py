"""Kernel 5, the packet visit (port of vpt_tpu/accel/visit_kernel.py).

Every ray of a packet walks its packet's entry-sorted candidate groups
front to back, with its own best t (tmax at first).  Its walk ends at the
first candidate whose packet entry is not below its best t (the packet's
entry of a group never exceeds the ray's own).  For each of a walked
group's member clusters, in index order:

  1. a per-ray gate: does the ray enter the cluster's world box within its
     current best t?
  2. the ray moves to the cluster's instance space (direction unnormalised);
  3. for each of the 8 sub-blocks, a per-ray slab test of the sub-block's
     mesh-local box against the current best t, then Moller-Trumbore over
     its K / 8 triangles for the rays that entered.  Within a sub-block the
     smallest triangle index wins a t tie; across sub-blocks and clusters
     only a strictly closer hit replaces the current one.

"Live" rays are the active ones; with `any_hit`, those still without a hit.
The Pallas kernel gates a member on "any live ray of the packet enters it";
the gates here are each ray's own, as in the JAX stream kernel, because the
CUDA kernel runs a warp per ray (csrc/visit.cu says why).  `visit_trace`
launches CUDA csrc/visit.cu vpt_visit (replacing the Pallas _visit_kernel)
for CUDA tensors and `visit_trace_plain` for CPU tensors.  The plain version
keeps the kernel's gates, in the kernel's order, so the two agree exactly,
ties included.  Both take packets of any size (cluster.PACKET_SIZE,
`VPT_PACKET_SIZE`) and any cluster layout check_kernel_clusters admits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpt_tpu_torch.accel import kernels
from vpt_tpu_torch.accel.traverse import (check_kernel_clusters, group_size, guarded_inverse, instance_space,
                                          moller_trumbore_scalar, slab)
from vpt_tpu_torch.scene.types import ClusterData

F32, I32 = torch.float32, torch.int32
WARP = 32  # candidates per walk step of the kernel
_PACKETS = 64  # packets per block of the plain version


def _visit_block(nvis, order, entry, o, d, act, tmax, cl: ClusterData, t_min: float, any_hit: bool):
    """The plain visit of one block of packets: (t, tri, u, v), each (c, pk)."""
    dev = o.device
    c, pk = act.shape
    gp = order.shape[1]
    gs = group_size(cl)
    n_sub = cl.sub_aabbs.shape[1]
    k_tris = cl.tris.shape[2]
    sub = k_tris // n_sub
    instanced = cl.inv_rows.shape[0] > 1
    t = tmax.clone()
    tri = torch.full((c, pk), -1, dtype=I32, device=dev)
    u = torch.zeros((c, pk), dtype=F32, device=dev)
    v = torch.zeros((c, pk), dtype=F32, device=dev)
    inv = guarded_inverse(d)
    kidx = torch.arange(k_tris, device=dev)
    members = torch.arange(gs, device=dev)

    def live_rays():
        return act & (tri < 0) if any_hit else act

    cont = nvis > 0
    w = 0
    while w < gp and bool(cont.any()):
        walking = cont[:, None] & (entry[:, w : w + 1] < t)  # (c, pk): the ray's walk reaches group w
        cids = torch.where(cont, order[:, w], 0).to(torch.int64)[:, None] * gs + members  # (c, M)
        box = cl.aabbs[cids]  # (c, M, 6)
        tn_m, tfg_m = slab(o[:, :, None, :], inv[:, :, None, :], box[:, None, :, :3], box[:, None, :, 3:], t_min)
        for m in range(gs):
            cid = cids[:, m]
            enter_m = (walking & live_rays() & (tn_m[..., m] <= t) & (tn_m[..., m] <= tfg_m[..., m])
                       & (cl.count[cid] > 0)[:, None])  # (c, pk): the ray's own member gate
            if not bool(enter_m.any()):
                continue
            blk = cl.block_id[cid].to(torch.int64)
            lo = [o[..., a] for a in range(3)]
            ld = [d[..., a] for a in range(3)]
            if instanced:
                lo, ld = instance_space(cl.inv_rows[cl.inst[cid].to(torch.int64)][:, None, :], lo, ld)
            lo3, linv = torch.stack(lo, dim=-1), guarded_inverse(torch.stack(ld, dim=-1))
            # Every triangle's test at once; the sub-block loop below only merges.
            tt, uu, vv, ok = moller_trumbore_scalar(
                *(x[..., None] for x in lo), *(x[..., None] for x in ld),
                cl.tris[blk].transpose(0, 1)[:, :, None, :], t_min)  # (c, pk, K)
            ok = ok & (kidx < cl.count[cid][:, None, None]) & enter_m[..., None]
            sb = cl.sub_aabbs[blk]  # (c, n_sub, 6)
            tn_s, tfg_s = slab(lo3[:, :, None, :], linv[:, :, None, :], sb[:, None, :, :3], sb[:, None, :, 3:], t_min)
            base = cl.start[cid][:, None]
            for s in range(n_sub):
                enter = (tn_s[..., s] <= t) & (tn_s[..., s] <= tfg_s[..., s]) & live_rays() & enter_m
                ks = slice(s * sub, (s + 1) * sub)
                valid = ok[..., ks] & (tt[..., ks] < t[..., None]) & enter[..., None]
                tb, j = torch.where(valid, tt[..., ks], torch.inf).min(dim=2)  # first minimum: smallest index
                better = tb < t
                t = torch.where(better, tb, t)
                tri = torch.where(better, (base + s * sub + j).to(I32), tri)
                u = torch.where(better, uu[..., ks].gather(2, j[..., None])[..., 0], u)
                v = torch.where(better, vv[..., ks].gather(2, j[..., None])[..., 0], v)
        cap = torch.where(live_rays(), t, 0.0).amax(dim=1)
        w += 1
        cont = cont & (w < nvis) & (entry[:, min(w, gp - 1)] < cap)
    return t, tri, u, v


def visit_trace_plain(nvis, order, entry_sorted, o_p, d_p, act_p, tmax_p, cl: ClusterData, t_min: float,
                      any_hit: bool = False):
    """(t, tri, u, v), each (P, pk): t = tmax and tri = -1 where nothing is hit."""
    parts = [
        _visit_block(nvis[s : s + _PACKETS], order[s : s + _PACKETS], entry_sorted[s : s + _PACKETS],
                     o_p[s : s + _PACKETS], d_p[s : s + _PACKETS], act_p[s : s + _PACKETS],
                     tmax_p[s : s + _PACKETS], cl, float(t_min), any_hit)
        for s in range(0, nvis.shape[0], _PACKETS)
    ]
    return tuple(torch.cat(x) for x in zip(*parts))


def visit_trace(nvis, order, entry_sorted, o_p, d_p, act_p, tmax_p, cl: ClusterData, t_min: float,
                any_hit: bool = False):
    """Kernel 5: (t, tri, u, v) of each (P, pk) packet ray.  nvis (P,) i32,
    order (P, Gp) i32 and entry_sorted (P, Gp) f32 are the packets' culled
    candidate groups; o_p/d_p (P, pk, 3), act_p (P, pk) bool, tmax_p (P, pk)."""
    if not o_p.is_cuda:
        return visit_trace_plain(nvis, order, entry_sorted, o_p, d_p, act_p, tmax_p, cl, t_min, any_hit)
    n_pk, pk = act_p.shape
    check_kernel_clusters(cl, "vpt_visit")
    dev = o_p.device
    out = (torch.empty((n_pk, pk), dtype=F32, device=dev), torch.empty((n_pk, pk), dtype=I32, device=dev),
           torch.empty((n_pk, pk), dtype=F32, device=dev), torch.empty((n_pk, pk), dtype=F32, device=dev))
    act_i = act_p.to(I32)
    p = kernels.ptr
    kernels.launch(
        "vpt_visit", "visit",
        p(nvis, I32), p(order, I32), p(entry_sorted, F32), p(o_p, F32), p(d_p, F32), p(act_i, I32), p(tmax_p, F32),
        p(cl.aabbs, F32), p(cl.count, I32), p(cl.start, I32), p(cl.block_id, I32), p(cl.inst, I32),
        p(cl.inv_rows, F32), p(cl.tris, F32), p(cl.sub_aabbs, F32),
        n_pk, pk, order.shape[1], group_size(cl), cl.tris.shape[2], float(t_min), int(any_hit),
        int(cl.inv_rows.shape[0] > 1),
        *(p(x, dt) for x, dt in zip(out, (F32, I32, F32, F32))),
    )
    return out


class VisitWork(NamedTuple):
    """Per packet ray, the walk of csrc/visit.cu with the ray's best t held
    at a distance tf."""

    walked: torch.Tensor  # (P, pk) i64 candidates whose packet entry lies below tf
    steps: torch.Tensor  # (P, pk) i64 WARP-candidate steps of the walk
    groups: torch.Tensor  # (P, pk) i64 group boxes entered (each tests its member boxes)
    clusters: torch.Tensor  # (P, pk) i64 member boxes with triangles entered
    sub_slabs: torch.Tensor  # (P, pk) i64 sub-block boxes tested: the non-empty ones of entered clusters
    sub_blocks: torch.Tensor  # (P, pk) i64 sub-block boxes entered
    tests: torch.Tensor  # (P, pk) i64 triangle tests of the entered sub-blocks


def visit_work(nvis, order, entry_sorted, o_p, d_p, act_p, tf, cl: ClusterData, t_min: float) -> VisitWork:
    """The work the kernel's gates admit for active packet rays that stop at
    tf (P, pk): with tf = the ray's final hit t, the least its walk does;
    with tf = tmax, what a ray that finds nothing does."""
    n_pk, pk = act_p.shape
    dev = o_p.device
    gs = group_size(cl)
    n_sub = cl.sub_aabbs.shape[1]
    sub = cl.tris.shape[2] // n_sub
    ulo = cl.aabbs[:, :3].reshape(-1, gs, 3).amin(dim=1)  # the kernel's group boxes: its members' union
    uhi = cl.aabbs[:, 3:].reshape(-1, gs, 3).amax(dim=1)
    acc = [torch.zeros(n_pk * pk, dtype=torch.int64, device=dev) for _ in VisitWork._fields]
    walked, steps, groups, clusters, sub_slabs, sub_blocks, tests = acc
    first = torch.arange(n_sub, device=dev) * sub
    for s in range(0, n_pk, _PACKETS // 4):
        sl = slice(s, s + _PACKETS // 4)
        nv, ent, t, act = nvis[sl].to(torch.int64), entry_sorted[sl], tf[sl], act_p[sl]
        o, d = o_p[sl].reshape(-1, 3), d_p[sl].reshape(-1, 3)
        inv = guarded_inverse(d)
        rays = torch.arange(s * pk, s * pk + act.numel(), device=dev)
        listed = torch.arange(order.shape[1], device=dev)[None, :] < nv[:, None]
        walk = listed[:, None, :] & (ent[:, None, :] < t[..., None]) & act[..., None]  # (c, pk, Gp)
        n_walk = walk.sum(dim=2)
        walked[rays] = n_walk.reshape(-1)
        last = (nv[:, None] + WARP - 1) // WARP
        steps[rays] = torch.where(act & (nv[:, None] > 0), torch.minimum(n_walk // WARP + 1, last), 0).reshape(-1)
        g = order[sl].to(torch.int64).clamp(max=ulo.shape[0] - 1)
        tn, tfg = slab(o.reshape(act.shape + (1, 3)), inv.reshape(act.shape + (1, 3)), ulo[g][:, None], uhi[g][:, None],
                       t_min)
        in_g = walk & (tn <= t[..., None]) & (tn <= tfg)
        groups[rays] = in_g.sum(dim=2).reshape(-1)
        b, r, w = torch.nonzero(in_g, as_tuple=True)
        q = b * pk + r  # the pair's ray, flat within the slice
        cids = g[b, w][:, None] * gs + torch.arange(gs, device=dev)  # (Q, gs)
        box = cl.aabbs[cids]
        tq = t.reshape(-1)[q]
        tn_m, tfg_m = slab(o[q][:, None], inv[q][:, None], box[..., :3], box[..., 3:], t_min)
        in_m = (tn_m <= tq[:, None]) & (tn_m <= tfg_m) & (cl.count[cids] > 0)
        qm, m = torch.nonzero(in_m, as_tuple=True)
        c, rq = cids[qm, m], q[qm]
        clusters.index_add_(0, rq + s * pk, torch.ones_like(rq))
        lo = [o[rq, a] for a in range(3)]
        ld = [d[rq, a] for a in range(3)]
        if cl.inv_rows.shape[0] > 1:
            lo, ld = instance_space(cl.inv_rows[cl.inst[c].to(torch.int64)], lo, ld)
        sb = cl.sub_aabbs[cl.block_id[c].to(torch.int64)]
        tn_s, tfg_s = slab(torch.stack(lo, dim=-1)[:, None], guarded_inverse(torch.stack(ld, dim=-1))[:, None],
                           sb[..., :3], sb[..., 3:], t_min)
        sizes = (cl.count[c][:, None] - first[None, :]).clamp(0, sub)
        in_s = (tn_s <= t.reshape(-1)[rq][:, None]) & (tn_s <= tfg_s) & (sizes > 0)
        for a, x in ((sub_slabs, (sizes > 0).sum(dim=1)), (sub_blocks, in_s.sum(dim=1)), (tests, (sizes * in_s).sum(dim=1))):
            a.index_add_(0, rq + s * pk, x.to(torch.int64))
    return VisitWork(*(x.reshape(n_pk, pk) for x in acc))
