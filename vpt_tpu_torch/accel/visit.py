"""Kernel 5, the packet visit (port of vpt_tpu/accel/visit_kernel.py).

Every packet of rays marches its entry-sorted candidate groups front to
back.  The march runs while the next candidate's entry distance is below
the packet's cap, the largest best t of its live rays.  For each of a
group's member clusters:

  1. a packet-level gate: does any ray enter the cluster's world box, with
     tf = best t for live rays and t_min for the others?
  2. the rays move to the cluster's instance space (direction unnormalised);
  3. for each of the 8 sub-blocks, a per-ray slab test of the sub-block's
     mesh-local box against the current best t, then Moller-Trumbore over
     its 16 triangles for the rays that entered.  Within a sub-block the
     smallest triangle index wins a t tie; across sub-blocks and clusters
     only a strictly closer hit replaces the current one.

"Live" rays are the active ones; with `any_hit`, those still without a hit.
`visit_trace` launches CUDA csrc/visit.cu vpt_visit (replacing the Pallas
_visit_kernel) for CUDA tensors and `visit_trace_plain` for CPU tensors.
The plain version keeps the kernel's gates, in the kernel's order, so the
two agree exactly, ties included.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.accel import kernels
from vpt_tpu_torch.accel.traverse import guarded_inverse, instance_space, moller_trumbore_scalar, slab
from vpt_tpu_torch.scene.types import ClusterData

F32, I32 = torch.float32, torch.int32
PACKET = 512  # rays per packet, one thread each: vpt_visit's fixed block size
_PACKETS = 64  # packets per block of the plain version


def _group_size(cl: ClusterData) -> int:
    return cl.count.shape[0] // cl.group_min.shape[0]


def _visit_block(nvis, order, entry, o, d, act, tmax, cl: ClusterData, t_min: float, any_hit: bool):
    """The plain visit of one block of packets: (t, tri, u, v), each (c, pk)."""
    dev = o.device
    c, pk = act.shape
    gp = order.shape[1]
    group_size = _group_size(cl)
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
    members = torch.arange(group_size, device=dev)

    def live_rays():
        return act & (tri < 0) if any_hit else act

    cont = nvis > 0
    w = 0
    while w < gp and bool(cont.any()):
        cids = torch.where(cont, order[:, w], 0).to(torch.int64)[:, None] * group_size + members  # (c, M)
        box = cl.aabbs[cids]  # (c, M, 6)
        tn_m, tfg_m = slab(o[:, :, None, :], inv[:, :, None, :], box[:, None, :, :3], box[:, None, :, 3:], t_min)
        for m in range(group_size):
            cid = cids[:, m]
            tf = torch.where(live_rays(), t, t_min)
            gate = ((tn_m[..., m] <= tf) & (tn_m[..., m] <= tfg_m[..., m])).any(dim=1)
            go = cont & gate & (cl.count[cid] > 0)
            if not bool(go.any()):
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
            ok = ok & (kidx < cl.count[cid][:, None, None]) & go[:, None, None]
            sb = cl.sub_aabbs[blk]  # (c, n_sub, 6)
            tn_s, tfg_s = slab(lo3[:, :, None, :], linv[:, :, None, :], sb[:, None, :, :3], sb[:, None, :, 3:], t_min)
            base = cl.start[cid][:, None]
            for s in range(n_sub):
                enter = (tn_s[..., s] <= t) & (tn_s[..., s] <= tfg_s[..., s]) & live_rays()
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
    if pk != PACKET or cl.tris.shape[2] % cl.sub_aabbs.shape[1]:
        raise ValueError(f"vpt_visit takes {PACKET}-ray packets and K divisible by the sub-block count, "
                         f"got {pk} rays and K = {cl.tris.shape[2]}")
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
        n_pk, order.shape[1], _group_size(cl), cl.tris.shape[2], float(t_min), int(any_hit),
        int(cl.inv_rows.shape[0] > 1),
        *(p(x, dt) for x, dt in zip(out, (F32, I32, F32, F32))),
    )
    return out
