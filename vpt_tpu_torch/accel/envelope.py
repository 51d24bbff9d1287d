"""Ray-vs-group envelope: per-ray sort keys and per-supertile entry tables
(port of vpt_tpu/accel/envelope.py).

Two kernels, each with a plain torch version of the same signature:

  ray_keys          - packs a ray's first `levels` entered groups, in entry
                      order, into an int32 sort key (CUDA: csrc/envelope.cu
                      vpt_ray_keys, replacing the Pallas _keys_kernel);
  supertile_tables  - for every 1024-ray supertile of the sorted rays and
                      every group, the minimum slab entry distance, +inf
                      where no ray enters (CUDA: vpt_supertile_tables,
                      replacing the Pallas _tables_kernel).

The slab formula is cluster._slab_tn_tf's: tn starts at t_min, tf at the
ray's tmax, reciprocal directions come in with the caller's 1e-20 guard.
A wrapper takes the plain version for CPU tensors and launches the kernel
for CUDA tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.accel import kernels

SUPERTILE = 1024
_CHUNK = 32768  # rays per slab block in the plain versions


def _entry(origin, inv, tmax, gmin_pad, gmax_pad, t_min: float):
    """(n, Gp) slab entry distances, +inf where the ray does not enter."""
    n = origin.shape[0]
    gp = gmin_pad.shape[1]
    tn = torch.full((n, gp), t_min, dtype=torch.float32, device=origin.device)
    tf = tmax[:, None].expand(n, gp)
    for ax in range(3):
        o = origin[:, ax : ax + 1]
        i = inv[:, ax : ax + 1]
        s0 = (gmin_pad[ax][None, :] - o) * i
        s1 = (gmax_pad[ax][None, :] - o) * i
        tn = torch.maximum(tn, torch.minimum(s0, s1))
        tf = torch.minimum(tf, torch.maximum(s0, s1))
    return torch.where(tn <= tf, tn, torch.inf)


def ray_keys_plain(origin, inv, tmax, gmin_pad, gmax_pad, t_min: float, levels: int):
    gp = gmin_pad.shape[1]
    out = []
    for s in range(0, origin.shape[0], _CHUNK):
        ent = _entry(origin[s : s + _CHUNK], inv[s : s + _CHUNK], tmax[s : s + _CHUNK], gmin_pad, gmax_pad, t_min)
        v0, g0 = torch.min(ent, dim=1)  # first minimum: ties go to the lower id
        l0 = torch.where(torch.isfinite(v0), g0, gp)
        if levels == 2:
            ent = ent.scatter(1, g0[:, None], torch.inf)
            v1, g1 = torch.min(ent, dim=1)
            l1 = torch.where(torch.isfinite(v1), g1, gp)
            out.append(l0 * (gp + 1) + l1)
        else:
            out.append(l0)
    return torch.cat(out).to(torch.int32)


def ray_keys(origin, inv, tmax, gmin_pad, gmax_pad, t_min: float, levels: int):
    """(N,) int32 key: levels=2 -> g0 * (Gp + 1) + g1, levels=1 -> g0, with
    the sentinel Gp for an absent entry.  origin/inv (N, 3), tmax (N,),
    gmin_pad/gmax_pad (3, Gp)."""
    if not origin.is_cuda:
        return ray_keys_plain(origin, inv, tmax, gmin_pad, gmax_pad, t_min, levels)
    n, gp = origin.shape[0], gmin_pad.shape[1]
    key = torch.empty(n, dtype=torch.int32, device=origin.device)
    f32 = torch.float32
    kernels.launch(
        "vpt_ray_keys", "ray_keys",
        kernels.ptr(origin, f32), kernels.ptr(inv, f32), kernels.ptr(tmax, f32), kernels.ptr(gmin_pad, f32),
        kernels.ptr(gmax_pad, f32), n, gp, float(t_min), int(levels), kernels.ptr(key, torch.int32),
    )
    return key


def supertile_tables_plain(origin, inv, tmax_eff, gmin_pad, gmax_pad, t_min: float):
    gp = gmin_pad.shape[1]
    out = []
    for s in range(0, origin.shape[0], _CHUNK):
        ent = _entry(origin[s : s + _CHUNK], inv[s : s + _CHUNK], tmax_eff[s : s + _CHUNK], gmin_pad, gmax_pad, t_min)
        out.append(ent.reshape(-1, SUPERTILE, gp).amin(dim=1))
    return torch.cat(out)


def supertile_tables(origin, inv, tmax_eff, gmin_pad, gmax_pad, t_min: float):
    """(N // 1024, Gp) minimum entry per (supertile, group), +inf where no
    ray of the supertile enters.  Rays arrive sorted; tmax_eff already folds
    the active mask (inactive -> t_min)."""
    if origin.shape[0] % SUPERTILE:
        raise ValueError("supertile_tables needs a multiple of 1024 rays")
    if not origin.is_cuda:
        return supertile_tables_plain(origin, inv, tmax_eff, gmin_pad, gmax_pad, t_min)
    n, gp = origin.shape[0], gmin_pad.shape[1]
    out = torch.empty((n // SUPERTILE, gp), dtype=torch.float32, device=origin.device)
    f32 = torch.float32
    kernels.launch(
        "vpt_supertile_tables", "supertile_tables",
        kernels.ptr(origin, f32), kernels.ptr(inv, f32), kernels.ptr(tmax_eff, f32), kernels.ptr(gmin_pad, f32),
        kernels.ptr(gmax_pad, f32), n, gp, float(t_min), kernels.ptr(out, f32),
    )
    return out
