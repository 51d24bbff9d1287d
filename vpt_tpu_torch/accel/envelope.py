"""Ray-vs-group envelope: per-ray sort keys and per-supertile entry tables
(port of vpt_tpu/accel/envelope.py).

Two kernels, each with a plain torch version of the same signature:

  ray_keys          - packs a ray's first `levels` entered groups, in entry
                      order, into an int32 sort key, or (with `diag`) its
                      first entered group and quantised entry depth, the
                      packet trace's "fe" key (CUDA: csrc/envelope.cu
                      vpt_ray_keys, replacing the Pallas _keys_kernel);
  supertile_tables  - for every tile of the sorted rays (a 1024-ray
                      supertile of the stream path, or a packet of the
                      packet trace, VPT_PACKET_SIZE rays) and every
                      group, the minimum slab entry distance, +inf where no
                      ray enters (CUDA: vpt_supertile_tables, replacing the
                      Pallas _tables_kernel).

The slab formula is cluster._slab_tn_tf's: tn starts at t_min, tf at the
ray's tmax, reciprocal directions come in with the caller's 1e-20 guard.
The plain versions reduce the dense (N, Gp) `slab_entry` matrix.  The
kernels walk two levels: the union box of each CHUNK consecutive groups
first (`union_boxes`), a chunk's member groups only where the ray enters
the union and could still change the result.  The cull is exact
(csrc/envelope.cu says why), so both give the same results;
`envelope_work` counts the walk's work.  A wrapper takes the plain version
for CPU tensors and launches the kernel for CUDA tensors; there is no
fallback from one to the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpt_tpu_torch.accel import kernels

SUPERTILE = 1024
DEPTH_STEPS = 1024  # the "fe" key's entry-depth levels per group (cluster.py:507-510)
CHUNK = 8  # groups per union box
WARP = 32
_CHUNK_RAYS = 32768  # rays per slab block in the plain versions


def slab_entry(origin, inv, tmax, gmin_pad, gmax_pad, t_min: float):
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


def union_boxes(gmin_pad, gmax_pad):
    """(3, Gp / CHUNK) lo / hi: the union box of each CHUNK consecutive
    group boxes, padding included, each box's lo / hi taken in either order
    (as the kernels stage them)."""
    lo = torch.minimum(gmin_pad, gmax_pad).reshape(3, -1, CHUNK).amin(dim=2)
    hi = torch.maximum(gmin_pad, gmax_pad).reshape(3, -1, CHUNK).amax(dim=2)
    return lo, hi


def _check_groups(gmin_pad) -> None:
    if gmin_pad.shape[1] % CHUNK:
        raise ValueError(f"the envelope takes a multiple of {CHUNK} padded groups, got {gmin_pad.shape[1]}")


def fe_key(first, v, gp: int, diag):
    """The "fe" key of cluster.py:504-511: the first entered group * 1024 +
    its entry v quantised as clip(v / max(diag, 1e-20) * 256, 0, 1023);
    Gp * 1024 where the ray enters no group."""
    q = torch.clamp(v / torch.clamp(diag, min=1e-20) * 256.0, 0.0, DEPTH_STEPS - 1.0)
    entered = torch.isfinite(v)
    return torch.where(entered, first, gp) * DEPTH_STEPS + torch.where(entered, q, 0.0).to(torch.int32)


def ray_keys_plain(origin, inv, tmax, gmin_pad, gmax_pad, t_min: float, levels: int, diag=None):
    gp = gmin_pad.shape[1]
    out = []
    for s in range(0, origin.shape[0], _CHUNK_RAYS):
        rows = slice(s, s + _CHUNK_RAYS)
        ent = slab_entry(origin[rows], inv[rows], tmax[rows], gmin_pad, gmax_pad, t_min)
        v0, g0 = torch.min(ent, dim=1)  # first minimum: ties go to the lower id
        l0 = torch.where(torch.isfinite(v0), g0, gp)
        if diag is not None:
            out.append(fe_key(g0, v0, gp, diag))
        elif levels == 2:
            ent = ent.scatter(1, g0[:, None], torch.inf)
            v1, g1 = torch.min(ent, dim=1)
            l1 = torch.where(torch.isfinite(v1), g1, gp)
            out.append(l0 * (gp + 1) + l1)
        else:
            out.append(l0)
    return torch.cat(out).to(torch.int32)


def ray_keys(origin, inv, tmax, gmin_pad, gmax_pad, t_min: float, levels: int, diag=None):
    """(N,) int32 key: levels=2 -> g0 * (Gp + 1) + g1, levels=1 -> g0, with
    the sentinel Gp for an absent entry; levels=1 with `diag` (a (1,)
    float32 tensor, the root box's diagonal) -> the "fe" key (`fe_key`).
    origin/inv (N, 3), tmax (N,), gmin_pad/gmax_pad (3, Gp), Gp a multiple
    of CHUNK."""
    if levels not in (1, 2):
        raise ValueError(f"ray_keys takes levels 1 or 2, got {levels}")
    if diag is not None and (levels != 1 or diag.shape != (1,) or diag.dtype != torch.float32):
        raise ValueError("ray_keys' fe key takes levels 1 and diag a (1,) float32 tensor")
    _check_groups(gmin_pad)
    if not origin.is_cuda:
        return ray_keys_plain(origin, inv, tmax, gmin_pad, gmax_pad, t_min, levels, diag)
    n, gp = origin.shape[0], gmin_pad.shape[1]
    if diag is not None and gp * DEPTH_STEPS >= 2**31:
        raise ValueError(f"the fe key of {gp} padded groups overflows int32")
    key = torch.empty(n, dtype=torch.int32, device=origin.device)
    f32 = torch.float32
    kernels.launch(
        "vpt_ray_keys", "ray_keys",
        kernels.ptr(origin, f32), kernels.ptr(inv, f32), kernels.ptr(tmax, f32), kernels.ptr(gmin_pad, f32),
        kernels.ptr(gmax_pad, f32), n, gp, float(t_min), int(levels) if diag is None else 3,
        None if diag is None else kernels.ptr(diag, f32), kernels.ptr(key, torch.int32),
    )
    return key


def _check_tile(n: int, tile: int) -> None:
    if tile < 1:
        raise ValueError(f"supertile_tables takes tiles of at least one ray (VPT_PACKET_SIZE), got {tile}")
    if n % tile:
        raise ValueError(f"supertile_tables needs a multiple of {tile} rays, got {n}")


def supertile_tables_plain(origin, inv, tmax_eff, gmin_pad, gmax_pad, t_min: float, tile: int = SUPERTILE):
    _check_tile(origin.shape[0], tile)
    gp = gmin_pad.shape[1]
    step = max(1, _CHUNK_RAYS // tile) * tile  # whole tiles per slab block
    out = []
    for s in range(0, origin.shape[0], step):
        rows = slice(s, s + step)
        ent = slab_entry(origin[rows], inv[rows], tmax_eff[rows], gmin_pad, gmax_pad, t_min)
        out.append(ent.reshape(-1, tile, gp).amin(dim=1))
    return torch.cat(out)


def supertile_tables(origin, inv, tmax_eff, gmin_pad, gmax_pad, t_min: float, tile: int = SUPERTILE):
    """(N // tile, Gp) minimum entry per (tile, group), +inf where no ray
    of the tile enters; tile is 1024 (supertiles) or a packet's rays (any
    VPT_PACKET_SIZE; the kernel is compiled for tiles of 128, 256, 512 and
    1024 rays and runs other tiles in its run-time-tile build).  Rays arrive sorted; tmax_eff already folds the
    active mask: the stream path gives inactive rays t_min (JAX's rule,
    which still enters a box around the origin), the packet cull -inf
    (enters nothing).  Any t_min: the kernel orders entries by an
    order-preserving key of their bits."""
    _check_tile(origin.shape[0], tile)
    _check_groups(gmin_pad)
    if not origin.is_cuda:
        return supertile_tables_plain(origin, inv, tmax_eff, gmin_pad, gmax_pad, t_min, tile)
    n, gp = origin.shape[0], gmin_pad.shape[1]
    out = torch.empty((n // tile, gp), dtype=torch.float32, device=origin.device)
    f32 = torch.float32
    kernels.launch(
        "vpt_supertile_tables", "supertile_tables",
        kernels.ptr(origin, f32), kernels.ptr(inv, f32), kernels.ptr(tmax_eff, f32), kernels.ptr(gmin_pad, f32),
        kernels.ptr(gmax_pad, f32), n, gp, float(t_min), int(tile), kernels.ptr(out, f32),
    )
    return out


class EnvelopeWork(NamedTuple):
    """Per ray, the work of the envelope's two-level walk."""

    groups: torch.Tensor  # (N,) i64 groups entered
    chunks: torch.Tensor  # (N,) i64 union boxes entered
    slabs: torch.Tensor  # (N,) i64 slab tests: every union box and the CHUNK members of each entered one
    warp_chunks: torch.Tensor  # (N,) i64 union boxes entered by any ray of the ray's 32-ray warp (input order)


def envelope_work(origin, inv, tmax, gmin_pad, gmax_pad, t_min: float) -> EnvelopeWork:
    """The work of the two-level walk for these rays, in their order: what
    a one-thread-per-ray walk with the static gate (union entered) tests.
    A dense pass tests Gp slabs per ray."""
    ulo, uhi = union_boxes(gmin_pad, gmax_pad)
    n_chunks = ulo.shape[1]
    groups, chunks, warp = [], [], []
    for s in range(0, origin.shape[0], _CHUNK_RAYS):
        rows = slice(s, s + _CHUNK_RAYS)
        groups.append(torch.isfinite(slab_entry(origin[rows], inv[rows], tmax[rows], gmin_pad, gmax_pad,
                                                t_min)).sum(dim=1))
        enter = torch.isfinite(slab_entry(origin[rows], inv[rows], tmax[rows], ulo, uhi, t_min))
        chunks.append(enter.sum(dim=1))
        n = enter.shape[0]
        lanes = torch.nn.functional.pad(enter, (0, 0, 0, (-n) % WARP)).reshape(-1, WARP, n_chunks)
        warp.append(lanes.any(dim=1).sum(dim=1).repeat_interleave(WARP)[:n])
    chunks = torch.cat(chunks)
    return EnvelopeWork(groups=torch.cat(groups), chunks=chunks, slabs=n_chunks + CHUNK * chunks,
                        warp_chunks=torch.cat(warp))
