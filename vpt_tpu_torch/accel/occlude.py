"""Any-hit occlusion over the cluster tables (port of vpt_tpu/accel/occlude.py).

A shadow ray is blocked iff some triangle whose virtual id differs from the
ray's `exclude_tri` lies in (t_min, t_max).  Sky NEE passes -1 (any hit
blocks); light NEE passes the sampled triangle, which then never blocks its
own sample.  The wrapper sorts by the first entered group only and reuses
the stream path's band tables; the trace is kernel 4, `occlude_trace`: CUDA
csrc/trace.cu vpt_occlude (replacing the Pallas _occlude_kernel) for CUDA
tensors, `occlude_trace_plain` for CPU tensors.  Both count a triangle only
in sub-blocks whose mesh-local box the ray enters before its tmax (the
Pallas kernel's sub-block cull), so they agree exactly.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.accel import kernels
from vpt_tpu_torch.accel.stream import I32, Bands, layout_arguments, pair_results, prepare_bands, table_pointers, unsort
from vpt_tpu_torch.accel.traverse import T_MAX, T_MIN
from vpt_tpu_torch.scene.types import ClusterData


def nearest_blocker_plain(bands: Bands, cl: ClusterData, t_min: float):
    """(N,) f32 per sorted ray: t of the nearest candidate triangle other
    than the ray's exclude id in (t_min, tmax), +inf where there is none.
    Triangles count only in sub-blocks the ray enters before its tmax, as in
    the kernel.  Payload = (active, exclude_tri)."""
    act, extri = bands.payload[0] > 0, bands.payload[1]

    def nearest(r, c, t, u, v, valid):
        k = torch.arange(t.shape[1], device=t.device)
        other = (cl.start[c][:, None] + k[None, :]) != extri[r][:, None]
        return (torch.where(valid & other, t, torch.inf).amin(dim=1),)

    near = torch.full((bands.origin.shape[0],), torch.inf, dtype=torch.float32, device=bands.origin.device)
    for r, _, (tp,) in pair_results(bands, cl, act, t_min, nearest):
        near = near.scatter_reduce(0, r, tp, reduce="amin")
    return near


def occlude_trace_plain(bands: Bands, cl: ClusterData, t_min: float):
    """(N,) int32 per sorted ray: 1 if a triangle blocks it
    (`nearest_blocker_plain` is finite)."""
    return torch.isfinite(nearest_blocker_plain(bands, cl, t_min)).to(torch.int32)


def occlude_trace(bands: Bands, cl: ClusterData, t_min: float):
    """Kernel 4: (N,) int32 blocked flag per sorted ray."""
    if not bands.origin.is_cuda:
        return occlude_trace_plain(bands, cl, t_min)
    blocked = torch.empty(bands.origin.shape[0], dtype=torch.int32, device=bands.origin.device)
    kernels.launch(
        "vpt_occlude", "occlude", *table_pointers(bands, cl, bands.payload[:2]),
        *layout_arguments(bands, cl, t_min), kernels.ptr(blocked, I32),
    )
    return blocked


def shadow_bands(origin, direction, cl: ClusterData, t_min, t_max, active, exclude_tri) -> Bands:
    """The bands of a shadow wavefront: keys of the first entered group only,
    payload = (active, exclude_tri)."""
    return prepare_bands(origin, direction, cl, t_min, t_max, active, levels=1,
                         payload=(active.to(torch.int32), exclude_tri.to(torch.int32)), pad_payload=(0, -1))


def occlude_stream(origin, direction, cl: ClusterData, t_min=T_MIN, t_max=T_MAX,
                   active=None, exclude_tri=None):
    """(N,) bool: does a triangle with virtual id != exclude_tri intersect
    the ray in (t_min, t_max)?"""
    n = origin.shape[0]
    dev = origin.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if exclude_tri is None:
        exclude_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    bands = shadow_bands(origin, direction, cl, t_min, t_max, active, exclude_tri)
    return unsort(bands, occlude_trace(bands, cl, t_min)) > 0
