"""Any-hit occlusion over the cluster tables (port of vpt_tpu/accel/occlude.py).

A shadow ray is blocked iff some triangle whose virtual id differs from the
ray's `exclude_tri` lies in (t_min, t_max).  Sky NEE passes -1 (any hit
blocks); light NEE passes the sampled triangle, which then never blocks its
own sample.  The wrapper sorts by the first entered group only and reuses
the stream path's band tables; the trace is kernel 4, `occlude_trace`: CUDA
csrc/trace.cu vpt_occlude (replacing the Pallas _occlude_kernel) for CUDA
tensors, `occlude_trace_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.accel import kernels
from vpt_tpu_torch.accel.cluster import GROUP_SIZE
from vpt_tpu_torch.accel.stream import I32, Bands, pair_results, prepare_bands, table_pointers, unsort
from vpt_tpu_torch.accel.traverse import T_MAX, T_MIN
from vpt_tpu_torch.scene.types import ClusterData


def occlude_trace_plain(bands: Bands, cl: ClusterData, t_min: float):
    """(N,) int32 per sorted ray: 1 if any candidate triangle other than the
    ray's exclude id lies in (t_min, tmax).  Payload = (active, exclude_tri)."""
    act, extri = bands.payload[0] > 0, bands.payload[1]

    def any_blocking(r, c, t, u, v, valid):
        k = torch.arange(t.shape[1], device=t.device)
        other = (cl.start[c][:, None] + k[None, :]) != extri[r][:, None]
        return ((valid & other).any(dim=1).to(torch.int32),)

    blocked = torch.zeros(bands.origin.shape[0], dtype=torch.int32, device=bands.origin.device)
    for r, _, (bp,) in pair_results(bands, cl, act, t_min, any_blocking):
        blocked = blocked.scatter_reduce(0, r, bp, reduce="amax")
    return blocked


def occlude_trace(bands: Bands, cl: ClusterData, t_min: float):
    """Kernel 4: (N,) int32 blocked flag per sorted ray."""
    if not bands.origin.is_cuda:
        return occlude_trace_plain(bands, cl, t_min)
    n = bands.origin.shape[0]
    blocked = torch.empty(n, dtype=torch.int32, device=bands.origin.device)
    kernels.launch(
        "vpt_occlude", "occlude", *table_pointers(bands, cl, bands.payload[:2]),
        n, bands.tiles, bands.order.shape[1], GROUP_SIZE, cl.tris.shape[2],
        float(t_min), int(cl.inv_rows.shape[0] > 1), kernels.ptr(blocked, I32),
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
