"""Sharded rendering: the pixel x spp wavefront over a torch.distributed
device mesh (port of vpt_tpu/dist/mesh.py).

A (tile, spp) `DeviceMesh` with JAX's axes:

* ``tile`` -- pixels are partitioned across this axis (each rank owns a
  contiguous chunk of the row-major pixels),
* ``spp``  -- samples are partitioned across this axis and averaged.

One process per device, as PyTorch runs it, takes the place of JAX's single
controller with `shard_map`: every rank calls `render_sharded` with the same
arguments and gets the whole image back.

Determinism: RNG seeds are a pure function of (pixel index, sample index),
with sample indices offset by ``spp_coord * local_samples``, so a (T, S)
mesh render draws exactly the sample set of a one-process ``n_samples``
render, and the image does not depend on the mesh shape.

The image is reduced by one ``all_reduce(SUM)`` over the world of a
full-frame buffer, into which each rank writes its chunk (its pixels' mean
over its local samples) and zeros elsewhere, divided by ``n_spp`` after
the sum.  That is one collective where the other form (an ``all_reduce``
over the ``spp`` group, then the list form of ``all_gather`` over ``tile``)
takes two; the buffer is the frame, 3 MB at 512x512, small beside a
dispatch; and ``all_reduce`` is the one collective that gloo runs on CUDA
tensors as well as on CPU ones, so a dry run of several ranks on one card
needs nothing else.  Adding the zeros is exact, so a (T, 1) mesh gives each
pixel its one-process value bit for bit.  The segment counts are summed
over the world the same way (pad lanes count, as in JAX).

JAX caches one compiled executable per static configuration
(`functools.lru_cache` on `_sharded_step`); the port's counterpart is the
step cache of render/graphs.py, which every rank's `render_samples`
reaches: each rank captures its loop once per configuration and launches
it as one graph, its pixels and sample offset copied into the step's
buffers.
The scene is replicated on every rank.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from vpt_tpu_torch.render import integrator


def make_mesh(tile: int | None = None, spp: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """A (tile, spp) mesh over the world, rank r at (r // spp, r % spp) as
    JAX's ``np.array(devices).reshape(tile, spp)``.  Defaults: all ranks on
    the tile axis.  Without a running default group, `init_device_mesh`
    starts it from torchrun's environment.  On "cuda" each rank's device is
    ``cuda:{local_rank % device_count}``, set before the group starts; there
    is no fallback to another device type or backend."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device_type='cuda') but torch.cuda.is_available() is False")
        rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    n = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
    if tile is None:
        tile = n // spp
    assert tile * spp == n, f"mesh {tile}x{spp} != {n} devices"
    return init_device_mesh(device_type, (tile, spp), mesh_dim_names=("tile", "spp"))


def pixel_grid(width: int, height: int):
    """Row-major (pixel_xy (N, 2) f32, pixel_index (N,) i64) with the
    collision-free stream ids x + width * y (uint32 values)."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    pixel_xy = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32)
    pixel_index = (xs.reshape(-1) + width * ys.reshape(-1)).astype(np.uint32).astype(np.int64)
    return pixel_xy, pixel_index


def _check_samples(n_samples: int, n_spp: int):
    assert n_samples >= n_spp and n_samples % n_spp == 0, (
        f"n_samples ({n_samples}) must be a positive multiple of the spp axis ({n_spp})"
    )


def _pad_pixels(pixel_xy, pixel_index, n_tile: int, n_real_streams: int):
    """Pad the pixel arrays to a tile-axis multiple.  Pad lanes trace real
    (discarded) paths through pixel (0, 0) with RNG stream ids past the
    frame's range, so they perturb nothing and collide with nothing."""
    n = pixel_xy.shape[0]
    pad = (-n) % n_tile
    if pad == 0:
        return pixel_xy, pixel_index, 0
    pixel_xy = np.concatenate([pixel_xy, np.zeros((pad, 2), np.float32)], axis=0)
    pad_index = (n_real_streams + np.arange(pad, dtype=np.uint32)).astype(np.uint32)
    pixel_index = np.concatenate([pixel_index, pad_index.astype(np.int64)])
    return pixel_xy, pixel_index, pad


def _mesh_shape(mesh: DeviceMesh):
    """(n_tile, n_spp, tile coordinate, spp coordinate) of this rank."""
    names = mesh.mesh_dim_names
    assert names == ("tile", "spp"), f"the mesh's axes must be ('tile', 'spp'), not {names}"
    assert mesh.size() == dist.get_world_size(), "the mesh must span the world"
    tile_c, spp_c = mesh.get_coordinate()
    return mesh.size(0), mesh.size(1), tile_c, spp_c


def _render_pixels(scene_data, meta, flags, params, pixel_xy, pixel_index, resolution, frame_seed, local_samples,
                   mesh: DeviceMesh):
    """This rank's tile chunk of the (padded) pixel arrays at its spp offset,
    reduced over the world: ((N, 3) radiance of every pixel on every rank,
    int64 (1,) segment total), on the device `scene_data` lives on."""
    n_tile, n_spp, tile_c, spp_c = _mesh_shape(mesh)
    dev = scene_data.tri_p0.device
    chunk = pixel_xy.shape[0] // n_tile
    rows = slice(tile_c * chunk, (tile_c + 1) * chunk)
    radiance, segs, _ = integrator.render_samples(
        scene_data, meta, flags, params, torch.as_tensor(pixel_xy[rows], device=dev),
        torch.as_tensor(pixel_index[rows], device=dev), resolution, frame_seed, local_samples,
        sample_offset=spp_c * local_samples,
    )
    frame = torch.zeros((pixel_xy.shape[0], 3), dtype=radiance.dtype, device=dev)
    frame[rows] = radiance
    segs = segs.reshape(1)
    dist.all_reduce(frame)
    dist.all_reduce(segs)
    return frame / n_spp, segs


def render_sharded(scene_data, meta, flags, params, resolution, frame_seed, n_samples: int, mesh: DeviceMesh):
    """Render one frame with pixels sharded over ``tile`` and samples over
    ``spp``.  Returns ((H, W, 3) radiance, int64 device scalar segment
    count), the image whole on every rank.

    ``n_samples`` is the total spp; it must be divisible by the spp axis.
    """
    width, height = resolution
    n_tile, n_spp = mesh.size(0), mesh.size(1)
    _check_samples(n_samples, n_spp)
    pixel_xy, pixel_index = pixel_grid(width, height)
    # Non-divisible pixel counts pad to a tile multiple; the pad is dropped.
    pixel_xy, pixel_index, pad = _pad_pixels(pixel_xy, pixel_index, n_tile, width * height)
    radiance, segs = _render_pixels(scene_data, meta, flags, params, pixel_xy, pixel_index, resolution, frame_seed,
                                    n_samples // n_spp, mesh)
    return radiance[: width * height].reshape(height, width, 3), segs[0]


def render_tiled_final_frame(scene_data, meta, flags, params, resolution, n_samples, mesh: DeviceMesh,
                             tile_rows: int = 4, frame_seed: int = 1234):
    """High-res / high-spp final frame: a host loop over row bands, each band
    rendered sharded (the reference's split-screen chunking,
    PathTracer.cpp:141-152, which bounds a dispatch's device time).  Short
    bands pad to the full band shape, as JAX's do to reuse one executable,
    so the segment total counts the same pad lanes.  Returns (host (H, W, 3)
    float32 image, float segment total)."""
    width, height = resolution
    band_h = -(-height // tile_rows)  # ceil: the last band may be short
    n_tile, n_spp = mesh.size(0), mesh.size(1)
    _check_samples(n_samples, n_spp)
    local_samples = n_samples // n_spp

    out = np.zeros((height, width, 3), np.float32)
    total_segs = 0.0
    for b in range(tile_rows):
        y0 = b * band_h
        ys = np.arange(y0, min(y0 + band_h, height))
        if ys.size == 0:
            break
        gy, gx = np.meshgrid(ys, np.arange(width), indexing="ij")
        pixel_xy = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1).astype(np.float32)
        pixel_index = (gx.reshape(-1) + width * gy.reshape(-1)).astype(np.int64)
        n_full = band_h * width
        if pixel_xy.shape[0] < n_full:
            extra = n_full - pixel_xy.shape[0]
            pixel_xy = np.concatenate([pixel_xy, np.zeros((extra, 2), np.float32)])
            pixel_index = np.concatenate([pixel_index, width * height + np.arange(extra, dtype=np.int64)])
        pixel_xy, pixel_index, _ = _pad_pixels(pixel_xy, pixel_index, n_tile, width * height + n_full)
        band, segs = _render_pixels(scene_data, meta, flags, params, pixel_xy, pixel_index, resolution, frame_seed,
                                    local_samples, mesh)
        out[ys[0]: ys[-1] + 1] = band[: ys.size * width].cpu().numpy().reshape(ys.size, width, 3)
        total_segs += float(segs[0])
    return out, total_segs
