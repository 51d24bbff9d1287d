"""Pixel-order tiling (port of vpt_tpu/core/tiling.py): rays are laid out in
8x8 screen tiles so neighbouring wavefront slots are neighbouring pixels."""

from __future__ import annotations

import numpy as np
import torch

TILE = 8


def tiled_pixel_order(width: int, height: int):
    """(pixel_xy (N,2) f32, pixel_index (N,) u32, scatter (N,) i64, (wp, hp))
    in tile-major order; `scatter[i]` is ray i's row-major index into the
    padded image."""
    wp = -(-width // TILE) * TILE
    hp = -(-height // TILE) * TILE
    ty, tx = np.meshgrid(np.arange(hp // TILE), np.arange(wp // TILE), indexing="ij")
    iy, ix = np.meshgrid(np.arange(TILE), np.arange(TILE), indexing="ij")
    px = (tx[:, :, None, None] * TILE + ix[None, None]).reshape(-1)
    py = (ty[:, :, None, None] * TILE + iy[None, None]).reshape(-1)
    pixel_xy = np.stack([px, py], axis=-1).astype(np.float32)
    pixel_index = (px + width * py).astype(np.uint32)
    scatter = py.astype(np.int64) * wp + px.astype(np.int64)
    return pixel_xy, pixel_index, scatter, (wp, hp)


def scatter_to_image(radiance: torch.Tensor, scatter: torch.Tensor, padded, width: int, height: int):
    """(N, 3) tile-ordered radiance -> (height, width, 3) row-major image."""
    wp, hp = padded
    flat = torch.zeros((wp * hp, 3), dtype=radiance.dtype, device=radiance.device)
    flat[scatter] = radiance
    return flat.reshape(hp, wp, 3)[:height, :width]
