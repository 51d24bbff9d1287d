"""Camera matrices and primary-ray generation (port of vpt_tpu/core/camera.py).

`look_at` / `perspective` build the host-side matrices (numpy);
`generate_primary_rays` turns pixels into rays with AA jitter and thin-lens
depth of field, drawing from the RNG in the reference's order.  The
interactive `FlyCamera` is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import normalize


def look_at(eye, center, up) -> np.ndarray:
    """GLM-style right-handed lookAt view matrix (row-major, m @ v)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy_rad: float, aspect: float, znear: float = 0.1, zfar: float = 1000.0) -> np.ndarray:
    """GLM-style perspective with the Vulkan Y flip."""
    f = 1.0 / np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = -f
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    m[3, 2] = -1.0
    return m


def generate_primary_rays(
    view_inverse: torch.Tensor,  # (4, 4)
    proj_inverse: torch.Tensor,  # (4, 4)
    pixel_xy: torch.Tensor,  # (N, 2) float pixel coordinates
    resolution,  # (width, height)
    rng_state: torch.Tensor,  # (N,) int64-held uint32
    focus_distance: float,
    dof_strength: float,
):
    """(state, origin, direction): two uniforms for AA jitter, then two for
    the lens disk, as in RayGen.slang:35-50."""
    width, height = resolution
    rng_state, jit2 = rng.next_float2(rng_state)
    pixel_center = pixel_xy + 0.5 + (jit2 - 0.5)
    d = torch.stack([pixel_center[:, 0] / width, pixel_center[:, 1] / height], dim=-1) * 2.0 - 1.0

    origin = view_inverse[:3, 3].expand(pixel_xy.shape[0], 3)
    ones = torch.ones_like(d[:, 0])
    target_h = torch.stack([d[:, 0], d[:, 1], ones, ones], dim=-1) @ proj_inverse.T
    target = normalize(target_h[:, :3])
    direction = target @ view_inverse[:3, :3].T

    focus_point = origin + direction * max(float(focus_distance), 0.001)
    rng_state, u2 = rng.next_float2(rng_state)
    theta = (2.0 * math.pi) * u2[:, 0]
    r = torch.sqrt(u2[:, 1])
    disk = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1) * 0.5 * dof_strength

    origin = origin + disk[:, 0:1] * view_inverse[:3, 0] + disk[:, 1:2] * view_inverse[:3, 1]
    direction = normalize(focus_point - origin)
    return rng_state, origin, direction
