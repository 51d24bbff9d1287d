"""Camera matrices and primary-ray generation (port of vpt_tpu/core/camera.py).

`look_at` / `perspective` build the host-side matrices (numpy) and
`FlyCamera` keeps yaw/pitch camera state (FlyCamera.{h,cpp});
`generate_primary_rays` turns pixels into rays with AA jitter and thin-lens
depth of field, drawing from the RNG in the reference's order.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class FlyCamera:
    """WASD/mouse-style camera state; yaw/pitch Euler angles in degrees, GLM
    conventions: yaw = -90 faces -Z."""

    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = -90.0
    pitch: float = 0.0
    fov_deg: float = 45.0
    aspect: float = 1.0
    world_up: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 1, 0], np.float32))

    @property
    def front(self) -> np.ndarray:
        cy, sy = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        cp, sp = np.cos(np.radians(self.pitch)), np.sin(np.radians(self.pitch))
        f = np.array([cy * cp, sp, sy * cp], np.float32)
        return f / np.linalg.norm(f)

    def move(self, direction: str, amount: float) -> None:
        f = self.front
        r = np.cross(f, self.world_up)
        r /= np.linalg.norm(r)
        delta = {
            "forward": f, "back": -f, "right": r, "left": -r,
            "up": self.world_up, "down": -self.world_up,
        }[direction]
        self.position = (self.position + amount * delta).astype(np.float32)

    def rotate(self, dyaw: float, dpitch: float) -> None:
        self.yaw += dyaw
        self.pitch = float(np.clip(self.pitch + dpitch, -89.0, 89.0))

    def view_matrix(self) -> np.ndarray:
        return look_at(self.position, self.position + self.front, self.world_up)

    def proj_matrix(self, znear: float = 0.1, zfar: float = 1000.0) -> np.ndarray:
        return perspective(np.radians(self.fov_deg), self.aspect, znear, zfar)

    def view_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.view_matrix()).astype(np.float32)

    def proj_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.proj_matrix()).astype(np.float32)

    @staticmethod
    def from_matrices(view: np.ndarray, proj: np.ndarray) -> "FlyCamera":
        """From arbitrary view / projection matrices (FlyCamera.cpp:110-140)."""
        vi = np.linalg.inv(view)
        pos = vi[:3, 3]
        front = -vi[:3, 2]
        yaw = float(np.degrees(np.arctan2(front[2], front[0])))
        pitch = float(np.degrees(np.arcsin(np.clip(front[1], -1, 1))))
        fovy = 2.0 * np.arctan(1.0 / abs(proj[1, 1]))
        aspect = abs(proj[1, 1] / proj[0, 0])
        return FlyCamera(position=pos.astype(np.float32), yaw=yaw, pitch=pitch,
                         fov_deg=float(np.degrees(fovy)), aspect=aspect)


def generate_primary_rays(
    view_inverse: torch.Tensor,  # (4, 4)
    proj_inverse: torch.Tensor,  # (4, 4)
    pixel_xy: torch.Tensor,  # (N, 2) float pixel coordinates
    resolution,  # (width, height)
    rng_state: torch.Tensor,  # (N,) int64-held uint32
    focus_distance: torch.Tensor,  # 0-d float32
    dof_strength: torch.Tensor,  # 0-d float32
):
    """(state, origin, direction): two uniforms for AA jitter, then two for
    the lens disk, as in RayGen.slang:35-50.  The lens parameters are read on
    the device, so a captured step follows them."""
    width, height = resolution
    rng_state, jit2 = rng.next_float2(rng_state)
    pixel_center = pixel_xy + 0.5 + (jit2 - 0.5)
    d = torch.stack([pixel_center[:, 0] / width, pixel_center[:, 1] / height], dim=-1) * 2.0 - 1.0

    origin = view_inverse[:3, 3].expand(pixel_xy.shape[0], 3)
    ones = torch.ones_like(d[:, 0])
    target_h = torch.stack([d[:, 0], d[:, 1], ones, ones], dim=-1) @ proj_inverse.T
    target = normalize(target_h[:, :3])
    direction = target @ view_inverse[:3, :3].T

    focus_point = origin + direction * torch.clamp(focus_distance, min=0.001)
    rng_state, u2 = rng.next_float2(rng_state)
    theta = (2.0 * math.pi) * u2[:, 0]
    r = torch.sqrt(u2[:, 1])
    disk = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1) * 0.5 * dof_strength

    origin = origin + disk[:, 0:1] * view_inverse[:3, 0] + disk[:, 1:2] * view_inverse[:3, 1]
    direction = normalize(focus_point - origin)
    return rng_state, origin, direction
