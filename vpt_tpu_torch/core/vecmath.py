"""Small-vector math over (..., 3) tensors (port of vpt_tpu/core/vecmath.py).

Right-handed, Y-up world space; Z-up tangent space.
"""

from __future__ import annotations

import math

import torch

# Guard for exactly-zero vectors only (see vpt_tpu/core/vecmath.py).
EPS = 1e-30


def dot(a, b, keepdim: bool = False):
    return (a * b).sum(dim=-1, keepdim=keepdim)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdim=True), min=EPS))


def reflect(i, n):
    """GLSL reflect: i - 2 dot(n, i) n."""
    return i - 2.0 * dot(n, i, keepdim=True) * n


def refract(i, n, eta):
    """GLSL refract; eta is (...,); returns 0 on total internal reflection."""
    eta = eta[..., None]
    cosi = -dot(i, n, keepdim=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    t = eta * i + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, torch.zeros_like(t), t)


def unit_axis(i: int, like):
    """The (3,) unit vector along axis i on `like`'s device.  Made on the
    device: a host-to-device copy of a constant would synchronise."""
    return (torch.arange(3, device=like.device) == i).to(like.dtype)


def rotate_axis_angle(v, axis: int, theta: float):
    """Rodrigues rotation about unit axis `axis` (0, 1, 2) by a scalar angle."""
    axis = unit_axis(axis, v).expand(v.shape)
    c = math.cos(theta)
    s = math.sin(theta)
    return v * c + cross(axis, v) * s + axis * dot(axis, v, keepdim=True) * (1.0 - c)


def onb_from_z(w):
    """Orthonormal basis with +Z = w (Sampler.slang:187-189 up-vector pick)."""
    up = torch.where(torch.abs(w[..., 1:2]) < 0.9999999, unit_axis(1, w), unit_axis(2, w))
    t = normalize(cross(up, w))
    b = cross(w, t)
    return t, b


def luminance(rgb):
    """Rec.709 luma used by the firefly clamp."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic a^2 / (a^2 + b^2)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / torch.clamp(a2 + b2, min=1e-20)
