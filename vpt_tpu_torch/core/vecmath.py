"""Small-vector math over (..., 3) tensors (port of vpt_tpu/core/vecmath.py).

Right-handed, Y-up world space; Z-up tangent space.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Guard for exactly-zero vectors only (see vpt_tpu/core/vecmath.py).
EPS = 1e-30


def dot(a, b, keepdims: bool = False):
    return (a * b).sum(dim=-1, keepdim=keepdims)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v, keepdims: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims=keepdims), min=0.0))


def normalize(v):
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdims=True), min=EPS))


def reflect(i, n):
    """GLSL reflect: i - 2 dot(n, i) n."""
    return i - 2.0 * dot(n, i, keepdims=True) * n


def refract(i, n, eta):
    """GLSL refract; eta is (...,); returns 0 on total internal reflection."""
    eta = eta[..., None]
    cosi = -dot(i, n, keepdims=True)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    t = eta * i + (eta * cosi - torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, torch.zeros_like(t), t)


def unit_axis(i: int, like):
    """The (3,) unit vector along axis i on `like`'s device.  Made on the
    device: a host-to-device copy of a constant would synchronise."""
    return (torch.arange(3, device=like.device) == i).to(like.dtype)


def _axis_vector(axis, like):
    """`axis` as a (3,) or broadcastable tensor on `like`'s device: an index
    0-2 is the exact unit axis; a tuple is built from fills and adds of its
    float32 values, as a host-to-device copy would synchronise (and break a
    capture); a tensor is taken as it is.  Whether it needs normalising is
    the second value: a unit axis does not (JAX's normalize multiplies it by
    rsqrt(1) = 1), so its rotation stays bitwise the index's."""
    if torch.is_tensor(axis):
        return axis.to(device=like.device, dtype=like.dtype), True
    if isinstance(axis, (int, np.integer)):
        return unit_axis(int(axis), like), False
    vals = [float(np.float32(a)) for a in axis]
    if len(vals) != 3:
        raise ValueError(f"rotate_axis_angle takes an axis of 3 components, got {axis!r}")
    if sorted(vals) == [0.0, 0.0, 1.0]:
        return unit_axis(vals.index(1.0), like), False
    return sum(unit_axis(i, like) * a for i, a in enumerate(vals)), True


def rotate_axis_angle(v, axis, theta):
    """Rodrigues rotation about `axis` by `theta` (RTCommon.slang:37-45), as
    vpt_tpu/core/vecmath.py:57-66: `axis` an index 0-2, a 3-tuple or a tensor
    broadcastable to v, normalised; `theta` a number, a 0-d tensor or one
    angle per lane (`theta.ndim == v.ndim - 1`), its cosine and sine taken
    in float32 on v's device."""
    axis, unnormalised = _axis_vector(axis, v)
    axis = axis.expand(v.shape)
    if unnormalised:
        axis = normalize(axis)
    if not torch.is_tensor(theta):
        theta = torch.full((), float(np.float32(theta)), dtype=v.dtype, device=v.device)
    c, s = torch.cos(theta), torch.sin(theta)
    if c.ndim == v.ndim - 1:
        c, s = c[..., None], s[..., None]
    return v * c + cross(axis, v) * s + axis * dot(axis, v, keepdims=True) * (1.0 - c)


def onb_from_z(w):
    """Orthonormal basis with +Z = w (Sampler.slang:187-189 up-vector pick)."""
    up = torch.where(torch.abs(w[..., 1:2]) < 0.9999999, unit_axis(1, w), unit_axis(2, w))
    t = normalize(cross(up, w))
    b = cross(w, t)
    return t, b


def luminance(rgb):
    """Rec.709 luma used by the firefly clamp."""
    return rgb[..., 0] * 0.212671 + rgb[..., 1] * 0.715160 + rgb[..., 2] * 0.072169


def direction_to_uv(v):
    """Equirect direction -> (u, v) (RTCommon.slang:129-136):
    u = atan2(x, -z) / 2 pi + 0.5, v = asin(y) / pi + 0.5."""
    gamma = torch.asin(torch.clamp(v[..., 1], -1.0, 1.0))
    theta = torch.atan2(v[..., 0], -v[..., 2])
    return theta * (0.5 / math.pi) + 0.5, gamma * (1.0 / math.pi) + 0.5


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic a^2 / (a^2 + b^2)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / torch.clamp(a2 + b2, min=1e-20)


def balance_heuristic(pdf_a, pdf_b):
    """MIS balance heuristic a / (a + b)."""
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-20)


def pow32(x, y):
    """x ** y in float32, taken in float64 and rounded.  XLA's float32 power
    is correctly rounded on all but ~0.06% of inputs, torch's float32 kernel
    differs from it on ~2% (measured on the CPU), and a media loop's step
    count can hang on one such ulp.  A Python-float exponent is rounded to
    float32 first, as the JAX package's weakly typed constant is."""
    y = y.double() if torch.is_tensor(y) else float(np.float32(y))
    return torch.pow(x.double(), y).to(torch.float32)


def sqrt32(x):
    """Correctly rounded float32 square root, taken in float64: XLA's is,
    ATen's vectorised CPU kernel is not on ~0.7% of inputs, and the Draine
    sampler's cancellations turn that ulp into 1e-4."""
    return torch.sqrt(x.double()).to(torch.float32)


def dot3(a, b):
    """a . b summed in the order x, y, z, as XLA's reduction sums it: the
    planet-scale sphere tests cancel to a few ulps of 4e13, so the order
    must not change with the device's reduction kernel."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def blackbody_rgb(temperature):
    """Kelvin -> RGB (Tanner Helland fit, RTCommon.slang:138-172)."""
    t = temperature / 100.0
    r = torch.where(t <= 66.0, 255.0, 329.698727446 * pow32(torch.clamp(t - 60.0, min=1e-6), -0.1332047592))
    g = torch.where(
        t <= 66.0,
        99.4708025861 * torch.log(torch.clamp(t, min=1e-6)) - 161.1195681661,
        288.1221695283 * pow32(torch.clamp(t - 60.0, min=1e-6), -0.0755148492),
    )
    b = torch.where(
        t >= 66.0,
        255.0,
        torch.where(t <= 19.0, 0.0, 138.5177312231 * torch.log(torch.clamp(t - 10.0, min=1e-6)) - 305.0447927307),
    )
    return torch.clamp(torch.stack([r, g, b], dim=-1) / 255.0, 0.0, 1.0)


def intersect_sphere(origin, direction, center, radius: torch.Tensor):
    """Ray-sphere: (t0, t1), both -1 when missed (RTCommon.slang:174-192).
    The 0-d float32 radius is squared in float32, as the JAX package
    squares its float32 parameter."""
    oc = origin - center
    a = dot3(direction, direction)
    b = 2.0 * dot3(oc, direction)
    c = dot3(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = sqrt32(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    miss = disc < 0.0
    return torch.where(miss, -1.0, t0), torch.where(miss, -1.0, t1)
