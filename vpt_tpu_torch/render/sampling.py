"""Importance samplers: directions, microfacets, phase functions (port of
vpt_tpu/render/sampling.py), with the same math and the same draw counts."""

from __future__ import annotations

import math

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import cross, dot, normalize, onb_from_z, pow32, sqrt32, unit_axis

TWO_PI = 2.0 * math.pi


def _full(g, like):
    """A Python-float parameter as a float32 tensor shaped like `like`, made on
    its device (no host-to-device copy), so that it is rounded to float32
    before any arithmetic as the JAX package's `jnp.asarray(g, float32)` is."""
    return g if torch.is_tensor(g) else torch.full_like(like, g)


def _nonzero(x, tiny):
    return torch.where(torch.abs(x) < tiny, tiny, x)


_ONE_THIRD_F32 = float(np.float32(1.0 / 3.0))


def _cbrt(x):
    """Real cube root in float32 (torch has none).  XLA computes cbrt as
    sign(x) * |x| ** float32(1/3); that power is taken here in float64 and
    rounded, which gives XLA's float32 result on all but ~0.06% of inputs."""
    xd = x.double()
    return (torch.sign(xd) * xd.abs().pow(_ONE_THIRD_F32)).to(x.dtype)


def sample_disk(state):
    """Uniform disk via polar coordinates (Sampler.slang:102-112)."""
    state, u = rng.next_float2(state)
    theta = TWO_PI * u[..., 0]
    r = torch.sqrt(u[..., 1])
    return state, torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def sample_sphere(state):
    """Uniform sphere (Sampler.slang:114-133)."""
    state, u = rng.next_float2(state)
    theta = TWO_PI * u[..., 0]
    z = 1.0 - 2.0 * u[..., 1]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return state, torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def sample_cosine_hemisphere(state, normal):
    """Cosine-weighted hemisphere as normalize(sphere + n)."""
    state, s = sample_sphere(state)
    return state, normalize(s + normal)


def sample_ggx_vndf(state, v, ax, ay):
    """Anisotropic GGX visible-normal sampling (Heitz 2018): the half-vector."""
    state, u = rng.next_float2(state)
    u1, u2 = u[..., 0], u[..., 1]
    vh = normalize(torch.stack([ax * v[..., 0], ay * v[..., 1], torch.abs(v[..., 2])], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    t1 = torch.where(
        (lensq > 0)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], dim=-1) * inv_len[..., None],
        unit_axis(0, v),
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))[..., None] * vh
    )
    return state, normalize(
        torch.stack([ax * nh[..., 0], ay * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)], dim=-1)
    )


def _local_to_world_around(incident, cos_t, phi):
    """The direction at polar angle acos(cos_t) and azimuth phi about
    `incident` (Sampler.slang:186-191 basis choice)."""
    sin_t = sqrt32(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    t, b = onb_from_z(incident)
    return normalize(local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * incident)


def _hg_cos_theta(u0, g_safe):
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u0)
    return (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)


def sample_henyey_greenstein(state, incident, g):
    """HG phase sample around `incident` (Sampler.slang:168-193); g is (N,)
    or a Python float."""
    state, u = rng.next_float2(state)
    g = _full(g, u[..., 0])
    small = torch.abs(g) < 1e-5
    cos_t = torch.where(small, 2.0 * u[..., 0] - 1.0, _hg_cos_theta(u[..., 0], torch.where(small, 1e-5, g)))
    return state, _local_to_world_around(incident, cos_t, TWO_PI * u[..., 1])


def sample_rayleigh(state, incident):
    """Exact inverse-CDF Rayleigh phase sample (Sampler.slang:195-215)."""
    state, u = rng.next_float2(state)
    x = 2.0 * u[..., 0] - 1.0
    w = -_cbrt(2.0 * x + sqrt32(4.0 * x * x + 1.0))
    cos_t = torch.clamp(w - 1.0 / _nonzero(w, 1e-9), -1.0, 1.0)
    return state, _local_to_world_around(incident, cos_t, TWO_PI * u[..., 1])


def _draine_cos_theta(u1, g, a):
    """Analytic Draine sampling (Jendersie & d'Eon 2023; Sampler.slang:217-266)."""
    g2 = g * g
    g3 = g * g2
    g4 = g2 * g2
    g6 = g2 * g4
    pgp1_2 = (1 + g2) * (1 + g2)
    t1a = -a + a * g4
    t1a3 = t1a * t1a * t1a
    t2 = -1296 * (-1 + g2) * (a - a * g2) * t1a * (4 * g2 + a * pgp1_2)
    t3 = 3 * g2 * (1 + g * (-1 + 2 * u1)) + a * (2 + g2 + g3 * (1 + 2 * g2) * (-1 + 2 * u1))
    t4a = 432 * t1a3 + t2 + 432 * (a - a * g2) * t3 * t3
    t4b = -144 * a * g2 + 288 * a * g4 - 144 * a * g6
    t4b3 = t4b * t4b * t4b
    t4 = t4a + sqrt32(torch.clamp(-4 * t4b3 + t4a * t4a, min=0.0))
    t4p3 = _cbrt(t4)
    cbrt2 = 2.0 ** (1.0 / 3.0)
    t6 = (2 * t1a + (48 * cbrt2 * (-(a * g2) + 2 * a * g4 - a * g6)) / _nonzero(t4p3, 1e-20)
          + t4p3 / (3.0 * cbrt2)) / _nonzero(a - a * g2, 1e-20)
    t5 = 6 * (1 + g2) + t6
    sq5 = sqrt32(torch.clamp(t5, min=0.0))
    inner = 6 * (1 + g2) - (8 * t3) / _nonzero(a * (-1 + g2) * sq5, 1e-20) - t6
    term = -0.5 * sq5 + sqrt32(torch.clamp(inner, min=0.0)) / 2.0
    return (1 + g2 - term * term) / (2.0 * g)


def sample_draine(state, incident, g, a):
    """Draine phase sample; g and a are (N,)."""
    state, u = rng.next_float2(state)
    iso = 2.0 * u[..., 0] - 1.0
    g_safe = torch.where(torch.abs(g) < 1e-5, 1e-5, g)
    hg = _hg_cos_theta(u[..., 0], g_safe)
    dr = _draine_cos_theta(u[..., 0], g_safe, torch.where(torch.abs(a) < 1e-5, 1e-5, a))
    cos_t = torch.where(torch.abs(g) < 1e-5, iso, torch.where(torch.abs(a) < 1e-5, hg, dr))
    return state, _local_to_world_around(incident, torch.clamp(cos_t, -1.0, 1.0), TWO_PI * u[..., 1])


def hg_plus_draine_params(d):
    """Fitted HG+Draine mixture constants for droplet size d (Sampler.slang:269-274)."""
    g_hg = torch.exp(-(0.0990567 / (d - 1.67154)))
    g_d = torch.exp(-(2.20679 / (d + 3.91029)) - 0.428934)
    alpha_d = torch.exp(3.62489 - (8.29288 / (d + 5.52825)))
    w_d = torch.exp(-(0.599085 / (d - 0.641583)) - 0.665888)
    return g_hg, g_d, alpha_d, w_d


def _depth_powered(g_hg, g_d, ray_depth):
    depth_f = ray_depth.to(torch.float32)
    return (pow32(torch.clamp(g_hg, min=0.0), 1.0 + depth_f),
            pow32(torch.clamp(g_d, min=0.0), 1.0 + depth_f))


def sample_hg_plus_draine(state, incident, d, ray_depth):
    """HG+Draine mixture with the per-depth exponent (Sampler.slang:269-284)."""
    g_hg, g_d, alpha_d, w_d = hg_plus_draine_params(d)
    g_hg, g_d = _depth_powered(g_hg, g_d, ray_depth)
    state, u = rng.next_float(state)
    state_hg, dir_hg = sample_henyey_greenstein(state, incident, g_hg)
    state_dr, dir_dr = sample_draine(state, incident, g_d, alpha_d)
    pick_hg = u < w_d
    return torch.where(pick_hg, state_hg, state_dr), torch.where(pick_hg[..., None], dir_hg, dir_dr)


def sample_scatter_distance(state, density):
    """Exponential free-flight distance -ln(u) / sigma."""
    state, u = rng.next_float(state)
    return state, -torch.log(torch.clamp(u, min=1e-37)) / density


# Phase function evaluation (RTCommon.slang:197-227).


def phase_rayleigh(v, l):
    cos_t = dot(v, l)
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_t * cos_t)


def phase_mie_approx(v, l, g=0.85):
    cos_t = dot(v, l)
    g = torch.clamp(_full(g, cos_t), max=0.9381)
    k = 1.55 * g - 0.55 * g * g * g
    kc = k * cos_t
    return (1.0 - k * k) / ((4.0 * math.pi) * (1.0 - kc) * (1.0 - kc))


def phase_henyey_greenstein(v, l, g):
    cos_t = dot(v, l)
    g = _full(g, cos_t)
    denom = pow32(torch.clamp(1.0 + g * g - 2.0 * g * cos_t, min=1e-9), 1.5)
    hg = (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / denom
    return torch.where(g == 0.0, 1.0 / (4.0 * math.pi), hg)


def phase_draine(v, l, g, a):
    cos_t = dot(v, l)
    denom = 4.0 * (1.0 + (a * (1.0 + 2.0 * g * g)) / 3.0) * math.pi
    denom = denom * pow32(torch.clamp(1.0 + g * g - 2.0 * g * cos_t, min=1e-9), 1.5)
    return ((1.0 - g * g) * (1.0 + a * cos_t * cos_t)) / denom


def phase_hg_plus_draine(v, l, d, ray_depth):
    g_hg, g_d, alpha_d, w_d = hg_plus_draine_params(d)
    g_hg, g_d = _depth_powered(g_hg, g_d, ray_depth)
    return w_d * phase_henyey_greenstein(v, l, g_hg) + (1.0 - w_d) * phase_draine(v, l, g_d, alpha_d)
