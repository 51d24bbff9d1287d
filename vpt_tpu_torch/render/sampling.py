"""Importance samplers for the surface path (port of the matching parts of
vpt_tpu/render/sampling.py), with the same math and the same draw counts.
The atmosphere and volume phase functions wait for those ports."""

from __future__ import annotations

import math

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import cross, normalize, onb_from_z, unit_axis

TWO_PI = 2.0 * math.pi


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


def sample_henyey_greenstein(state, incident, g):
    """HG phase sample around `incident` (Sampler.slang:168-193); g is (N,)."""
    state, u = rng.next_float2(state)
    small = torch.abs(g) < 1e-5
    g_safe = torch.where(small, 1e-5, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u[..., 0])
    cos_g = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_t = torch.where(small, 2.0 * u[..., 0] - 1.0, cos_g)
    phi = TWO_PI * u[..., 1]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    t, b = onb_from_z(incident)
    return state, normalize(local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * incident)


def sample_scatter_distance(state, density):
    """Exponential free-flight distance -ln(u) / sigma."""
    state, u = rng.next_float(state)
    return state, -torch.log(torch.clamp(u, min=1e-37)) / density
