"""Path-traced atmosphere: Rayleigh, Mie and ozone with null collisions
(port of vpt_tpu/render/atmosphere.py, Atmosphere.slang).

Earth's sea-level coefficients, exponential Rayleigh / Mie densities and
the tent ozone profile; single-channel transmittance by ratio tracking with
planet shadowing; scatter-distance sampling with null collisions and a
stochastic component pick.  The renderer splits rays spectrally: after the
first atmosphere event one colour channel is tracked.

Heights are |p - planet| - radius in float32 at planet scale, where one ulp
is half a metre: the norm is a sum of squares in x, y, z order and a square
root, as the JAX package computes it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import dot3, intersect_sphere, sqrt32
from vpt_tpu_torch.render.loop import LoopStats, while_live

# Sea-level coefficients (1/m), Atmosphere.slang:7-11, in float32.
C_RAYLEIGH = np.array([5.802, 13.558, 33.100], np.float32) * np.float32(1e-6)
C_MIE_SCATTERING = np.array([3.996] * 3, np.float32) * np.float32(1e-6)
C_MIE_ABSORPTION = np.array([4.40] * 3, np.float32) * np.float32(1e-6)
C_MIE = C_MIE_SCATTERING + C_MIE_ABSORPTION
C_OZONE = np.array([0.650, 1.881, 0.085], np.float32) * np.float32(1e-6)

MAX_STEPS = 1000  # Atmosphere.slang:71,149

COMPONENT_NONE = -1
COMPONENT_RAYLEIGH = 0
COMPONENT_MIE = 1
COMPONENT_OZONE = 2


@functools.lru_cache(maxsize=None)
def coefficients(device: torch.device) -> torch.Tensor:
    """(4, 3) float32 on `device`, made once: rows Rayleigh, Mie extinction,
    ozone and C_MIE_ABSORPTION / C_MIE."""
    return torch.as_tensor(np.stack([C_RAYLEIGH, C_MIE, C_OZONE, C_MIE_ABSORPTION / C_MIE]), device=device)


def atmosphere_height(params, position):
    d = position - params.planet_position
    return sqrt32(dot3(d, d)) - params.planet_radius


def rayleigh_density(params, height):
    return torch.exp(-height / params.rayleigh_density_falloff)


def mie_density(params, height):
    return torch.exp(-height / params.mie_density_falloff)


def ozone_density(params, height):
    return torch.exp(-(torch.abs(height - params.ozone_peak) / params.ozone_density_falloff))


def _top_radius(params):
    """The atmosphere's outer radius, summed in float32 on the device."""
    return params.planet_radius + params.atmosphere_height


def _channel_coeffs(params, channel):
    """Per-ray coefficients of the tracked channel, (N,) each, and the
    majorant: the densities' maxima (at sea level and at the ozone peak)
    times the coefficients.  The maxima are float32 tensor arithmetic on
    the parameters, as the JAX package's (a zero falloff gives NaN there
    too)."""
    c = coefficients(channel.device)
    cr = c[0][channel] * params.rayleigh_scattering_multiplier[channel]
    cm = c[1][channel] * params.mie_scattering_multiplier[channel]
    co = c[2][channel] * params.ozone_absorption_multiplier[channel]
    zero = torch.zeros_like(params.rayleigh_density_falloff)
    r0 = torch.exp(-zero / params.rayleigh_density_falloff)
    m0 = torch.exp(-zero / params.mie_density_falloff)
    peak = params.ozone_peak
    o0 = torch.exp(-(torch.abs(peak - peak) / params.ozone_density_falloff))
    majorant = r0 * cr + m0 * cm + o0 * co
    return cr, cm, co, majorant


def _free_flight(state, majorant):
    state, u = rng.next_float(state)
    return state, -torch.log(torch.clamp(1.0 - u, min=1e-37)) / torch.clamp(majorant, min=1e-37)


def _densities(params, h, cr, cm, co):
    return rayleigh_density(params, h) * cr, mie_density(params, h) * cm, ozone_density(params, h) * co


def transmittance(state, params, origin, direction, channel, active, stats: Optional[LoopStats] = None):
    """CalculateTransmittanceThroughAtmosphere for one channel per ray
    (Atmosphere.slang:33-106): (state, (N,) transmittance)."""
    _, p_far = intersect_sphere(origin, direction, params.planet_position, params.planet_radius)
    occluded = p_far > 0.0
    a_near, a_far = intersect_sphere(origin, direction, params.planet_position, _top_radius(params))
    t_lo = torch.clamp(a_near, min=0.0)
    outside = a_far < 0.0
    cr, cm, co, majorant = _channel_coeffs(params, channel)
    no_atmo = majorant <= 0.0

    def body(c):
        state, dt = _free_flight(c["state"], majorant)
        t = c["t"] + dt
        exited = t >= (a_far - t_lo)
        h = atmosphere_height(params, origin + direction * (t + t_lo)[:, None])
        below = h < 0.0
        dr, dm, do = _densities(params, h, cr, cm, co)
        ratio = 1.0 - (dr + dm + do) / torch.clamp(majorant, min=1e-37)
        test = c["live"] & ~exited & ~below
        tr = torch.where(test, c["tr"] * ratio, c["tr"])
        state, u2 = rng.next_float(state)
        absorbed = test & (u2 > tr)
        tr = torch.where(absorbed, 0.0, torch.where(test, 1.0, tr))
        return dict(state=state, t=torch.where(c["live"], t, c["t"]), tr=tr,
                    live=c["live"] & ~exited & ~below & ~absorbed)

    init = dict(state=state, t=torch.zeros_like(t_lo), tr=torch.ones_like(t_lo),
                live=active & ~occluded & ~outside & ~no_atmo)
    out = while_live(body, init, MAX_STEPS, stats)
    return out["state"], torch.where(occluded, 0.0, torch.where(outside | no_atmo, 1.0, out["tr"]))


def sample_scatter_distance(state, params, origin, direction, channel, active, stats: Optional[LoopStats] = None):
    """SampleAtmosphereScatterDistance (Atmosphere.slang:116-202): (state,
    t (N,) with -1 for none, component (N,))."""
    a_near, a_far = intersect_sphere(origin, direction, params.planet_position, _top_radius(params))
    p_near, _ = intersect_sphere(origin, direction, params.planet_position, params.planet_radius)
    cr, cm, co, majorant = _channel_coeffs(params, channel)

    def body(c):
        state, dt = _free_flight(c["state"], majorant)
        t = c["t"] + dt
        exited = (t >= a_far) | ((p_near > 0.0) & (t >= p_near))
        dr, dm, do = _densities(params, atmosphere_height(params, origin + direction * t[:, None]), cr, cm, co)
        density = dr + dm + do
        state, u2 = rng.next_float(state)
        real = c["live"] & ~exited & ~(density / torch.clamp(majorant, min=1e-37) < u2)
        state, x = rng.next_float(state)
        p_r = dr / torch.clamp(density, min=1e-37)
        p_m = dm / torch.clamp(density, min=1e-37)
        pick = torch.where(x <= p_r, COMPONENT_RAYLEIGH, torch.where(x <= p_r + p_m, COMPONENT_MIE, COMPONENT_OZONE))
        return dict(state=state, t=torch.where(c["live"], t, c["t"]), result=torch.where(real, t, c["result"]),
                    comp=torch.where(real, pick, c["comp"]), live=c["live"] & ~exited & ~real)

    init = dict(state=state, t=torch.clamp(a_near, min=0.0), result=torch.full_like(a_near, -1.0),
                comp=torch.full(a_near.shape, COMPONENT_NONE, dtype=torch.int64, device=a_near.device),
                live=active & ~(a_far < 0.0) & ~(majorant <= 0.0))
    out = while_live(body, init, MAX_STEPS, stats)
    return out["state"], out["result"], out["comp"]
