"""Light sampling (port of vpt_tpu/render/lights.py): bilinear env lookups,
alias-map env importance sampling, the atmosphere mode's sun disk and
emissive-triangle NEE."""

from __future__ import annotations

import math

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import cross, direction_to_uv, dot, normalize, rotate_axis_angle, sqrt32, unit_axis
from vpt_tpu_torch.render.surface import sample_texture

X_AXIS = (1.0, 0.0, 0.0)
Y_AXIS = (0.0, 1.0, 0.0)
SUN_THETA = 0.004675  # radians (Sampler.slang:469)
SUN_RADIANCE_SCALE = 2e5  # Sampler.slang:459


def _env_bilinear(env, u, v):
    """Bilinear fetch, wrap-u / clamp-v, RGBA with the PDF in alpha."""
    h, w = env.image.shape[0], env.image.shape[1]
    x = u * w - 0.5
    y = torch.clamp(v, 0.0, 1.0) * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    if env.quad.shape[0] == h:
        q = env.quad.reshape(h * w, 16)[y0i * w + x0i]
        t00, t10, t01, t11 = q[..., 0:4], q[..., 4:8], q[..., 8:12], q[..., 12:16]
    else:
        x1i = torch.remainder(x0i + 1, w)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        t00, t10 = env.image[y0i, x0i], env.image[y0i, x1i]
        t01, t11 = env.image[y1i, x0i], env.image[y1i, x1i]
    return (t00 * (1 - fx) + t10 * fx) * (1 - fy) + (t01 * (1 - fx) + t11 * fx) * fy


def env_radiance(env, direction, azimuth_deg, altitude_deg):
    """Miss-shader env lookup with the inverse sky rotation (RGBA); the
    angles are 0-d float32 tensors (the render parameters)."""
    d = rotate_axis_angle(direction, X_AXIS, -(altitude_deg / 180.0 * math.pi))
    d = rotate_axis_angle(d, Y_AXIS, -(azimuth_deg / 180.0 * math.pi))
    return _env_bilinear(env, *direction_to_uv(d))


def importance_sample_env(state, env, azimuth_deg, altitude_deg, shape):
    """Alias-map env sampling: (state, to_light (N, 3), rgba (N, 4)).
    `shape`, the wavefront's shape (N,), is taken as the JAX package takes
    it: the draws take their shape from `state`."""
    h, w = env.image.shape[0], env.image.shape[1]
    size = h * w
    state, xi = rng.next_float3(state)
    idx = torch.clamp((xi[..., 0] * size).to(torch.int64), max=size - 1)
    arow = env.alias[idx]
    imp = arow[..., 0]
    ali = arow[..., 1].to(torch.int64)
    take_self = xi[..., 1] < imp
    env_idx = torch.where(take_self, idx, ali)
    xi_y = torch.where(
        take_self,
        xi[..., 1] / torch.clamp(imp, min=1e-12),
        (xi[..., 1] - imp) / torch.clamp(1.0 - imp, min=1e-12),
    )
    px = (env_idx % w).to(torch.float32)
    py = (env_idx // w).to(torch.float32)
    u = (px + xi_y) / w
    phi = u * (2.0 * math.pi) - math.pi
    step_theta = math.pi / h
    theta0 = py * step_theta
    cos_theta = torch.cos(theta0) * (1.0 - xi[..., 2]) + torch.cos(theta0 + step_theta) * xi[..., 2]
    theta = torch.acos(torch.clamp(cos_theta, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    v = theta * (1.0 / math.pi)
    to_light = torch.stack([torch.sin(phi) * sin_theta, -cos_theta, -torch.cos(phi) * sin_theta], dim=-1)
    to_light = rotate_axis_angle(to_light, Y_AXIS, azimuth_deg / 180.0 * math.pi)
    to_light = rotate_axis_angle(to_light, X_AXIS, altitude_deg / 180.0 * math.pi)
    return state, to_light, _env_bilinear(env, u, v)


def sample_sun_disk(state, sun_color, environment_intensity, azimuth_deg, altitude_deg, shape):
    """Sun-disk cone sampling for the atmosphere mode (Sampler.slang:430-462):
    (state, to_light (*shape, 3), colour (*shape, 3), pdf `shape`), `shape`
    the wavefront's shape, a tuple as in the JAX package.  The float32 cone
    constants are computed on the host in float32: 1 - cos(SUN_THETA) keeps
    only a few bits there, and they must be the JAX package's bits."""
    shape = tuple(shape)
    base = -unit_axis(2, sun_color).expand(*shape, 3)
    sun_dir = rotate_axis_angle(base, X_AXIS, altitude_deg / 180.0 * math.pi)
    sun_dir = rotate_axis_angle(sun_dir, Y_AXIS, azimuth_deg / 180.0 * math.pi)

    cos_max = np.cos(np.float32(SUN_THETA))
    state, u1 = rng.next_float(state)
    state, u2 = rng.next_float(state)
    phi = 2.0 * math.pi * u1
    cos_t = float(cos_max) + float(np.float32(1.0) - cos_max) * u2
    sin_t = sqrt32(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    local = torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)

    wz = normalize(sun_dir)
    up = torch.where(torch.abs(wz[..., 2:3]) < 0.999, unit_axis(2, wz), unit_axis(0, wz))
    u_ax = normalize(cross(up, wz))
    v_ax = cross(wz, u_ax)
    to_light = u_ax * local[..., 0:1] + v_ax * local[..., 1:2] + wz * local[..., 2:3]

    solid_angle = np.float32(2.0 * math.pi) * (np.float32(1.0) - cos_max)
    pdf = torch.full(shape, float(np.float32(1.0) / solid_angle), dtype=torch.float32, device=u1.device)
    color = (sun_color * SUN_RADIANCE_SCALE * environment_intensity).expand(*shape, 3)
    return state, to_light, color, pdf


def sample_emissive_triangle(state, scene, position, n_emissive: int, has_textures: bool = True):
    """Uniform mesh -> uniform triangle -> uniform barycentric NEE sample.

    Returns (state, to_light, color, pdf, virtual tri id, distance); the id
    is in the id space the tracer reports, so shadow rays can exclude it."""
    em = scene.emissive
    state, u_mesh = rng.next_float(state)
    mesh_idx = torch.clamp((u_mesh * n_emissive).to(torch.int64), max=n_emissive - 1)
    em_row = em.attr[mesh_idx]  # [tri_count, offset, instance, material]
    tri_count_f = em_row[..., 0]
    state, u_tri = rng.next_float(state)
    tri_idx = torch.minimum((u_tri * tri_count_f).to(torch.int64), tri_count_f.to(torch.int64) - 1)
    entry = torch.clamp(em_row[..., 1].to(torch.int64) + tri_idx, 0, em.slot_table.shape[0] - 1)
    slot = em.slot_table[entry]
    row = em.tri_rows[entry]
    p0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]

    state, xi = rng.next_float2(state)
    su1 = torch.sqrt(xi[..., 0])
    b0 = 1.0 - su1
    b1 = xi[..., 1] * su1
    b2 = 1.0 - b0 - b1
    tri_pos = p0 + b1[..., None] * e1 + b2[..., None] * e2
    uv = row[..., 18:20] * b0[..., None] + row[..., 20:22] * b1[..., None] + row[..., 22:24] * b2[..., None]

    to_light = normalize(tri_pos - position)
    normal = normalize(cross(e2, e1))  # the reference's cross(v2 - v0, v1 - v0)
    c = cross(e1, e2)
    area = 0.5 * torch.sqrt(torch.clamp(dot(c, c), min=0.0))
    dist_sq = dot(tri_pos - position, tri_pos - position)
    cos_theta = torch.abs(dot(normal, to_light))
    denom = n_emissive * tri_count_f * area * cos_theta
    pdf = torch.where(denom > 0.0, dist_sq / torch.clamp(denom, min=1e-20), 0.0)

    mat_id = torch.clamp(em_row[..., 3].to(torch.int64), 0, scene.material_attr.shape[0] - 1)
    mat_row = scene.material_attr[mat_id]
    color = mat_row[..., 3:6]
    if has_textures:
        color = color * sample_texture(scene.textures, scene.texture_dims, mat_row[..., 27].to(torch.int64), uv)[..., :3]
    return state, to_light, color, pdf, slot.to(torch.int32), torch.sqrt(dist_sq)
