"""Hit-surface reconstruction (port of vpt_tpu/render/surface.py):
interpolation, normal fixups, tangent frames and texture fetches."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vpt_tpu_torch.core.vecmath import cross, dot, normalize, reflect, unit_axis


class SurfaceGeom(NamedTuple):
    world_pos: torch.Tensor  # (N, 3)
    uv: torch.Tensor  # (N, 2)
    normal: torch.Tensor  # (N, 3) shading normal after fixups
    tangent: torch.Tensor  # (N, 3)
    bitangent: torch.Tensor  # (N, 3)
    geom_normal: torch.Tensor  # (N, 3)
    hit_from_inside: torch.Tensor  # (N,) bool
    mat_row: torch.Tensor  # (N, MAT_ATTR_COLS) packed material attributes
    area: torch.Tensor  # (N,) world-space triangle area
    em_tcount: torch.Tensor  # (N,) emissive tri count of the instance (0 = not emissive)


def sample_texture(textures, tex_dims, tex_id, uv):
    """Bilinear, repeat-wrap fetch from the flat RGBA8 texel pool: (N, 4) in
    [0, 1].  `tex_id` is clamped to the texture table, as JAX clamps."""
    tex_id = torch.clamp(tex_id, 0, tex_dims.shape[0] - 1)
    dims = tex_dims[tex_id].to(torch.int64)  # (N, 3)
    h = dims[:, 0].to(torch.float32)
    w = dims[:, 1].to(torch.float32)
    off = dims[:, 2]
    wi = torch.clamp(dims[:, 1], min=1)
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    def wrap(i, n):
        return torch.remainder(i.to(torch.int64), torch.clamp(n.to(torch.int64), min=1))

    x0i, x1i = wrap(x0, w), wrap(x0 + 1, w)
    y0i, y1i = wrap(y0, h), wrap(y0 + 1, h)
    last = textures.shape[0] - 1

    def fetch(yi, xi):
        texel = textures[torch.clamp(off + yi * wi + xi, 0, last)]
        return torch.stack(
            [(texel >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1
        ).to(torch.float32) * (1.0 / 255.0)

    top = fetch(y0i, x0i) * (1 - fx) + fetch(y0i, x1i) * fx
    bot = fetch(y1i, x0i) * (1 - fx) + fetch(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def make_surface(scene, hit, ray_dir, use_only_geometry_normals: bool, has_textures: bool = True):
    """Surface.slang:26-117 for a wavefront at `hit` (a traverse.Hit, or
    anything with tri, u and v).  `hit.tri` must already be clamped to a
    valid slot for missed lanes (their results are masked later)."""
    row = scene.tri_attr[hit.tri]  # (N, 32)
    p0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    u = hit.u[:, None]
    v = hit.v[:, None]
    world_pos = p0 + u * e1 + v * e2
    uv = row[:, 18:20] * (1.0 - u - v) + row[:, 20:22] * u + row[:, 22:24] * v
    mat_id = torch.clamp(row[:, 24].to(torch.int64), 0, scene.material_attr.shape[0] - 1)
    mat_row = scene.material_attr[mat_id]

    c = cross(e1, e2)
    geom_n = normalize(c)
    area = 0.5 * torch.sqrt(torch.clamp(dot(c, c), min=0.0))
    if use_only_geometry_normals:
        n = geom_n
    else:
        n = normalize(row[:, 9:12] * (1.0 - u - v) + row[:, 12:15] * u + row[:, 15:18] * v)

    view = -ray_dir
    inside = dot(geom_n, view) < 0.0
    n = torch.where(inside[:, None], -n, n)
    geom_n = torch.where(inside[:, None], -geom_n, geom_n)

    up = torch.where(torch.abs(n[:, 2:3]) < 0.9999999, unit_axis(2, n), unit_axis(0, n))
    tangent = normalize(cross(up, n))
    bitangent = normalize(cross(n, tangent))

    if not use_only_geometry_normals and has_textures:
        ntex = mat_row[:, 24].to(torch.int64)
        nval = sample_texture(scene.textures, scene.texture_dims, ntex, uv)[:, :3] * 2.0 - 1.0
        n = normalize(nval[:, 0:1] * tangent + nval[:, 1:2] * bitangent + nval[:, 2:3] * n)

    # Fixup 1: pull the normal toward the view direction (Surface.slang:92-100).
    ndotv = dot(n, view)
    pulled = normalize(n - view * (ndotv - 0.01)[:, None])
    n = torch.where((ndotv < 0.0)[:, None], pulled, n)
    # Fixup 2: keep the perfect reflection above the geometric surface.
    perfect = normalize(reflect(-view, n))
    pushed = normalize(n + geom_n * (0.1 + dot(n, geom_n))[:, None])
    n = torch.where((dot(perfect, geom_n) < 0.0)[:, None], pushed, n)
    # The reference recomputes the frame with tangent = cross(normal, up).
    tangent = normalize(cross(n, up))
    bitangent = normalize(cross(n, tangent))

    return SurfaceGeom(
        world_pos=world_pos, uv=uv, normal=n, tangent=tangent, bitangent=bitangent,
        geom_normal=geom_n, hit_from_inside=inside, mat_row=mat_row, area=area,
        em_tcount=row[:, 27],
    )


def rotate_tangents(surf: SurfaceGeom, rotation_degrees) -> SurfaceGeom:
    """Anisotropy rotation (Surface.slang:139-147)."""
    rot = rotation_degrees * (math.pi / 180.0)
    c = torch.cos(rot)[:, None]
    s = torch.sin(rot)[:, None]
    n, t = surf.normal, surf.tangent
    t_new = t * c + cross(n, t) * s + n * dot(n, t, keepdims=True) * (1.0 - c)
    return surf._replace(tangent=t_new, bitangent=cross(t_new, n))


def world_to_tangent(surf: SurfaceGeom, vec):
    return normalize(
        torch.stack([dot(vec, surf.tangent), dot(vec, surf.bitangent), dot(vec, surf.normal)], dim=-1)
    )


def tangent_to_world(surf: SurfaceGeom, vec):
    return normalize(vec[..., 0:1] * surf.tangent + vec[..., 1:2] * surf.bitangent + vec[..., 2:3] * surf.normal)
