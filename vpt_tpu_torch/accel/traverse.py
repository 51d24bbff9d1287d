"""Hit record and brute-force intersection (port of vpt_tpu/accel/traverse.py).

Semantics shared by every intersector of the port: Moller-Trumbore is
two-sided, a triangle counts only when |det| > 1e-12 and
t_min < t < t_max, and a miss reports t = -1 and tri = -1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vpt_tpu_torch.core.vecmath import cross, dot

T_MIN = 1e-4
T_MAX = 1e8


class Hit(NamedTuple):
    t: torch.Tensor  # (N,) f32, -1 on a miss
    tri: torch.Tensor  # (N,) i32 virtual triangle id, -1 on a miss
    u: torch.Tensor  # (N,) f32 barycentric of v1
    v: torch.Tensor  # (N,) f32 barycentric of v2


def _moller_trumbore(origin, direction, p0, e1, e2, t_min, t_max):
    """Batched Moller-Trumbore over (..., 3) operands: (t, u, v, valid)."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = origin - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return t, u, v, valid


def intersect_brute(origin, direction, tri_p0, tri_e1, tri_e2, t_min=T_MIN, t_max=T_MAX) -> Hit:
    """Closest hit of every ray against every triangle; `t_max` may be (N,).
    Equal t resolves to the lower triangle index."""
    if torch.is_tensor(t_max) and t_max.ndim == 1:
        t_max = t_max[:, None]
    t, u, v, valid = _moller_trumbore(
        origin[:, None, :], direction[:, None, :], tri_p0[None], tri_e1[None], tri_e2[None], t_min, t_max,
    )
    t_masked = torch.where(valid, t, torch.inf)
    best_t, best = torch.min(t_masked, dim=1)
    best = best[:, None]
    hit = torch.isfinite(best_t)
    return Hit(
        t=torch.where(hit, best_t, -1.0),
        tri=torch.where(hit, best[:, 0].to(torch.int32), -1),
        u=torch.where(hit, u.gather(1, best)[:, 0], 0.0),
        v=torch.where(hit, v.gather(1, best)[:, 0], 0.0),
    )
