"""Energy-compensation lookups as tensor-Chebyshev fits (port of
vpt_tpu/render/lookup_fit.py: `constant_fit`, `eval_fit`, `layer_coord`).

The table bake and `fit_table` are not ported yet; scenes compiled by the
port carry the constant fit, as `compile_scene(scene, lookup_tables=None)`
does in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def constant_fit(value: float, deg=(12, 10, 6)) -> np.ndarray:
    """Coefficients of the constant function."""
    dx, dy, dz = deg
    c = np.zeros((dz + 1, dy + 1, dx + 1), np.float32)
    c[0, 0, 0] = value
    return c


def _cheb_vals(x, deg: int):
    """Shifted Chebyshev T_0..T_deg at x in [0, 1]: (N, deg + 1)."""
    xs = 2.0 * x - 1.0
    t = [torch.ones_like(x), xs]
    for _ in range(2, deg + 1):
        t.append(2.0 * xs * t[-1] - t[-2])
    return torch.stack(t[: deg + 1], dim=-1)


def eval_fit(coeffs: torch.Tensor, u, v, w):
    """Evaluate a (dz+1, dy+1, dx+1) fit at (u, v, w) in [0, 1]^3.

    Contracts x, then y, then z as batched products, where the JAX package
    unrolls the same sums into scalar multiply-adds: the result differs in
    float32 summation order only."""
    dz1, dy1, dx1 = coeffs.shape
    tx = _cheb_vals(torch.clamp(u, 0.0, 1.0), dx1 - 1)
    ty = _cheb_vals(torch.clamp(v, 0.0, 1.0), dy1 - 1)
    tz = _cheb_vals(torch.clamp(w, 0.0, 1.0), dz1 - 1)
    acc = (tx @ coeffs.reshape(dz1 * dy1, dx1).T).reshape(-1, dz1, dy1)
    acc = (acc * ty[:, None, :]).sum(-1)
    return (acc * tz).sum(-1)


def layer_coord(layer, n_layers: int):
    """Nearest-layer index (e.g. (ior - 1) * 32) -> texel-centre coordinate."""
    return (torch.clamp(layer, 0.0, n_layers - 1.0) + 0.5) / n_layers
