"""Energy-compensation lookups as tensor-Chebyshev fits (port of
vpt_tpu/render/lookup_fit.py).

Each baked table (render/lookup.py) is fitted once on the host by a
least-squares tensor-product Chebyshev polynomial; shading evaluates the
fit instead of gathering texels.  `compile_scene(scene,
lookup_tables=None)` carries the constant fit, as the JAX package's does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Degrees (x = V.z column, y = roughness row, z = layer) per table.
REFLECT_DEG = (12, 10, 6)
REFRACT_DEG = (12, 10, 6)


def _cheb_basis(x: np.ndarray, deg: int) -> np.ndarray:
    """Shifted Chebyshev T_0..T_deg on [0, 1]: (n, deg + 1)."""
    xs = 2.0 * x - 1.0
    t = [np.ones_like(x), xs]
    for _ in range(2, deg + 1):
        t.append(2.0 * xs * t[-1] - t[-2])
    return np.stack(t[: deg + 1], axis=-1)


def fit_table(table: np.ndarray, deg=(12, 10, 6)) -> np.ndarray:
    """Least-squares fit of an (L, H, W) table on texel centres ((i + 0.5) / n
    per axis): coefficients (dz + 1, dy + 1, dx + 1) float32.  The grid is a
    full tensor product, so the solve factorises into one pseudo-inverse
    per axis, contracted one axis at a time (the JAX package's einsum
    contracts all four operands at once; the float64 sums differ in order
    only)."""
    dx, dy, dz = deg
    nl, nh, nw = table.shape
    bx = np.linalg.pinv(_cheb_basis((np.arange(nw) + 0.5) / nw, dx))
    by = np.linalg.pinv(_cheb_basis((np.arange(nh) + 0.5) / nh, dy))
    bz = np.linalg.pinv(_cheb_basis((np.arange(nl) + 0.5) / nl, dz))
    return np.einsum("kl,jh,iw,lhw->kji", bz, by, bx, table.astype(np.float64), optimize=True).astype(np.float32)


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


def get_lookup_fits(n_samples: int = 4096, cache_dir: str | None = None, device="cuda"):
    """Fits of the three baked tables (baked on `device`, or loaded from the
    cache): (reflect, refract_out, refract_in) float32 coefficient arrays."""
    # Imported here: lookup imports bsdf, which imports this module.
    from vpt_tpu_torch.render.lookup import CACHE_DIR, get_lookup_tables

    cache_dir = cache_dir or CACHE_DIR
    path = os.path.join(cache_dir, f"torch_lookup_fits_{n_samples}_{'x'.join(map(str, REFLECT_DEG))}.npz")
    if os.path.exists(path):
        z = np.load(path)
        return z["reflect"], z["out"], z["in_"]
    reflect_t, refract_out, refract_in = get_lookup_tables(n_samples, cache_dir, device)
    fits = (fit_table(reflect_t, REFLECT_DEG), fit_table(refract_out, REFRACT_DEG), fit_table(refract_in, REFRACT_DEG))
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(path, reflect=fits[0], out=fits[1], in_=fits[2])
    return fits
