"""Image comparison metrics, SSIM and PSNR (numpy copy of
vpt_tpu/io/metrics.py): Wang et al. 2004 SSIM with an 11x11 Gaussian
window, averaged over channels, and PSNR against a data range.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax**2) / (2 * sigma**2))
    k = np.outer(k, k)
    return k / k.sum()


def _filter2(img, kernel):
    """'valid' 2D convolution via stacked shifts (no scipy dependency)."""
    ks = kernel.shape[0]
    h, w = img.shape
    oh, ow = h - ks + 1, w - ks + 1
    out = np.zeros((oh, ow), np.float64)
    for dy in range(ks):
        for dx in range(ks):
            out += kernel[dy, dx] * img[dy : dy + oh, dx : dx + ow]
    return out


def ssim(a: np.ndarray, b: np.ndarray, data_range: float | None = None) -> float:
    """Mean SSIM over channels. Inputs (H, W) or (H, W, C), same shape."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"ssim needs images of one shape, got {a.shape} and {b.shape}")
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range) for c in range(a.shape[2])]))
    if data_range is None:
        data_range = max(a.max() - a.min(), b.max() - b.min(), 1e-9)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = _gaussian_kernel()
    mu_a = _filter2(a, k)
    mu_b = _filter2(b, k)
    mu_a2, mu_b2, mu_ab = mu_a**2, mu_b**2, mu_a * mu_b
    sa = _filter2(a * a, k) - mu_a2
    sb = _filter2(b * b, k) - mu_b2
    sab = _filter2(a * b, k) - mu_ab
    s = ((2 * mu_ab + c1) * (2 * sab + c2)) / ((mu_a2 + mu_b2 + c1) * (sa + sb + c2))
    return float(s.mean())


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB; inf for equal images."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range**2 / mse)
