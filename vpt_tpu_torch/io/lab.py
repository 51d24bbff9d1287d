"""PIL's conversion of a Lab image ("LAB", L and signed a, b bytes) to
RGB(A), which it makes through LittleCMS 2.17: `ImageCms.buildTransform`
from the built-in Lab profile to the built-in sRGB profile, perceptual,
8 bits in and out.  LittleCMS optimises that pipeline for 8-bit data by
resampling: it evaluates the whole float pipeline at the nodes of a 33^3
grid of 16-bit inputs and interpolates the grid tetrahedrally in 16-bit
integers.  Both are reproduced here operation by operation, equal to PIL on
all 2**24 Lab byte triples:

- the grid: each node's 16-bit Lab (V4 encoding: L = x / 65535 * 100,
  a = x / 65535 * 255 - 128, as float32 input) through cmsLab2XYZ (D50),
  float32 XYZ / MAX_ENCODEABLE_XYZ, the sRGB profile's matrix (its
  colorants from Rec. 709 primaries and a D65 white, Bradford-adapted to
  D50 as `_cmsBuildRGB2XYZtransferMatrix` computes them, inverted by
  `_cmsMAT3inverse`, times MAX_ENCODEABLE_XYZ) in double with float32
  outputs, the sRGB curve's analytic inverse (parametric type -4), and
  `_cmsQuickSaturateWord` to 16 bits;
- the lookup: 8-bit samples widened to 16 bits (x * 257; a and b with
  their sign bit flipped to LittleCMS's offset encoding), LittleCMS's
  `TetrahedralInterp16`, then 16 to 8 bits (`FROM_16_TO_8`).
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec

N = 33  # the grid's nodes per axis for 3-channel input
_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # MAX_ENCODEABLE_XYZ
_GRID = None


def _inv3(a: list) -> list:
    """_cmsMAT3inverse, its cofactors and order."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det, (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det, (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det, (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul(a: list, b: list) -> list:
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)] for i in range(3)]


def _eval(a: list, v: list) -> list:
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _srgb_matrix() -> list:
    """The sRGB profile's RGB -> XYZ (D50) matrix as LittleCMS builds it."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    coef = _eval(_inv3([[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
                 [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    bradford = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    src = _eval(bradford, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _eval(bradford, [0.9642, 1.0, 0.8249])
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0], [0.0, 0.0, dst[2] / src[2]]]
    return _mul(_mul(_inv3(bradford), _mul(cone, bradford)), m)


def _saturate_word(d: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord: + 0.5, clamped, floored after rounding to
    2**-16 (its 1.5 * 2**36 trick)."""
    d = d + 0.5
    floor = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, floor)).astype(np.int64)


def grid() -> np.ndarray:
    """The (33^3, 3) 16-bit sRGB nodes, indexed ((L * 33) + a) * 33 + b."""
    global _GRID
    if _GRID is None:
        inv = [[v * _MAX_XYZ for v in row] for row in _inv3(_srgb_matrix())]
        q = _saturate_word(np.arange(N) * 65535.0 / (N - 1))
        node = [x.ravel() for x in np.meshgrid(q, q, q, indexing="ij")]
        f = [(np.float32(x) / np.float32(65535.0)).astype(np.float32).astype(np.float64) for x in node]
        lab = (f[0] * 100.0, f[1] * 255.0 - 128.0, f[2] * 255.0 - 128.0)
        y = (lab[0] + 16.0) / 116.0
        t = (y + 0.002 * lab[1], y, y - 0.005 * lab[2])
        xyz = [np.where(v <= 24.0 / 116.0, (108.0 / 841.0) * (v - 16.0 / 116.0), v * v * v) * w / _MAX_XYZ
               for v, w in zip(t, (0.9642, 1.0, 0.8249))]
        xyz = [v.astype(np.float32).astype(np.float64) for v in xyz]
        g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
        disc = (a * d + b) ** g
        out = []
        for i in range(3):
            lin = ((0.0 + xyz[0] * inv[i][0]) + xyz[1] * inv[i][1]) + xyz[2] * inv[i][2]
            lin = lin.astype(np.float32).astype(np.float64)
            enc = np.where(lin >= disc, (np.power(np.maximum(lin, 0.0), 1.0 / g) - b) / a, lin / c)
            out.append(_saturate_word(enc.astype(np.float32).astype(np.float64) * 65535.0))
        _GRID = np.stack(out, -1)
    return _GRID


def to_rgb(lab: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 PIL Lab samples (L, signed a, signed b) to (H, W, 3)
    uint8 sRGB, as PIL's convert("RGB") / convert("RGBA") gives them (the
    lookup is csrc/imgcodec.c's `vpt_lab_to_rgb`)."""
    return codec.lab_to_rgb(lab, grid())
