"""Tonemapping: ACES (fitted) and AGX with its looks, after exposure and
gamma (port of vpt_tpu/post/tonemap.py, PostProcess/Tonemap.slang).

The order is Tonemap.slang:168-175's: exposure, then gamma, then the
curve.  Elementwise torch on the image's device; the colour matrices are
made on that device per call.
"""

from __future__ import annotations

import torch

# ACES matrices (Tonemap.slang:20-33)
_ACES_INPUT = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_OUTPUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)
# AGX (Tonemap.slang:57-157)
_AGX_MAT = (
    (0.842479062253094, 0.0423282422610123, 0.0423756549057051),
    (0.0784335999999992, 0.878468636469772, 0.0784336),
    (0.0792237451477643, 0.0791661274605434, 0.879142973793104),
)
_AGX_MAT_INV = (
    (1.19687900512017, -0.0528968517574562, -0.0529716355144438),
    (-0.0980208811401368, 1.15190312990417, -0.0980434501171241),
    (-0.0990297440797205, -0.0989611768448433, 1.15107367264116),
)
_LOOKS = {  # (slope, power, saturation)
    "default": ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0), 1.0),
    "golden": ((1.0, 0.9, 0.5), (0.8, 0.8, 0.8), 0.8),
    "punchy": ((1.0, 1.0, 1.0), (1.35, 1.35, 1.35), 1.4),
}
_LUMA = (0.2126, 0.7152, 0.0722)


def _mat(rows, like):
    return torch.tensor(rows, dtype=like.dtype, device=like.device)


def _rrt_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(color):
    """ACESFitted (Tonemap.slang:42-55); color (..., 3)."""
    c = color @ _mat(_ACES_INPUT, color).T
    c = _rrt_odt_fit(c)
    c = c @ _mat(_ACES_OUTPUT, color).T
    return torch.clamp(c, 0.0, 1.0)


def _agx_contrast(x):
    x2 = x * x
    x4 = x2 * x2
    x6 = x4 * x2
    return (
        -17.86 * x6 * x
        + 78.01 * x6
        - 126.7 * x4 * x
        + 92.06 * x4
        - 28.72 * x2 * x
        + 4.361 * x2
        - 0.1718 * x
        + 0.002857
    )


def agx_tonemap(color, look: str = "default"):
    """AGX with the default, golden or punchy look (Tonemap.slang:79-157);
    an unknown look is the default one, as in the JAX package."""
    val = color @ _mat(_AGX_MAT, color)  # row vector times the matrix
    min_ev = -12.47393
    max_ev = 4.026069
    val = torch.clamp(torch.log2(torch.clamp(val, min=1e-10)), min_ev, max_ev)
    val = (val - min_ev) / (max_ev - min_ev)
    val = _agx_contrast(val)
    slope, power, sat = _LOOKS.get(look, _LOOKS["default"])
    val = torch.pow(torch.clamp(val * _mat(slope, color), min=0.0), _mat(power, color))
    luma = torch.sum(val * _mat(_LUMA, color), dim=-1, keepdim=True)
    val = luma + sat * (val - luma)
    val = val @ _mat(_AGX_MAT_INV, color)
    return torch.pow(torch.clamp(val, min=0.0), 2.2)


def tonemap(image, bloom=None, exposure=1.0, gamma=2.2, mode: str = "aces"):
    """Full tonemap pass (Tonemap.slang:159-176): (H, W, 3) -> [0, 1].
    `mode` is "aces", "agx" or "agx:<look>"; anything else only clamps."""
    c = image
    if bloom is not None:
        c = c + bloom
    c = c * exposure
    c = torch.pow(torch.clamp(c, min=0.0), 1.0 / gamma)
    if mode == "aces":
        c = aces_fitted(c)
    elif mode.startswith("agx"):
        look = mode.split(":")[1] if ":" in mode else "default"
        c = torch.clamp(agx_tonemap(c, look), 0.0, 1.0)
    else:
        c = torch.clamp(c, 0.0, 1.0)
    return c
