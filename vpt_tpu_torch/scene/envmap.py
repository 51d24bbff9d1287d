"""Environment map preprocessing (jax-free copy of vpt_tpu/scene/envmap.py).

Per-texel importance = texel solid angle x max(R, G, B); a Walker alias map
over texels with mean importance 1; alpha stores max(R, G, B) / sum of
importance, the quantity the MIS weights read as the PDF.  Leaves are numpy.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.scene.types import EnvMapData


def build_alias_map(importance: np.ndarray):
    """Walker alias map (Vose construction): (alias, normalised importance)."""
    n = importance.shape[0]
    total = float(importance.sum())
    if total <= 0.0:
        return np.arange(n, dtype=np.int32), np.zeros(n, np.float32)
    norm = (importance * (n / total)).astype(np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = list(np.nonzero(norm < 1.0)[0][::-1])
    large = list(np.nonzero(norm >= 1.0)[0][::-1])
    norm = norm.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        alias[s] = l
        norm[l] -= 1.0 - norm[s]
        if norm[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    return alias.astype(np.int32), norm.astype(np.float32)


def prepare_environment(image: np.ndarray) -> EnvMapData:
    """Solid-angle importance, alias map, PDF alpha and 2x2 neighbourhoods."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    rgb = image[..., :3]
    step_phi = 2.0 * np.pi / w
    cos_theta = np.cos(np.pi * np.arange(h + 1) / h)
    area = (cos_theta[:-1] - cos_theta[1:]) * step_phi
    brightness = rgb.max(axis=-1)
    importance = (area[:, None] * brightness).reshape(-1)
    alias, imp = build_alias_map(importance)
    total = float(importance.sum())
    pdf = brightness / total if total > 0 else np.zeros_like(brightness)
    out = np.concatenate([rgb, pdf[..., None]], axis=-1).astype(np.float32)
    if h * w <= 2 * 1024 * 1024:
        xr = np.concatenate([out[:, 1:], out[:, :1]], axis=1)  # x+1 wrapped
        yd = np.concatenate([out[1:], out[-1:]], axis=0)  # y+1 clamped
        ydxr = np.concatenate([yd[:, 1:], yd[:, :1]], axis=1)
        quad = np.concatenate([out, xr, yd, ydxr], axis=-1).astype(np.float32)
    else:
        quad = np.zeros((1, 1, 16), np.float32)
    return EnvMapData(
        image=out, alias=np.stack([imp, alias.astype(np.float32)], axis=-1), quad=quad,
    )


def constant_environment(color=(0.0, 0.0, 0.0), size=(8, 16)) -> EnvMapData:
    h, w = size
    img = np.zeros((h, w, 3), np.float32)
    img[..., :] = np.asarray(color, np.float32)
    return prepare_environment(img)


def default_sky(size=(64, 128), sun_azimuth=0.35, sun_altitude=0.35, sun_radiance=150.0) -> np.ndarray:
    """Procedural gradient sky with a sun hotspot, for scenes with no lights."""
    h, w = size
    ys = np.linspace(-1.0, 1.0, h)[:, None]
    up = np.clip(-ys, 0.0, 1.0)
    horizon = 1.0 - np.abs(ys)
    sky = np.zeros((h, w, 3), np.float32)
    sky[..., 0] = 0.25 + 0.35 * horizon + 0.05 * up
    sky[..., 1] = 0.35 + 0.35 * horizon + 0.15 * up
    sky[..., 2] = 0.55 + 0.30 * horizon + 0.35 * up
    ground = ys[:, 0] > 0
    sky[ground] *= np.array([0.45, 0.38, 0.30], np.float32)
    sy = int((0.5 - sun_altitude / 2) * h)
    sx = int((0.5 + sun_azimuth / 2) * w) % w
    sky[max(sy - 1, 0) : sy + 2, max(sx - 1, 0) : sx + 2] = sun_radiance
    return sky
