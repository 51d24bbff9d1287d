"""Bloom: threshold extraction and a box down/upsample mip chain (port of
vpt_tpu/post/bloom.py; PostProcess/BloomDownSample.slang, BloomUpSample.slang
and PostProcessor.cpp:199-247).

Up to 10 mip levels, each at half resolution, then additive upsampling back
to full resolution.  The 4x4 box filters are 16 clamped shifted gathers,
summed in the JAX package's order.
"""

from __future__ import annotations

import torch

_LUMA = (0.2126, 0.7152, 0.0722)


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / max(e1 - e0, 1e-8), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def threshold_extract(image, bloom_threshold, falloff_range):
    """First dispatch: smoothstep brightness window (BloomDownSample.slang:32-45)."""
    lw = torch.tensor(_LUMA, dtype=torch.float32, device=image.device)
    brightness = torch.sum(image * lw, dim=-1, keepdim=True)
    return image * smoothstep(bloom_threshold - falloff_range, bloom_threshold + falloff_range, brightness)


def _box4(src, ys, xs, offset: int):
    """Sum of the 16 samples src[ys + dy + offset, xs + dx + offset] for
    dy, dx in -2..1, coordinates clamped to the image."""
    h, w = src.shape[0], src.shape[1]
    acc = torch.zeros((ys.shape[0], xs.shape[0], src.shape[2]), dtype=src.dtype, device=src.device)
    for dy in range(-2, 2):
        for dx in range(-2, 2):
            yy = torch.clamp(ys + dy + offset, 0, h - 1)
            xx = torch.clamp(xs + dx + offset, 0, w - 1)
            acc = acc + src[yy[:, None], xx[None, :]]
    return acc


def downsample(image, strength):
    """4x4 clamped box downsample to half resolution, times strength
    (BloomDownSample.slang:46-63: samples at 2p + (-2..1))."""
    h, w = image.shape[0], image.shape[1]
    ys = torch.arange(max(h // 2, 1), device=image.device) * 2
    xs = torch.arange(max(w // 2, 1), device=image.device) * 2
    return _box4(image, ys, xs, 0) / 25.0 * strength  # /= (2*2+1)^2, exactly as the shader


def upsample_add(low, high, strength):
    """4x4 box upsample of `low` added into `high`
    (BloomUpSample.slang:31-48: samples at p/2 + (-2..1) + 1)."""
    ys = torch.arange(high.shape[0], device=high.device) // 2
    xs = torch.arange(high.shape[1], device=high.device) // 2
    return high + _box4(low, ys, xs, 1) / 25.0 * strength


def bloom(image, threshold=1.5, strength=0.5, falloff_range=0.5, mip_levels=10):
    """The bloom image at full resolution (PostProcessor.cpp:199-232), to be
    added to the input before tonemapping (Tonemap.slang:169)."""
    h, w = image.shape[0], image.shape[1]
    levels = []
    base = threshold_extract(image, threshold, falloff_range)
    cur = base
    size = min(h, w)
    while size >= 2 and len(levels) < mip_levels:
        cur = downsample(cur, strength)
        levels.append(cur)
        size //= 2
    if not levels:
        return base
    acc = levels[-1]
    for lvl in reversed(levels[:-1]):
        acc = upsample_add(acc, lvl, strength)
    # The last upsample adds into the thresholded full-resolution image:
    # mip 0 of the reference's chain.
    return upsample_add(acc, base, strength)
