"""PhotoCD decoding to what PIL's PcdImagePlugin opens: the 768x512 base
image at sector 96 (two rows of luma and a row of each half-width chroma
plane per 2,304 bytes, the C codec's `pcd_planes`), PhotoYCC to RGB as
PIL's "YCC;P" unpacker converts it, turned 90 or 270 degrees as the header's
orientation says.  A file without the "PCD_" mark at byte 2048 raises
PassOn."""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn

_TABLES = None


def _tables() -> tuple:
    """PIL's PhotoYCC tables (UnpackYCC.c): luma 1.3584 * y, and the chroma
    terms k * (c - 156) or k * (c - 137), each plus 0.5 truncated toward
    zero (equal to PIL's unpacker on all 2**24 inputs)."""
    global _TABLES
    if _TABLES is None:
        i = np.arange(256, dtype=np.float64)
        _TABLES = tuple(np.trunc(v + 0.5).astype(np.int32) for v in
                        (1.3584 * i, 1.8215 * (i - 137), -0.9271 * (i - 137), -0.4303 * (i - 156), 2.2179 * (i - 156)))
    return _TABLES


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """(..., 3) PhotoYCC (Y, C1, C2) uint8 to RGB as PIL's "YCC;P" does."""
    lum, cr, gr, gb, cb = _tables()
    y, c1, c2 = (ycc[..., k] for k in range(3))
    l = lum[y]
    rgb = np.stack([l + cr[c2], l + gr[c2] + gb[c1], l + cb[c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A PhotoCD file as PIL opens it: (array, "RGB", None)."""
    s = data[2048 : 2048 + 1539]
    if not s.startswith(b"PCD_") or len(s) < 1539:
        raise PassOn(f"{name}: not a PCD file")
    orientation = s[1538] & 3
    try:
        planes = codec.pcd_planes(memoryview(data)[96 * 2048 :], 768, 512)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    rgb = ycc_to_rgb(planes)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, -1)
    return np.ascontiguousarray(rgb), "RGB", None
