"""Sun raster decoding to what PIL's SunImagePlugin opens (not OpenCV's
reader, io/cv_sunras.py, which imageio uses only where it hands the file to
OpenCV): 1-bit ("1", a set bit black), 4-bit gray ("L"), 8-bit gray or,
with an RGB colour map, palette ("P"), 24- and 32-bit BGR or RGB (file type
3) as "RGB"; raw scanlines padded to 16 bits, or PIL's byte-oriented RLE
(type 2, the C codec's `sun_rle`, scanlines unpadded).  A header PIL's
plugin does not take raises PassOn."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from(">I", prefix)[0] == 0x59A66A95


def palette_rgbl(entries: bytes) -> np.ndarray:
    """PIL's "RGB;L" palette (all reds, then greens, then blues) as a (256,
    3) table, the entries it does not give black."""
    n = min(len(entries) // 3, 256)
    table = np.zeros((256, 3), np.uint8)
    planes = np.frombuffer(entries, np.uint8, 3 * n).reshape(3, n)
    table[:n] = planes.T
    return table


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A Sun raster file as PIL opens it: (array, mode, palette or None)."""
    if not accept(data) or len(data) < 32:
        raise PassOn(f"{name}: not a Sun raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack_from(">7I", data, 4)
    modes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
             24: ("RGB", "RGB" if ftype == 3 else "BGR"), 32: ("RGB", "RGBX" if ftype == 3 else "BGRX")}
    if depth not in modes:
        raise PassOn(f"{name}: Sun raster depth {depth} (PIL: unsupported mode)")
    mode, rawmode = modes[depth]
    offset, palette = 32, None
    if plen:
        if plen > 1024:
            raise PassOn(f"{name}: Sun raster colour map of {plen} bytes")
        if ptype != 1:
            raise PassOn(f"{name}: Sun raster colour map type {ptype}")
        offset += plen
        palette = palette_rgbl(data[32 : 32 + plen])
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
        else:
            raise ValueError(f"{name}: a colour map on a {mode} Sun raster (PIL cannot load it)")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise PassOn(f"{name}: Sun raster file type {ftype}")
    if w == 0 or h == 0:
        raise PassOn(f"{name}: Sun raster of {w}x{h} pixels")
    codec.check_size(w, h, name)
    if ftype != 2:
        stride = ((w * depth + 15) // 16) * 2
        return raw.tile(data, offset, w, h, mode, rawmode, name, stride=stride), mode, palette
    try:
        lines = codec.sun_rle(memoryview(data)[offset:], (w * raw.bits(rawmode) + 7) // 8, h)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return raw.unpack(mode, rawmode, lines, w), mode, palette
