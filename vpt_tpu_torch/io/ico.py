"""ICO and CUR decoding to what PIL's IcoImagePlugin and CurImagePlugin open.

ICO: the entry PIL picks (the largest area, then the smallest colour depth,
then the first), a PNG entry as the port's PNG decoder reads it (in its own
mode, without its transparency), a BMP entry (io/bmp.py) as the upper half
of its bitmap converted to RGBA with its AND mask, or for a 32-bit entry its
fourth bytes, as alpha.  CUR: the first entry unless a later one is larger
in both width and height bytes, its bitmap's upper half in the bitmap's own
mode, no mask (32-bit BI_RGB pixels as BGRA when the bitmap starts at byte
22).  A file PIL's plugin passes on raises PassOn; CUR's `\\0\\0\\2\\0` is
also an uncompressed TGA's first four bytes, and such a file goes on to the
TGA reader as in PIL.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from vpt_tpu_torch.io import bmp
from vpt_tpu_torch.io.probe import PassOn

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _entries(data: bytes, name: str) -> list:
    if len(data) < 6:
        raise PassOn(f"{name}: icon directory is short")
    (count,) = struct.unpack_from("<H", data, 4)
    out = []
    for i in range(count):
        e = data[6 + 16 * i : 22 + 16 * i]
        out.append(e)
        if len(e) < 16:
            break
    return out


def bitmap_header(data: bytes, pos: int, name: str, raw_alpha: bool = False) -> dict:
    """bmp.header, with the cases PIL's plugins pass on (a short header size
    field or bit masks) raised as PassOn."""
    if pos + 4 > len(data):
        raise PassOn(f"{name}: bitmap header is short")
    (size,) = struct.unpack_from("<I", data, pos)
    if size == 40 and len(data) >= pos + 40 and struct.unpack_from("<I", data, pos + 16)[0] == 3 and \
            pos + 52 > len(data):
        raise PassOn(f"{name}: bitmap masks are short")
    return bmp.header(data, pos, name, raw_alpha=raw_alpha)


def read_cur(data: bytes, name: str = "image") -> tuple:
    """A CUR file as PIL opens it: (array, mode, palette)."""
    if len(data) < 6:
        raise PassOn(f"{name}: cursor directory is short")
    (count,) = struct.unpack_from("<H", data, 4)
    best, pos = b"", 6
    for _ in range(count):
        e = data[pos : pos + 16]
        pos += len(e)
        if not best:
            best = e
        elif len(e) < 2 or len(best) < 2:
            raise PassOn(f"{name}: cursor directory is short")
        elif e[0] > best[0] and e[1] > best[1]:
            best = e
    if len(best) < 16:
        raise PassOn(f"{name}: no cursors were found")
    (start,) = struct.unpack_from("<I", best, 12)
    hd = bitmap_header(data, start or pos, name, raw_alpha=start == 22)
    height = hd["height"] // 2
    if hd["width"] <= 0 or height <= 0:
        raise PassOn(f"{name}: cursor of {hd['width']}x{height} pixels")
    return bmp.decode(data, hd, name, height=height)


def read_ico(data: bytes, name: str, png) -> tuple:
    """An ICO file as PIL opens it: (array, mode, palette).  png(bytes)
    decodes a PNG entry as PIL opens it, (array, mode, palette)."""
    entries = _entries(data, name)
    if not entries or len(entries[-1]) < 16:
        raise PassOn(f"{name}: icon directory is empty or short")
    heads = []
    for e in entries:
        width, height, nb_color = e[0] or 256, e[1] or 256, e[2]
        bpp, size, offset = struct.unpack_from("<HII", e, 6)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        heads.append((width, height, bpp, size, offset, depth))
    heads.sort(key=lambda x: x[5])
    heads.sort(key=lambda x: x[0] * x[1], reverse=True)
    _, _, bpp, size, offset, _ = heads[0]
    if data[offset : offset + 8] == _PNG_SIGNATURE:
        return png(data[offset:])
    hd = bitmap_header(data, offset, name)
    w, h = hd["width"], int(hd["height"] / 2)
    if w <= 0 or h <= 0:
        raise PassOn(f"{name}: icon bitmap of {w}x{h} pixels")
    if bpp == 32:
        alpha = data[hd["start"] : hd["start"] + w * h * 4][3::4]
        if len(alpha) < w * h:
            raise ValueError(f"{name}: icon alpha is short (PIL: not enough image data)")
        mask = np.frombuffer(alpha, np.uint8, w * h).reshape(h, w)[::-1]
    else:
        padded = w + (32 - w % 32) % 32
        total = padded * h // 8
        at = offset + size - total
        if at < 0:
            raise ValueError(f"{name}: icon AND mask before the file's start (PIL: negative seek)")
        bits = data[at : at + total]
        if len(bits) < total:
            raise ValueError(f"{name}: icon AND mask is short (PIL: not enough image data)")
        rows = np.frombuffer(bits, np.uint8).reshape(h, padded // 8)[::-1]
        mask = np.where(np.unpackbits(rows, axis=1)[:, :w], 0, 255).astype(np.uint8)
    arr, mode, palette = bmp.decode(data, hd, name, height=h)
    rgba = np.empty((h, w, 4), np.uint8)
    if mode == "P":
        rgba[..., :3] = palette[arr]
    elif mode in ("1", "L"):
        rgba[..., :3] = (arr.astype(np.uint8) * 255 if mode == "1" else arr)[..., None]
    else:
        rgba[..., :3] = arr[..., :3]
    rgba[..., 3] = mask
    return rgba, "RGBA", None
