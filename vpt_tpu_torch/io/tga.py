"""TGA decoding to what PIL's TgaImagePlugin opens.

Image types 1, 2 and 3 and their RLE forms 9, 10 and 11; 8-bit colour-mapped
(mode "P", a 16- or 24-bit map whose first entry may be offset), 1- and 8-bit
gray and 16-bit gray + alpha, 16-bit "BGRA;15Z" (5-bit channels scaled as
v * 255 // 31, alpha 0 where bit 15 is set), 24- and 32-bit colour; the
orientation bits (bottom-up unless bit 5, mirrored when bit 4); RLE raw
packets that run on over scanlines as PIL's decoder reads them (the C codec's
`tga_rle`).  What PIL refuses raises a ValueError naming it; a header PIL's
plugin rejects raises PassOn, and PIL tries the file's later plugins.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn

# (image type & 7, depth) -> PIL's raw mode.
_RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z", (2, 24): "BGR",
             (2, 32): "BGRA"}
_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}


def _bgra15(v: np.ndarray) -> np.ndarray:
    """PIL's "BGRA;15Z" unpacker of little-endian 16-bit values: (..., 4) RGBA."""
    v = v.astype(np.int32)
    rgb = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
    return np.stack(rgb + [np.where(v & 0x8000, 0, 255)], axis=-1).astype(np.uint8)


def _unpack(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    h = rows.shape[0]
    if raw == "1":
        return np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    if raw in ("P", "L"):
        return rows[:, :w]
    if raw == "LA":
        return rows[:, : 2 * w].reshape(h, w, 2)
    if raw == "BGRA;15Z":
        return _bgra15(rows[:, : 2 * w].view("<u2"))
    size = 3 if raw == "BGR" else 4
    px = rows[:, : size * w].reshape(h, w, size)
    return px[..., [2, 1, 0, 3][:size]]


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A TGA file as PIL opens it: (array, mode, palette) with the palette
    (256, 3) or, for a 16-bit colour map, (256, 4) RGBA."""
    if len(data) < 18:
        raise PassOn(f"{name}: not a TGA file (its header is short)")
    id_len, map_type, image_type = data[0], data[1], data[2]
    map_start, map_len, map_depth = struct.unpack_from("<HHB", data, 3)
    w, h, depth, flags = struct.unpack_from("<HHBB", data, 12)
    if map_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise PassOn(f"{name}: not a TGA file")
    if image_type in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif image_type in (1, 9):
        mode = "P" if map_type else "L"
    elif image_type in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise PassOn(f"{name}: unknown TGA image type {image_type}")
    orientation = flags & 0x30
    if orientation not in (0, 0x10, 0x20, 0x30):
        raise PassOn(f"{name}: unknown TGA orientation")
    pos = 18 + id_len
    palette = None
    if map_type:
        entry = {16: 2, 24: 3, 32: 4}.get(map_depth)
        if entry is None:
            raise PassOn(f"{name}: unknown TGA colour map depth {map_depth}")
        table = bytes(entry * map_start) + data[pos : pos + entry * map_len]
        pos = min(pos + entry * map_len, max(len(data), pos))
        if map_depth == 32:
            raise ValueError(f"{name}: TGA with a 32-bit colour map (PIL: unrecognized raw mode)")
        n = len(table) // entry
        if n > 256:
            raise ValueError(f"{name}: TGA colour map of {n} entries (PIL: invalid palette size)")
        if map_depth == 16:
            palette = np.zeros((256, 4), np.uint8)
            palette[:, 3] = 255
            palette[:n] = _bgra15(np.frombuffer(table[: 2 * n], "<u2"))
        else:
            palette = np.zeros((256, 3), np.uint8)
            palette[:n] = np.frombuffer(table[: 3 * n], np.uint8).reshape(n, 3)[:, ::-1]
    raw = _RAWMODES.get((image_type & 7, depth))
    if raw is None:
        raise ValueError(f"{name}: TGA image type {image_type} at {depth} bits (PIL: cannot load this image)")
    if mode != {"P": "P", "1": "1", "L": "L", "LA": "LA", "BGRA;15Z": "RGBA", "BGR": "RGB", "BGRA": "RGBA"}[raw]:
        raise ValueError(f"{name}: TGA image type {image_type} in mode {mode} (PIL: no {raw} unpacker for it)")
    codec.check_size(w, h, name)
    row_bytes = (w * _BITS[raw] + 7) // 8
    if image_type & 8:
        rows, status = codec.tga_rle(data[pos:], depth // 8, row_bytes, h)
        if status < 0:
            raise ValueError(f"{name}: TGA RLE run crosses a scanline (PIL: image buffer overrun error)")
        if status:
            raise ValueError(f"{name}: TGA RLE data ends early (PIL: image file is truncated)")
    else:
        if len(data) - pos < row_bytes * h:
            raise ValueError(f"{name}: TGA image data is truncated")
        rows = np.frombuffer(data, np.uint8, row_bytes * h, pos).reshape(h, row_bytes)
    if not orientation & 0x20:  # bottom-up
        rows = rows[::-1]
    arr = _unpack(np.ascontiguousarray(rows), raw, w)
    if orientation & 0x10:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr), mode, palette
