"""BMP decoding to what PIL's BmpImagePlugin opens.

Headers: CORE (12 bytes) and INFO, V2-V5 (40, 52, 56, 64, 108, 124 bytes);
bottom-up rows, or top-down ones under a negative height.  Pixels: 1-, 4- and
8-bit palettes (mode "P"; mode "1" or "L" when the palette is black and
white or the identity gray ramp, as PIL decides), 16-bit 5-5-5 and
BI_BITFIELDS 5-6-5 and 5-5-5, 24-bit, 32-bit BI_RGB (the fourth byte
ignored) and BI_BITFIELDS in the byte orders PIL reads (with an alpha mask:
mode "RGBA"), and RLE8 / RLE4 (the C codec's `bmp_rle`, which decodes as
PIL's RLE decoder does).  A 5- or 6-bit channel is scaled as PIL scales it,
v * 255 // 31 (or 63).  Palette entries past the table are black, as in
PIL.  What PIL refuses (other depths, masks and
compressions, JPEG or PNG inside a BMP) raises a ValueError naming it.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec

_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"), 24: ("RGB", "BGR"),
             32: ("RGB", "BGRX")}
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX", (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR", (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA", (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR", (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR", (16, (0xF800, 0x7E0, 0x1F)): "BGR;16", (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
# Byte positions of R, G, B (and A) in a pixel of each byte-order raw mode.
_ORDER = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1), "BGXR": (3, 1, 0), "ABGR": (3, 2, 1, 0),
          "RGBA": (0, 1, 2, 3), "BGRA": (2, 1, 0, 3), "BGAR": (3, 1, 0, 2)}


def _unpack(rows: np.ndarray, raw: str, w: int) -> np.ndarray:
    """PIL's unpacker `raw` over (h, stride) rows: (h, w) indices, levels or
    booleans, or (h, w, 3 | 4) uint8."""
    h = rows.shape[0]
    if raw in ("P;1", "1"):
        bits = np.unpackbits(rows, axis=1)[:, :w]
        return bits.astype(bool) if raw == "1" else bits
    if raw == "P;4":
        return np.stack([rows >> 4, rows & 15], axis=-1).reshape(h, -1)[:, :w]
    if raw in ("P", "L"):
        return rows[:, :w]
    if raw in ("BGR;15", "BGR;16"):
        v = rows[:, : 2 * w].view("<u2").astype(np.int32)
        if raw == "BGR;15":
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            return np.stack([r * 255 // 31, g * 255 // 31, b * 255 // 31], axis=-1).astype(np.uint8)
        r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
        return np.stack([r * 255 // 31, g * 255 // 63, b * 255 // 31], axis=-1).astype(np.uint8)
    size = 3 if raw == "BGR" else 4
    px = rows[:, : size * w].reshape(h, w, size)
    return px[..., list(_ORDER[raw])]


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A BMP as PIL opens it: (array, mode, (256, 3) palette or None)."""
    if data[:2] != b"BM":
        raise ValueError(f"{name} is not a BMP file")
    if len(data) < 18:
        raise ValueError(f"{name}: BMP file is truncated")
    offset = struct.unpack_from("<I", data, 10)[0]
    return decode(data, header(data, 14, name, offset), name)


def header(data: bytes, pos: int, name: str, offset: int = 0, raw_alpha: bool = False) -> dict:
    """PIL's BmpImageFile._bitmap: the bitmap header at `pos` (after a BMP
    file header, or where a DIB, ICO or CUR entry starts), with its masks
    and palette: width, height, bits, mode, raw (the unpacker), palette,
    rle (0, or 1 / 2 for RLE8 / RLE4), direction and start (the pixel data's
    offset: `offset`, or where the header and its palette end).  raw_alpha
    reads 32-bit BI_RGB pixels as BGRA (PIL does for a CUR bitmap at 22)."""
    header_size = struct.unpack_from("<I", data, pos)[0]
    hd = data[pos + 4 : pos + header_size]
    if len(hd) < header_size - 4 or header_size < 12:
        raise ValueError(f"{name}: BMP header is truncated")
    pos += header_size
    direction = -1
    masks = None
    if header_size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", hd, 0)
        compression, colors, padding = 0, 0, 3
    elif header_size in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        direction = 1 if flip else -1
        w, h = struct.unpack_from("<II", hd, 0)
        h = 2**32 - h if flip else h
        bits, compression = struct.unpack_from("<HI", hd, 10)
        colors = struct.unpack_from("<I", hd, 28)[0]
        padding = 4
        if compression == 3:
            if len(hd) >= 48:
                masks = list(struct.unpack_from("<III", hd, 36)) + [struct.unpack_from("<I", hd, 48)[0]
                                                                    if len(hd) >= 52 else 0]
            else:
                if pos + 12 > len(data):
                    raise ValueError(f"{name}: BMP bit masks are truncated")
                masks = list(struct.unpack_from("<III", data, pos)) + [0]
                pos += 12
    else:
        raise ValueError(f"{name}: BMP header type ({header_size} bytes) is not read")
    colors = colors if colors else 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"{name}: {bits}-bit BMP images are not read")
    mode, raw = _BIT2MODE[bits]
    rle = 0
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if bits not in (16, 24, 32) or key not in _MASK_MODES:
            raise ValueError(f"{name}: BMP bit-field layout {tuple(hex(m) for m in masks)} is not read")
        raw = _MASK_MODES[key]
        if bits == 32 and "A" in raw:
            mode = "RGBA"
    elif compression in (1, 2):
        rle = compression
    elif compression != 0:
        raise ValueError(f"{name}: BMP compression {compression} is not read (only none, RLE8, RLE4 and bit "
                         f"fields)")
    elif bits == 32 and raw_alpha:
        mode, raw = "RGBA", "BGRA"
    palette = None
    if mode == "P":
        if not 0 < colors <= 256:
            raise ValueError(f"{name}: BMP palette size {colors} is not read")
        table = data[pos : pos + padding * colors]
        pos += len(table)
        indices = (0, 255) if colors == 2 else range(colors)
        gray = all(table[i * padding : i * padding + 3] == bytes([v & 0xFF]) * 3 for i, v in enumerate(indices))
        if gray:
            mode = raw = "1" if colors == 2 else "L"
        else:
            n = min(len(table) // padding, 256)
            palette = np.zeros((256, 3), np.uint8)
            if n:
                palette[:n] = np.frombuffer(table[: n * padding], np.uint8).reshape(n, padding)[:, 2::-1]
    return {"width": w, "height": h, "bits": bits, "mode": mode, "raw": raw, "palette": palette, "rle": rle,
            "direction": direction, "start": offset or pos}


def decode(data: bytes, hd: dict, name: str, height: int | None = None) -> tuple:
    """The pixels a header describes (its height, or `height` rows of it, as
    an ICO or CUR entry gives): (array, mode, palette)."""
    w, h, bits, mode, raw, start = hd["width"], hd["height"] if height is None else height, hd["bits"], hd["mode"], \
        hd["raw"], hd["start"]
    if w == 0 or h == 0:
        raise ValueError(f"{name}: BMP image has no pixels")
    codec.check_size(w, h, name)
    if hd["rle"]:
        if mode == "1":
            raise ValueError(f"{name}: RLE BMP with a black-and-white palette is not read (PIL has no unpacker)")
        idx = codec.bmp_rle(data[start:], start, w, h, hd["rle"] == 2)
        if idx.size < w * h:
            raise ValueError(f"{name}: BMP RLE data is short of the image (not enough image data)")
        rows, raw = idx.reshape(h, w), "P"
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        need = {"1": 1, "P;1": 1, "P;4": 4, "L": 8, "P": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}.get(raw, 32)
        if (w * need + 7) // 8 > stride:
            raise ValueError(f"{name}: BMP palette and depth do not fit (PIL's raw decoder refuses them)")
        if start + stride * h > len(data):
            raise ValueError(f"{name}: BMP file is truncated")
        rows = np.frombuffer(data, np.uint8, stride * h, start).reshape(h, stride)
    if hd["direction"] == -1:
        rows = rows[::-1]
    arr = _unpack(np.ascontiguousarray(rows), raw, w)
    return np.ascontiguousarray(arr), mode, hd["palette"]
