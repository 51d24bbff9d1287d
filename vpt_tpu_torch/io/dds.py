"""DDS decoding to what PIL's DdsImagePlugin opens.

The legacy header and DX10's: block-compressed DXT1 / DXT3 / DXT5 (BC1-BC3,
mode "RGBA"), ATI1 / BC4U (mode "L"), ATI2 / BC5U and BC5S (mode "RGB"),
BC6H UF16 / SF16 (mode "RGB") and BC7 (mode "RGBA") through the block
decoders of csrc/bcndec.c; uncompressed RGB(A) with any channel masks (each
channel v * 255 / (mask >> shift), truncated, PIL's reading, a short file
read as zeros), 8-bit luminance, 16-bit luminance + alpha, 8-bit palette
(mode "P" with a 256-entry RGBA palette) and DX10 R8G8B8A8.  Only the first
surface is read; mip levels, array slices and cube faces after it are
skipped, as PIL skips them.  What PIL refuses raises a ValueError naming it;
a file PIL's plugin does not claim raises PassOn.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn

_ALPHAPIXELS, _FOURCC, _PALETTEINDEXED8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FourCC -> (block kind, signed, mode)
_FOURCCS = {b"DXT1": (1, False, "RGBA"), b"DXT3": (2, False, "RGBA"), b"DXT5": (3, False, "RGBA"),
            b"BC4U": (4, False, "L"), b"ATI1": (4, False, "L"), b"BC5S": (5, True, "RGB"),
            b"BC5U": (5, False, "RGB"), b"ATI2": (5, False, "RGB")}
# DXGI format -> (block kind, signed, mode); kind 0 is uncompressed RGBA.
_DXGI = {70: (1, False, "RGBA"), 71: (1, False, "RGBA"), 73: (2, False, "RGBA"), 74: (2, False, "RGBA"),
         76: (3, False, "RGBA"), 77: (3, False, "RGBA"), 79: (4, False, "L"), 80: (4, False, "L"),
         82: (5, False, "RGB"), 83: (5, False, "RGB"), 84: (5, True, "RGB"), 95: (6, False, "RGB"),
         96: (6, True, "RGB"), 97: (7, False, "RGBA"), 98: (7, False, "RGBA"), 99: (7, False, "RGBA"),
         27: (0, False, "RGBA"), 28: (0, False, "RGBA"), 29: (0, False, "RGBA")}


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int, masks: tuple) -> np.ndarray:
    """PIL's DdsRgbDecoder: w * h little-endian pixels of bitcount // 8 bytes
    (only the low 32 bits meet a mask), reads past the end giving zeros."""
    size = bitcount // 8
    n = w * h
    rest = np.frombuffer(data, np.uint8, max(0, len(data) - pos), pos)
    values = np.zeros(n, np.uint64)
    if size:
        starts = np.arange(n, dtype=np.int64) * size
        for k in range(min(size, 4)):
            idx = starts + k
            byte = np.where(idx < rest.size, rest[np.minimum(idx, max(rest.size - 1, 0))] if rest.size else 0, 0)
            values |= byte.astype(np.uint64) << np.uint64(8 * k)
    out = np.zeros((n, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if mask == 0:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = (values & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = (v.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A DDS file as PIL opens it: (array, mode, palette); the palette of
    mode "P" is (256, 4) RGBA."""
    if data[:4] != b"DDS ":
        raise PassOn(f"{name}: not a DDS file")
    if len(data) < 8:
        raise PassOn(f"{name}: DDS header is short")
    (header_size,) = struct.unpack_from("<I", data, 4)
    if header_size != 124:
        raise ValueError(f"{name}: unsupported DDS header size {header_size}")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError(f"{name}: incomplete DDS header ({len(header)} bytes)")
    _, height, width = struct.unpack_from("<3I", header, 0)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", header, 72)
    pos, kind, sign, palette = 128, None, False, None
    if pfflags & _RGB:
        count = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", header, 84)
        mode = "RGBA" if count == 4 else "RGB"
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            mode = "LA"
        else:
            raise ValueError(f"{name}: unsupported DDS luminance bit count {bitcount} for flags {pfflags}")
    elif pfflags & _PALETTEINDEXED8:
        mode = "P"
        table = data[128:1152]
        pos = 128 + len(table)
        n = len(table) // 4
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        palette[:n] = np.frombuffer(table[: 4 * n], np.uint8).reshape(n, 4)
    elif pfflags & _FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:
                raise PassOn(f"{name}: DDS DX10 header is short")
            (dxgi,) = struct.unpack_from("<I", data, 128)
            pos = 148
            if dxgi not in _DXGI:
                raise ValueError(f"{name}: unimplemented DXGI format {dxgi} (PIL does not read it)")
            kind, sign, mode = _DXGI[dxgi]
        elif fourcc in _FOURCCS:
            kind, sign, mode = _FOURCCS[fourcc]
        else:
            raise ValueError(f"{name}: unimplemented DDS pixel format {fourcc!r} (PIL does not read it)")
    else:
        raise ValueError(f"{name}: unknown DDS pixel format flags {pfflags}")
    if width <= 0 or height <= 0:
        raise PassOn(f"{name}: DDS image of {width}x{height} pixels")
    codec.check_size(width, height, name)
    if pfflags & _RGB:
        return _masked(data, pos, width, height, bitcount, masks), mode, None
    if kind:
        arr = codec.bcn_decode(np.frombuffer(data, np.uint8, len(data) - pos, pos), width, height, kind, sign)
        return (arr[..., :3] if mode == "RGB" else arr), mode, None
    bands = {"L": 1, "LA": 2, "P": 1, "RGBA": 4}[mode]
    n = width * height * bands
    if len(data) - pos < n:
        raise ValueError(f"{name}: DDS image data is truncated")
    arr = np.frombuffer(data, np.uint8, n, pos)
    return arr.reshape((height, width) if bands == 1 else (height, width, bands)), mode, palette
