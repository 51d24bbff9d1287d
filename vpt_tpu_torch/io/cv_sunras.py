"""Sun raster files as OpenCV 5.0's SunRasterDecoder (grfmt_sunras.cpp)
reads them with `IMREAD_COLOR`.

The header is eight big-endian 32-bit words: the magic, width, height,
depth, data length (not read), type, colour-map type and map length.
OpenCV takes depths 1, 8, 24 and 32 of the old (0) and standard (1) types
only: its test for byte-encoded (2) and RGB (3) data compares them with
the image type it has not set yet, so those fail.  The map is none (type 0,
length 0) or an RGB one (type 1) of 1 to 3 x 2^depth bytes for a depth up
to 8: its first third red, then green, then blue, entries past it black.
Without a map, depth 1 reads 0 as black and 1 as white, and depth 8 as
gray.  Rows are padded to 16 bits; 24-bit pixels are stored B, G, R and
32-bit ones X, B, G, R.  A file that ends before its last row's padding
fails.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec

MAGIC = b"\x59\xa6\x6a\x95"


def claims(sig: bytes) -> bool:
    return sig[:4] == MAGIC


def read(data: bytes, name: str) -> tuple:
    """The image as (H, W, 3) uint8 RGB, and no EXIF."""
    if len(data) < 32:
        raise ValueError(f"{name}: Sun raster header is truncated (OpenCV)")
    _, width, height, bpp, _, kind, maptype, maplength = struct.unpack(">8i", data[:32])
    pal_size = (1 << bpp) * 3 if 0 < bpp <= 8 else 0
    if not (width > 0 and height > 0 and bpp in (1, 8, 24, 32) and kind in (0, 1)
            and ((maptype == 0 and maplength == 0) or (maptype == 1 and 0 < maplength <= pal_size))):
        raise ValueError(f"{name}: Sun raster of {width}x{height} pixels, depth {bpp}, type {kind}, map type "
                         f"{maptype} ({maplength} bytes), which OpenCV does not read")
    if len(data) < 32 + maplength:
        raise ValueError(f"{name}: Sun raster colour map is truncated (OpenCV)")
    palette = np.zeros((256, 3), np.uint8)  # RGB
    if maplength:
        n = maplength // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32)
        palette[:n] = cmap.reshape(3, n).T
    elif bpp <= 8:
        palette[: 1 << bpp] = (np.arange(1 << bpp) * 255 // ((1 << bpp) - 1))[:, None]
    codec.check_cv_size(width, height, name)
    pitch = ((width * bpp + 7) // 8 + 1) & ~1
    start = 32 + maplength
    if len(data) - start < pitch * height:
        raise ValueError(f"{name}: Sun raster data is truncated (OpenCV)")
    rows = np.frombuffer(data, np.uint8, pitch * height, start).reshape(height, pitch)
    if bpp == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :width]], None
    if bpp == 8:
        return palette[rows[:, :width]], None
    c = bpp // 8
    px = rows[:, : width * c].reshape(height, width, c)
    return np.ascontiguousarray(px[..., [c - 1, c - 2, c - 3]]), None
