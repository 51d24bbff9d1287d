"""BMP files as OpenCV 5.0's BmpDecoder (grfmt_bmp.cpp) reads them with
`IMREAD_COLOR`.

The header: the pixel offset at byte 10, then an info header of 12 bytes
(OS/2: 16-bit width and height, depths 1, 4, 8, 24, 32, a palette of
2^depth B, G, R triples) or of 36 bytes or more (32-bit width and height,
a negative height top-down; compression 0-3 only; the colours-used word at
its byte 32; a palette of that many, or 2^depth, B, G, R, X quads, up to
256, right after the info header, entries past it black).  OpenCV takes
depths 1, 4, 8, 24 and 32 uncompressed, 16 uncompressed (5-5-5) or with the
bit fields 5-6-5 or 5-5-5 (read right after the info header, whatever its
size), 32 with any bit fields, RLE4 at depth 4 and RLE8 at depth 8.  The
bit fields of a 32-bit image are read from an info header of 56 bytes or
more (each field x 255 / its largest value, truncated), when none of red, green and
blue is 0; else the pixels are B, G, R, A.  Rows are padded to 4 bytes and read whole; a
file that ends before the last row's padding fails.

5-5-5 and 5-6-5 samples are widened by shifting alone (x << 3, no
repetition of the high bits).  The RLE decoders write the skipped pixels
of a delta, an end of line and an end of bitmap in palette entry 0, fail on
a run past the end of its row, and fail where the data ends before the
image is full; an end of line right after a run that ended its row exactly
does not skip a second row (RLE8).  OpenCV's RLE4 loop fills only the part
of the current row a record covers: a delta moves dx pixels and no rows,
an end of bitmap ends the row and reading goes on.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec


def claims(sig: bytes) -> bool:
    return sig[:2] == b"BM"


class _Bad(Exception):
    pass


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Bad
        self.pos += n
        return self.data[self.pos - n : self.pos]


def _header(data: bytes, name: str) -> tuple:
    if len(data) < 18:
        raise _Bad
    offset, size = struct.unpack_from("<ii", data, 10)
    if size <= 0:
        raise _Bad
    if size >= 36:
        if len(data) < 14 + 36:
            raise _Bad
        width, height, planes_bits, rle = struct.unpack_from("<iiii", data, 18)
        bpp = planes_bits >> 16
        if not 0 <= rle <= 3:
            raise _Bad
        (clrused,) = struct.unpack_from("<i", data, 46)
        pos = 14 + size  # (the skip to it past the end fails only at the next read)
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and rle == 0) or (bpp in (16, 32) and rle in (0, 3))
            or (bpp == 4 and rle == 2) or (bpp == 8 and rle == 1))
        if not ok:
            raise _Bad
        palette = np.zeros((256, 3), np.uint8)  # RGB
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                raise _Bad
            n = clrused or 1 << bpp
            table = np.frombuffer(_Stream(data, pos).take(n * 4), np.uint8).reshape(n, 4)
            palette[:n] = table[:, 2::-1]
        elif bpp == 16 and rle == 3:
            if len(data) < pos + 12:
                raise _Bad
            red, green, blue = struct.unpack_from("<iii", data, pos)
            if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                bpp = 15
            elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                raise _Bad
        elif bpp == 16:
            bpp = 15
    elif size == 12:
        if len(data) < 26:
            raise _Bad
        width, height, planes_bits = struct.unpack_from("<HHi", data, 18)
        bpp, rle = planes_bits >> 16, 0
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise _Bad
        palette = np.zeros((256, 3), np.uint8)
        if bpp <= 8:
            n = 1 << bpp
            table = np.frombuffer(_Stream(data, 26).take(n * 3), np.uint8).reshape(n, 3)
            palette[:n] = table[:, ::-1]
    else:
        raise _Bad
    masks = None
    if bpp == 32 and rle == 3 and size >= 56:
        red, green, blue = struct.unpack_from("<III", data, 54)
        if red and green and blue:
            masks = (red, green, blue)
    return offset, width, height, bpp, rle, palette, masks


def _field(v: np.ndarray, mask: int) -> np.ndarray:
    """A bit field scaled to 8 bits: value x (255 / its largest value) in
    float, truncated."""
    shift = (mask & -mask).bit_length() - 1
    scale = np.float32(255.0) / np.float32(mask >> shift)
    return (((v & mask) >> shift).astype(np.float32) * scale).astype(np.int64)


def _rle(s: _Stream, width: int, height: int, rle4: bool) -> np.ndarray:
    """The RLE records into (height, width) indices, rows in stream order
    (the loops of BmpDecoder::readData, a row's end `line_end`)."""
    out = np.zeros(height * width, np.int32)
    y, x, wrapped = 0, 0, False  # x: pixels written in row y; wrapped: RLE8's line_end_flag

    def fill(count: int) -> None:  # FillUniColor of entry 0, `count` pixels, across rows
        nonlocal x, y
        while True:
            end = min(x + count, width)
            out[y * width + x : y * width + end] = 0
            count -= end - x
            x = end
            if x >= width:
                x = 0
                y += 1
                if y >= height:
                    return
            if count <= 0:
                return

    while True:
        n, code = s.take(2)
        if n:  # encoded run
            if x + n > width:
                raise _Bad
            if rle4:
                out[y * width + x : y * width + x + n] = np.array([code >> 4, code & 15] * ((n + 1) // 2))[:n]
                x += n
            else:
                prev = y
                out[y * width + x : y * width + x + n] = code
                x += n
                if x >= width:
                    x, y = 0, y + 1
                wrapped = y != prev
                if y >= height:
                    break
        elif code > 2:  # absolute run
            if x + code > width:
                raise _Bad
            raw = np.frombuffer(s.take(((code + 1) // 2 + 1) & ~1 if rle4 else (code + 1) & ~1), np.uint8)
            vals = np.stack([raw >> 4, raw & 15], -1).reshape(-1) if rle4 else raw
            out[y * width + x : y * width + x + code] = vals[:code]
            x += code
            wrapped = False
        else:
            skip = width - x
            rows = height - y
            if not rle4 and not (code or not wrapped or skip < width):
                wrapped = False
                continue
            if code == 2:
                dx, dy = s.take(2)
                skip, rows = dx, dy
            if code != 0 and not rle4:  # (RLE4 fills the row's part alone: a delta's dx, to the row's end)
                skip += rows * width
            if y >= height:
                break
            fill(skip)
            if y >= height:
                break
            wrapped = False
    return out.reshape(height, width)


def read(data: bytes, name: str) -> tuple:
    """The image as (H, W, 3) uint8 RGB, and no EXIF."""
    try:
        offset, width, height, bpp, rle, palette, masks = _header(data, name)
    except (_Bad, struct.error):
        raise ValueError(f"{name}: BMP header OpenCV does not read") from None
    top_down = height < 0
    height = abs(height)
    codec.check_cv_size(width, height, name)
    s = _Stream(data, offset)
    try:
        if rle in (1, 2):
            rows = palette[_rle(s, width, height, rle == 2)]
        else:
            pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
            if offset < 0:
                raise _Bad
            raw = np.frombuffer(s.take(pitch * height), np.uint8).reshape(height, pitch)
            if bpp <= 8:
                idx = np.unpackbits(raw, axis=1).reshape(height, -1, bpp)
                idx = (idx << np.arange(bpp - 1, -1, -1, dtype=np.uint8)).sum(-1)[:, :width]
                rows = palette[idx]
            elif bpp in (15, 16):
                t = raw[:, : 2 * width].copy().view("<u2").astype(np.int32)
                if bpp == 15:
                    b, g, r = (t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8
                else:
                    b, g, r = (t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8
                rows = np.stack([r, g, b], -1).astype(np.uint8)
            elif masks:
                v = raw[:, : 4 * width].copy().view("<u4").astype(np.int64)
                rows = np.stack([_field(v, m) for m in masks], -1).astype(np.uint8)
            else:
                c = bpp // 8
                rows = raw[:, : c * width].reshape(height, width, c)[..., 2::-1]
    except _Bad:
        raise ValueError(f"{name}: BMP data OpenCV does not read (truncated or a bad RLE record)") from None
    return np.ascontiguousarray(rows if top_down else rows[::-1]), None
