"""GIF files as OpenCV 5.0's own GifDecoder (grfmt_gif.cpp) reads their
first frame with `IMREAD_COLOR`.

The header must say GIF87a or GIF89a (any "GIF" file is claimed).  The
logical screen is the image; a frame that reaches past it fails, as
does one without a colour table (local, else the global one), a
background index past the global table, a disposal method above 3 before
the first frame, or a file whose blocks do not run on to the trailer
(`_walk`; later frames' codes are not decoded).

The canvas is the global table's background colour (black without a global
table), whatever the disposal; the frame's indices are written as their
colours (the local table, else the global one; an index past both fails),
a pixel of the transparent index keeping the canvas.

The LZW decoder is OpenCV's (`lzwDecode`): LSB-first codes of 3-12 bits, a
clear code resets the table, and decoding stops at the frame's last pixel;
a code past the table, a string that runs past the frame, or codes or data
that end before its last pixel fail.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec


def claims(sig: bytes) -> bool:
    """GifDecoder::checkSignature: "GIF"."""
    return sig[:3] == b"GIF"


class _Fail(Exception):
    pass


class _Stream:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Fail("the data ends early")
        self.pos += 1
        return self.data[self.pos - 1]

    def word(self) -> int:
        return self.byte() | self.byte() << 8


def _lzw(s: _Stream, npixels: int) -> tuple:
    """(indices, count, ok) of OpenCV's lzwDecode."""
    min_size = s.byte()
    size = min_size + 1
    if not 2 < size <= 12:
        raise _Fail(f"LZW code size {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray(npixels)
    idx = 0
    prefix, suffix = {}, {}
    table = end
    left, src = 0, 0
    block = s.byte()
    while block:
        if left < size:
            src |= s.byte() << left
            block -= 1
            left += 8
        while left >= size:
            code = src & ((1 << size) - 1)
            src >>= size
            left -= size
            if code == end and idx == npixels:
                return out, idx, True
            if code == clear or code == end:
                prefix, suffix = {}, {}
                size, table = min_size + 1, end
                continue
            if code > table:  # (a code past the table ends the decoding)
                return out, idx, idx == npixels
            if idx == npixels:
                return out, idx, False
            if code < clear:
                suffix[table] = code
                table += 1
                prefix[table] = bytes([code])
                table = min(table, 4096)
            elif code <= table:
                p = prefix.get(code, b"")
                if not p:
                    return out, idx, False
                suffix[table] = p[0]
                table += 1
                prefix[table] = p + bytes([suffix.get(code, 0)])
                table = min(table, 4096)
            else:
                return out, idx, False
            run = bytes([code]) if code < clear else prefix[code] + bytes([suffix.get(code, 0)])
            if idx + len(run) > npixels:
                return out, idx, False
            out[idx : idx + len(run)] = run
            idx += len(run)
            if table == 1 << size and size < 12:
                size += 1
        if block == 0:
            block = s.byte()
    return out, idx, idx == npixels


def _walk(data: bytes, pos: int) -> None:
    """The block structure of the whole file, which OpenCV walks to count
    its frames: extensions and images (descriptor, colour table, code size,
    sub-blocks) up to the trailer; another byte, or the end of the data
    before the trailer, fails."""
    s = _Stream(data, pos)
    while True:
        c = s.byte()
        if c == 0x3B:
            return
        if c == 0x21:
            s.byte()
        elif c == 0x2C:
            s.pos += 8
            f = s.byte()
            if f & 0x80:
                s.pos += 3 << ((f & 7) + 1)
            s.byte()
        else:
            raise _Fail(f"block 0x{c:02X}")
        n = s.byte()
        while n:
            s.pos += n
            n = s.byte()


def read(data: bytes, name: str) -> tuple:
    """The first frame on its screen as (H, W, 3) uint8 RGB, and no EXIF."""
    try:
        return _read(data, name), None
    except _Fail as e:
        raise ValueError(f"{name}: GIF that OpenCV does not read ({e})") from None


def _read(data: bytes, name: str) -> np.ndarray:
    if data[:6] not in (b"GIF87a", b"GIF89a"):  # (GifDecoder::readHeader; its signature check takes "GIF")
        raise _Fail(f"version {data[3:6]!r}")
    s = _Stream(data, 6)
    sw, sh = s.word(), s.word()
    if not (sw > 0 and sh > 0):
        raise _Fail(f"a screen of {sw}x{sh}")
    flags = s.byte()
    bg = s.byte()
    s.byte()
    global_table = None
    if flags & 0x80:
        n = 1 << ((flags & 7) + 1)
        global_table = np.frombuffer(bytes(s.byte() for _ in range(3 * n)), np.uint8).reshape(n, 3)
        if bg >= n:
            raise _Fail(f"background index {bg} past the global table")
    codec.check_cv_size(sw, sh, name)
    _walk(data, s.pos)
    transparent = None
    while True:  # readExtensions: up to the image descriptor
        c = s.byte()
        if c == 0x2C:
            break
        if c == 0x21:
            label = s.byte()
            if label == 0xF9:
                if s.byte() != 4:
                    raise _Fail("a graphic control extension not of 4 bytes")
                f = s.byte()
                s.word()
                t = s.byte()
                transparent = t if f & 1 else None
                if (f & 0x1C) >> 2 > 3:
                    raise _Fail(f"disposal method {(f & 0x1C) >> 2}")
                s.byte()
            else:
                n = s.byte()
                while n:
                    s.pos += n
                    n = s.byte()
        else:
            raise _Fail(f"block 0x{c:02X} before the first image")
    left, top, w, h = s.word(), s.word(), s.word(), s.word()
    if not (w > 0 and h > 0 and left + w <= sw and top + h <= sh):
        raise _Fail(f"a frame of {w}x{h} at ({left}, {top}) on a screen of {sw}x{sh}")
    f = s.byte()
    if f & 0x80:
        n = 1 << ((f & 7) + 1)
        table = np.frombuffer(bytes(s.byte() for _ in range(3 * n)), np.uint8).reshape(n, 3)
    elif global_table is not None:
        table = global_table
    else:
        raise _Fail("a frame without a colour table")
    if global_table is not None:
        canvas = np.broadcast_to(global_table[bg], (sh, sw, 3)).copy()
    else:
        canvas = np.zeros((sh, sw, 3), np.uint8)
    idx, count, ok = _lzw(s, w * h)
    if not ok:
        raise _Fail("its LZW codes")
    idx = np.frombuffer(bytes(idx), np.uint8).reshape(h, w)
    if f & 0x40:  # interlaced: rows of the four passes
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4), np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    glob_n = 0 if global_table is None else len(global_table)
    if idx.max(initial=0) >= max(len(table), glob_n):
        raise _Fail("an index past its colour tables")
    full = np.zeros((256, 3), np.uint8)
    if global_table is not None:
        full[:glob_n] = global_table
    full[: len(table)] = table
    colours = full[idx]
    region = canvas[top : top + h, left : left + w]
    if transparent is not None:
        keep = idx == transparent
        colours[keep] = region[keep]
    region[...] = colours
    return canvas
