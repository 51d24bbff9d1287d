"""Netpbm and PFM decoding, as PIL's PpmImagePlugin opens them (textures,
`load_png`, `load_hdr` under .ppm / .pgm / .pnm) and as OpenCV reads them
(`load_hdr` under .pbm / .pfm, which imageio gives to its OpenCV plugin).

PIL: P1-P6, ASCII and binary, comments and PIL's whitespace rules, maxval
1-65535 rescaled as PIL rescales it (16-bit gray as mode "I"), P1 / P4 as
mode "1", gray "Pf" as mode "F" (rows bottom-up, the scale's sign the byte
order), and PIL's extensions "P0CMYK", "PyP", "PyRGBA" and "PyCMYK".

OpenCV (imageio's `imread` of a .pbm / .pfm file, flags IMREAD_COLOR): P1-P6
as three 8-bit channels (binary 8-bit samples as they are, ASCII ones scaled
by 255 / maxval, 16-bit ones shifted down 8 bits), colour and gray PFM
divided by the scale's magnitude and rounded to 8 bits (rows bottom-up), a
gray PFM as (H, W).
"""

from __future__ import annotations

import math
import re

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn

_WHITESPACE = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB", b"P0CMYK": "CMYK",
          b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
_SAFEBLOCK = 1024 * 1024  # PIL's ImageFile.SAFEBLOCK: what its ASCII decoder reads at a time


def accept(prefix: bytes) -> bool:
    """PIL's PpmImagePlugin._accept."""
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


class _Reader:
    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def read(self, n: int = 1) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += len(out)
        return out

    def token(self) -> bytes:
        """PIL's PpmImageFile._read_token: a header token of at most 10 bytes."""
        token = b""
        while len(token) <= 10:
            c = self.read()
            if not c:
                break
            if c in _WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read() not in b"\r\n":  # b"" (the end) is in it too
                    pass
                continue
            token += c
        if not token:
            raise ValueError(f"{self.name}: PPM header ends early (PIL: reached EOF while reading header)")
        if len(token) > 10:
            raise ValueError(f"{self.name}: PPM header token {token[:11]!r} is too long")
        return token


def _int(token: bytes, name: str) -> int:
    try:
        return int(token)
    except ValueError:
        raise ValueError(f"{name}: PPM header value {token!r} is no number") from None


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A Netpbm or gray PFM file as PIL opens it: (array, mode, palette).
    Raises PassOn where PIL's plugin passes the file on, a ValueError
    where PIL refuses it."""
    r = _Reader(data, name)
    magic = b""
    for _ in range(6):
        c = r.read()
        if not c or c in _WHITESPACE:
            break
        magic += c
    if magic not in _MODES:
        raise PassOn(f"{name}: not a PPM file")
    mode = _MODES[magic]
    width, height = _int(r.token(), name), _int(r.token(), name)
    scale = maxval = None
    if mode == "F":
        try:
            scale = float(r.token())
        except ValueError:
            raise ValueError(f"{name}: PFM scale is no number") from None
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{name}: PFM scale must be finite and non-zero")
    elif mode != "1":
        maxval = _int(r.token(), name)
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: PPM maxval must be greater than 0 and less than 65536, not {maxval}")
    if width <= 0 or height <= 0:
        raise PassOn(f"{name}: PPM image of {width}x{height} pixels")
    codec.check_size(width, height, name)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            return _plain_bitonal(r, width, height), "1", None
        stride = (width + 7) // 8
        rows = _raw(r, stride * height, name).reshape(height, stride)
        return ~np.unpackbits(rows, axis=1)[:, :width].astype(bool), "1", None
    if mode == "F":
        raw = _raw(r, 4 * width * height, name)
        arr = raw.view("<f4" if scale < 0 else ">f4").astype(np.float32).reshape(height, width)
        return np.ascontiguousarray(arr[::-1]), "F", None
    out_mode = "I" if maxval > 255 and mode == "L" else mode
    bands = _BANDS[out_mode]
    shape = (height, width) if bands == 1 else (height, width, bands)
    if plain:
        return _plain_blocks(r, out_mode, maxval, width * height * bands).reshape(shape), out_mode, None
    if maxval == 255 or (maxval == 65535 and mode == "L"):
        if maxval == 255:
            arr = _raw(r, width * height * bands, name).reshape(shape)
        else:
            arr = _raw(r, 2 * width * height, name).view(">u2").astype(np.int32).reshape(shape)
        return arr, out_mode, None
    # PIL's PpmDecoder: samples rescaled to 255 (65535 for mode "I"), rounded
    # half to even, capped; the data read whole pixels at a time.
    size = 1 if maxval < 256 else 2
    count = min(len(data) - r.pos, size * bands * width * height) // (size * bands) * bands
    if count < width * height * bands:
        raise ValueError(f"{name}: PPM image data is short (PIL: not enough image data)")
    raw = np.frombuffer(data, np.uint8 if size == 1 else ">u2", count, r.pos)
    out_max = 65535 if out_mode == "I" else 255
    values = np.minimum(np.round(raw.astype(np.float64) / maxval * out_max), out_max)
    return values.astype(np.int32 if out_mode == "I" else np.uint8).reshape(shape), out_mode, None


def _raw(r: _Reader, n: int, name: str) -> np.ndarray:
    if len(r.data) - r.pos < n:
        raise ValueError(f"{name}: PPM image data is truncated")
    return np.frombuffer(r.data, np.uint8, n, r.pos)


class _Plain:
    """PIL's PpmPlainDecoder: blocks of the ASCII data with comments cut out,
    a comment that runs on past its block carried over."""

    def __init__(self, r: _Reader):
        self.r, self.comment_spans = r, False

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def ignore_comments(self, block: bytes) -> bytes:
        if self.comment_spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1 :]
                    break
                block = self.r.read(_SAFEBLOCK)
        self.comment_spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1 :]
            else:
                block = block[:start]
                self.comment_spans = True
                break
        return block


def _plain_bitonal(r: _Reader, width: int, height: int) -> np.ndarray:
    plain, data, total = _Plain(r), b"", width * height
    while len(data) != total:
        block = r.read(_SAFEBLOCK)
        if not block:
            break
        tokens = b"".join(plain.ignore_comments(block).split())
        bad = tokens.translate(None, b"01")
        if bad:
            raise ValueError(f"{r.name}: invalid token {bad[:1]!r} in a plain PBM")
        data = (data + tokens)[:total]
    if len(data) < total:
        raise ValueError(f"{r.name}: PBM image data is short (PIL: not enough image data)")
    return (np.frombuffer(data, np.uint8) == ord("0")).reshape(height, width)


def _plain_blocks(r: _Reader, mode: str, maxval: int, total: int) -> np.ndarray:
    plain, values, half = _Plain(r), [], b""
    out_max = 65535 if mode == "I" else 255
    while len(values) != total:
        block = r.read(_SAFEBLOCK)
        if not block:
            if not half:
                break
            block = b" "
        block = plain.ignore_comments(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"{r.name}: PPM data token {half[:11]!r} is too long")
        for token in tokens:
            if len(token) > 10:
                raise ValueError(f"{r.name}: PPM data token {token[:11]!r} is too long")
            value = _int(token, r.name)
            if value < 0 or value > maxval:
                raise ValueError(f"{r.name}: PPM channel value {value} outside 0..{maxval}")
            values.append(round(value / maxval * out_max))
            if len(values) == total:
                break
    if len(values) < total:
        raise ValueError(f"{r.name}: PPM image data is short (PIL: not enough image data)")
    return np.asarray(values, np.int32 if mode == "I" else np.uint8)


# ------------------------------------------------------------------ OpenCV


def cv2_claims(data: bytes) -> bool:
    """OpenCV's PxM and PFM signatures: "P1".."P6", "Pf" or "PF", then a
    space character."""
    return len(data) >= 3 and data[:1] == b"P" and data[1] in b"123456fF" and data[2] in _WHITESPACE


class _CvStream:
    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError(f"{self.name}: unexpected end of the file (OpenCV)")
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, maxdigits: int = 0) -> int:
        """OpenCV's PxM ReadNumber: skip space and comments, then digits."""
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:  # '#': to the end of the line
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in _WHITESPACE:
                while code in _WHITESPACE:
                    code = self.byte()
            else:
                raise ValueError(f"{self.name}: unexpected byte {code:#x} in a number (OpenCV)")
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 2**31 - 1:
                raise ValueError(f"{self.name}: number too large (OpenCV)")
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            code = self.byte()
            if not 48 <= code <= 57:
                break
        return val

    def word(self) -> bytes:
        """OpenCV's PFM read_number: bytes up to (and eating) a space character."""
        out = b""
        for _ in range(2048):
            c = self.data[self.pos : self.pos + 1]
            if not c:
                raise ValueError(f"{self.name}: unexpected end of the file (OpenCV)")
            self.pos += 1
            if c in _WHITESPACE:
                break
            out += c
        return out.split(b"\0")[0]


def _c_number(word: bytes, parse) -> float:
    """C's atoi / atof: the longest leading number, 0 if there is none."""
    m = re.match(rb"[ \t\n\x0b\x0c\r]*([+-]?(?:\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|inf(?:inity)?|nan))",
                 word, re.I) if parse is float else re.match(rb"[ \t\n\x0b\x0c\r]*([+-]?\d+)", word)
    return parse(m.group(1)) if m else parse(0)


def read_cv2(data: bytes, name: str = "image") -> np.ndarray:
    """A Netpbm or PFM file as imageio's OpenCV plugin reads it: (H, W, 3)
    uint8 in RGB order, a gray PFM (H, W).  A ValueError where OpenCV fails."""
    s = _CvStream(data, name)
    kind = data[1:2]
    if kind in (b"f", b"F"):
        s.pos = 2
        if s.byte() != 10:
            raise ValueError(f"{name}: PFM header has no line break after its magic (OpenCV)")
        width = int(_c_number(s.word(), int)) & 0xFFFFFFFF
        height = int(_c_number(s.word(), int)) & 0xFFFFFFFF
        scale = _c_number(s.word(), float)
        if not 0 < width < 2**31 or not 0 < height < 2**31 or scale == 0.0 or math.isnan(scale):
            raise ValueError(f"{name}: PFM header gives {width}x{height} pixels at scale {scale} (OpenCV)")
        codec.check_size(width, height, name)
        c = 3 if kind == b"F" else 1
        if len(data) - s.pos < 4 * c * width * height:
            raise ValueError(f"{name}: PFM data is truncated (OpenCV)")
        img = np.frombuffer(data, ">f4" if scale >= 0 else "<f4", c * width * height, s.pos)
        img = img.astype(np.float32).reshape(height, width, c)[::-1]
        img = img * np.float32(1.0 / abs(scale))
        rounded = np.rint(img)
        with np.errstate(invalid="ignore"):
            fits = (rounded >= -(2.0**31)) & (rounded < 2.0**31)
        out = np.where(fits, np.clip(np.nan_to_num(rounded), 0, 255), 0).astype(np.uint8)
        return np.ascontiguousarray(out[..., 0] if c == 1 else out)
    s.pos = 2
    bpp = {b"1": 1, b"4": 1, b"2": 8, b"5": 8, b"3": 24, b"6": 24}[kind]
    binary = kind in (b"4", b"5", b"6")
    width, height = s.number(), s.number()
    maxval = s.number() if bpp > 1 else 1
    if maxval > 65535 or width <= 0 or height <= 0 or maxval <= 0:
        raise ValueError(f"{name}: PxM header gives {width}x{height} pixels, maxval {maxval} (OpenCV)")
    codec.check_size(width, height, name)
    ch = 3 if bpp == 24 else 1
    if bpp == 1:
        if binary:
            pitch = (width + 7) // 8
            if len(data) - s.pos < pitch * height:
                raise ValueError(f"{name}: PBM data is truncated (OpenCV)")
            rows = np.frombuffer(data, np.uint8, pitch * height, s.pos).reshape(height, pitch)
            ones = np.unpackbits(rows, axis=1)[:, :width]
        else:
            ones = np.array([[s.number(1) != 0 for _ in range(width)] for _ in range(height)], np.uint8)
        gray = np.where(ones != 0, 0, 255).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=-1)
    if binary:
        size = 2 if maxval > 255 else 1
        n = width * height * ch * size
        if len(data) - s.pos < n:
            raise ValueError(f"{name}: PxM data is truncated (OpenCV)")
        if size == 2:
            samples = (np.frombuffer(data, ">u2", width * height * ch, s.pos) >> 8).astype(np.uint8)
        else:
            samples = np.frombuffer(data, np.uint8, n, s.pos)
    else:
        codes = np.array([min(s.number(), maxval) for _ in range(width * height * ch)], np.int64)
        samples = (codes >> 8 if maxval > 255 else codes * 255 // maxval).astype(np.uint8)
    samples = samples.reshape(height, width, ch)
    return np.ascontiguousarray(samples if ch == 3 else np.repeat(samples, 3, axis=-1))
