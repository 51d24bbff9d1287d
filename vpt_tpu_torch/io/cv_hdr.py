"""Radiance RGBE pictures as OpenCV 5.0 reads them (grfmt_hdr.cpp over
rgbe.cpp, Bruce Walter's reader), to the 8-bit BGR image that
`IMREAD_COLOR` asks for.

The header is read a line at a time with a 128-byte `fgets`, so a longer
line reads as several; each line is a C string, ended by its first NUL.
Lines up to the first empty one (a newline alone, or a NUL first) must
hold `FORMAT=32-bit_rle_rgbe` exactly; that empty line ends the header,
and the next one must scan as `-Y %d +X %d` (height, then width), the only
orientation taken.  GAMMA and EXPOSURE are not read (the decoder hands the
reader no header record).  The pixels are new-style run-length scanlines
or flat quadruples (codec.rgbe_cv); old-style runs are not expanded.

Each pixel becomes floats by `rgbe2float`: mantissa x 2^(e - 136), or 0
where e is 0 (no half added, unlike the port's own `load_radiance_hdr`);
`convertTo(CV_8U, 255)` then rounds value x 255 to the nearest integer,
ties to even, and saturates, a value that rounds to 2^31 or more (or is
infinite in float) giving 0, as `cvRound` does, not 255.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_LUT = None


def claims(sig: bytes) -> bool:
    """HdrDecoder::checkSignature: beginning with either magic."""
    return sig.startswith(SIGNATURES)


class _Lines:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def fgets(self) -> bytes | None:
        """The next line as fgets(buf, 128) gives it, as a C string (None at
        the end of the file)."""
        if self.pos >= len(self.data):
            return None
        nl = self.data.find(b"\n", self.pos, self.pos + 127)
        end = nl + 1 if nl >= 0 else min(self.pos + 127, len(self.data))
        line = self.data[self.pos : end]
        self.pos = end
        return line.split(b"\0", 1)[0]


_SPACE = b" \t\n\v\f\r"


def _scan_int(s: bytes, i: int) -> tuple:
    """glibc's `%d`: white space, a sign, digits (strtol's value, kept to its
    low 32 bits as a signed int; beyond a long, LONG_MAX / MIN)."""
    while i < len(s) and s[i] in _SPACE:
        i += 1
    j = i + (i < len(s) and s[i] in b"+-")
    k = j
    while k < len(s) and 48 <= s[k] <= 57:
        k += 1
    if k == j:
        return None, i
    v = int(s[j:k]) * (-1 if s[i : i + 1] == b"-" else 1)
    v = max(min(v, 2**63 - 1), -(2**63))
    v &= 0xFFFFFFFF
    return (v - 2**32 if v >= 2**31 else v), k


def _size(line: bytes) -> tuple:
    """sscanf(line, "-Y %d +X %d", &height, &width): the values scanned."""
    got, i = [], 0
    for lit in (b"-Y", b"+X"):
        if line[i : i + 2] != lit:
            return got
        i += 2
        while i < len(line) and line[i] in _SPACE:
            i += 1
        v, i = _scan_int(line, i)
        if v is None:
            return got
        got.append(v)
        while i < len(line) and line[i] in _SPACE:
            i += 1
    return got


def header(data: bytes, name: str) -> tuple:
    """RGBE_ReadHeader: (width, height, offset of the pixels); a ValueError
    with OpenCV's message where it fails."""
    r = _Lines(data)
    buf = r.fgets()
    if buf is None:
        raise ValueError(f"{name}: RGBE read error (OpenCV)")
    found = False
    while True:
        if buf[:1] in (b"", b"\n"):
            if not found:
                raise ValueError(f"{name}: RGBE bad file format: no FORMAT specifier found (OpenCV)")
            break
        if buf == _FORMAT:
            found = True
        buf = r.fgets()
        if buf is None:
            raise ValueError(f"{name}: RGBE read error (OpenCV)")
    if buf != b"\n":
        raise ValueError(f"{name}: RGBE bad file format: missing blank line after FORMAT specifier (OpenCV)")
    buf = r.fgets()
    if buf is None:
        raise ValueError(f"{name}: RGBE read error (OpenCV)")
    size = _size(buf)
    if len(size) < 2:
        raise ValueError(f"{name}: RGBE bad file format: missing image size specifier (OpenCV)")
    height, width = size
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: Radiance picture of {width}x{height} pixels (OpenCV)")
    return width, height, r.pos


def _lut() -> np.ndarray:
    """(exponent, mantissa) -> the byte convertTo gives mantissa x 2^(e-136) x 255."""
    global _LUT
    if _LUT is None:
        e = np.arange(256, dtype=np.float64)[:, None]
        m = np.arange(256, dtype=np.float64)[None, :]
        v = np.rint(m * 255.0 * np.exp2(e - 136.0))  # exact: 16 significant bits times a power of 2
        v = np.where(e > 0, v, 0.0)
        _LUT = np.where(v >= 2.0**31, 0, np.minimum(v, 255)).astype(np.uint8)
    return _LUT


def read(data: bytes, name: str) -> tuple:
    """The picture as (H, W, 3) uint8 RGB (OpenCV's BGR, as imageio turns
    it), and no EXIF."""
    width, height, pos = header(data, name)
    codec.check_cv_size(width, height, name)
    try:
        rgbe = codec.rgbe_cv(memoryview(data)[pos:], width, height)
    except ValueError as e:
        raise ValueError(f"{name}: {e} (OpenCV)") from None
    return _lut()[rgbe[..., 3:4], rgbe[..., :3]], None
