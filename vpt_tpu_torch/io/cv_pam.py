"""PAM ("P7") files as OpenCV 5.0's PAMDecoder (grfmt_pam.cpp) reads them
with `IMREAD_COLOR`.

The header: after the three bytes "P7" and a space character, lines of an
identifier (HEIGHT, WIDTH, DEPTH, MAXVAL, TUPLTYPE or ENDHDR, in capitals)
and its value, or `#` comments, up to ENDHDR; a field given twice (but
TUPLTYPE, whose last value counts), an unknown one, a number that is not an
optionally negative decimal, or a MAXVAL above 65535 fails.  A field whose
line ends at its name has no value (a number 0); one followed by space only
takes the next line.  Without a TUPLTYPE, 1 channel is GRAYSCALE (or
BLACKANDWHITE at MAXVAL 1) and 3 are RGB, for a MAXVAL below 256; a
TUPLTYPE must name as many channels as DEPTH gives.

The samples (16-bit ones big-endian, their high byte kept):
- 3 channels go to OpenCV's BGR image as they are stored, so the RGB that
  imageio returns has them reversed;
- 1 channel is repeated;
- at MAXVAL 1 each row's bytes are read as packed bits, most significant
  first, 1 white;
- 2 or 4 channels fill only the first width / channels pixels of each row
  (`basic_conversion` stops after `width` bytes of the row); the rest of
  the row is memory OpenCV never writes, so the port refuses them.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec

_SPACE = b" \t\n\v\f\r"
_FIELDS = (b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
_TUPLTYPES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2, b"RGB": 3, b"RGB_ALPHA": 4}


def claims(sig: bytes) -> bool:
    """PAMDecoder::checkSignature: "P7" and a space character."""
    return len(sig) >= 3 and sig[:2] == b"P7" and sig[2] in _SPACE


class _Stream:
    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 3, name

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise ValueError(f"{self.name}: PAM header ends early (OpenCV)")
        self.pos += 1
        return self.data[self.pos - 1]

    def line(self) -> tuple:
        """ReadPAMHeaderLine: (field or None for a comment, value)."""
        code = self.byte()
        while code in _SPACE:
            code = self.byte()
        if code == 35:  # '#'
            while code not in (10, 13):
                code = self.byte()
            return None, b""
        ident = b""
        for _ in range(8):
            ident += bytes([code])
            code = self.byte()
            if code in _SPACE:
                break
        if ident not in _FIELDS:
            raise ValueError(f"{self.name}: PAM header has an unknown field {ident!r} (OpenCV)")
        value = b""
        if code not in (10, 13):
            while code in _SPACE:  # newlines too: a field with no value on its line takes the next line's
                code = self.byte()
            while code not in (10, 13):
                value += bytes([code])
                code = self.byte()
        return ident, value.split(b"\0", 1)[0]


def _number(value: bytes, name: str) -> int:
    """ParseNumber: space, an optional minus and decimal digits, then only
    space; no digits at all read as 0; beyond an int fails."""
    s = value.strip(_SPACE)
    body = s[1:] if s[:1] == b"-" else s
    if s and not body.isdigit() or not -(2**31) <= int(s or b"0") < 2**31:
        raise ValueError(f"{name}: PAM header value {value!r} is no number OpenCV takes")
    return int(s or b"0")


def read(data: bytes, name: str) -> tuple:
    """The image as (H, W, 3) uint8 RGB, and no EXIF."""
    s = _Stream(data, name)
    fields = {}
    while True:
        field, value = s.line()
        if field is None:
            continue
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":  # (the last one counts)
            fields[field] = value.rstrip(_SPACE)
            continue
        if field in fields:
            raise ValueError(f"{name}: PAM header gives {field.decode()} twice (OpenCV)")
        fields[field] = _number(value, name)
    if not all(f in fields for f in (b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL")):
        raise ValueError(f"{name}: PAM header lacks a field (OpenCV)")
    width, height, depth, maxval = fields[b"WIDTH"], fields[b"HEIGHT"], fields[b"DEPTH"], fields[b"MAXVAL"]
    if maxval > 65535:
        raise ValueError(f"{name}: PAM MAXVAL {maxval} (OpenCV)")
    tupltype = fields.get(b"TUPLTYPE")
    if tupltype is not None:
        if _TUPLTYPES.get(tupltype) != depth:
            raise ValueError(f"{name}: PAM TUPLTYPE {tupltype!r} for {depth} channels (OpenCV)")
    elif not (depth in (1, 3) and maxval < 256):
        raise ValueError(f"{name}: PAM of {depth} channels at MAXVAL {maxval} has no TUPLTYPE (OpenCV)")
    if not 1 <= depth <= 4:
        raise ValueError(f"{name}: PAM of {depth} channels (OpenCV)")
    codec.check_cv_size(width, height, name)
    size = 2 if maxval > 255 else 1
    if len(data) - s.pos < width * height * depth * size:
        raise ValueError(f"{name}: PAM data is truncated (OpenCV)")
    if maxval == 1:
        rows = np.frombuffer(data, np.uint8, width * height * depth, s.pos).reshape(height, width * depth)
        bits = np.unpackbits(rows[:, : (width + 7) // 8], axis=1)[:, :width]
        return np.repeat((bits * 255)[..., None], 3, axis=-1), None
    if depth in (2, 4):
        raise ValueError(f"{name}: OpenCV fills only the first {width // depth or 1} pixels of each row of a "
                         f"{depth}-channel PAM and leaves the rest of its image unwritten; the port does not "
                         f"read it")
    samples = np.frombuffer(data, ">u2" if size == 2 else np.uint8, width * height * depth, s.pos)
    if size == 2:
        samples = samples >> 8
    samples = samples.astype(np.uint8).reshape(height, width, depth)
    return np.ascontiguousarray(samples[..., ::-1] if depth == 3 else np.repeat(samples, 3, axis=-1)), None
