"""FITS decoding to what PIL's FitsImagePlugin opens: the 80-byte header
cards of each unit up to END (units padded to 2,880 bytes), the first unit
with an image: BITPIX 8 ("L"), 16 ("I;16"), 32 ("I"), -32 and -64 ("F"),
read as PIL reads them (little-endian words, rows bottom-up), or a
GZIP_1-compressed image in a binary table (`gzip.decompress`, each value's
low bytes of its 32-bit word, as PIL's fits_gzip decoder takes them).  A
file PIL's plugin does not take raises PassOn; what it refuses, a
ValueError."""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def accept(prefix: bytes) -> bool:
    return prefix[:6] == b"SIMPLE"


def _int(value: bytes, name: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}: FITS header value {value!r} is no integer (PIL: ValueError)") from None


def _size(headers: dict, prefix: bytes, name: str):
    naxis = _int(headers[prefix + b"NAXIS"], name)
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers[prefix + b"NAXIS1"], name)
    return _int(headers[prefix + b"NAXIS1"], name), _int(headers[prefix + b"NAXIS2"], name)


def _parse(headers: dict, name: str) -> tuple:
    """PIL's _parse_headers: (decoder, offset, bits, size, mode)."""
    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T" and \
            headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
        table = _size(headers, prefix, name) or (0, 0)
        offset = table[0] * table[1] * (_int(headers[b"BITPIX"], name) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix, name)
    if not size:
        return "", 0, 0, None, ""
    bits = _int(headers[prefix + b"BITPIX"], name)
    return decoder, offset, bits, size, _MODES.get(bits, "")


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """A FITS file as PIL opens it: (array, mode, None)."""
    if not accept(data):
        raise PassOn(f"{name}: not a FITS file")
    headers, in_progress, decoder, pos = {}, False, "", 0
    try:
        while True:
            header = data[pos : pos + 80]
            pos += len(header)
            if not header:
                raise ValueError(f"{name}: truncated FITS file (PIL: OSError)")
            keyword = header[:8].strip()
            if keyword in (b"SIMPLE", b"XTENSION"):
                in_progress = True
            elif headers and not in_progress:
                break
            elif keyword == b"END":
                pos = math.ceil(pos / 2880) * 2880
                if not decoder:
                    decoder, offset, bits, size, mode = _parse(headers, name)
                in_progress = False
                continue
            if decoder:
                continue
            value = header[8:].split(b"/")[0].strip()
            if value.startswith(b"="):
                value = value[1:].strip()
            if not headers and (not accept(keyword) or value != b"T"):
                raise PassOn(f"{name}: not a FITS file")
            headers[keyword] = value
    except KeyError as e:
        raise PassOn(f"{name}: FITS header without {e}") from None
    if not decoder:
        raise ValueError(f"{name}: no image data in the FITS file")
    offset += pos - 80
    w, h = size
    if not mode or w <= 0 or h <= 0:
        raise PassOn(f"{name}: FITS image PIL gives no mode or size (BITPIX {bits}, {w}x{h})")
    codec.check_size(w, h, name)
    if decoder == "raw":
        return raw.tile(data, offset, w, h, mode, mode, name, ystep=-1, mappable=from_file == raw.PATH), mode, None
    if offset < 0:
        raise ValueError(f"{name}: negative FITS data offset (PIL: negative seek)")
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"{name}: FITS GZIP_1 data is corrupt ({e})") from None
    n = min(bits // 8, 4)
    words = np.frombuffer(value, np.uint8, len(value) // 4 * 4).reshape(-1, 4)
    if n <= 0:
        stream = b""
    else:
        rows = words[: w * h, 4 - n :]
        full = rows.shape[0] // w
        stream = rows[: full * w].reshape(full, w * n)[::-1].tobytes() if full == h else b""
    return raw.set_as_raw(stream, w, h, mode, name), mode, None
