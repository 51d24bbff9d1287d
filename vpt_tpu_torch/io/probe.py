"""Which of PIL's plugins claims a file, for the formats that decode on
neither machine: PIL 12.1's `Image.open` tries its plugins in order (the
five of `preinit`, then `Image.ID`'s), each plugin's `_accept` on the first
16 bytes and then its `_open`, and goes on to the next plugin when `_open`
raises a SyntaxError (or an IndexError, TypeError, KeyError, EOFError or
struct.error) or gives no image.  A file with no magic bytes (TGA) is thus
decided by every plugin before it.  `UNPORTED[format](data)` is that test for
each plugin the port has no reader for: true where PIL would take the file
with it (and then fail to load it), so the port refuses it naming the
format.  `PassOn` is how the port's readers say that PIL tries the next
plugin.
"""

from __future__ import annotations

import re
import struct


class PassOn(ValueError):
    """A reader's plugin passes the file on to PIL's next plugin."""


def _i32(data: bytes, at: int = 0, order: str = ">") -> int | None:
    return struct.unpack_from(order + "I", data, at)[0] if len(data) >= at + 4 else None


def _wmf(data: bytes) -> bool:
    """WmfImagePlugin: a placeable metafile with the standard header (or a
    zero "inch", which PIL refuses) or an enhanced one, of a positive
    size."""
    s = data[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if len(s) < 16:
            return False
        x0, y0, x1, y1, inch = struct.unpack_from("<4hH", s, 6)
        if inch == 0:
            return True  # PIL raises: a refusal either way
        return s[22:26] == b"\x01\x00\t\x00" and (x1 - x0) * 72 // inch > 0 and (y1 - y0) * 72 // inch > 0
    if s.startswith(b"\x01\x00\x00\x00") and s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        return f2 == f0 or f3 == f1 or (x1 - x0 > 0 and y1 - y0 > 0)  # a zero frame: PIL divides by zero
    return False


# PIL's own `_accept` of each of them (what imageio's legacy "<format>-PIL"
# plugin checks before it claims a file).
ACCEPT = {
    "AVIF": lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
    "BUFR": lambda d: d[:4] in (b"BUFR", b"ZCZC"),
    "EPS": lambda d: d[:4] == b"%!PS" or _i32(d, 0, "<") == 0xC6D3D0C5,
    "GRIB": lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1,
    "HDF5": lambda d: d[:8] == b"\x89HDF\r\n\x1a\n",
    "MPEG": lambda d: d[:4] == b"\0\0\x01\xb3",
    "WMF": lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or d[:4] == b"\x01\x00\x00\x00",
}
# The plugins PIL 12.1 has that decode on neither machine (no handler, no
# Ghostscript, no decoder, not Windows), each with its test, by the name of
# PIL's format.  (AVIF the port reads: io/avif.py.)
UNPORTED = {
    **{fmt: accept for fmt, accept in ACCEPT.items() if fmt != "AVIF"},
    "MPEG": lambda d: d[:4] == b"\0\0\x01\xb3" and len(d) >= 7 and
    (int.from_bytes(d[4:7], "big") >> 12) > 0 and (int.from_bytes(d[4:7], "big") & 0xFFF) > 0,
    "WMF": _wmf,
}
