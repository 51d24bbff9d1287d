"""Which of PIL's plugins claims a file, for the formats the port does not
read: PIL 12.1's `Image.open` tries its plugins in order (the five of
`preinit`, then `Image.ID`'s), each plugin's `_accept` on the first 16 bytes
and then its `_open`, and goes on to the next plugin when `_open` raises a
SyntaxError (or an IndexError, TypeError, KeyError, EOFError or
struct.error) or gives no image.  A file with no magic bytes (TGA) is thus
decided by every plugin before it.  `UNPORTED[format](data)` is that test for
each plugin the port has no reader for: true where PIL would open the file
with it (or fail there), so the port refuses it naming the format.
"""

from __future__ import annotations

import re
import struct


class PassOn(ValueError):
    """A reader's plugin passes the file on to PIL's next plugin."""


def _i32(data: bytes, at: int = 0, order: str = ">") -> int | None:
    return struct.unpack_from(order + "I", data, at)[0] if len(data) >= at + 4 else None


def _im(data: bytes) -> bool:
    """ImImagePlugin: "Key: value" header lines up to a NUL or ^Z, at least
    one a key PIL knows, then ^Z."""
    if b"\n" not in data[:100]:
        return False
    keys = (b"File size (no of images)", b"Scale (x,y)", b"Image size (x*y)", b"Image type", b"Comment", b"Date",
            b"Digitalization equipment", b"Lut", b"Name")
    pos, tags = 0, 0
    while True:
        c = data[pos : pos + 1]
        pos += len(c)
        if c == b"\r":
            continue
        if not c or c in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        line = c + (data[pos:] if end < 0 else data[pos : end + 1])
        pos = len(data) if end < 0 else end + 1
        if len(line) > 100:
            return False
        line = line[:-2] if line.endswith(b"\r\n") else (line[:-1] if line.endswith(b"\n") else line)
        m = re.match(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$", line, re.S)
        if not m:
            return False
        tags += m.group(1) in keys
    return tags > 0 and (c == b"\x1a" or b"\x1a" in data[pos:])


def _imt(data: bytes) -> bool:
    """ImtImagePlugin: an IM tools header that gives a size and mode "n8"."""
    buffer = data[:100]
    if b"\n" not in buffer:
        return False
    pos, width, height, mode = min(len(data), 100), 0, 0, False
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos : pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += data[pos : pos + 100]
            pos += len(data[pos : pos + 100])
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                width = int(v)
            elif k == b"height":
                height = int(v)
        except ValueError:
            return True  # PIL raises: a refusal either way
        if k == b"pixel" and v == b"n8":
            mode = True
    return mode and width > 0 and height > 0


def _iptc(data: bytes) -> bool:
    """IptcImagePlugin: fields of 0x1C, a record number, a tag and a size,
    up to record 8 tag 10 or a field of zeros, with the records PIL reads
    the image's layers and size from (3:60, 3:20, 3:30)."""
    pos, tags = 0, set()
    while True:
        s = data[pos : pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            break
        if len(s) < 5 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False  # PIL's SyntaxError (or IndexError): the file passes on
        tag, size = (s[1], s[2]), s[3]
        if size > 132:
            return True  # PIL raises: a refusal either way
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes(data[pos : pos + size - 128][-4:], "big")
            pos += min(s[3] - 128, len(data) - pos)
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        if tag == (8, 10):
            break
        pos += min(size, max(len(data) - pos, 0))
        tags.add(tag)
    return {(3, 60), (3, 20), (3, 30)} <= tags


def _spider_header(t: tuple) -> int:
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _spider(data: bytes) -> bool:
    """SpiderImagePlugin: 27 floats that read as a 2D Spider header."""
    if len(data) < 108:
        return False
    for order in (">", "<"):
        t = struct.unpack(order + "27f", data[:108])
        if _spider_header(t):
            h = (99,) + t
            if int(h[5]) != 1:
                return False
            try:
                istack, imgnumber, w, hh = int(h[24]), int(h[27]), int(h[12]), int(h[2])
            except (ValueError, OverflowError):
                return True  # PIL raises: a refusal either way
            return ((istack == 0 and imgnumber >= 0) or (istack > 0 and imgnumber == 0)) and w > 0 and hh > 0
    return False


def _gbr(data: bytes) -> bool:
    """GbrImagePlugin: a GIMP brush header (version 1, or 2 with "GIMP")."""
    if len(data) < 20:
        return False
    size, version, width, height, depth = struct.unpack_from(">5I", data)
    if size < 20 or version not in (1, 2) or width == 0 or height == 0 or depth not in (1, 4):
        return False
    return version == 1 or (data[20:24] == b"GIMP" and len(data) >= 28)


def _mcidas(data: bytes) -> bool:
    if len(data) < 256:
        return False
    w = (0,) + struct.unpack(">64i", data[:256])
    return w[11] in (1, 2, 4) and w[10] > 0 and w[9] > 0


# The plugins PIL 12.1 has that the port does not read, each with its
# test, by the name of PIL's format.
UNPORTED = {
    "AVIF": lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
    "BLP": lambda d: d[:4] in (b"BLP1", b"BLP2"),
    "BUFR": lambda d: d[:4] in (b"BUFR", b"ZCZC"),
    "DCX": lambda d: _i32(d, 0, "<") == 0x3ADE68B1,
    "EPS": lambda d: d[:4] == b"%!PS" or _i32(d, 0, "<") == 0xC6D3D0C5,
    "FITS": lambda d: d[:6] == b"SIMPLE",
    "FLI": lambda d: len(d) >= 22 and struct.unpack_from("<H", d, 4)[0] in (0xAF11, 0xAF12) and
    struct.unpack_from("<H", d, 14)[0] in (0, 3) and d[20:22] == b"\0\0",
    "FTEX": lambda d: d[:4] == b"FTEX",
    "GBR": _gbr,
    "GRIB": lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1,
    "HDF5": lambda d: d[:8] == b"\x89HDF\r\n\x1a\n",
    "ICNS": lambda d: d[:4] == b"icns",
    "IM": _im,
    "IMT": _imt,
    "IPTC": _iptc,
    "MCIDAS": lambda d: d[:8] == b"\0\0\0\0\0\0\0\x04" and _mcidas(d),
    "MPEG": lambda d: d[:4] == b"\0\0\x01\xb3" and len(d) >= 7 and
    (int.from_bytes(d[4:7], "big") >> 12) > 0 and (int.from_bytes(d[4:7], "big") & 0xFFF) > 0,
    "MSP": lambda d: d[:4] in (b"DanM", b"LinS"),
    "PCD": lambda d: d[2048:2052] == b"PCD_",
    "PIXAR": lambda d: d[:4] == b"\x80\xe8\x00\x00",
    "SPIDER": _spider,
    "SUN": lambda d: _i32(d) == 0x59A66A95,
    "WMF": lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\x00\x00" or d[:4] == b"\x01\x00\x00\x00",
    "XBM": lambda d: d[:16].lstrip().startswith(b"#define"),
    "XPM": lambda d: d[:9] == b"/* XPM */",
    "XVTHUMB": lambda d: d[:6] == b"P7 332",
}
