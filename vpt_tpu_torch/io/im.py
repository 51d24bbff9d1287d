"""IFUNC / LabEye IM and IM Tools decoding to what PIL's ImImagePlugin and
ImtImagePlugin open.

IM: "Key: value" header lines up to ^Z (a NUL ends them too, and the data
starts after the next ^Z), the image type naming the mode and PIL's rawmode
(gray, 1-bit, 2- and 4-bit palette, RGB planes per line or per image, LA,
RGBA, RGBX, CMYK, YCbCr, 8- to 32-bit integer and float gray, 16-bit gray
in either byte order), a 768-byte lookup table after the ^Z that makes a
gray image a palette image unless it is a gray ramp, rows bottom-up; the
"L*n" float types through PIL's "bit" decoder.  IMT: "key value" lines up
to a form feed, "width", "height" and "pixel n8" (8-bit gray).  A file PIL's
plugin does not take raises PassOn; one it refuses, a ValueError."""

from __future__ import annotations

import re

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn

FRAMES, SCALE, SIZE, MODE, LUT, COMMENT = ("File size (no of images)", "Scale (x,y)", "Image size (x*y)",
                                           "Image type", "Lut", "Comment")
TAGS = {COMMENT, "Date", "Digitalization equipment", FRAMES, LUT, "Name", SCALE, SIZE, MODE}
OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
        "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
        "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
        "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"), "L 32 F image": ("F", "F;32"),
        "RGB3 image": ("RGB", "RGB;T"), "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
        "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
        "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _readline(data: bytes, pos: int) -> int:
    end = data.find(b"\n", pos)
    return len(data) if end < 0 else end + 1


def _header(data: bytes, name: str) -> tuple:
    """PIL's IM _open up to the data: (info, rawmode, position after ^Z)."""
    if b"\n" not in data[:100]:
        raise PassOn(f"{name}: not an IM file")
    info, rawmode, n, pos = {MODE: "L", SIZE: (512, 512), FRAMES: 1}, "L", 0, 0
    while True:
        s = data[pos : pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = _readline(data, pos)
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            raise PassOn(f"{name}: not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            raise PassOn(f"{name}: syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError:
                raise ValueError(f"{name}: IM header value {v!r} is no number (PIL: ValueError)") from None
            v = v[0] if len(v) == 1 else v
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k == COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        n += k in TAGS
    if not n:
        raise PassOn(f"{name}: not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = data[pos : pos + 1]
        pos += len(s)
    if not s:
        raise PassOn(f"{name}: IM file truncated")
    return info, rawmode, pos


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """An IM file as PIL opens it: (array, mode, palette or None)."""
    info, rawmode, pos = _header(data, name)
    size, mode, palette = info[SIZE], info[MODE], None
    if LUT in info:
        lut = data[pos : pos + 768]
        if len(lut) < 768:
            raise PassOn(f"{name}: IM lookup table ends early")
        pos += 768
        t = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = (t[0] == t[1]).all() and (t[1] == t[2]).all()
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else ("PA", "PA;L")
            palette = t.T.copy()
    if not isinstance(size, tuple) or len(size) < 2:
        raise PassOn(f"{name}: IM image size {size!r} (PIL: TypeError)")
    w, h = size[0], size[1]
    if not mode or w <= 0 or h <= 0:
        raise PassOn(f"{name}: IM image of {w}x{h} pixels")
    if len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise ValueError(f"{name}: IM image size {size!r} (PIL cannot make the image)")
    codec.check_size(w, h, name)
    if mode not in raw.PAIRS:
        raise ValueError(f"{name}: IM image of mode {mode!r}, which the port does not read")
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        if mode != "F":
            raise ValueError(f"{name}: PIL's bit decoder fills float images only")
        return raw.bit_decode(data, pos, w, h, int(rawmode[2:]), name), mode, palette
    if rawmode in ("RGB;T", "RYB;T"):
        raw.check(mode, "G", name)
        arr = np.zeros((h, w, 3), np.uint8)
        for k, band in enumerate("GRB"):
            arr[..., "RGB".index(band)] = raw.tile(data, pos + k * w * h, w, h, mode, band, name, ystep=-1)[
                ..., "RGB".index(band)]
        return arr, mode, palette
    return raw.tile(data, pos, w, h, mode, rawmode, name, ystep=-1, mappable=from_file == raw.PATH), mode, palette


def read_imt(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """An IM Tools file as PIL opens it: (array, "L", None)."""
    buffer = data[:100]
    pos = len(buffer)
    if b"\n" not in buffer:
        raise PassOn(f"{name}: not an IM Tools file")
    w = h = 0
    mode, offset = "", None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos : pos + 1]
            pos += len(s)
        if not s:
            break
        if s == b"\x0c":
            offset = pos - len(buffer)
            break
        if b"\n" not in buffer:
            more = data[pos : pos + 100]
            buffer += more
            pos += len(more)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            raise ValueError(f"{name}: IM Tools {k.decode()} {v!r} is no number (PIL: ValueError)") from None
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or w <= 0 or h <= 0:
        raise PassOn(f"{name}: not an IM Tools file PIL reads")
    codec.check_size(w, h, name)
    if offset is None:
        raise ValueError(f"{name}: IM Tools file without image data (PIL: cannot load this image)")
    return raw.tile(data, offset, w, h, "L", "L", name, mappable=from_file == raw.PATH), "L", None
