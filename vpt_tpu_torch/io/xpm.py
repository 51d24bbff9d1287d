"""X pixmap decoding to what PIL's XpmImagePlugin opens: the values line,
the colour lines (the first "c" key of each: "#rrggbb"-style hex or None,
the transparent key), then the pixel strings as PIL's Python decoder reads
them, into palette indices (mode "P", 256 colours or fewer) or RGB.  A file
PIL's plugin does not take raises PassOn; one it refuses, a ValueError."""

from __future__ import annotations

import re

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accept(prefix: bytes) -> bool:
    return prefix[:9] == b"/* XPM */"


class _Lines:
    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        line, self.pos = self.data[self.pos : end], end
        return line


def _number(s: bytes, name: str) -> int:
    try:
        return int(s)
    except ValueError:
        raise ValueError(f"{name}: XPM values line without a number (PIL: ValueError)") from None


def read_pil(data: bytes, name: str = "image") -> tuple:
    """An X pixmap as PIL opens it: (array, mode, palette, transparency)."""
    if not accept(data):
        raise PassOn(f"{name}: not an XPM file")
    f = _Lines(data, 9)
    while True:
        line = f.readline()
        if not line:
            raise PassOn(f"{name}: broken XPM file")
        m = _HEAD.match(line)
        if m:
            break
    w, h, ncolours, bpp = (_number(g, name) for g in m.group(1, 2, 3, 4))
    palette, transparency = {}, None
    for _ in range(ncolours):
        line = f.readline().rstrip()
        c = line[1 : bpp + 1]
        s = line[bpp + 1 : -2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1] if i + 1 < len(s) else None
                if rgb is None:
                    raise PassOn(f"{name}: XPM colour line ends at its key (PIL: IndexError)")
                if rgb == b"None":
                    transparency = c
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError(f"{name}: XPM colour {rgb!r} (PIL: ValueError)") from None
                    palette[c] = bytes(((v >> 16) & 255, (v >> 8) & 255, v & 255))
                else:
                    raise ValueError(f"{name}: cannot read this XPM file (colour {rgb!r})")
                break
        else:
            raise ValueError(f"{name}: cannot read this XPM file (a colour without a c key)")
    mode = "RGB" if ncolours > 256 else "P"
    if w <= 0 or h <= 0:
        raise PassOn(f"{name}: XPM image of {w}x{h} pixels")
    codec.check_size(w, h, name)
    keys = tuple(palette)
    index = {k: i for i, k in reversed(list(enumerate(keys)))}
    need = w * h * (3 if mode == "RGB" else 1)
    out, size, header = [], 0, False
    while size < need:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp) if bpp > 0 else ():
            key = line[i : i + bpp]
            if mode == "RGB":
                if key not in palette:
                    raise ValueError(f"{name}: XPM pixel {key!r} has no colour (PIL: KeyError)")
                out.append(palette[key])
                size += 3
            else:
                if key not in index:
                    raise ValueError(f"{name}: XPM pixel {key!r} has no colour (PIL: ValueError)")
                out.append(bytes((index[key] & 255,)))
                size += 1
        if bpp <= 0 and line:
            raise ValueError(f"{name}: XPM of {bpp} characters per pixel (PIL: ValueError)")
    arr = raw.set_as_raw(b"".join(out), w, h, mode, name)
    if mode == "RGB":
        return arr, mode, None, transparency
    table = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(b"".join(palette.values()), np.uint8).reshape(-1, 3)[:256]
    table[: len(entries)] = entries
    return arr, mode, table, transparency
