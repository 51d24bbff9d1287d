"""FLI / FLC animation decoding to what PIL's FliImagePlugin opens: the
128-byte header (its reserved bytes zero), the palette of the first
frame's first colour chunk (6-bit FLI_COLOR values shifted up, 8-bit
FLI_256_COLOR ones as they are; a gray ramp where none comes first), and
the first frame as PIL's C decoder draws it (the C codec's `fli_decode`:
BRUN, LC, SS2, BLACK and COPY chunks), fed the file in blocks of the
frame's size as PIL's ImageFile.load feeds it.  Mode "P".  A header PIL's
plugin does not take raises PassOn; what it refuses, a ValueError."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 16 and struct.unpack_from("<H", prefix, 4)[0] in (0xAF11, 0xAF12) and \
        struct.unpack_from("<H", prefix, 14)[0] in (0, 3)


class _File:
    def __init__(self, data: bytes, name: str):
        self.data, self.pos, self.name = data, 0, name

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def field(self, fmt: str, s: bytes, at: int = 0):
        if len(s) < at + struct.calcsize(fmt):
            raise PassOn(f"{self.name}: FLI header ends early")
        return struct.unpack_from(fmt, s, at)[0]


def _palette(f: _File, palette: np.ndarray, shift: int) -> None:
    i = 0
    for _ in range(f.field("<H", f.read(2))):
        s = f.read(2)
        if len(s) < 2:
            raise PassOn(f"{f.name}: FLI palette ends early")
        i += s[0]
        n = s[1] or 256
        s = f.read(n * 3)
        for k in range(0, len(s), 3):
            if k + 3 > len(s) or i >= 256:
                raise PassOn(f"{f.name}: FLI palette runs past its data or its 256 entries")
            palette[i] = ((s[k] << shift) & 255, (s[k + 1] << shift) & 255, (s[k + 2] << shift) & 255)
            i += 1


def read_pil(data: bytes, name: str = "image") -> tuple:
    """An FLI / FLC file's first frame as PIL opens it: (array, "P",
    palette)."""
    f = _File(data, name)
    s = f.read(128)
    if not (accept(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise PassOn(f"{name}: not an FLI/FLC file")
    frames, w, h = struct.unpack_from("<3H", s, 6)
    palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    s = f.read(16)
    if f.field("<H", s, 4) == 0xF100:
        f.pos = 128 + f.field("<I", s)
        s = f.read(16)
    if f.field("<H", s, 4) == 0xF1FA:
        size = None
        for _ in range(f.field("<H", s, 6)):
            if size is not None:
                f.pos = max(f.pos + size - 6, 0)
            s = f.read(6)
            kind = f.field("<H", s, 4)
            if kind in (4, 11):
                _palette(f, palette, 2 if kind == 11 else 0)
                break
            size = f.field("<I", s)
            if not size:
                break
    if frames == 0:
        raise PassOn(f"{name}: FLI file of no frames (PIL: attempt to seek outside sequence)")
    head = data[128:132]
    if not head:
        raise PassOn(f"{name}: FLI file without a frame (PIL: missing frame size)")
    if len(head) < 4:
        raise PassOn(f"{name}: FLI frame size ends early")
    (framesize,) = struct.unpack("<I", head)
    if w == 0 or h == 0:
        raise PassOn(f"{name}: FLI image of {w}x{h} pixels")
    codec.check_size(w, h, name)
    img = np.zeros((h, w), np.uint8)
    pos, b = 128, b""
    while True:
        piece = data[pos : pos + framesize]
        pos += len(piece)
        if not piece:
            raise ValueError(f"{name}: FLI frame is truncated (PIL: image file is truncated)")
        b += piece
        n, err = codec.fli_decode(b, img)
        if n < 0:
            break
        b = b[n:]
    if err < 0:
        raise ValueError(f"{name}: FLI frame is broken (PIL: decoder error {err})")
    return img, "P", palette
