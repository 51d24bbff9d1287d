"""XV thumbnail decoding to what PIL's XVThumbImagePlugin opens: "P7 332",
comment lines, the size line, then raw 8-bit indices into the fixed 3-3-2
palette (mode "P")."""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn

_LEVELS = np.arange(8) * 255 // 7
PALETTE = np.stack([np.repeat(_LEVELS, 32), np.tile(np.repeat(_LEVELS, 4), 8), np.tile(np.arange(4) * 255 // 3, 64)],
                   axis=-1).astype(np.uint8)


def accept(prefix: bytes) -> bool:
    return prefix[:6] == b"P7 332"


def _line(data: bytes, pos: int) -> tuple:
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """An XV thumbnail as PIL opens it: (array, "P", the 3-3-2 palette)."""
    if not accept(data):
        raise PassOn(f"{name}: not an XV thumbnail file")
    _, pos = _line(data, 6)
    while True:
        s, pos = _line(data, pos)
        if not s:
            raise PassOn(f"{name}: unexpected end of an XV thumbnail file")
        if s[0] != 35:
            break
    fields = s.strip().split(maxsplit=2)[:2]
    if len(fields) < 2:
        raise ValueError(f"{name}: XV thumbnail size line {s!r} (PIL: ValueError)")
    try:
        w, h = int(fields[0]), int(fields[1])
    except ValueError:
        raise ValueError(f"{name}: XV thumbnail size line {s!r} (PIL: ValueError)") from None
    if w <= 0 or h <= 0:
        raise PassOn(f"{name}: XV thumbnail of {w}x{h} pixels")
    codec.check_size(w, h, name)
    return raw.tile(data, pos, w, h, "P", "P", name, mappable=from_file == raw.PATH), "P", PALETTE.copy()
