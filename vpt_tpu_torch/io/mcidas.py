"""McIdas area decoding to what PIL's McIdasImagePlugin opens: the 64-word
big-endian area directory, then rows of 8-bit ("L"), 16-bit ("I;16B") or
32-bit ("I", from big-endian words) samples, each after its line prefix,
at the directory's offset and stride (a file opened by its path maps "L"
and "I;16B" rows as PIL does)."""

from __future__ import annotations

import struct

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return prefix[:8] == b"\0\0\0\0\0\0\0\x04"


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """A McIdas area file as PIL opens it: (array, mode, None)."""
    if not accept(data) or len(data) < 256:
        raise PassOn(f"{name}: not an McIdas area file")
    w = (0, *struct.unpack_from(">64i", data))
    modes = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}
    if w[11] not in modes:
        raise PassOn(f"{name}: unsupported McIdas format {w[11]}")
    mode, rawmode = modes[w[11]]
    width, height = w[10], w[9]
    if width <= 0 or height <= 0:
        raise PassOn(f"{name}: McIdas image of {width}x{height} pixels")
    codec.check_size(width, height, name)
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    return raw.tile(data, offset, width, height, mode, rawmode, name, stride=stride, mappable=from_file == raw.PATH), mode, None
