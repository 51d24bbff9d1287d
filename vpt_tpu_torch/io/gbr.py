"""GIMP brush decoding to what PIL's GbrImagePlugin opens: version 1, or 2
with its "GIMP" magic and spacing, then the comment and the pixels, 8-bit
gray ("L") or RGBA.  A header PIL's plugin does not take raises PassOn."""

from __future__ import annotations

import struct

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 8 and struct.unpack_from(">I", prefix)[0] >= 20 and \
        struct.unpack_from(">I", prefix, 4)[0] in (1, 2)


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """A GIMP brush as PIL opens it: (array, mode, None).  A comment of a
    negative length reads the rest of the file; from a file opened by its
    path only a length of -1 does (another raises, as a file's read
    does)."""
    if len(data) < 20:
        raise PassOn(f"{name}: not a GIMP brush")
    header_size, version, width, height, depth = struct.unpack_from(">5I", data)
    if header_size < 20 or version not in (1, 2) or width == 0 or height == 0 or depth not in (1, 4):
        raise PassOn(f"{name}: not a GIMP brush PIL reads")
    pos = 20
    if version == 1:
        comment = header_size - 20
    else:
        comment = header_size - 28
        if data[20:24] != b"GIMP" or len(data) < 28:
            raise PassOn(f"{name}: not a GIMP brush (bad magic number)")
        pos = 28
    if comment < -1 and from_file:
        raise ValueError(f"{name}: GIMP brush comment of {comment} bytes (PIL: read length must be non-negative)")
    pos = len(data) if comment < 0 else min(pos + comment, len(data))
    codec.check_size(width, height, name)
    mode = "L" if depth == 1 else "RGBA"
    return raw.set_as_raw(data[pos : pos + width * height * depth], width, height, mode, name), mode, None
