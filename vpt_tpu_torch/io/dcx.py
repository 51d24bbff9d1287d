"""DCX decoding to what PIL's DcxImagePlugin opens: the container's first
page, a PCX image (io/pcx.py) at the first offset of its directory (up to
1,024 offsets, ended by a zero), read as PIL reads it there (its 8-bit
palette from the end of the whole file).  A directory that ends early or
holds no page raises PassOn, and PIL tries the file's later plugins."""

from __future__ import annotations

import struct

from vpt_tpu_torch.io import pcx
from vpt_tpu_torch.io.probe import PassOn

MAGIC = 0x3ADE68B1


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from("<I", prefix)[0] == MAGIC


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """A DCX file's first page as PIL opens it: (array, mode, palette)."""
    if not accept(data):
        raise PassOn(f"{name}: not a DCX file")
    offsets = []
    for i in range(1024):
        at = 4 + 4 * i
        if at + 4 > len(data):
            raise PassOn(f"{name}: DCX directory ends early")
        (offset,) = struct.unpack_from("<I", data, at)
        if not offset:
            break
        offsets.append(offset)
    if not offsets:
        raise PassOn(f"{name}: DCX file without a page (PIL: attempt to seek outside sequence)")
    return pcx.read_pil(data[offsets[0] :], name, from_file, whole=data)
