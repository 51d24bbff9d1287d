"""Windows Paint decoding to what PIL's MspImagePlugin opens: the 32-byte
header (its 16-bit words XOR to 0), 1-bit pixels ("1"), raw in version 1
("DanM"), run-length coded rows in version 2 ("LinS": the C codec's
`msp_rle`, which runs PIL's Python MspDecoder).  A header PIL's plugin does
not take raises PassOn."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return prefix[:4] in (b"DanM", b"LinS")


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A Windows Paint file as PIL opens it: (array, "1", None)."""
    if not accept(data) or len(data) < 32:
        raise PassOn(f"{name}: not an MSP file")
    if np.bitwise_xor.reduce(np.frombuffer(data, "<u2", 16)) != 0:
        raise PassOn(f"{name}: bad MSP checksum")
    w, h = struct.unpack_from("<2H", data, 4)
    if w == 0 or h == 0:
        raise PassOn(f"{name}: MSP image of {w}x{h} pixels")
    if data[:4] == b"DanM":
        return raw.tile(data, 32, w, h, "1", "1", name), "1", None
    line = (w + 7) // 8
    try:
        stream, made = codec.msp_rle(data, h, line, line * h)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if made < line * h:
        raise ValueError(f"{name}: MSP rows hold {made} of {line * h} bytes (PIL: not enough image data)")
    return raw.set_as_raw(stream, w, h, "1", name), "1", None
