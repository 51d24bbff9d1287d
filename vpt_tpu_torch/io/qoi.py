"""QOI decoding to what PIL's QoiImagePlugin opens: every op, the index hash,
3 channels (mode "RGB") or any other channel count (mode "RGBA"), the
colour-space byte ignored, no end marker looked for (the C codec's
`qoi_decode` runs the ops as PIL's decoder does).  A header PIL's plugin
cannot read raises PassOn, and PIL tries the file's later plugins."""

from __future__ import annotations

import struct

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A QOI file as PIL opens it: (array, mode, None)."""
    if data[:4] != b"qoif" or len(data) < 13:
        raise PassOn(f"{name}: not a QOI file")
    width, height = struct.unpack_from(">II", data, 4)
    mode = "RGB" if data[12] == 3 else "RGBA"
    if width <= 0 or height <= 0:
        raise PassOn(f"{name}: QOI image of {width}x{height} pixels")
    codec.check_size(width, height, name)
    c = len(mode)
    try:
        pixels = codec.qoi_decode(memoryview(data)[14:], width * height, c)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return pixels.reshape(height, width, c), mode, None
