"""FTEX (Independence War 2 texture) decoding to what PIL's FtexImagePlugin
opens: one format, its first mipmap, raw RGB (mode "RGB") or DXT1 through
PIL's BCn decoder (mode "RGBA"; csrc/bcndec.c).  What PIL refuses raises a
ValueError naming it; a header PIL's plugin cannot read raises PassOn."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"FTEX"


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """An FTEX file as PIL opens it: (array, mode, None)."""
    if not accept(data) or len(data) < 24:
        raise PassOn(f"{name}: not an FTEX file")
    w, h, _, formats = struct.unpack_from("<4i", data, 8)
    if formats != 1:
        raise ValueError(f"{name}: FTEX file of {formats} formats (PIL: AssertionError)")
    if len(data) < 32:
        raise PassOn(f"{name}: FTEX header ends early")
    kind, where = struct.unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"{name}: FTEX mipmap at a negative offset (PIL: negative seek)")
    if where + 4 > len(data):
        raise PassOn(f"{name}: FTEX mipmap size past the end of the file")
    (size,) = struct.unpack_from("<i", data, where)
    if size < -1 and from_file:
        raise ValueError(f"{name}: FTEX mipmap of {size} bytes (PIL: read length must be non-negative)")
    body = data[where + 4 :] if size < 0 else data[where + 4 : where + 4 + size]
    if kind not in (0, 1):
        raise ValueError(f"{name}: invalid FTEX texture compression format {kind}")
    if w <= 0 or h <= 0:
        raise PassOn(f"{name}: FTEX image of {w}x{h} pixels")
    codec.check_size(w, h, name)
    if kind == 1:
        return raw.tile(body, 0, w, h, "RGB", "RGB", name), "RGB", None
    try:
        return codec.bcn_decode(np.frombuffer(body, np.uint8), w, h, 1), "RGBA", None
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
