"""PIXAR raster decoding to what PIL's PixarImagePlugin opens: the 512-byte
header's size and, for 8-bit RGB (channel code 14, depth 2), raw RGB
pixels at byte 1024; any other layout gives PIL no mode, so the file passes
on to PIL's later plugins (PassOn)."""

from __future__ import annotations

import struct

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"\x80\xe8\x00\x00"


def read_pil(data: bytes, name: str = "image", from_file: bool = False) -> tuple:
    """A PIXAR file as PIL opens it: (array, "RGB", None)."""
    if not accept(data) or len(data) < 428:
        raise PassOn(f"{name}: not a PIXAR file")
    h, w = struct.unpack_from("<2H", data, 416)
    channels, depth = struct.unpack_from("<2H", data, 424)
    if (channels, depth) != (14, 2) or w <= 0 or h <= 0:
        raise PassOn(f"{name}: PIXAR layout PIL reads no mode of (channels {channels}, depth {depth}, {w}x{h})")
    codec.check_size(w, h, name)
    return raw.tile(data, 1024, w, h, "RGB", "RGB", name), "RGB", None
