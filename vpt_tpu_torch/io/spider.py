"""SPIDER decoding to what PIL's SpiderImagePlugin opens: 2D images (iform
1), the header's floats big-endian or, failing that, little-endian, a
single image or a stack's first, as float32 (mode "F").  A header PIL's
plugin does not take raises PassOn."""

from __future__ import annotations

import struct

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.probe import PassOn


def _spider_header(t: tuple) -> int:
    """PIL's isSpiderHeader: the header's bytes where its values 1, 2, 5,
    12, 13, 22 and 23 are integers, iform is one PIL knows and labbyt =
    labrec * lenbyt, else 0."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def _header(data: bytes, at: int, name: str) -> tuple:
    """(header floats with a leading 99, big-endian, header bytes) of the
    27 floats at `at`, as PIL's _open tries them."""
    if at < 0 or at + 108 > len(data):
        raise PassOn(f"{name}: not a valid Spider file")
    for big in (True, False):
        t = struct.unpack_from((">" if big else "<") + "27f", data, at)
        hdrlen = _spider_header(t)
        if hdrlen:
            return (99,) + t, big, hdrlen
    raise PassOn(f"{name}: not a valid Spider file")


def read_pil(data: bytes, name: str = "image", from_file: bool = False, imageio: bool = False) -> tuple:
    """A SPIDER file as PIL opens it: (array, "F", None).  `imageio`: as
    imageio's Pillow plugin reads it, which seeks frame 0 first (a file that
    is no stack refuses the seek; a stack reads its first image's own
    header)."""
    h, big, hdrlen = _header(data, 0, name)
    if int(h[5]) != 1:
        raise PassOn(f"{name}: not a Spider 2D image")
    try:
        w, hh, istack, imgnumber = int(h[12]), int(h[2]), int(h[24]), int(h[27])
        frames = int(h[26]) if istack > 0 and imgnumber == 0 else 1
    except (ValueError, OverflowError):
        raise ValueError(f"{name}: Spider header value out of range (PIL: ValueError)") from None
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    else:
        raise PassOn(f"{name}: inconsistent Spider stack header values")
    if w <= 0 or hh <= 0:
        raise PassOn(f"{name}: Spider image of {w}x{hh} pixels")
    codec.check_size(w, hh, name)
    if imageio and (istack == 0 or frames < 1):  # a stack is at frame 0 already: its seek does nothing
        raise ValueError(f"{name}: imageio seeks frame 0, which PIL refuses here (EOFError)")
    rawmode = "F;32BF" if big else "F;32F"
    return raw.tile(data, offset, w, hh, "F", rawmode, name), "F", None
