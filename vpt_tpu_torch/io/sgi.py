"""SGI decoding to what PIL's SgiImagePlugin opens: verbatim and RLE, 8 and
16 bits per channel (16-bit samples as their high bytes, PIL's 8-bit modes),
1 channel (mode "L"), 3 ("RGB") and 4 ("RGBA"), rows bottom-up.  The RLE
rows run through the C codec's `sgi_rle`, which reads them as PIL's decoder
does (a row's length counts its packets; a row that does not end in a
terminator where its length runs out ends the image, the rows above it left
black).  What PIL refuses raises a ValueError naming it; a header PIL's
plugin cannot read raises PassOn."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn

# (bytes per channel, dimension, channels) -> mode
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB", (2, 3, 3): "RGB",
          (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def accept(prefix: bytes) -> bool:
    """PIL's SgiImagePlugin._accept: the magic number 474."""
    return len(prefix) >= 2 and prefix[:2] == b"\x01\xda"


def read_pil(data: bytes, name: str = "image") -> tuple:
    """An SGI file as PIL opens it: (array, mode, None)."""
    if not accept(data) or len(data) < 12:
        raise PassOn(f"{name}: not an SGI file")
    compression, bpc = data[2], data[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">4H", data, 4)
    mode = _MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise ValueError(f"{name}: unsupported SGI image mode (bpc {bpc}, dimension {dimension}, zsize {zsize})")
    if xsize <= 0 or ysize <= 0:
        raise PassOn(f"{name}: SGI image of {xsize}x{ysize} pixels")
    if compression not in (0, 1):
        raise ValueError(f"{name}: SGI compression {compression} (PIL: cannot load this image)")
    codec.check_size(xsize, ysize, name)
    bands, page = len(mode), xsize * ysize
    if compression == 0:
        if len(data) - 512 < bands * page * bpc:
            raise ValueError(f"{name}: SGI image data is truncated")
        planes = np.frombuffer(data, np.uint8, bands * page * bpc, 512).reshape(bands, ysize, xsize * bpc)
        if bpc == 2:
            planes = planes[:, :, 0::2]
        arr = np.moveaxis(planes[:, ::-1], 0, -1)
    else:
        size = len(data) - 512
        if size < 8 * bands * ysize:
            raise ValueError(f"{name}: SGI RLE tables are truncated (PIL: image buffer overrun error)")
        tables = np.frombuffer(data, ">u4", 2 * bands * ysize, 512)
        try:
            rows, _ = codec.sgi_rle(memoryview(data)[512:], tables[: bands * ysize], tables[bands * ysize :], bands,
                                    xsize, ysize, bpc)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        rows = rows.reshape(ysize, xsize, bands, bpc)[..., 0]
        arr = rows[::-1]
    arr = np.ascontiguousarray(arr)
    return (arr[..., 0] if bands == 1 else arr), mode, None
