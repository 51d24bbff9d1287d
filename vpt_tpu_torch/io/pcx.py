"""PCX decoding to what PIL's PcxImagePlugin opens: RLE scanlines (the C
codec's `pcx_rle`, which reads them as PIL's decoder does), 1-bit (mode
"1"), 2- and 4-plane 1-bit with the header's 16-colour palette (mode "P"),
8-bit with the 256-colour palette at the file's end (mode "P", or "L" when
it is the identity gray ramp or absent) and 3-plane 8-bit colour ("RGB").
A file read from a path that is shorter than the 769 bytes of the trailing
palette is refused, as PIL's seek before the end of such a file fails; from
memory it opens.  What PIL refuses raises a ValueError naming it; a header
PIL's plugin rejects raises PassOn."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    """PIL's PcxImagePlugin._accept: 0x0A, then version 0, 2, 3 or 5."""
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def _planes(buf: np.ndarray, w: int, planes: int) -> np.ndarray:
    """PIL's "P;2L" / "P;4L" unpackers: bit planes (w + 7) // 8 bytes apart."""
    s = (w + 7) // 8
    bits = np.unpackbits(buf[:, : planes * s].reshape(buf.shape[0], planes, s), axis=2)[:, :, :w]
    return sum(bits[:, p] << p for p in range(planes)).astype(np.uint8)


def read_pil(data: bytes, name: str = "image", from_file: bool = False, whole: bytes | None = None) -> tuple:
    """A PCX file as PIL opens it: (array, mode, (256, 3) palette or None).
    `whole`: the file the PCX image lies in (a DCX page), whose end PIL
    reads the 8-bit palette from."""
    whole = data if whole is None else whole
    if not accept(data) or len(data) < 68:
        raise PassOn(f"{name}: not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise PassOn(f"{name}: bad PCX image size")
    version, bits, planes = data[1], data[3], data[65]
    (provided_stride,) = struct.unpack_from("<H", data, 66)
    palette = None
    if bits == 1 and planes == 1:
        mode = raw = "1"
    elif bits == 1 and planes in (2, 4):
        mode, raw = "P", f"P;{planes}L"
        palette = np.zeros((256, 3), np.uint8)
        palette[:16] = np.frombuffer(data, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = raw = "L"
        if from_file and len(whole) < 769:
            raise ValueError(f"{name}: PCX file shorter than its 769-byte palette (PIL: invalid seek)")
        tail = whole[-769:] if len(whole) >= 769 else whole
        if len(tail) == 769 and tail[0] == 12 and tail[1:] != bytes(np.repeat(np.arange(256, dtype=np.uint8), 3)):
            mode = raw = "P"
            palette = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3).copy()
    elif version == 5 and bits == 8 and planes == 3:
        mode, raw = "RGB", "RGB;L"
    else:
        raise ValueError(f"{name}: unknown PCX mode ({bits} bits, {planes} planes, version {version})")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    codec.check_size(w, h, name)
    stride = (w * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2
    row_bytes = planes * stride
    unpacked = {"1": 1, "P;2L": 2, "P;4L": 4, "L": 8, "P": 8, "RGB;L": 24}[raw]
    if (w * unpacked + 7) // 8 > row_bytes:
        raise ValueError(f"{name}: PCX scanline of {row_bytes} bytes is short of its pixels (PIL: buffer overrun)")
    rows, status = codec.pcx_rle(memoryview(data)[128:], row_bytes, w, unpacked, h)
    if status < 0:
        raise ValueError(f"{name}: PCX run past the end of a scanline (PIL: image buffer overrun error)")
    if status:
        raise ValueError(f"{name}: PCX image data ends early (PIL: image file is truncated)")
    if raw == "1":
        arr = np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    elif raw in ("P;2L", "P;4L"):
        arr = _planes(rows, w, planes)
    elif raw == "RGB;L":
        arr = np.stack([rows[:, :w], rows[:, w : 2 * w], rows[:, 2 * w : 3 * w]], axis=-1)
    else:
        arr = rows[:, :w]
    return np.ascontiguousarray(arr), mode, palette
