"""PSD decoding to what PIL's PsdImagePlugin opens: the merged image only
(layers are not decoded, as PIL does not decode them on open or convert),
raw or PackBits (the C codec's `packbits_rows`, each channel's scanlines
read on from its first row's offset as PIL's decoder reads them), in the
modes PIL gives: bitmap ("1"), gray, duotone and multichannel ("L"),
indexed ("P", with its 768-byte palette), RGB (with a fourth channel
"RGBA"), CMYK (PIL's inverted samples) and Lab ("LAB").  What PIL refuses
raises a ValueError naming it; a header PIL's plugin cannot read raises
PassOn."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn

# (Photoshop colour mode, bits) -> (mode, channels needed)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1), (3, 8): ("RGB", 3),
          (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class _Cursor:
    def __init__(self, data: bytes, pos: int, name: str):
        self.data, self.pos, self.name = data, pos, name

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def u(self, fmt: str) -> int:
        raw = self.read(struct.calcsize(fmt))
        if len(raw) < struct.calcsize(fmt):
            raise PassOn(f"{self.name}: PSD header ends early")
        return struct.unpack(fmt, raw)[0]


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A PSD file's merged image as PIL opens it: (array, mode, (256, 3)
    palette or None)."""
    if data[:4] != b"8BPS" or len(data) < 26 or data[4:6] != b"\x00\x01":
        raise PassOn(f"{name}: not a PSD file")
    channels, height, width, bits, psd_mode = struct.unpack_from(">H2I2H", data, 12)
    if (psd_mode, bits) not in _MODES:
        raise PassOn(f"{name}: PSD colour mode {psd_mode} at {bits} bits (PIL: unsupported mode)")
    mode, needed = _MODES[(psd_mode, bits)]
    if needed > channels:
        raise ValueError(f"{name}: PSD has {channels} channels, mode {mode} needs {needed}")
    if mode == "RGB" and channels == 4:
        mode, needed = "RGBA", 4
    c = _Cursor(data, 26, name)
    size = c.u(">I")
    palette = None
    if size:
        table = c.read(size)
        if mode == "P" and size == 768:
            palette = np.frombuffer(table, np.uint8).reshape(3, 256).T.copy()
    size = c.u(">I")
    if size:  # image resources: walked as PIL walks them
        end = c.pos + size
        while c.pos < end:
            c.read(4)
            c.u(">H")
            name_len = c.read(1)
            if not name_len:
                raise PassOn(f"{name}: PSD image resources end early")
            got = c.read(name_len[0])
            if not len(got) & 1:
                c.read(1)
            got = c.read(c.u(">I"))
            if len(got) & 1:
                c.read(1)
    size = c.u(">I")
    if size:
        end = c.pos + size
        c.u(">I")
        c.pos = end
    compression = c.u(">H")
    if width <= 0 or height <= 0:
        raise PassOn(f"{name}: PSD image of {width}x{height} pixels")
    codec.check_size(width, height, name)
    row = (width + 7) // 8 if mode == "1" else width
    planes = []
    if compression == 0:
        offset = c.pos
        for _ in range(needed):
            if len(data) - offset < row * height:
                raise ValueError(f"{name}: PSD image data is truncated")
            planes.append(np.frombuffer(data, np.uint8, row * height, offset).reshape(height, row))
            offset += width * height
    elif compression == 1:
        counts = c.read(needed * height * 2)
        if len(counts) < needed * height * 2:
            raise PassOn(f"{name}: PSD row byte counts end early")
        offsets = c.pos + np.concatenate([[0], np.cumsum(np.frombuffer(counts, ">u2"))])
        for ch in range(needed):
            rows, status = codec.packbits_rows(memoryview(data)[int(offsets[ch * height]) :], row, height)
            if status:
                raise ValueError(f"{name}: PSD PackBits data ends early (PIL: image file is truncated)")
            planes.append(rows)
    else:
        raise ValueError(f"{name}: PSD compression {compression} (PIL: cannot load this image)")
    if mode == "1":
        return np.unpackbits(planes[0], axis=1)[:, :width].astype(bool), mode, None
    if mode == "CMYK":
        planes = [255 - p for p in planes]
    elif mode == "LAB":  # PIL's Lab unpackers take a and b as signed bytes
        planes = [planes[0], planes[1] ^ 0x80, planes[2] ^ 0x80]
    arr = planes[0] if needed == 1 else np.stack(planes, axis=-1)
    return np.ascontiguousarray(arr), mode, palette
