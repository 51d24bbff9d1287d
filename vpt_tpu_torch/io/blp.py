"""BLP (Blizzard texture) decoding to what PIL's BlpImagePlugin opens: BLP1
as a JPEG (the shared header and the first mipmap through io/jpeg.py,
converted to RGB as PIL converts it, then read back as BGR) or a 256-colour
palette; BLP2 as a palette or DXT1 / DXT3 / DXT5, the blocks decoded as
PIL's Python `decode_dxt1` / `3` / `5` decode them (the C codec's
`blp_dxt`: 565 colours widened by shifts, integer thirds and halves),
block rows of whole blocks read back into the image's rows as PIL's raw
decoder reads them.  Mode "RGBA" when the
header's alpha flag is set, else "RGB".  A header PIL's plugin cannot read
raises PassOn; what it refuses, a ValueError."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec, raw
from vpt_tpu_torch.io.jpeg import decode_jpeg
from vpt_tpu_torch.io.probe import PassOn


def accept(prefix: bytes) -> bool:
    return prefix[:4] in (b"BLP1", b"BLP2")


class _File:
    """A file position with PIL's `_safe_read` (short reads raise)."""

    def __init__(self, data: bytes, pos: int, name: str):
        self.data, self.pos, self.name = data, pos, name

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        out = self.data[self.pos : self.pos + n]
        self.pos += len(out)
        if len(out) < n:
            raise ValueError(f"{self.name}: truncated BLP file (PIL: Truncated File Read)")
        return out


def _palette(f: _File) -> np.ndarray:
    """256 BGRA entries as RGBA."""
    return np.frombuffer(f.read(1024), np.uint8).reshape(256, 4)[:, [2, 1, 0, 3]]


def _indexed(f: _File, length: int, palette: np.ndarray, alpha: bool) -> bytes:
    idx = np.frombuffer(f.read(length), np.uint8)
    return palette[idx][:, : 4 if alpha else 3].tobytes()


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A BLP file as PIL opens it: (array, mode, None)."""
    magic = data[:4]
    if not accept(magic):
        raise PassOn(f"{name}: not a BLP file")
    if magic == b"BLP1":
        if len(data) < 24:
            raise PassOn(f"{name}: BLP header ends early")
        compression, alpha, w, h, encoding = struct.unpack_from("<iIIIi", data, 4)
        offset, alpha = 28, alpha != 0
    else:
        if len(data) < 20:
            raise PassOn(f"{name}: BLP header ends early")
        (compression,) = struct.unpack_from("<i", data, 4)
        encoding, alpha, alpha_encoding = struct.unpack_from("<3b", data, 8)
        w, h = struct.unpack_from("<II", data, 12)
        offset, alpha = 20, alpha != 0
    mode = "RGBA" if alpha else "RGB"
    if w <= 0 or h <= 0:
        raise PassOn(f"{name}: BLP image of {w}x{h} pixels")
    codec.check_size(w, h, name)
    f = _File(data, offset, name)
    offsets = struct.unpack("<16I", f.read(64))
    lengths = struct.unpack("<16I", f.read(64))
    if magic == b"BLP1":
        if compression == 0:
            (head,) = struct.unpack("<I", f.read(4))
            header = f.read(head)
            f.read(offsets[0] - f.pos)
            body = header + f.read(lengths[0])
            return raw.set_as_raw(_jpeg_rgb(body, name), w, h, mode, name, "BGR"), mode, None
        if compression == 1 and encoding in (4, 5):
            palette = _palette(f)
            return raw.set_as_raw(_indexed(f, lengths[0], palette, alpha), w, h, mode, name), mode, None
        raise ValueError(f"{name}: unsupported BLP1 compression {compression} / encoding {encoding}")
    palette = _palette(f)
    f.pos = offsets[0]
    if compression != 1:
        raise ValueError(f"{name}: unknown BLP2 compression {compression}")
    if encoding == 1:
        stream = _indexed(f, lengths[0], palette, alpha)
    elif encoding == 2:
        kind = {0: 1, 1: 3, 7: 5}.get(alpha_encoding)
        if kind is None:
            raise ValueError(f"{name}: unsupported BLP2 alpha encoding {alpha_encoding}")
        blocks, nrows = (w + 3) // 4, (h + 3) // 4
        body = f.read(blocks * (8 if kind == 1 else 16) * nrows)
        stream = codec.blp_dxt(body, nrows, blocks, kind, 3 if kind == 1 and not alpha else 4)
    else:
        raise ValueError(f"{name}: unknown BLP2 encoding {encoding}")
    return raw.set_as_raw(stream, w, h, mode, name), mode, None


def _jpeg_rgb(body: bytes, name: str) -> bytes:
    """The BLP1 JPEG as PIL's `convert("RGB").tobytes()` gives it (PIL's
    BLP decoder tells libjpeg a four-channel JPEG holds CMYK, so YCCK data,
    or an unknown Adobe transform, is not converted)."""
    if body[:3] != b"\xff\xd8\xff":
        raise ValueError(f"{name}: BLP1 JPEG data is not a JPEG file (PIL: SyntaxError)")
    arr = decode_jpeg(body, name)
    if arr.ndim == 3 and arr.shape[2] == 4:
        arr = decode_jpeg(body, name, color="raw")
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, -1).tobytes()
    if arr.shape[2] == 3:
        return arr.tobytes()
    cmyk = arr.astype(np.int32)
    nk = 255 - cmyk[..., 3:4]
    t = cmyk[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8).tobytes()
