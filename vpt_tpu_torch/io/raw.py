"""PIL's "raw" decoder and its unpackers, for the plugins whose pixels PIL
reads as they lie in the file (IM, IMT, FITS, SPIDER, McIdas, PIXAR, XV
thumbnails, Sun raster, MSP, GBR, BLP, FTEX, XPM, IPTC).

`unpack(mode, rawmode, lines, w)` turns (h, bytes) scanlines into the array
`np.asarray` gives of a PIL image of that mode ("1" bool, "L" / "P" uint8,
"I;16" / "I;16L" uint16, "I;16B" big-endian uint16, "I" int32, "F" float32,
"LA" / "PA" two bands, "RGB" / "YCbCr" / "LAB" three, "RGBA" / "CMYK" four),
for the (mode, rawmode) pairs PIL 12.1 has unpackers for; another pair
raises as PIL's `_getdecoder` raises.  `tile(...)` is `ImageFile.load` of one
raw tile (its stride, its row order, a file that ends early, and the memory
map PIL reads a file's "L", "P" and 16-bit gray tiles through when it opens
the file by its path); `set_as_raw(...)` is `PyDecoder.set_as_raw`, the
Python decoders' last step.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec

# Each rawmode's bits per pixel.
_BITS = {"1": 1, "1;I": 1, "1;R": 1, "P;1": 1, "P;2": 2, "L;4": 4, "P;4": 4,
         **{r: 8 for r in ("L", "L;I", "P", "F;8", "F;8S", "I;8", "I;8S", "G", "R", "B")},
         **{r: 16 for r in ("I;16", "I;16L", "I;16B", "I;16S", "F;16", "F;16S", "F;16B", "LA", "PA", "LA;L", "PA;L")},
         **{r: 24 for r in ("RGB", "BGR", "RGB;L", "YCbCr", "YCbCr;L")},
         **{r: 32 for r in ("RGBX", "BGRX", "RGBA", "RGBX;L", "RGBA;L", "CMYK", "CMYK;L", "I", "I;32", "I;32S",
                            "I;32B", "F", "F;32", "F;32S", "F;32F", "F;32BF")}}
# The rawmodes PIL 12.1 unpacks into each mode.
PAIRS = {
    "1": ("1", "1;I", "1;R"),
    "L": ("L", "L;4", "L;I"),
    "P": ("L", "P", "P;1", "P;2", "P;4"),
    "I": ("I;16", "I;16B", "I;32B", "I;32", "I;32S", "I", "I;16S", "I;8", "I;8S"),
    "F": ("F", "F;32F", "F;32BF", "F;32", "F;16", "F;16S", "F;8", "F;8S", "F;16B", "F;32S"),
    "LA": ("LA;L", "LA"),
    "PA": ("PA;L", "LA", "PA"),
    "RGB": ("RGB", "BGR", "RGBX", "BGRX", "RGB;L", "RGBX;L", "RGBA;L", "G", "R", "B"),
    "RGBA": ("BGR", "RGBA", "RGBA;L", "G", "R", "B", "LA"),
    "CMYK": ("CMYK;L", "CMYK"),
    "YCbCr": ("YCbCr;L", "YCbCr"),
    "I;16": ("I;16", "I;16B"),
    "I;16L": ("I;16L",),
    "I;16B": ("I;16B",),
    "LAB": ("L",),
}
MAPMODES = ("L", "P", "RGBX", "RGBA", "CMYK", "I;16", "I;16L", "I;16B")  # Image._MAPMODES
# How PIL was handed the file: bytes in memory, a file object (imageio's
# Pillow plugin: a real file's seeks and reads, no memory map), or a path
# (`Image.open(path)`: a file PIL may map).
MEMORY, FILE_OBJECT, PATH = 0, 1, 2
_BANDS = {"1": 0, "L": 0, "P": 0, "I": 0, "F": 0, "I;16": 0, "I;16L": 0, "I;16B": 0, "LA": 2, "PA": 2, "RGB": 3,
          "YCbCr": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}


def bits(rawmode: str) -> int:
    return _BITS[rawmode]


def check(mode: str, rawmode: str, name: str) -> None:
    """Raise where PIL has no unpacker from rawmode to mode."""
    if rawmode not in PAIRS.get(mode, ()):
        raise ValueError(f"{name}: PIL has no {rawmode!r} unpacker for mode {mode!r} (unknown raw mode)")


def _bitfield(lines: np.ndarray, w: int, n: int, lsb: bool = False) -> np.ndarray:
    """n-bit fields, the first in the high bits of each byte (the low ones
    with lsb)."""
    per = 8 // n
    shifts = np.arange(per, dtype=np.uint8) * n if lsb else np.arange(8 - n, -1, -n, dtype=np.uint8)
    return ((lines[:, :, None] >> shifts) & ((1 << n) - 1)).reshape(lines.shape[0], -1)[:, :w]


def _planes(lines: np.ndarray, w: int, k: int) -> np.ndarray:
    """";L" rawmodes: a line holds its k bands one after the other."""
    return np.stack([lines[:, b * w : (b + 1) * w] for b in range(k)], axis=-1)


def unpack(mode: str, rawmode: str, lines: np.ndarray, w: int) -> np.ndarray:
    """(h, >= bytes) uint8 scanlines to the mode's array (see the module)."""
    lines = np.ascontiguousarray(lines[:, : (w * _BITS[rawmode] + 7) // 8], np.uint8)
    h = lines.shape[0]
    r = rawmode
    if r in ("1", "1;I", "1;R", "P;1", "P;2", "L;4", "P;4"):
        v = _bitfield(lines, w, _BITS[r], lsb=r in ("1;R",))
        if mode == "1":
            return (v == 0) if r == "1;I" else v.astype(bool)
        return (v * 17).astype(np.uint8) if r == "L;4" else v.astype(np.uint8)
    if mode in ("L", "P", "LAB") and r in ("L", "P", "L;I"):
        v = lines[:, :w]
        v = ~v if r == "L;I" else v
        if mode == "LAB":  # the a and b bands PIL's new image holds: 128
            out = np.full((h, w, 3), 128, np.uint8)
            out[..., 0] = v
            return out
        return v.copy()
    if mode in ("I", "F"):
        src = {"I;16": "<u2", "I;16B": ">u2", "I;16S": "<i2", "I;8": "u1", "I;8S": "i1", "I;32B": ">i4", "I;32": "<i4",
               "I;32S": "<i4", "I": "<i4", "F": "<f4", "F;32F": "<f4", "F;32BF": ">f4", "F;32": "<u4", "F;32S": "<i4",
               "F;16": "<u2", "F;16S": "<i2", "F;16B": ">u2", "F;8": "u1", "F;8S": "i1"}[r]
        v = lines.view(src)[:, :w]
        return v.astype(np.int32 if mode == "I" else np.float32)
    if mode in ("I;16", "I;16L", "I;16B"):
        v = lines.view(">u2" if r == "I;16B" else "<u2")[:, :w]
        return v.astype(">u2" if mode == "I;16B" else np.uint16)
    c = _BANDS[mode]
    out = np.zeros((h, w, c), np.uint8)
    if r in ("G", "R", "B"):
        out[..., "RGB".index(r)] = lines[:, :w]
    elif r.endswith(";L"):
        k = {"RGB;L": 3, "RGBX;L": 4, "RGBA;L": 4, "CMYK;L": 4, "YCbCr;L": 3, "LA;L": 2, "PA;L": 2}[r]
        v = _planes(lines, w, k)
        out[...] = v[..., :c] if mode != "RGB" else v[..., :3]
    elif r in ("RGB", "BGR", "YCbCr"):
        v = lines[:, : 3 * w].reshape(h, w, 3)
        out[..., :3] = v[..., ::-1] if r == "BGR" else v
        if c == 4:
            out[..., 3] = 255
    elif r in ("RGBX", "BGRX", "RGBA", "CMYK"):
        v = lines[:, : 4 * w].reshape(h, w, 4)
        v = v[..., [2, 1, 0, 3]] if r == "BGRX" else v
        out[...] = v[..., :c]
    elif r in ("LA", "PA"):
        v = lines[:, : 2 * w].reshape(h, w, 2)
        if mode == "RGBA":
            out[..., :3] = v[..., :1]
            out[..., 3] = v[..., 1]
        else:
            out[...] = v
    else:  # pragma: no cover  (PAIRS lists no other)
        raise ValueError(f"no unpacker for {mode} / {rawmode}")
    return out


def _lines(data, offset: int, w: int, h: int, rawmode: str, stride: int = 0):
    """The raw decoder's scanlines: h lines of the rawmode's bytes, `stride`
    apart (0: packed), from data[offset:] (offset >= 0), or None where the
    data ends first (PIL: "image file is truncated")."""
    nbytes = (w * _BITS[rawmode] + 7) // 8
    step = stride or nbytes
    need = (h - 1) * step + nbytes
    if offset + need > len(data):
        return None
    return np.lib.stride_tricks.as_strided(np.frombuffer(data, np.uint8, need, offset), (h, nbytes), (step, 1))


def tile(data, offset: int, w: int, h: int, mode: str, rawmode: str, name: str, stride: int = 0, ystep: int = 1,
         mappable: bool = False) -> np.ndarray:
    """`ImageFile.load` of one raw tile at `offset`: the array, rows in file
    order or bottom-up (ystep -1), `stride` bytes apart (0: packed).
    `mappable`: PIL maps the file instead (opened by its path, one raw
    tile, rawmode == mode, a mode of Image._MAPMODES, no read or seek
    override), which needs the mode's whole rows to lie in the file and
    takes a stride below a line's bytes (0 or less: packed)."""
    check(mode, rawmode, name)
    if offset < 0:
        raise ValueError(f"{name}: negative tile offset (PIL: ValueError)")
    if mappable and mode == rawmode and mode in MAPMODES and not offset + h * stride > len(data):
        if not -(1 << 31) <= stride < 1 << 31:
            raise ValueError(f"{name}: a stride of {stride} (PIL: signed integer out of range)")
        line = w * (1 if mode in ("L", "P") else 2 if mode.startswith("I;16") else 4)
        step = stride if stride > 0 else line
        if offset + h * step > len(data):
            raise ValueError(f"{name}: image data is short of its {h} rows (PIL: buffer is not large enough)")
        if step < line and offset + (h - 1) * step + line > len(data):
            raise ValueError(f"{name}: image rows run past the end of the file (PIL reads past its map)")
        buf = np.frombuffer(data, np.uint8)
        lines = np.lib.stride_tricks.as_strided(buf[offset:], (h, line), (step, 1))
    else:
        if stride < 0 or (stride and stride < (w * _BITS[rawmode] + 7) // 8):
            raise ValueError(f"{name}: a stride of {stride} bytes is shorter than a line (PIL: decoder error)")
        lines = _lines(data, offset, w, h, rawmode, stride)
        if lines is None:
            raise ValueError(f"{name}: image file is truncated (PIL)")
    arr = unpack(mode, rawmode, lines, w)
    return np.ascontiguousarray(arr[::-1] if ystep < 0 else arr)


def set_as_raw(stream, w: int, h: int, mode: str, name: str, rawmode: str | None = None) -> np.ndarray:
    """`PyDecoder.set_as_raw`: the image from a stream of raw bytes (more
    than it needs is ignored; fewer raises PIL's "not enough image data")."""
    rawmode = rawmode or mode
    check(mode, rawmode, name)
    lines = _lines(stream, 0, w, h, rawmode)
    if lines is None:
        raise ValueError(f"{name}: not enough image data (PIL)")
    return np.ascontiguousarray(unpack(mode, rawmode, lines, w))


def bit_decode(data, offset: int, w: int, h: int, nbits: int, name: str) -> np.ndarray:
    """PIL's "bit" decoder as ImImagePlugin uses it (fill 3: bits taken
    from the low end of each byte up; a line's bits start afresh, the bit
    buffer's leftovers kept; rows bottom-up) into mode "F"."""
    codec.check_size(w, h, name)
    out = np.zeros((h, w), np.float32)
    src = np.frombuffer(data, np.uint8)[offset:] if 0 <= offset <= len(data) else np.zeros(0, np.uint8)
    if codec.bit_decode(src, out, nbits) < 0:
        raise ValueError(f"{name}: image file is truncated (PIL)")
    return out
