"""Apple icon (ICNS) decoding to what PIL's IcnsImagePlugin opens: the
resource directory, PIL's pick of the largest size it knows, and that
size's entries: a PNG or JPEG 2000 entry (read as PIL reads it, a JPEG 2000
one converted to RGBA), else the 24-bit RGB entry (raw, or PIL's
packbits-like RLE per channel, `read_32`) with its 8-bit mask as alpha.  A
directory PIL's plugin cannot read raises PassOn; what it refuses, a
ValueError.  The image is in the PNG's mode where a PNG entry gives it."""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec, jpeg2000
from vpt_tpu_torch.io.probe import PassOn

# PIL's IcnsFile.SIZES: (width, height, scale) -> its entries, in order.
SIZES = {
    (512, 512, 2): ((b"ic10", "png"),), (512, 512, 1): ((b"ic09", "png"),),
    (256, 256, 2): ((b"ic14", "png"),), (256, 256, 1): ((b"ic08", "png"),),
    (128, 128, 2): ((b"ic13", "png"),),
    (128, 128, 1): ((b"ic07", "png"), (b"it32", "32t"), (b"t8mk", "mk")),
    (64, 64, 1): ((b"icp6", "png"),), (32, 32, 2): ((b"ic12", "png"),),
    (48, 48, 1): ((b"ih32", "32"), (b"h8mk", "mk")),
    (32, 32, 1): ((b"icp5", "png"), (b"il32", "32"), (b"l8mk", "mk")),
    (16, 16, 2): ((b"ic11", "png"),),
    (16, 16, 1): ((b"icp4", "png"), (b"is32", "32"), (b"s8mk", "mk")),
}
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"icns"


def _directory(data: bytes, name: str, from_file: bool) -> dict:
    """PIL's IcnsFile: {type: (start, length)}, the file position moved by
    each block's length (a real file refuses a seek before its start, a
    buffer stops at 0)."""
    if len(data) < 8 or data[:4] != b"icns":
        raise PassOn(f"{name}: not an icns file")
    (filesize,) = struct.unpack_from(">I", data, 4)
    i = pos = 8
    dct = {}
    while i < filesize:
        if pos + 8 > len(data):
            raise PassOn(f"{name}: icns directory ends early")
        sig, blocksize = struct.unpack_from(">4sI", data, pos)
        pos += 8
        if blocksize <= 0:
            raise PassOn(f"{name}: invalid icns block header")
        i += 8
        blocksize -= 8
        dct[sig] = (i, blocksize)
        pos += blocksize
        if pos < 0:
            if from_file:
                raise ValueError(f"{name}: icns block seeks before the file's start (PIL: invalid seek)")
            pos = 0
        i += blocksize
    return dct


def _read_32(data: bytes, start: int, length: int, side: int) -> np.ndarray:
    """PIL's read_32: (side, side, 3) uint8."""
    sq = side * side
    if length == sq * 3:
        body = data[start : start + length]
        if len(body) < length:
            raise ValueError("not enough image data (PIL)")
        return np.frombuffer(body, np.uint8).reshape(side, side, 3).copy()
    out = np.zeros((side, side, 3), np.uint8)
    pos = start
    for band in range(3):
        parts, left = [], sq
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                size = b - 125
                v = data[pos : pos + 1]
                pos += 1
                parts.append(v * size)
            else:
                size = b + 1
                parts.append(data[pos : pos + size])
                pos += size
            left -= size
            if left <= 0:
                break
        if left != 0:
            raise ValueError(f"error reading icns channel [{left} left] (PIL: SyntaxError)")
        plane = b"".join(parts)
        if len(plane) < sq:
            raise ValueError("icns channel data is short (PIL: buffer is not large enough)")
        out[..., band] = np.frombuffer(plane, np.uint8, sq).reshape(side, side)
    return out


def read_pil(data: bytes, name: str = "image", from_file: bool = False, png=None, rgba=None,
             asarray: bool = False) -> tuple:
    """An icns file as PIL opens it: (array, mode, palette).  `png(bytes)`
    reads a PNG entry as PIL opens it, (array, mode, palette); `rgba(array,
    mode, palette, transparency)` is PIL's `convert("RGBA")` as uint8 (for
    a JPEG 2000 entry).  `asarray`: the array as `np.asarray` gives it, which
    packs the loaded image as the mode PIL opened it in, "RGBA", and shapes
    it as the loaded mode: an RGB image's bytes with their pad byte (255
    from raw or PNG data, 0 from the RLE channels) read three to a pixel;
    PIL has no RGBA packer for the other modes a PNG entry gives, so they
    raise."""
    arr, mode, table, pad = _read(data, name, from_file, png, rgba)
    if not asarray or mode == "RGBA":
        return arr, mode, table
    if mode != "RGB":
        raise ValueError(f"{name}: an icns image of mode {mode} (PIL: no packer found from {mode} to RGBA)")
    h, w = arr.shape[:2]
    packed = np.concatenate([arr, np.full((h, w, 1), pad, np.uint8)], -1).reshape(-1)
    return packed[: h * w * 3].reshape(h, w, 3), mode, table


def _read(data: bytes, name: str, from_file: bool, png, rgba) -> tuple:
    """(array, mode, palette, the RGB image's pad byte)."""
    dct = _directory(data, name, from_file)
    sizes = [size for size, entries in SIZES.items() if any(code in dct for code, _ in entries)]
    if not sizes:
        raise PassOn(f"{name}: no 32-bit icon resources found")
    best = max(sizes)
    side = best[0] * best[2]
    codec.check_size(side, best[1] * best[2], name)
    channels, pad = {}, 0
    for code, kind in SIZES[best]:
        if code not in dct:
            continue
        start, length = dct[code]
        if kind == "png":
            sig = data[start : start + 12]
            if sig.startswith(b"\x89PNG\r\n\x1a\n"):
                channels["RGBA"] = png(data[start:])
            elif sig.startswith(_J2K) or sig == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a":
                if length < -1 and from_file:
                    raise ValueError(f"{name}: icns entry of {length} bytes (PIL: read length must be non-negative)")
                arr, mode, table = jpeg2000.read_pil(data[start:] if length < 0 else data[start : start + length], name)
                channels["RGBA"] = (arr, "RGBA", None) if mode == "RGBA" else (rgba(arr, mode, table, None), "RGBA",
                                                                                 None)
            else:
                raise ValueError(f"{name}: unsupported icon subimage format")
        elif kind == "mk":
            plane = data[start : start + side * side]
            if len(plane) < side * side:
                raise ValueError(f"{name}: icns mask is short (PIL: buffer is not large enough)")
            channels["A"] = np.frombuffer(plane, np.uint8).reshape(side, side)
        else:
            if kind == "32t":
                if data[start : start + 4] != b"\0\0\0\0":
                    raise ValueError(f"{name}: unknown icns it32 signature (PIL: SyntaxError)")
                start, length = start + 4, length - 4
            try:
                channels["RGB"] = _read_32(data, start, length, side)
            except ValueError as e:
                raise ValueError(f"{name}: {e}") from None
            pad = 255 if length == side * side * 3 else 0
    if "RGBA" in channels:
        arr, mode, table = channels["RGBA"]
        h, w = arr.shape[:2]
        for size in sizes:
            full = (size[0] * size[2], size[1] * size[2])
            if full[1] / h == full[0] // w:
                return arr, mode, table, 255
        raise ValueError(f"{name}: icns entry of {w}x{h} pixels is not one of the image's sizes (PIL: ValueError)")
    if "RGB" not in channels:
        raise ValueError(f"{name}: icns size without its RGB entry (PIL: KeyError)")
    if "A" not in channels:
        return channels["RGB"], "RGB", None, pad
    return np.concatenate([channels["RGB"], channels["A"][..., None]], -1), "RGBA", None, pad
