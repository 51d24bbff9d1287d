"""PNG files as OpenCV 5.0's PngDecoder (grfmt_png.cpp, over libpng
1.6) reads them with `IMREAD_COLOR`.

The samples are the port's own PNG decode (io/image._decode_png) put
through the transforms OpenCV asks libpng for: `png_set_strip_16` (the
high byte of a 16-bit sample), `png_set_strip_alpha` (alpha and tRNS
dropped, nothing composited), `png_set_palette_to_rgb` (an index past the
palette black), `png_set_expand_gray_1_2_4_to_8` (1, 2 and 4-bit gray
scaled by 255, 85, 17) and `png_set_gray_to_rgb`.  An APNG reads as its
first frame: the default image where an fcTL comes before IDAT, else the
first frame's fdAT data, as stored (not blended), on a black canvas.  The EXIF orientation comes from an
`eXIf` chunk.  libpng reads every chunk to IEND and refuses what is
broken on the way (`_sanitise`), more strictly than PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from vpt_tpu_torch.io.image import _decode_png

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def claims(sig: bytes) -> bool:
    return sig[:8] == SIGNATURE


def _exif(data: bytes) -> bytes | None:
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        if kind == b"eXIf":
            return data[pos + 8 : pos + 8 + length]
        if kind == b"IEND":
            break
        pos += 12 + length
    return None


def _chunks(data: bytes) -> list:
    out, pos = [], 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        out.append((data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]))
        if data[pos + 4 : pos + 8] == b"IEND":
            break
        pos += 12 + length
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _first_frame(data: bytes) -> tuple:
    """An APNG whose default image is not its first frame (no fcTL before
    IDAT): (that frame as a PNG of its own, its offset, the canvas size);
    else (data, None, None)."""
    chunks = _chunks(data)
    kinds = [k for k, _ in chunks]
    if b"acTL" not in kinds or b"IDAT" not in kinds or b"fcTL" not in kinds \
            or kinds.index(b"fcTL") < kinds.index(b"IDAT"):
        return data, None, None
    header = next(b for k, b in chunks if k == b"IHDR")
    first = kinds.index(b"fcTL")
    fc = chunks[first][1]
    w, h, x, y = struct.unpack(">4I", fc[4:20])
    parts = []
    for k, b in chunks[first + 1 :]:
        if k == b"fcTL":
            break
        if k == b"fdAT":
            parts.append(b[4:])
    png = SIGNATURE + _chunk(b"IHDR", struct.pack(">II", w, h) + header[8:13])
    png += b"".join(_chunk(k, b) for k, b in chunks if k in (b"PLTE", b"tRNS"))
    png += b"".join(_chunk(b"IDAT", p) for p in parts) + _chunk(b"IEND", b"")
    return png, (x, y), struct.unpack(">II", header[:8])


_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")


def _sanitise(data: bytes, name: str) -> bytes:
    """The file as libpng reads it through IEND: each chunk whole, its name
    of letters, its length below 2^31, no unknown critical chunk, a critical
    chunk's CRC right (IEND's is not checked); an ancillary chunk with a bad
    CRC is dropped.  The data must reach IEND.  An APNG (acTL) is read by
    OpenCV's own chunk reader up to its first frame, unchecked."""
    if b"acTL" in [k for k, _ in _chunks(data)]:
        return data
    pos, out = 8, [data[:8]]
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: PNG ends before IEND (libpng: Read Error)")
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        if not kind.isalpha() or not kind.isascii():
            raise ValueError(f"{name}: PNG chunk {kind!r} has a bad name (libpng)")
        if length > 0x7FFFFFFF:
            raise ValueError(f"{name}: PNG chunk length out of range (libpng)")
        if pos + 12 + length > len(data):
            raise ValueError(f"{name}: PNG ends inside chunk {kind!r} (libpng: Read Error)")
        if kind == b"IEND":
            return b"".join(out) + _chunk(b"IEND", b"")
        critical = kind[:1].isupper()
        if critical and kind not in _CRITICAL:
            raise ValueError(f"{name}: PNG has an unknown critical chunk {kind!r} (libpng)")
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF == crc:
            out.append(data[pos : pos + 12 + length])
        elif critical:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC (libpng)")
        pos += 12 + length


def read(data: bytes, name: str) -> tuple:
    """The image as (H, W, 3) uint8 RGB, and its EXIF bytes."""
    data = _sanitise(data, name)
    try:
        png, at, canvas = _first_frame(data)
    except (struct.error, StopIteration):
        raise ValueError(f"{name}: APNG with a broken acTL / fcTL chunk") from None
    rgb = _rgb(png, name)
    if at is not None:
        out = np.zeros((canvas[1], canvas[0], 3), np.uint8)
        out[at[1] : at[1] + rgb.shape[0], at[0] : at[0] + rgb.shape[1]] = rgb
        rgb = out
    return rgb, _exif(data)


def _rgb(data: bytes, name: str) -> np.ndarray:
    samples, depth, ctype, palette, _ = _decode_png(data, name)
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[: min(len(palette), 256)] = palette[:256]
        return table[samples[..., 0]]
    if depth == 16:
        samples = samples >> 8
    elif ctype == 0 and depth < 8:
        samples = samples * {1: 255, 2: 85, 4: 17}[depth]
    samples = samples.astype(np.uint8)
    rgb = samples[..., :3] if ctype in (2, 6) else np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(rgb)
