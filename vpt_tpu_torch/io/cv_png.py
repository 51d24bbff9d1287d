"""PNG files as OpenCV 5.0's PngDecoder (grfmt_png.cpp, over libpng
1.6) reads them with `IMREAD_COLOR`.

The samples are the port's own PNG decode (io/image._decode_png) put
through the transforms OpenCV asks libpng for: `png_set_strip_16` (the
high byte of a 16-bit sample), `png_set_strip_alpha` (alpha and tRNS
dropped, nothing composited), `png_set_palette_to_rgb` (an index past the
palette black), `png_set_expand_gray_1_2_4_to_8` (1, 2 and 4-bit gray
scaled by 255, 85, 17) and `png_set_gray_to_rgb`.  An APNG reads as its
first frame (`_first_frame`): the default image where an fcTL comes before
IDAT, else the first frame's fdAT data, as stored (not blended), on a
black canvas; OpenCV's own chunk reader feeds it to libpng with CRCs and
the Adler-32 unchecked, and reads no chunk after it.  The EXIF orientation comes from an
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


def _crc_ok(data: bytes, pos: int, length: int) -> bool:
    crc = data[pos + 8 + length : pos + 12 + length]
    return len(crc) == 4 and zlib.crc32(data[pos + 4 : pos + 8 + length]) & 0xFFFFFFFF == struct.unpack(">I", crc)[0]


def _inflate_frame(stream: bytes, name: str) -> bytes:
    """A frame's zlib stream as libpng inflates it under OpenCV's APNG
    settings: the zlib header checked, the Adler-32 not (its CRC action
    QUIET_USE turns libpng's IGNORE_ADLER32 on)."""
    if len(stream) < 2 or (stream[0] << 8 | stream[1]) % 31 or stream[0] & 15 != 8 or stream[0] >> 4 > 7 or \
            stream[1] & 32:
        raise ValueError(f"{name}: APNG frame with a bad zlib header")
    try:
        return zlib.decompressobj(-15).decompress(stream[2:])
    except zlib.error as e:
        raise ValueError(f"{name}: APNG frame data is corrupt ({e})") from None


def _first_frame(data: bytes, name: str) -> tuple:
    """An APNG's first frame as OpenCV's APNG reader gives it: (that frame
    as a PNG of its own, its offset or None, the canvas size).  The
    default image where an fcTL comes before IDAT, else the data of the
    first fcTL's fdAT chunks; the frame's CRCs unchecked, as are those of
    the chunks OpenCV reads itself, but IHDR's and PLTE's (libpng reads
    them first); the chunks after the frame unread.  (How OpenCV's reader
    goes on where a frame's data is corrupt is not known: ROADMAP Queue
    3.)"""
    chunks, pos = [], 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        chunks.append((kind, data[pos + 8 : pos + 8 + length], _crc_ok(data, pos, length)))
        if kind == b"IEND":
            break
        pos += 12 + length
    kinds = [k for k, _, _ in chunks]
    if b"IDAT" not in kinds:
        raise ValueError(f"{name}: APNG without image data")
    idat = kinds.index(b"IDAT")
    for kind, body, ok in chunks[:idat]:
        if kind in (b"IHDR", b"PLTE") and not ok:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC (libpng)")
    header = next(b for k, b, _ in chunks if k == b"IHDR")
    default = b"".join(b for k, b, _ in chunks[idat:][: next((i for i, (k, _, _) in enumerate(chunks[idat:])
                                                              if k != b"IDAT"), len(chunks) - idat)])
    first = kinds.index(b"fcTL") if b"fcTL" in kinds else None
    canvas = struct.unpack(">II", header[:8])
    if first is None or first < idat:
        raw, at, size = _inflate_frame(default, name), None, canvas
    else:
        w, h, x, y = struct.unpack(">4I", chunks[first][1][4:20])
        parts = []
        for k, b, _ in chunks[first + 1 :]:
            if k == b"fcTL":
                break
            if k == b"fdAT":
                parts.append(b[4:])
        raw, at, size = _inflate_frame(b"".join(parts), name), (x, y), (w, h)
    png = SIGNATURE + _chunk(b"IHDR", struct.pack(">II", *size) + header[8:13])
    png += b"".join(_chunk(k, b) for k, b, _ in chunks[:idat] if k in (b"PLTE", b"tRNS"))
    return png + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""), at, canvas


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
    png, at, canvas = data, None, None
    if b"acTL" in [k for k, _ in _chunks(data)]:
        try:
            png, at, canvas = _first_frame(data, name)
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
