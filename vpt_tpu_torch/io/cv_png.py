"""PNG files as OpenCV 5.0's PngDecoder (grfmt_png.cpp, over libpng
1.6) reads them with `IMREAD_COLOR`.

The samples are the port's own PNG decode (io/image._decode_png) put
through the transforms OpenCV asks libpng for: `png_set_strip_16` (the
high byte of a 16-bit sample), `png_set_strip_alpha` (alpha and tRNS
dropped, nothing composited), `png_set_palette_to_rgb` (an index past the
palette black), `png_set_expand_gray_1_2_4_to_8` (1, 2 and 4-bit gray
scaled by 255, 85, 17) and `png_set_gray_to_rgb`.  An APNG reads as its
first frame (`_first_frame`): the default image where an fcTL comes before
IDAT, else the first frame's fdAT rows over the default image, as stored
(not blended), on a black canvas; OpenCV's own chunk reader feeds each
frame to libpng's progressive reader chunk by chunk, with the CRCs
unchecked, and a frame's rows stop at its first inflate error
(`_frame_rows`).  The EXIF orientation comes from an
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


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _frame_rows(parts: list, header: bytes, size: tuple, name: str) -> tuple:
    """A frame's zlib data as libpng's progressive reader takes it under
    OpenCV's APNG reader, fed one chunk at a time: (the raw rows it hands
    on, filter byte first, whether every row came).  Each row is one
    inflate call into a row-sized buffer; a call that fails (a deflate
    error, a bad zlib header, a wrong Adler-32 found in the call that
    fills the last row) is libpng's benign "ADLER32 checksum mismatch",
    so the row it was filling and every later row are never handed on.
    A row with a filter byte above 4 is libpng's error, and the read
    fails."""
    depth, ctype, interlace = header[8], header[9], header[12]
    rowbytes = (size[0] * _CHANNELS.get(ctype, 1) * depth + 7) // 8 + 1
    inflater, rows, row = zlib.decompressobj(), [], b""
    for part in parts:
        while part and not inflater.eof and len(rows) < size[1]:
            try:
                out = inflater.decompress(part, rowbytes - len(row))
            except zlib.error:
                return rows, False
            part, row = inflater.unconsumed_tail, row + out
            if len(row) == rowbytes:
                if row[0] > 4 and not interlace:
                    raise ValueError(f"{name}: APNG frame row with a bad filter byte (libpng: bad adaptive "
                                     "filter value)")
                rows.append(row)
                row = b""
            elif not out:
                break
    return rows, len(rows) == size[1]


def _frame_png(header: bytes, size: tuple, rows: list, plte: bytes) -> bytes:
    """A frame's rows as a PNG of their own; rows that never came are
    filter-0 zeros (the caller puts what lies beneath in their place)."""
    rowbytes = (size[0] * _CHANNELS.get(header[9], 1) * header[8] + 7) // 8 + 1
    raw = b"".join(rows) + bytes(rowbytes * (size[1] - len(rows)))
    png = SIGNATURE + _chunk(b"IHDR", struct.pack(">II", *size) + header[8:13]) + plte
    return png + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _fctl(body: bytes, canvas: tuple, name: str) -> tuple:
    """An fcTL's (width, height, x, y), refused as OpenCV refuses it:
    the frame past the canvas, a dispose op above 2 or a blend op above
    1."""
    w, h, x, y = struct.unpack(">4I", body[4:20])
    if x + w > canvas[0] or y + h > canvas[1] or body[24] > 2 or body[25] > 1:
        raise ValueError(f"{name}: APNG fcTL frame outside the canvas or with a bad dispose / blend op (OpenCV)")
    return w, h, x, y


def _first_frame(data: bytes, name: str) -> np.ndarray:
    """An APNG's first frame as OpenCV's APNG reader gives it, RGB on the
    canvas.  The default image is frame 0 where an fcTL comes before
    IDAT; else it is decoded all the same, into the buffer the first
    fcTL's fdAT rows then overwrite (row j of a w-wide frame at pixel
    j * w of that buffer), and the frame is drawn as stored (not blended)
    on a black canvas.  The chunks' CRCs go unchecked but IHDR's and
    PLTE's (libpng reads them first); the first fcTL and the one after
    frame 0's data are checked (`_fctl`), and a chunk up to that one cut
    short by the end of the file fails the read; nothing after it is read.
    Rows that never came (`_frame_rows`) show the default image beneath,
    and where nothing was decoded beneath them OpenCV returns memory it
    never writes, which no reader can reproduce: refused by name."""
    chunks, pos, complete = [], 8, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        chunks.append((kind, data[pos + 8 : pos + 8 + length], _crc_ok(data, pos, length)))
        complete.append(pos + 12 + length <= len(data))
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
    canvas = struct.unpack(">II", header[:8])
    plte = b"".join(_chunk(k, b) for k, b, _ in chunks[:idat] if k in (b"PLTE", b"tRNS"))
    ends = next((i for i, (k, _, _) in enumerate(chunks[idat:]) if k != b"IDAT"), len(chunks) - idat)
    default = [b for _, b, _ in chunks[idat : idat + ends]]
    first = kinds.index(b"fcTL") if b"fcTL" in kinds else None
    fctl0 = _fctl(chunks[first][1], canvas, name) if first is not None else None
    rows, whole = _frame_rows(default, header, canvas, name)
    beneath = _rgb(_frame_png(header, canvas, rows, plte), name).reshape(-1, 3)
    written = np.zeros(canvas[0] * canvas[1], bool)
    written[: len(rows) * canvas[0]] = True
    if header[12] and not whole:
        written[:] = False
    if first is None or first < idat:
        frame, at, size, nxt = beneath, (0, 0), canvas, idat + ends
    else:
        w, h, x, y = fctl0
        parts, nxt = [], len(chunks)
        for i, (k, b, _) in enumerate(chunks[first + 1 :], first + 1):
            if k == b"fcTL":
                nxt = i
                break
            if k == b"fdAT":
                parts.append(b[4:])
        rows, whole = _frame_rows(parts, header, (w, h), name)
        frame = beneath.copy()
        if rows and not (header[12] and not whole):
            frame[: len(rows) * w] = _rgb(_frame_png(header, (w, h), rows, plte), name).reshape(-1, 3)[: len(rows) * w]
            written[: len(rows) * w] = True
        at, size = (x, y), (w, h)
    if not all(complete[: nxt + 1]):
        raise ValueError(f"{name}: APNG chunk cut short by the end of the file (OpenCV's chunk reader)")
    if nxt < len(chunks) and chunks[nxt][0] == b"fcTL":
        _fctl(chunks[nxt][1], canvas, name)
    if not written[: size[0] * size[1]].all():
        raise ValueError(f"{name}: APNG frame 0 stops early with nothing decoded beneath it: OpenCV returns "
                         "memory it never writes (unwritten rows; ROADMAP \"Known, kept\")")
    out = np.zeros((canvas[1], canvas[0], 3), np.uint8)
    out[at[1] : at[1] + size[1], at[0] : at[0] + size[0]] = frame[: size[0] * size[1]].reshape(size[1], size[0], 3)
    return out


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
    if b"acTL" in [k for k, _ in _chunks(data)]:
        try:
            rgb = _first_frame(data, name)
        except (struct.error, StopIteration, IndexError):
            raise ValueError(f"{name}: APNG with a broken acTL / fcTL chunk") from None
    else:
        rgb = _rgb(data, name)
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
