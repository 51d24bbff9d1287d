"""Image files that no writer at hand makes, built to their specifications
with numpy, struct and zlib alone (no JAX, no PIL), for the decoder tests,
tests/make_torch_formats.py and chip_smoke.py:

- `encode_tiff`: classic TIFF or BigTIFF, II or MM, strips or tiles, planar
  configuration 1 or 2, compression none / LZW / Deflate / PackBits,
  predictor 1, 2 or 3, fill order 1 or 2, any sample type, extra samples,
  a colour map, an image description;
- `encode_gif`: GIF87a / 89a with a global or local colour table, a frame
  anywhere on (or past) its logical screen, interlaced rows, a
  transparency index, any LZW minimum code size;
- `encode_bmp`: CORE, INFO, V4 and V5 headers, bottom-up or top-down,
  1 / 4 / 8-bit palettes, 16-bit 5-5-5 and 5-6-5, 24- and 32-bit, bit
  fields, RLE8 and RLE4 (encoded runs, absolute runs, deltas);
- `encode_jpeg`: a baseline Huffman JPEG of any number of components at any
  sampling factors, with an optional Adobe APP14 transform (CMYK, YCCK).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_REVERSE_BITS = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


# ------------------------------------------------------------------- TIFF


class _MsbBits:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def write(self, code: int, width: int) -> None:
        self.acc = (self.acc << width) | code
        self.n += width
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def done(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
        return bytes(self.out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW: MSB-first codes of 9-12 bits, CLEAR first, EOI last, the
    width growing one code early (when the decoder's table reaches 511,
    1023 and 2047 entries), CLEAR again before the table fills."""
    bits = _MsbBits()
    table = {bytes([i]): i for i in range(256)}
    free, dec = 258, 258  # the encoder's next entry, the decoder's table length

    def width() -> int:
        return 12 if dec >= 2047 else 11 if dec >= 1023 else 10 if dec >= 511 else 9

    bits.write(256, 9)
    first, w = True, b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        bits.write(table[w], width())
        dec += 0 if first else 1
        first = False
        table[wc] = free
        free += 1
        w = bytes([byte])
        if free >= 4094:
            bits.write(256, width())
            table = {bytes([i]): i for i in range(256)}
            free, dec, first = 258, 258, True
    if w:
        bits.write(table[w], width())
        dec += 0 if first else 1
    bits.write(257, width())
    return bits.done()


def packbits(data: bytes) -> bytes:
    """PackBits: repeat runs of 2-128 bytes, literal runs of 1-128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(seg: np.ndarray, predictor: int, order: str) -> bytes:
    """A segment's (rows, width, samples) samples as the file's bytes after
    the predictor."""
    if predictor == 2:
        diff = seg.copy()
        diff[:, 1:] = seg[:, 1:] - seg[:, :-1]
        seg = diff
    if predictor == 3:
        rows, w, s = seg.shape
        size = seg.dtype.itemsize
        be = seg.astype(seg.dtype.newbyteorder(">")).view(np.uint8).reshape(rows, w * s, size)
        planes = np.ascontiguousarray(be.transpose(0, 2, 1)).reshape(rows, -1)  # byte planes, MSB first
        diff = planes.copy()
        diff[:, s:] = planes[:, s:] - planes[:, :-s]
        return diff.tobytes()
    return seg.astype(seg.dtype.newbyteorder(order)).tobytes()


def _pack_bits(seg: np.ndarray, bits: int) -> bytes:
    """Sub-byte samples packed high bits first, each row padded to a byte."""
    rows = seg.reshape(seg.shape[0], -1).astype(np.uint8)
    per = 8 // bits
    pad = (-rows.shape[1]) % per
    rows = np.concatenate([rows, np.zeros((rows.shape[0], pad), np.uint8)], axis=1).reshape(rows.shape[0], -1, per)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return (rows << shifts).sum(axis=2).astype(np.uint8).tobytes()


def encode_tiff(samples, *, order: str = "<", big: bool = False, compression: int = 1, predictor: int = 1,
                tile=None, rows_per_strip=None, planar: int = 1, photometric=None, bits=None, extra=(),
                colormap=None, fillorder: int = 1, description=None, sample_format=None) -> bytes:
    """A one-page TIFF of samples (h, w) or (h, w, spp).  bits: for 1-, 2-
    and 4-bit samples (uint8 values; bool arrays are 1-bit); tile: (length,
    width); photometric defaults to RGB for 3 or 4 samples, else min-is-black."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    if a.dtype == bool:
        a, bits = a.astype(np.uint8), 1
    bits = bits or a.dtype.itemsize * 8
    if sample_format is None:
        sample_format = {"u": 1, "b": 1, "i": 2, "f": 3}[a.dtype.kind]
    if photometric is None:
        photometric = 2 if spp >= 3 else 1
    planes = [a[..., i : i + 1] for i in range(spp)] if planar == 2 else [a]
    th, tw = tile if tile else (rows_per_strip or h, w)
    segments = []
    for plane in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw):
                seg = plane[y : y + th, x : x + tw]
                if tile:  # tiles are padded to their full size
                    full = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    full[: seg.shape[0], : seg.shape[1]] = seg
                    seg = full
                raw = _predict(seg, predictor, order) if bits >= 8 else _pack_bits(seg, bits)
                raw = {1: lambda d: d, 5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress,
                       32773: packbits}[compression](raw)
                if fillorder == 2:
                    raw = raw.translate(_REVERSE_BITS)
                segments.append(raw)
    off_code, off_size = (16, 8) if big else (4, 4)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar]), 339: (3, [sample_format] * spp)}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if fillorder != 1:
        tags[266] = (3, [fillorder])
    if extra:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).reshape(-1)])
    if description is not None:
        tags[270] = (2, description.encode() + b"\0")
    if tile:
        tags[322], tags[323] = (4, [tw]), (4, [th])
    else:
        tags[278] = (4, [th])
    head = 16 if big else 8
    offsets, pos = [], head
    for seg in segments:
        offsets.append(pos)
        pos += len(seg) + (len(seg) & 1)
    tags[324 if tile else 273] = (off_code, offsets)
    tags[325 if tile else 279] = (off_code, [len(s) for s in segments])
    body = b"".join(s + b"\0" * (len(s) & 1) for s in segments)
    ifd_at = head + len(body)
    entry, count_fmt = (20, "Q") if big else (12, "H")
    n = len(tags)
    extra_at = ifd_at + struct.calcsize(count_fmt) + n * entry + off_size
    entries, blobs = [], b""
    fmts = {2: "s", 3: "H", 4: "I", 16: "Q"}
    for code in sorted(tags):
        kind, values = tags[code]
        raw = values if kind == 2 else struct.pack(order + fmts[kind] * len(values), *values)
        count = len(values)
        if len(raw) <= off_size:
            field = raw + b"\0" * (off_size - len(raw))
        else:
            field = struct.pack(order + ("Q" if big else "I"), extra_at + len(blobs))
            blobs += raw + b"\0" * (len(raw) & 1)
        entries.append(struct.pack(order + "HH" + ("Q" if big else "I"), code, kind, count) + field)
    magic = (b"II" if order == "<" else b"MM") + struct.pack(order + "H", 43 if big else 42)
    header = magic + (struct.pack(order + "HHQ", 8, 0, ifd_at) if big else struct.pack(order + "I", ifd_at))
    ifd = struct.pack(order + count_fmt, n) + b"".join(entries) + b"\0" * off_size
    return header + body + ifd + blobs


# -------------------------------------------------------------------- GIF


def gif_lzw(indices: bytes, min_size: int) -> bytes:
    """GIF LZW: LSB-first codes from min_size + 1 bits up to 12, CLEAR first
    and again before the table fills, EOI last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    acc = n = 0
    out = bytearray()

    def put(code: int, width: int) -> None:
        nonlocal acc, n
        acc |= code << n
        n += width
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8

    def fresh():
        return {bytes([i]): i for i in range(clear)}, clear + 2, clear + 2, min_size + 1, True

    table, free, dec_next, dec_w, first = fresh()
    put(clear, dec_w)
    w = b""

    def emit(code: int) -> None:
        nonlocal dec_next, dec_w, first
        put(code, dec_w)
        if not first and dec_next < 4096:  # the decoder adds an entry for every code but the first
            if dec_next == (1 << dec_w) - 1 and dec_w < 12:
                dec_w += 1
            dec_next += 1
        first = False

    for byte in indices:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = free
        free += 1
        w = bytes([byte])
        if free >= 4095:
            put(clear, dec_w)
            table, free, dec_next, dec_w, first = fresh()
    if w:
        emit(table[w])
    put(end, dec_w)
    if n:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255] for i in range(0, len(data), 255)) + b"\0"


def encode_gif(indices, palette, *, screen=None, offset=(0, 0), local: bool = False, interlace: bool = False,
               transparency=None, min_size=None, version: bytes = b"GIF89a", lzw=None) -> bytes:
    """A one-frame GIF of (h, w) palette indices; palette (n, 3), n a power
    of 2 from 2 to 256 (in the global table, or the frame's local one);
    screen (width, height) defaults to the frame's; lzw: the frame's LZW
    data in place of its encoding (for broken streams)."""
    idx = np.asarray(indices, np.uint8)
    h, w = idx.shape
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    size_bits = max(int(np.ceil(np.log2(max(len(pal), 2)))), 1)
    table = pal.tobytes() + bytes(3 * ((1 << size_bits) - len(pal)))
    sw, sh = screen or (w + offset[0], h + offset[1])
    flags = 0x80 | (size_bits - 1) if not local else 0
    out = version + struct.pack("<HHBBB", sw, sh, flags, 0, 0) + (b"" if local else table)
    if transparency is not None:
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\0"
    rows = idx
    if interlace:
        order = list(range(0, h, 8)) + list(range(4, h, 8)) + list(range(2, h, 4)) + list(range(1, h, 2))
        rows = idx[order]
    dflags = (0x80 | (size_bits - 1) if local else 0) | (0x40 if interlace else 0)
    out += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], w, h, dflags) + (table if local else b"")
    m = min_size or max(size_bits, 2)
    out += bytes([m]) + _sub_blocks(lzw if lzw is not None else gif_lzw(rows.tobytes(), m)) + b"\x3b"
    return out


# -------------------------------------------------------------------- BMP


def bmp_rle(rows: np.ndarray, rle4: bool, delta_at=None) -> bytes:
    """RLE8 / RLE4 records of (h, w) indices, stored rows first (bottom-up
    order is the caller's): encoded runs of equal indices, absolute runs of
    3+ unequal ones (of even count for RLE4), an end of line after each row,
    end of bitmap last; delta_at (row, column): a delta record of (2, 1)
    put at that point of the stream."""
    out = bytearray()
    for y, row in enumerate(np.asarray(rows, np.uint8)):
        x, w = 0, len(row)
        while x < w:
            if delta_at == (y, x):
                out += b"\x00\x02\x02\x01"
            j = x
            while j + 1 < w and row[j + 1] == row[x] and j - x < 254:
                j += 1
            run = j - x + 1
            if run >= 2 or w - x < 4:
                n = max(run, 1)
                v = row[x]
                out += bytes([n, (v << 4 | v) if rle4 else v])
                x += n
                continue
            j = x
            while j < w and j - x < 254 and not (j + 1 < w and row[j + 1] == row[j]):
                j += 1
            n = j - x
            if rle4:
                n -= n % 2
            if n < 3:
                out += bytes([1, (row[x] << 4 | row[x]) if rle4 else row[x]])
                x += 1
                continue
            vals = row[x : x + n]
            data = bytes((vals[0::2] << 4) | vals[1::2]) if rle4 else vals.tobytes()
            out += bytes([0, n]) + data + (b"\0" if len(data) % 2 else b"")
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def encode_bmp(pixels, *, bits: int = 24, header: int = 40, top_down: bool = False, palette=None,
               compression: int = 0, masks=None, rle_delta_at=None) -> bytes:
    """A BMP of (h, w) indices (bits 1, 4, 8, with palette (n, 3) RGB) or
    (h, w, 3 | 4) uint8 RGB(A) (bits 16, 24, 32).  compression 1 / 2: RLE8 /
    RLE4 of the indices; 3: bit fields `masks` (r, g, b[, a])."""
    px = np.asarray(pixels)
    h, w = px.shape[:2]
    rows = px[::-1] if not top_down else px
    if compression in (1, 2):
        data = bmp_rle(rows, compression == 2, rle_delta_at)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits <= 8:
            per = 8 // bits
            r = rows.astype(np.uint8)
            pad = (-w) % per
            r = np.concatenate([r, np.zeros((h, pad), np.uint8)], axis=1).reshape(h, -1, per)
            packed = (r << np.arange(8 - bits, -1, -bits, dtype=np.uint8)).sum(axis=2).astype(np.uint8)
        elif bits == 16:
            rgb = rows.astype(np.uint16)
            if masks == (0xF800, 0x7E0, 0x1F):
                v = (rgb[..., 0] >> 3) << 11 | (rgb[..., 1] >> 2) << 5 | rgb[..., 2] >> 3
            else:
                v = (rgb[..., 0] >> 3) << 10 | (rgb[..., 1] >> 3) << 5 | rgb[..., 2] >> 3
            packed = v.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            c = 3 if bits == 24 else 4
            src = rows if rows.shape[2] >= c else np.concatenate([rows, np.full((h, w, 1), 255, np.uint8)], axis=2)
            if masks is None or bits == 24:
                order = [2, 1, 0, 3][:c]
                packed = src[..., order].reshape(h, -1)
            else:  # place each channel under its mask
                v = np.zeros((h, w), np.uint32)
                for ch, m in enumerate(masks):
                    if m:
                        v |= src[..., ch].astype(np.uint32) << (int(m).bit_length() - 8)
                packed = v.astype("<u4").view(np.uint8).reshape(h, -1)
        packed = packed.reshape(h, -1)
        data = np.concatenate([packed, np.zeros((h, stride - packed.shape[1]), np.uint8)], axis=1).tobytes()
    table = b""
    if bits <= 8:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        table = b"".join(bytes([b, g, r]) + (b"" if header == 12 else b"\0") for r, g, b in pal)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        colors = len(table) // 4 if bits <= 8 else 0
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, compression, len(data),
                           2835, 2835, colors, 0)
        if header >= 52 or compression == 3:
            m = list(masks or (0, 0, 0)) + [0] * 4
            mask_bytes = struct.pack("<IIII", *m[:4])
            info += mask_bytes[: 16 if header >= 56 else 12] if header >= 52 else b""
            if header == 40 and compression == 3:
                table = mask_bytes[:12] + table
        info += b"\0" * (header - len(info))
    offset = 14 + len(info) + len(table)
    return b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + table + data


# ------------------------------------------------------------------- JPEG

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63])
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) * np.cos((2 * x + 1) * u * np.pi / 16) / 2 for x in range(8)]
                 for u in range(8)])
# Huffman tables with every symbol a code of one length: DC symbols 0-11 in
# 4 bits, the 162 AC symbols in 8 (no code is all ones).
_DC_SYMS = list(range(12))
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]


def _dht(cls: int, ident: int, length: int, syms: list) -> bytes:
    counts = [0] * 16
    counts[length - 1] = len(syms)
    body = bytes([cls << 4 | ident]) + bytes(counts) + bytes(syms)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


def encode_jpeg(planes, factors, *, adobe=None, quality_step: int = 6, restart: int = 0) -> bytes:
    """A baseline JPEG whose components are `planes` (each (H, W) uint8 at
    full size; a component is point-sampled down to its sampling factors),
    factors [(h, v), ...]; adobe: an Adobe APP14 transform (0, 1 or 2) or
    None for no marker (one or three components get a JFIF marker instead).
    Every component uses one quantisation table, steps quality_step + k // 6."""
    planes = [np.asarray(p, np.float64) for p in planes]
    H, W = planes[0].shape
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qt = np.array([quality_step + k // 6 for k in range(64)])  # in zigzag order
    qnat = np.zeros(64)
    qnat[_ZIGZAG] = qt
    coefs = []
    for p, (h, v) in zip(planes, factors):
        dh, dw = -(-H * v // vmax), -(-W * h // hmax)
        small = p[(np.arange(dh) * H) // dh][:, (np.arange(dw) * W) // dw]
        bh, bw = (mcuy * v, mcux * h) if len(planes) > 1 else (-(-dh // 8), -(-dw // 8))
        full = np.pad(small, ((0, bh * 8 - dh), (0, bw * 8 - dw)), mode="edge") - 128.0
        blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT).reshape(bh, bw, 64)
        coefs.append(np.round(f / qnat).astype(np.int64)[..., _ZIGZAG])
    bits = _MsbBits()
    out = bytearray()
    dc_code = {s: i for i, s in enumerate(_DC_SYMS)}
    ac_code = {s: i for i, s in enumerate(_AC_SYMS)}

    def magnitude(v: int) -> tuple:
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    def block(zz, pred: int) -> int:
        s, m = magnitude(int(zz[0]) - pred)
        bits.write(dc_code[s], 4)
        if s:
            bits.write(m, s)
        run = 0
        for k in range(1, 64):
            v = int(zz[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.write(ac_code[0xF0], 8)
                run -= 16
            s, m = magnitude(v)
            bits.write(ac_code[(run << 4) | s], 8)
            bits.write(m, s)
            run = 0
        if run:
            bits.write(ac_code[0x00], 8)
        return int(zz[0])

    preds = [0] * len(planes)
    units = []  # (component, block row, block column) in scan order, per restart interval
    if len(planes) == 1:
        units = [[(0, by, bx)] for by in range(coefs[0].shape[0]) for bx in range(coefs[0].shape[1])]
    else:
        for my in range(mcuy):
            for mx in range(mcux):
                units.append([(c, my * v + y, mx * h + x) for c, (h, v) in enumerate(factors) for y in range(v)
                              for x in range(h)])
    for i, unit in enumerate(units):
        if restart and i and i % restart == 0:
            if bits.n:
                bits.write((1 << (8 - bits.n)) - 1, 8 - bits.n)  # pad with ones
            scan = bits.done()
            out += scan.replace(b"\xff", b"\xff\x00") + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            bits.__init__()
            preds = [0] * len(planes)
        for c, by, bx in unit:
            preds[c] = block(coefs[c][by, bx], preds[c])
    if bits.n:
        bits.write((1 << (8 - bits.n)) - 1, 8 - bits.n)  # pad with ones
    out += bits.done().replace(b"\xff", b"\xff\x00")
    n = len(planes)
    head = b"\xff\xd8"
    if adobe is not None:
        head += b"\xff\xee" + struct.pack(">H", 14) + b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe)
    elif n in (1, 3):
        head += b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0])
    head += b"\xff\xdb" + struct.pack(">H", 67) + b"\x00" + bytes(int(q) for q in qt)
    sof = struct.pack(">BHHB", 8, H, W, n) + b"".join(bytes([i + 1, h << 4 | v, 0]) for i, (h, v) in enumerate(factors))
    head += b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
    head += _dht(0, 0, 4, _DC_SYMS) + _dht(1, 0, 8, _AC_SYMS)
    if restart:
        head += b"\xff\xdd" + struct.pack(">HH", 4, restart)
    sos = bytes([n]) + b"".join(bytes([i + 1, 0]) for i in range(n)) + b"\x00\x3f\x00"
    head += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
    return head + bytes(out) + b"\xff\xd9"
