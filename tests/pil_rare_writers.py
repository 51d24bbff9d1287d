"""Writers of the files of PIL's rarer plugins that PIL cannot write (or
writes in one layout only), for tests/pil_rare_cases.py: DCX pages, FTEX,
XV thumbnails, PIXAR, McIdas areas, SPIDER stacks, IM headers and IM Tools,
GIMP brushes, FITS (plain and GZIP_1 tables), Sun rasters (raw and RLE),
Windows Paint v2, X bitmaps and pixmaps, BLP1 / BLP2 in every encoding,
icns directories (PNG, JPEG 2000, RLE RGB and masks), FLI / FLC frames in
every chunk, IPTC / NAA and PhotoCD.  Each takes numpy arrays and returns
the file's bytes; the encoders are written from the formats' descriptions
(and PIL's readers), not taken from a library.  No PIL, no JAX.
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

# ------------------------------------------------------------------ DCX


def dcx(pages: list) -> bytes:
    """A DCX container of the given PCX files."""
    head = 4 + 4 * (len(pages) + 1)
    offsets, pos = [], head
    for p in pages:
        offsets.append(pos)
        pos += len(p)
    return struct.pack("<I", 0x3ADE68B1) + b"".join(struct.pack("<I", o) for o in offsets + [0]) + b"".join(pages)


# ------------------------------------------------------------------ FTEX


def ftex(w: int, h: int, kind: int, body: bytes, formats: int = 1) -> bytes:
    """An FTEX file of one mipmap: kind 0 DXT1 blocks, 1 raw RGB."""
    return b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, formats, kind, 32) + struct.pack("<i", len(body)) + body


# ------------------------------------------------------------- XV thumb


def xvthumb(px: np.ndarray, comments=(b"#XVVERSION:Version 2.28",), end: bytes = b"#END_OF_COMMENTS\n") -> bytes:
    h, w = px.shape
    head = b"P7 332\n" + b"".join(c + b"\n" for c in comments) + end + b"%d %d 255\n" % (w, h)
    return head + px.astype(np.uint8).tobytes()


# ---------------------------------------------------------------- PIXAR


def pixar(rgb: np.ndarray, channels: int = 14, depth: int = 2) -> bytes:
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<4H", head, 416, h, w, 0, 0)
    struct.pack_into("<2H", head, 424, channels, depth)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


# --------------------------------------------------------------- McIdas


def mcidas(samples: np.ndarray, nbytes: int, prefix: int = 0, offset: int = 256) -> bytes:
    """An area file: (h, w) samples of 1, 2 or 4 big-endian bytes, each
    line after `prefix` bytes, the data at `offset`."""
    h, w = samples.shape
    words = [0] * 65
    words[2] = 4
    words[9], words[10], words[11], words[14], words[15], words[34] = h, w, nbytes, 1, prefix, offset
    head = struct.pack(">64i", *words[1:])
    dtype = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    lines = samples.astype(dtype).view(np.uint8).reshape(h, w * nbytes)
    body = np.concatenate([np.full((h, prefix), 0x5A, np.uint8), lines], axis=1).tobytes()
    return head + bytes(max(0, offset - 256)) + body


# --------------------------------------------------------------- SPIDER


def spider(img: np.ndarray, big: bool = True, stack: int = 0) -> bytes:
    """A SPIDER 2D image (float32), or a stack of `stack` copies."""
    h, w = img.shape
    order = ">" if big else "<"
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt

    def header(istack: int, imgnum: int, maxim: int) -> bytes:
        v = [0.0] * 27
        v[0], v[1], v[4], v[11], v[12], v[21], v[22] = h, h, 1, w, labrec, labbyt, lenbyt
        v[23], v[25], v[26] = istack, maxim, imgnum
        return struct.pack(order + "27f", *v).ljust(labbyt, b"\0")

    data = img.astype(order + "f4").tobytes()
    if not stack:
        return header(0, 0, 0) + data
    return header(2, 0, stack) + b"".join(header(0, k + 1, 0) + data for k in range(stack))


# ------------------------------------------------------------ IM / IMT


def im(header: dict, body: bytes, lut: bytes | None = None, eol: bytes = b"\r\n", end: bytes = b"\x1a") -> bytes:
    lines = b"".join(f"{k}: {v}".encode("latin-1") + eol for k, v in header.items())
    if lut is not None:
        lines += b"Lut: RGB" + eol
    return lines + end + (lut or b"") + body


def imt(px: np.ndarray, extra: bytes = b"") -> bytes:
    h, w = px.shape
    return b"width %d\nheight %d\n%spixel n8\n\x0c" % (w, h, extra) + px.astype(np.uint8).tobytes()


# ------------------------------------------------------------------ GBR


def gbr(px: np.ndarray, version: int = 2, comment: bytes = b"brush\0") -> bytes:
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    size = (20 if version == 1 else 28) + len(comment)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 25)
    return head + comment + px.astype(np.uint8).tobytes()


# ----------------------------------------------------------------- FITS


def _cards(cards: list) -> bytes:
    out = b"".join(c.encode().ljust(80)[:80] for c in cards + ["END"])
    return out.ljust(-(-len(out) // 2880) * 2880, b" ")


def fits(img: np.ndarray, bitpix: int, extra: list = (), pad: bool = True, little: bool = False) -> bytes:
    """A FITS primary image: (h, w) samples stored big-endian as BITPIX
    says (little-endian with `little`, as PIL reads them), the first row of
    the file the bottom one."""
    h, w = img.shape
    cards = ["SIMPLE  =                    T", f"BITPIX  = {bitpix:20d}", "NAXIS   =                    2",
             f"NAXIS1  = {w:20d}", f"NAXIS2  = {h:20d}", *extra]
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix].replace(">", "<" if little else ">")
    body = img[::-1].astype(dtype).tobytes()
    if pad:
        body = body.ljust(-(-len(body) // 2880) * 2880, b"\0")
    return _cards(cards) + body


def fits_gzip(img: np.ndarray, zbitpix: int) -> bytes:
    """A GZIP_1 tile-compressed image in a binary table after an empty
    primary unit: the gzip member holds 32-bit big-endian words, the
    first row of the image first."""
    h, w = img.shape
    primary = _cards(["SIMPLE  =                    T", "BITPIX  =                    8",
                      "NAXIS   =                    0", "EXTEND  =                    T"])
    payload = gzip.compress(img.astype(">i4").tobytes(), mtime=0)
    table = _cards(["XTENSION= 'BINTABLE'", "BITPIX  =                    8", "NAXIS   =                    2",
                    "NAXIS1  =                    8", "NAXIS2  =                    1", "ZIMAGE  =                    T",
                    "ZCMPTYPE= 'GZIP_1  '", f"ZBITPIX = {zbitpix:20d}", "ZNAXIS  =                    2",
                    f"ZNAXIS1 = {w:20d}", f"ZNAXIS2 = {h:20d}"])
    body = struct.pack(">2i", len(payload), 0) + payload
    return primary + table + body.ljust(-(-len(body) // 2880) * 2880, b"\0")


# ------------------------------------------------------------------ SUN


def sun_rle_encode(raw: bytes, rng=None) -> bytes:
    """Sun RLE: runs of 3 or more as 0x80 n-1 v, a lone 0x80 as 0x80 0;
    runs cross scanlines as the stream does."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j < n and raw[j] == raw[i] and j - i < 256:
            j += 1
        run = j - i
        if run >= 3 or raw[i] == 0x80:
            if raw[i] == 0x80 and run < 3:
                out += b"\x80\x00" * run
            else:
                out += bytes((0x80, run - 1, raw[i]))
            i = j
        else:
            out.append(raw[i])
            i += 1
    return bytes(out)


def sun(lines: np.ndarray, w: int, depth: int, ftype: int = 1, cmap: bytes = b"", rle_stream: bytes | None = None,
        ptype: int | None = None) -> bytes:
    """A Sun raster of (h, row_bytes) scanline bytes (padded to 16 bits for
    the raw types), or an RLE stream for type 2."""
    h = lines.shape[0]
    body = rle_stream if rle_stream is not None else lines.astype(np.uint8).tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype, (1 if cmap else 0) if ptype is None else ptype,
                       len(cmap))
    return head + cmap + body


# ------------------------------------------------------------------ MSP


def msp_header(magic: bytes, w: int, h: int) -> bytearray:
    head = bytearray(32)
    head[:4] = magic
    struct.pack_into("<2H", head, 4, w, h)
    words = np.frombuffer(bytes(head), "<u2").copy()
    struct.pack_into("<H", head, 24, int(np.bitwise_xor.reduce(words)))
    return head


def msp_v2(rows: list, w: int) -> bytes:
    """A Windows Paint v2 file of encoded rows (bytes each; b"" for an
    empty row)."""
    head = msp_header(b"LinS", w, len(rows))
    return bytes(head) + b"".join(struct.pack("<H", len(r)) for r in rows) + b"".join(rows)


def msp_encode_row(row: bytes, rng) -> bytes:
    """Runs (0 count value) and literal packets over a row, at random."""
    out, i = bytearray(), 0
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 255:
            j += 1
        if j - i >= 3 or rng.random() < 0.2:
            out += bytes((0, j - i, row[i]))
            i = j
        else:
            k = min(len(row) - i, int(rng.integers(1, 9)))
            out += bytes((k,)) + row[i : i + k]
            i += k
    return bytes(out)


# ------------------------------------------------------------ XBM / XPM


def xbm(bits: np.ndarray, name: str = "img", hot=None, per_line: int = 12, upper: bool = False) -> bytes:
    """An X bitmap of (h, w) 0 / 1 pixels, least significant bit first."""
    h, w = bits.shape
    packed = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    vals = [("0x%02X" if upper else "0x%02x") % v for v in packed.ravel()]
    head = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hot:
        head += f"#define {name}_x_hot {hot[0]}\n#define {name}_y_hot {hot[1]}\n"
    body = ",\n".join(", ".join(vals[i : i + per_line]) for i in range(0, len(vals), per_line))
    return (head + f"static char {name}_bits[] = {{\n{body}}};\n").encode()


def xpm(idx: np.ndarray, colours: list, cpp: int = 1, none_key: bool = False, header: bool = True) -> bytes:
    """An X pixmap of (h, w) indices into `colours` ("#rrggbb" strings, or
    "None"), keys of `cpp` characters."""
    chars = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    keys = ["".join(chars[(k // len(chars) ** p) % len(chars)] for p in range(cpp)) for k in range(len(colours))]
    h, w = idx.shape
    lines = ["/* XPM */", "static char *img[] = {", "/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {len(colours)} {cpp} ",']
    lines += [f'"{k} c {c}",' for k, c in zip(keys, colours)]
    if header:
        lines.append("/* pixels */")
    lines += ['"' + "".join(keys[v] for v in row) + '",' for row in idx]
    lines.append("};")
    return ("\n".join(lines) + "\n").encode()


# ------------------------------------------------------------------ BLP


def blp2(w: int, h: int, encoding: int, alpha: int, alpha_encoding: int, body: bytes, palette: bytes = bytes(1024),
         compression: int = 1) -> bytes:
    head = b"BLP2" + struct.pack("<i3bB2I", compression, encoding, alpha, alpha_encoding, 0, w, h)
    offset = len(head) + 128 + len(palette)
    return head + struct.pack("<16I", offset, *[0] * 15) + struct.pack("<16I", len(body), *[0] * 15) + palette + body


def blp1_palette(w: int, h: int, idx: bytes, palette: bytes, alpha: int = 0, encoding: int = 4) -> bytes:
    head = b"BLP1" + struct.pack("<iI2Iii", 1, alpha, w, h, encoding, 0)
    offset = len(head) + 128 + len(palette)
    return head + struct.pack("<16I", offset, *[0] * 15) + struct.pack("<16I", len(idx), *[0] * 15) + palette + idx


def blp1_jpeg(w: int, h: int, jpeg: bytes, split: int, gap: int = 0, alpha: int = 0) -> bytes:
    """A BLP1 JPEG: the shared header (the JPEG's first `split` bytes), then
    `gap` bytes, then the rest at offsets[0]."""
    head = b"BLP1" + struct.pack("<iI2Iii", 0, alpha, w, h, 5, 0)
    start = len(head) + 128 + 4 + split + gap
    rest = jpeg[split:]
    return head + struct.pack("<16I", start, *[0] * 15) + struct.pack("<16I", len(rest), *[0] * 15) + \
        struct.pack("<I", split) + jpeg[:split] + bytes(gap) + rest


# ----------------------------------------------------------------- ICNS


def icns(entries: list, total: int | None = None) -> bytes:
    """An icns file of (type, data) entries."""
    body = b"".join(t + struct.pack(">I", len(d) + 8) + d for t, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body) if total is None else total) + body


def icns_rle(rgb: np.ndarray, rng) -> bytes:
    """PIL's read_32 packbits-like RLE, channel after channel: 0x80 | (n -
    3) v is a run of n (3-130), n - 1 (0-127) then n literal bytes."""
    out = bytearray()
    for c in range(3):
        plane = rgb[..., c].ravel().tobytes()
        i = 0
        while i < len(plane):
            j = i
            while j < len(plane) and plane[j] == plane[i] and j - i < 130:
                j += 1
            if j - i >= 3:
                out += bytes((0x80 + j - i - 3, plane[i]))
                i = j
            else:
                k = min(len(plane) - i, int(rng.integers(1, 129)))
                out += bytes((k - 1,)) + plane[i : i + k]
                i += k
    return bytes(out)


# ------------------------------------------------------------------ FLI


def _chunk(kind: int, body: bytes) -> bytes:
    size = 6 + len(body)
    return struct.pack("<IH", size + (size % 2), kind) + body + bytes(size % 2)


def fli_colour(entries: list, kind: int = 11) -> bytes:
    """A colour chunk of (skip, [(r, g, b), ...]) packets."""
    body = struct.pack("<H", len(entries))
    for skip, cols in entries:
        body += bytes((skip, len(cols) & 255)) + b"".join(bytes(c) for c in cols)
    return _chunk(kind, body)


def fli_brun(px: np.ndarray, rng) -> bytes:
    body = bytearray()
    for row in px:
        body.append(0)
        x, w = 0, len(row)
        while x < w:
            j = x
            while j < w and row[j] == row[x] and j - x < 127:
                j += 1
            if j - x >= 2 and rng.random() < 0.7:
                body += bytes((j - x, row[x]))
                x = j
            else:
                k = min(w - x, int(rng.integers(1, 20)), 128)
                body += bytes((256 - k,)) + row[x : x + k].tobytes()
                x += k
    return _chunk(15, bytes(body))


def fli_lc(lines: dict, first: int, count: int) -> bytes:
    """A byte-delta chunk: lines[y] = [(skip, bytes or (count, value)), ...]."""
    body = bytearray(struct.pack("<2H", first, count))
    for y in range(first, first + count):
        packets = lines.get(y, [])
        body.append(len(packets))
        for skip, what in packets:
            if isinstance(what, tuple):
                body += bytes((skip, 256 - what[0], what[1]))
            else:
                body += bytes((skip, len(what))) + what
    return _chunk(12, bytes(body))


def fli_ss2(lines: list) -> bytes:
    """A word-delta chunk: lines = [(flags, [(skip, words or (count, (a, b))), ...]), ...]."""
    body = bytearray(struct.pack("<H", len(lines)))
    for flags, packets in lines:
        for f in flags:
            body += struct.pack("<H", f & 0xFFFF)
        body += struct.pack("<H", len(packets))
        for skip, what in packets:
            if isinstance(what, tuple):
                body += bytes((skip, 256 - what[0])) + bytes(what[1])
            else:
                body += bytes((skip, len(what) // 2)) + what
    return _chunk(7, bytes(body))


def fli_copy(px: np.ndarray) -> bytes:
    return _chunk(16, px.astype(np.uint8).tobytes())


def fli_black() -> bytes:
    return _chunk(13, b"")


def fli(w: int, h: int, frames: list, magic: int = 0xAF12, prefix: bytes = b"") -> bytes:
    """An FLI (0xaf11) / FLC (0xaf12) file of frames, each a list of chunks."""
    head = bytearray(128)
    body = prefix
    for chunks in frames:
        payload = b"".join(chunks)
        body += struct.pack("<IHH8x", 16 + len(payload), 0xF1FA, len(chunks)) + payload
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(body), magic, len(frames), w, h, 8, 0, 5)
    return bytes(head) + body


# ----------------------------------------------------------------- IPTC


def iptc_field(record: int, tag: int, data: bytes, long: str = "") -> bytes:
    """A dataset: a 16-bit size, or with `long` an extended one: "iim" as
    the IIM standard writes it (0x8004, then four bytes), "pil" as PIL
    reads it (a size byte of 0x84, one byte PIL skips, then four)."""
    if long == "iim":
        return bytes((0x1C, record, tag)) + struct.pack(">H", 0x8004) + struct.pack(">I", len(data)) + data
    if long == "pil":
        return bytes((0x1C, record, tag, 0x84, 0)) + struct.pack(">I", len(data)) + data
    return bytes((0x1C, record, tag)) + struct.pack(">H", len(data)) + data


def iptc(w: int, h: int, chunks: list, layers: int = 1, component: int = 0, band: int | None = None,
         compression: int = 1, long: str = "") -> bytes:
    out = iptc_field(2, 0, b"\0\2") + iptc_field(3, 60, bytes((layers, component)))
    if band is not None:
        out += iptc_field(3, 65, bytes((band,)))
    out += iptc_field(3, 20, struct.pack(">I", w)) + iptc_field(3, 30, struct.pack(">H", h))
    out += iptc_field(3, 120, bytes((compression,)))
    return out + b"".join(iptc_field(8, 10, c, long) for c in chunks) + bytes(5)


# ------------------------------------------------------------------ PCD


def pcd(ycc: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD file whose base image (512, 768, 3) PhotoYCC samples lie at
    sector 96 as PIL's decoder reads them (a half-width chroma row per two
    luma rows: the even pixels' chroma of the pair's first row)."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_IPI"[:4]
    head[2048 + 1538] = orientation
    y = ycc[..., 0].reshape(256, 2, 768)
    c1 = ycc[0::2, 0::2, 1]
    c2 = ycc[0::2, 0::2, 2]
    body = np.concatenate([y[:, 0], y[:, 1], c1, c2], axis=1).astype(np.uint8).tobytes()
    return bytes(head) + body


# ------------------------------------------------- generated, not committed


def pcd_case(orientation: int) -> bytes:
    """The PhotoCD case "pcd-orientationN" of tests/pil_rare_cases.py: random
    PhotoYCC samples from a seed of its name."""
    rng = np.random.default_rng(zlib.crc32(f"pcd-orientation{orientation}".encode()))
    return pcd(rng.integers(0, 256, (512, 768, 3), np.uint8), orientation)


def bc1_blocks(rng, n: int) -> bytes:
    """Random DXT1 blocks, half with colour0 <= colour1 (the 3-colour mode)."""
    b = rng.integers(0, 256, (n, 8), np.uint8)
    swap = rng.random(n) < 0.5
    c = b[:, :4].copy().view("<u2")
    lo, hi = np.minimum(c[:, 0], c[:, 1]), np.maximum(c[:, 0], c[:, 1])
    c[:, 0] = np.where(swap, lo, hi)
    c[:, 1] = np.where(swap, hi, lo)
    b[:, :4] = c.view(np.uint8)
    return b.tobytes()


TIMING = ("timing-sun-rle-2048.ras", "timing-msp-v2-2048.msp", "timing-fli-brun-2048.flc", "timing-xbm-2048.xbm",
          "timing-blp2-dxt5-2048.blp")
SKY = "sky-4096x2048.fits"
PCD = tuple(f"pcd-orientation{o}.pcd" for o in (0, 1, 3))


def generated_names() -> tuple:
    return TIMING + (SKY,) + PCD


def generated() -> dict:
    """The files the fixtures' manifest holds but the repository does not:
    the 2048x2048 textures chip_smoke.py phase 17b times (a Sun raster RLE,
    an MSP v2, an FLC of one BRUN frame, an XBM and a BLP2 DXT5), the
    4096x2048 float FITS sky of 17b / 17c (its floats little-endian, as
    PIL's plugin reads BITPIX -32) and the three PhotoCD cases; all from
    seeds (name -> bytes)."""
    rng = np.random.default_rng(23)
    n = 2048
    y, x = np.mgrid[0:n, 0:n]
    px = ((x // 8 + y // 8) % 7 * 30 + (rng.random((n, n)) < 0.05) * rng.integers(0, 30, (n, n))).astype(np.uint8)
    out = {TIMING[0]: sun(px, n, 8, 2, rle_stream=sun_rle_encode(px.tobytes()))}
    bits = np.packbits(px > 100, axis=1)
    out[TIMING[1]] = msp_v2([msp_encode_row(r.tobytes(), rng) for r in bits], n)
    pal = [(0, [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(256)])]
    out[TIMING[2]] = fli(n, n, [[fli_colour(pal), fli_brun(px, rng)]])
    out[TIMING[3]] = xbm((px > 100).astype(np.uint8))
    nb = (n // 4) ** 2
    blocks = np.concatenate([rng.integers(0, 256, (nb, 8), np.uint8),
                             np.frombuffer(bc1_blocks(rng, nb), np.uint8).reshape(nb, 8)], axis=1)
    out[TIMING[4]] = blp2(n, n, 2, 8, 7, blocks.tobytes())
    yy, xx = np.mgrid[0:2048, 0:4096].astype(np.float32)
    sky = (0.2 + 0.8 * np.exp(-((xx - 2900.0) ** 2 + (yy - 700.0) ** 2) / 2e4) * 40.0 +
           0.3 * np.cos(yy / 2048.0 * np.pi) ** 2).astype(np.float32)
    out[SKY] = fits(sky, -32, little=True)
    for o, name in zip((0, 1, 3), PCD):
        out[name] = pcd_case(o)
    return out
