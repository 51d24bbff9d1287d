"""Writers for the raster formats PIL opens without a codec library, in numpy
alone (no PIL, no JAX), for the files PIL does not write: TGA with RLE
packets over scanlines and colour maps, DDS of any pixel format (BC blocks
from random bytes, which reach every BC6H and BC7 mode), QOI with every op,
SGI RLE, PCX planes and palettes, CUR, PSD raw and PackBits, ASCII Netpbm.

tests/pil_format_cases.py builds its cases with them; `timing_textures`
makes the 2048x2048 BC7 DDS, RLE TGA and QOI textures that chip_smoke.py
phase 17b times and renders (17c) and tests/make_torch_pil_formats.py
records, from a seed, on a machine without PIL.
"""

from __future__ import annotations

import struct

import numpy as np

TIMING_SIZE = 2048


# -------------------------------------------------------------------- TGA


def tga(pixels: np.ndarray, image_type: int, depth: int, *, flags: int = 0x20, ident: bytes = b"",
        colour_map: bytes = b"", map_start: int = 0, map_depth: int = 0, packets=None) -> bytes:
    """A TGA file: pixels are the stored pixel bytes, (h, w, depth // 8)
    uint8 in file order (rows as `flags` orients them, BGR(A) order).  RLE
    types (9, 10, 11) take `packets`: a list of (kind, count) with kind
    "run" or "raw" over the pixels in stream order (default: `rle_packets`)."""
    h, w = pixels.shape[:2]
    size = max(depth // 8, 1)
    n_map = len(colour_map) // max(map_depth // 8, 1) if map_depth else 0
    header = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if map_depth else 0, image_type, map_start, n_map,
                         map_depth, 0, 0, w, h, depth, flags)
    flat = pixels.reshape(-1, size)
    if image_type & 8:
        body = bytearray()
        pos = 0
        for kind, count in (packets if packets is not None else rle_packets(pixels)):
            if kind == "run":
                body += bytes([0x80 | (count - 1)]) + flat[pos].tobytes()
            else:
                body += bytes([count - 1]) + flat[pos : pos + count].tobytes()
            pos += count
        data = bytes(body)
    else:
        data = pixels.tobytes()
    return header + ident + colour_map + data


def rle_packets(pixels: np.ndarray, cross: bool = False, rng=None) -> list:
    """TGA packets: runs of equal pixels within a scanline (at most 128),
    raw packets for the rest; with `cross`, raw packets of random length
    that run on over scanlines (PIL's decoder reads them)."""
    h, w = pixels.shape[:2]
    flat = pixels.reshape(h * w, -1)
    packets, pos = [], 0
    while pos < h * w:
        x = pos % w
        run = 1
        while x + run < w and run < 128 and (flat[pos + run] == flat[pos]).all():
            run += 1
        if run > 1:
            packets.append(("run", run))
            pos += run
            continue
        count = int(rng.integers(1, 129)) if cross else 1
        if not cross:
            while x + count < w and count < 128 and not (flat[pos + count] == flat[pos + count - 1]).all():
                count += 1
        count = min(count, h * w - pos)
        packets.append(("raw", count))
        pos += count
    return packets


def tga_rle_fast(pixels: np.ndarray, chunk: int = 16) -> bytes:
    """RLE type-10 data of (h, w, c) pixels (w a multiple of chunk): each
    chunk of a scanline one run packet when its pixels are equal, else one
    raw packet.  Vectorised, for the 2048x2048 timing texture."""
    h, w, c = pixels.shape
    blocks = pixels.reshape(h * w // chunk, chunk, c)
    same = (blocks == blocks[:, :1]).all(axis=(1, 2))
    run = np.concatenate([np.full((blocks.shape[0], 1), 0x80 | (chunk - 1), np.uint8), blocks[:, 0]], axis=1)
    raw = np.concatenate([np.full((blocks.shape[0], 1), chunk - 1, np.uint8), blocks.reshape(-1, chunk * c)], axis=1)
    lengths = np.where(same, 1 + c, 1 + chunk * c)
    out = np.empty(int(lengths.sum()), np.uint8)
    ends = np.cumsum(lengths)
    starts = ends - lengths
    for idx, src in ((np.nonzero(same)[0], run), (np.nonzero(~same)[0], raw)):
        if idx.size:
            cols = np.arange(src.shape[1])
            out[(starts[idx][:, None] + cols[None, :]).ravel()] = src[idx].ravel()
    return out.tobytes()


# -------------------------------------------------------------------- DDS

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8, DDPF_RGB, DDPF_LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000


def dds(width: int, height: int, data: bytes, *, fourcc: bytes = b"\0\0\0\0", dxgi: int | None = None,
        pfflags: int | None = None, bitcount: int = 0, masks=(0, 0, 0, 0), mipmaps: int = 1) -> bytes:
    """A DDS file: the legacy header, a DX10 one when dxgi is given, then data
    (the first surface, and whatever follows it: mip levels, slices)."""
    if pfflags is None:
        pfflags = DDPF_FOURCC
    if dxgi is not None:
        fourcc = b"DX10"
    pf = struct.pack("<II4sI4I", 32, pfflags, fourcc, bitcount, *masks)
    header = struct.pack("<7I", 124, 0x1007 | (0x20000 if mipmaps > 1 else 0), height, width, 0, 0, mipmaps)
    out = b"DDS " + header + b"\0" * 44 + pf + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        out += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return out + data


def bc_blocks(rng, width: int, height: int, kind: int) -> bytes:
    """Random blocks for a width x height BCn surface (kind 1-7); for BC6H
    and BC7 the mode bits are spread over every mode, reserved ones too."""
    n = ((width + 3) // 4) * ((height + 3) // 4)
    size = 8 if kind in (1, 4) else 16
    blocks = rng.integers(0, 256, (n, size), np.uint8)
    if kind == 7:
        mode = rng.integers(0, 9, n)
        blocks[:, 0] = np.where(mode == 8, 0, ((blocks[:, 0].astype(np.int64) << (mode + 1)) | (1 << mode)) & 0xFF)
    elif kind == 6:
        modes = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31], np.uint8)
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | modes[rng.integers(0, len(modes), n)]
    return blocks.tobytes()


# -------------------------------------------------------------------- QOI


def qoi(pixels: np.ndarray, channels: int | None = None, colorspace: int = 0, end: bool = True) -> bytes:
    """A QOI file of (h, w, 3 | 4) uint8 pixels with the reference encoder's
    ops (RUN, INDEX, DIFF, LUMA, RGB, RGBA), vectorised."""
    h, w, c = pixels.shape
    px = np.concatenate([pixels, np.full((h, w, 1), 255, np.uint8)], axis=-1) if c == 3 else pixels
    px = px.reshape(-1, 4).astype(np.int64)
    n = px.shape[0]
    prev = np.concatenate([[[0, 0, 0, 255]], px[:-1]], axis=0)
    same = (px == prev).all(axis=1)
    # runs: maximal stretches of `same`, cut into pieces of at most 62
    run_id = np.cumsum(~same)
    pos_in_run = np.zeros(n, np.int64)
    idx = np.nonzero(same)[0]
    if idx.size:
        starts = np.nonzero(same & ~np.concatenate([[False], same[:-1]]))[0]
        first = starts[np.searchsorted(starts, idx, side="right") - 1]
        pos_in_run[idx] = idx - first
    del run_id
    run_end = same & ((pos_in_run % 62 == 61) | ~np.concatenate([same[1:], [False]]))
    # the index: the last earlier stored (non-run) pixel with the same hash
    hashes = (px[:, 0] * 3 + px[:, 1] * 5 + px[:, 2] * 7 + px[:, 3] * 11) % 64
    stored = np.nonzero(~same)[0]
    order = stored[np.lexsort((stored, hashes[stored]))]
    before = np.full(n, -1, np.int64)
    same_hash = hashes[order[1:]] == hashes[order[:-1]]
    before[order[1:][same_hash]] = order[:-1][same_hash]
    ref = np.where(before[:, None] >= 0, px[np.maximum(before, 0)], 0)
    index_hit = ~same & (ref == px).all(axis=1)
    d = ((px - prev + 128) % 256) - 128
    alpha_same = px[:, 3] == prev[:, 3]
    diff = ~same & ~index_hit & alpha_same & (np.abs(d[:, :3] + 0.5) <= 2).all(axis=1)
    dr_dg, db_dg = d[:, 0] - d[:, 1], d[:, 2] - d[:, 1]
    luma = ~same & ~index_hit & ~diff & alpha_same & (d[:, 1] >= -32) & (d[:, 1] <= 31) & \
        (dr_dg >= -8) & (dr_dg <= 7) & (db_dg >= -8) & (db_dg <= 7)
    rgb = ~same & ~index_hit & ~diff & ~luma & alpha_same
    rgba = ~same & ~index_hit & ~diff & ~luma & ~alpha_same
    ops = np.zeros((n, 5), np.uint8)
    lengths = np.zeros(n, np.int64)
    ops[run_end, 0] = 0xC0 | (pos_in_run[run_end] % 62)
    lengths[run_end] = 1
    ops[index_hit, 0] = hashes[index_hit]
    lengths[index_hit] = 1
    ops[diff, 0] = 0x40 | ((d[diff, 0] + 2) << 4) | ((d[diff, 1] + 2) << 2) | (d[diff, 2] + 2)
    lengths[diff] = 1
    ops[luma, 0] = 0x80 | (d[luma, 1] + 32)
    ops[luma, 1] = ((dr_dg[luma] + 8) << 4) | (db_dg[luma] + 8)
    lengths[luma] = 2
    ops[rgb, 0] = 0xFE
    ops[rgb, 1:4] = px[rgb, :3]
    lengths[rgb] = 4
    ops[rgba, 0] = 0xFF
    ops[rgba, 1:5] = px[rgba]
    lengths[rgba] = 5
    keep = np.arange(5)[None, :] < lengths[:, None]
    body = ops[keep].tobytes()
    head = b"qoif" + struct.pack(">IIBB", w, h, channels if channels is not None else c, colorspace)
    return head + body + (b"\0" * 7 + b"\1" if end else b"")


# -------------------------------------------------------------------- SGI


def sgi_rle_row(samples: np.ndarray, rng) -> bytes:
    """One channel of a scanline as SGI RLE packets (runs and literals of at
    most 127, random splits), then the terminator."""
    out, pos, n = bytearray(), 0, len(samples)
    size = samples.dtype.itemsize
    while pos < n:
        run = 1
        while pos + run < n and run < 127 and samples[pos + run] == samples[pos]:
            run += 1
        if run > 1:
            out += (bytes([0, run]) if size == 2 else bytes([run])) + samples[pos : pos + 1].astype(f">u{size}").tobytes()
        else:
            run = min(int(rng.integers(1, 8)), n - pos, 127)
            out += (bytes([0, 0x80 | run]) if size == 2 else bytes([0x80 | run])) + \
                samples[pos : pos + run].astype(f">u{size}").tobytes()
        pos += run
    return bytes(out) + bytes(size)


def sgi(planes: np.ndarray, rle: bool = False, rng=None, dimension: int | None = None) -> bytes:
    """An SGI file of (channels, h, w) samples (uint8 or uint16), rows in
    file order (bottom-up)."""
    z, h, w = planes.shape
    bpc = planes.dtype.itemsize
    dim = dimension if dimension is not None else (3 if z > 1 else 2)
    header = struct.pack(">HBBHHHHII4x80sII", 474, int(rle), bpc, dim, w, h, z, 0, 255 if bpc == 1 else 65535,
                         b"", 0, 0).ljust(512, b"\0")
    if not rle:
        return header + planes.astype(f">u{bpc}").tobytes()
    rows = [[sgi_rle_row(planes[c, y], rng) for y in range(h)] for c in range(z)]
    table_end = 512 + 8 * z * h
    starts, lengths, body = [], [], bytearray()
    for c in range(z):
        for y in range(h):
            starts.append(table_end + len(body))
            lengths.append(len(rows[c][y]))
            body += rows[c][y]
    return header + struct.pack(f">{z * h}I", *starts) + struct.pack(f">{z * h}I", *lengths) + bytes(body)


# -------------------------------------------------------------------- PCX


def pcx_rle(line: bytes) -> bytes:
    """A scanline in PCX RLE: runs of up to 63, and bytes of 0xC0 or more
    always as runs."""
    out, pos = bytearray(), 0
    while pos < len(line):
        run = 1
        while pos + run < len(line) and run < 63 and line[pos + run] == line[pos]:
            run += 1
        if run > 1 or line[pos] >= 0xC0:
            out += bytes([0xC0 | run, line[pos]])
        else:
            out.append(line[pos])
        pos += run
    return bytes(out)


def pcx(lines: np.ndarray, width: int, height: int, bits: int, planes: int, *, version: int = 5,
        header_palette: bytes = b"", stride: int | None = None, tail_palette: bytes | None = None) -> bytes:
    """A PCX file: lines are (height, planes * stride) scanline bytes."""
    stride = stride if stride is not None else lines.shape[1] // planes
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, width - 1, height - 1, 72, 72)
    head += header_palette.ljust(48, b"\0")[:48] + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    body = b"".join(pcx_rle(row.tobytes()) for row in lines)
    return head.ljust(128, b"\0") + body + (b"\x0c" + tail_palette if tail_palette is not None else b"")


# ----------------------------------------------------------------- CUR, ICO


def dib(pixels: np.ndarray, bits: int, palette: np.ndarray | None = None, and_mask: np.ndarray | None = None,
        top_down: bool = False) -> bytes:
    """A BITMAPINFOHEADER bitmap as icons hold it: the height field twice the
    image's, palette entries (BGRX), rows padded to 4 bytes (bottom-up unless
    top_down), then the 1-bit AND mask (1 transparent)."""
    h, w = pixels.shape[:2]
    colors = 0 if palette is None else len(palette)
    header = struct.pack("<IiiHHIIiiII", 40, w, -2 * h if top_down else 2 * h, 1, bits, 0, 0, 0, 0, colors, 0)
    table = b"" if palette is None else np.concatenate([palette[:, ::-1], np.zeros((colors, 1), np.uint8)],
                                                         axis=1).astype(np.uint8).tobytes()
    stride = ((w * bits + 31) // 32) * 4
    if bits < 8:
        packed = np.packbits(np.unpackbits(pixels.astype(np.uint8)[..., None], axis=-1)[..., 8 - bits :].reshape(h, -1),
                             axis=1)
    else:
        packed = pixels.reshape(h, -1).astype(np.uint8)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : packed.shape[1]] = packed
    if not top_down:
        rows = rows[::-1]
    mask = and_mask if and_mask is not None else np.zeros((h, w), bool)
    mstride = ((w + 31) // 32) * 4
    mrows = np.zeros((h, mstride), np.uint8)
    mbits = np.packbits(mask.astype(np.uint8), axis=1)
    mrows[:, : mbits.shape[1]] = mbits
    return header + table + rows.tobytes() + mrows[::-1].tobytes()


def icon_dir(kind: int, entries: list) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) file of (width byte, height byte,
    colours, hotspot / planes, bpp, image bytes) entries."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    offset = 6 + 16 * len(entries)
    body = b""
    for w, h, colours, x, y, data in entries:
        out += struct.pack("<BBBBHHII", w, h, colours, 0, x, y, len(data), offset + len(body))
        body += data
    return out + body


# -------------------------------------------------------------------- PSD


def packbits(row: bytes) -> bytes:
    """PackBits: runs of 2-128 as (257 - n, byte), literals of 1-128."""
    out, pos, lit = bytearray(), 0, bytearray()

    def flush():
        while lit:
            chunk = lit[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del lit[:128]

    while pos < len(row):
        run = 1
        while pos + run < len(row) and run < 128 and row[pos + run] == row[pos]:
            run += 1
        if run > 1:
            flush()
            out += bytes([257 - run, row[pos]])
        else:
            lit.append(row[pos])
        pos += run
    flush()
    return bytes(out)


def psd(planes: np.ndarray, colour_mode: int, bits: int = 8, *, compression: int = 0, palette: bytes = b"",
        resources: bytes = b"", layers: bytes = b"", channels: int | None = None) -> bytes:
    """A PSD file's header, colour data, resources, layer section and merged
    image: planes are (channels, h, rows) bytes (rows (w + 7) // 8 for 1-bit)."""
    c, h, _ = planes.shape
    width = planes.shape[2] * 8 if bits == 1 else planes.shape[2]
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, channels if channels is not None else c, h, width, bits, colour_mode)
    out += struct.pack(">I", len(palette)) + palette + struct.pack(">I", len(resources)) + resources
    out += struct.pack(">I", len(layers)) + layers + struct.pack(">H", compression)
    if compression == 0:
        return out + planes.tobytes()
    rows = [packbits(planes[i, y].tobytes()) for i in range(c) for y in range(h)]
    return out + struct.pack(f">{len(rows)}H", *map(len, rows)) + b"".join(rows)


# ----------------------------------------------------------------- Netpbm


def netpbm_ascii(magic: str, samples: np.ndarray, maxval: int | None, *, comments: bool = True,
                 per_line: int = 7) -> bytes:
    """A plain (ASCII) Netpbm file, comments in its header and data."""
    h, w = samples.shape[:2]
    head = f"{magic}\n# made by pil_format_writers\n{w} {h}\n" if comments else f"{magic}\n{w} {h}\n"
    if maxval is not None:
        head += f"{maxval}\n"
    values = [str(int(v)) for v in samples.reshape(-1)]
    lines = [" ".join(values[i : i + per_line]) for i in range(0, len(values), per_line)]
    if comments and lines:
        lines[len(lines) // 2] += " # a comment in the data"
    return (head + "\n".join(lines) + "\n").encode()


# ---------------------------------------------------------------- timing


def timing_textures(seed: int = 2048) -> dict:
    """The three 2048x2048 textures chip_smoke.py times: name -> bytes.
    BC7 from random blocks (every mode), an RLE TGA of 16-pixel runs and
    noise, a QOI of smooth gradients with flat patches (every op)."""
    rng = np.random.default_rng(seed)
    s = TIMING_SIZE
    out = {"timing-bc7.dds": dds(s, s, bc_blocks(rng, s, s, 7), dxgi=98)}
    y, x = np.mgrid[0:s, 0:s]
    tiles = rng.integers(0, 256, (s // 16, s // 16, 3), np.uint8)
    img = np.repeat(np.repeat(tiles, 16, axis=0), 16, axis=1)
    noisy = (((x // 16) + (y // 16)) % 3 == 0)
    img[noisy] = rng.integers(0, 256, (int(noisy.sum()), 3), np.uint8)
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, s, s, 24, 0x20)
    out["timing-rle.tga"] = header + tga_rle_fast(img)
    grad = np.stack([(x // 8) % 256, (y // 8) % 256, ((x + y) // 16) % 256, 255 - (x // 64) * 0], axis=-1)
    grad = grad.astype(np.uint8)
    flat = ((x // 128 + y // 128) % 5 == 0)
    grad[flat] = (40, 90, 200, 255)
    jitter = rng.integers(0, 256, (s, s, 3), np.uint8)
    spots = rng.random((s, s)) < 0.02
    grad[spots, :3] = jitter[spots]
    grad[..., 3] = np.where(rng.random((s, s)) < 0.01, 128, 255)
    out["timing-ops.qoi"] = qoi(grad)
    return out
