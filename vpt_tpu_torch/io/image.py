"""Image export and import: PNG (LDR), and NPY or Radiance RGBE `.hdr` (HDR)
(port of vpt_tpu/io/image.py).

PNG is written and read with the standard library's `zlib` and `struct`
alone.  `save_png` writes 8-bit RGB or RGBA, one IDAT chunk, filter 0 on
every row; the quantisation is the JAX package's, clip(x, 0, 1) * 255 + 0.5
truncated.  `read_png` decodes any non-interlaced 8-bit gray, gray+alpha,
RGB or RGBA PNG and 1-, 2-, 4- or 8-bit palette PNGs (IDAT split over
several chunks, all five row filters); `load_png` gives its pixels as
float32 / 255, with PIL's shapes for the non-palette types, as the JAX
package's `load_png` does through PIL.  `decode_rgba` gives any of them as
(H, W, 4) float32 / 255, expanded the way PIL's `convert("RGBA")` expands
them (tRNS transparency included): the glTF loader's texture decode.
16-bit and interlaced PNGs, and JPEG or other formats, raise a ValueError
that names the format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels (gray, RGB, gray+alpha, RGBA)


def to_uint8(image) -> np.ndarray:
    """(H, W, C) float in [0, 1] to uint8, as `save_png` stores it."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return arr


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def save_png(path: str, image) -> None:
    """image: (H, W, 3 | 4) float in [0, 1] or uint8."""
    arr = to_uint8(image)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"save_png expects (H, W, 3 | 4), got {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(arr).reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + stride) filtered scanlines: 0
    none, 1 sub, 2 up, 3 average, 4 Paeth (PNG spec, section 9)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, row = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = row.copy()
        elif kind == 1:  # sub: a running sum per byte of a pixel, mod 256
            cur = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prev
        elif kind in (3, 4):  # each byte needs the one decoded bpp bytes before it
            x, b = row.tolist(), prev.tolist()
            c = bytearray(stride)
            for i in range(stride):
                a = c[i - bpp] if i >= bpp else 0
                if kind == 3:
                    c[i] = (x[i] + ((a + b[i]) >> 1)) & 0xFF
                else:
                    ul = b[i - bpp] if i >= bpp else 0
                    p = a + b[i] - ul
                    pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - ul)
                    pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else ul)
                    c[i] = (x[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(c), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def _decode(data: bytes, name: str):
    """(pixels, palette, trns) of a PNG's bytes: the uint8 samples (H, W, c),
    palette indices for colour type 3; the (n, 3) PLTE entries or None; the
    tRNS chunk's bytes or None."""
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{name}: JPEG images are not read, only PNG")
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name} is not a PNG file")
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0]:
            raise ValueError(f"{name}: CRC mismatch in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype == 3:
        if depth not in (1, 2, 4, 8):
            raise ValueError(f"{name}: {depth}-bit palette PNGs are not read")
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        c = 1
    elif ctype not in _CHANNELS:
        raise ValueError(f"{name}: unknown PNG colour type {ctype}")
    elif depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNGs are not read, only 8-bit")
    else:
        c = _CHANNELS[ctype]
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not read")
    stride = (w * c * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[: h * (1 + stride)].reshape(h, 1 + stride)
    rows = _unfilter(raw, h, stride, max(1, c * depth // 8))
    if depth < 8:  # palette indices packed high bit first
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    return rows.reshape(h, w, c), palette, trns


def _palette_colours(pixels, palette, trns) -> np.ndarray:
    """Palette indices (H, W, 1) to RGB, or RGBA where a tRNS chunk gives
    the entries' alphas (entries past its end are opaque)."""
    if trns is None:
        table = palette
    else:
        alpha = np.full(palette.shape[0], 255, np.uint8)
        n = min(len(trns), palette.shape[0])
        alpha[:n] = np.frombuffer(trns[:n], np.uint8)
        table = np.concatenate([palette, alpha[:, None]], axis=1)
    return table[np.minimum(pixels[..., 0], palette.shape[0] - 1)]


def read_png(path: str) -> np.ndarray:
    """The uint8 pixels of an 8-bit, non-interlaced gray (H, W), gray+alpha
    (H, W, 2), RGB (H, W, 3) or RGBA (H, W, 4) PNG; a palette PNG as RGB,
    or RGBA when it carries tRNS alphas."""
    with open(path, "rb") as f:
        pixels, palette, trns = _decode(f.read(), path)
    if palette is not None:
        return _palette_colours(pixels, palette, trns)
    return pixels[..., 0] if pixels.shape[2] == 1 else pixels


def decode_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """A PNG's bytes as (H, W, 4) float32 in [0, 1], expanded as PIL's
    `convert("RGBA")` expands each colour type: gray g -> (g, g, g, 255),
    gray+alpha -> (g, g, g, a), RGB -> alpha 255, palette -> its entries
    with the tRNS alphas; a gray or RGB tRNS colour becomes alpha 0."""
    pixels, palette, trns = _decode(data, name)
    c = pixels.shape[2]
    if palette is not None:
        rgba = _palette_colours(pixels, palette, trns)
        if rgba.shape[2] == 3:
            rgba = np.concatenate([rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    else:
        colour = pixels[..., :3] if c >= 3 else np.repeat(pixels[..., :1], 3, axis=-1)
        if c in (2, 4):
            alpha = pixels[..., -1:]
        else:
            alpha = np.full(pixels.shape[:2] + (1,), 255, np.uint8)
            if trns is not None:  # one 16-bit sample per channel: the transparent colour
                key = np.frombuffer(trns, ">u2")[:c].astype(np.int64)
                alpha[(pixels == key).all(axis=-1)] = 0
        rgba = np.concatenate([colour, alpha], axis=-1)
    return rgba.astype(np.float32) / 255.0


def load_png(path: str) -> np.ndarray:
    """The pixels of a PNG as float32 in [0, 1], value / 255 (vpt_tpu's
    io/image.load_png): (H, W) gray, else (H, W, channels)."""
    return read_png(path).astype(np.float32) / 255.0


def save_hdr(path: str, image) -> None:
    """HDR export: Radiance RGBE `.hdr`, or a raw float32 `.npy` dump."""
    if path.endswith(".hdr"):
        save_radiance_hdr(path, image)
    else:
        np.save(path, np.asarray(image, np.float32))


def save_radiance_hdr(path: str, image) -> None:
    """A Radiance RGBE .hdr file with flat scanlines, stb_image_write's
    shared-exponent encoding: e = exponent of max(r, g, b), 8-bit mantissas."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError("save_radiance_hdr expects (H, W, >=3)")
    h, w = img.shape[:2]
    rgb = np.maximum(img[..., :3], 0.0)
    mx = rgb.max(axis=-1)
    m, e = np.frexp(mx)  # mx = m * 2^e, m in [0.5, 1)
    scale = np.where(mx > 1e-32, (256.0 * m / np.maximum(mx, 1e-32)), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(mx > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def _is_adaptive(raw, p2: int, w: int) -> bool:
    """An adaptive-RLE scanline header at raw[p2]: 2, 2, then the width,
    big-endian (legal for widths 8..32767)."""
    return (8 <= w <= 32767 and p2 + 4 <= len(raw) and raw[p2] == 2 and raw[p2 + 1] == 2
            and ((int(raw[p2 + 2]) << 8) | int(raw[p2 + 3])) == w)


def _decode_scanline(raw, p2: int, w: int, y: int, rgbe) -> int:
    """Decode scanline y starting at raw[p2]: adaptive RLE, old-style RLE
    ((1, 1, 1, count) repeat markers) or flat.  Returns the next offset."""
    if _is_adaptive(raw, p2, w):
        p2 += 4
        for c in range(4):
            x = 0
            while x < w:
                n = int(raw[p2])
                p2 += 1
                if n > 128:  # run
                    rgbe[y, x : x + n - 128, c] = raw[p2]
                    p2 += 1
                    x += n - 128
                else:  # literal
                    rgbe[y, x : x + n, c] = raw[p2 : p2 + n]
                    p2 += n
                    x += n
        return p2
    x = shift = 0
    while x < w:
        if p2 + 4 > len(raw):
            raise ValueError("truncated HDR scanline")
        px = raw[p2 : p2 + 4]
        p2 += 4
        if px[0] == 1 and px[1] == 1 and px[2] == 1:
            if x == 0 and y == 0:
                raise ValueError("HDR old-style run with no prior pixel")
            count = int(px[3]) << shift
            rgbe[y, x : x + count] = rgbe[y, x - 1] if x > 0 else rgbe[y - 1, w - 1]
            x += count
            shift += 8
        else:
            rgbe[y, x] = px
            x += 1
            shift = 0
    return p2


def load_radiance_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr (flat or RLE scanlines) to float32 (H, W, 3)."""
    data = open(path, "rb").read()
    end = data.find(b"\n\n")  # the header ends at the first blank line
    if end < 0:
        raise ValueError("not a Radiance HDR file")
    nl = data.find(b"\n", end + 2)
    dims = data[end + 2 : nl].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {dims!r}")
    h, w = int(dims[1]), int(dims[3])
    raw = np.frombuffer(data, np.uint8, offset=nl + 1)
    flat = raw[: h * w * 4].reshape(-1, 4) if len(raw) >= h * w * 4 else None
    if (flat is not None and not _is_adaptive(raw, 0, w)
            and not ((flat[:, 0] == 1) & (flat[:, 1] == 1) & (flat[:, 2] == 1)).any()):
        rgbe = flat.reshape(h, w, 4)  # a flat file; trailing bytes are tolerated
    else:
        rgbe = np.zeros((h, w, 4), np.uint8)
        p2 = 0
        for y in range(h):
            p2 = _decode_scanline(raw, p2, w, y, rgbe)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    rgb = (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(e[..., None] > 0, 1.0, 0.0)
    return rgb.astype(np.float32)


def export_filename(base: str, spp: int, seconds: float) -> str:
    """Reference-style name embedding spp and render time (Editor.cpp:795)."""
    return f"{base}_{spp}spp_{seconds:.1f}s.png"
