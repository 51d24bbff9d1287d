"""Image export and import: PNG (LDR), and NPY or Radiance RGBE `.hdr` (HDR)
(port of vpt_tpu/io/image.py).

PNG is written and read with the standard library's `zlib` and `struct`
alone: 8-bit RGB or RGBA, one IDAT chunk, filter 0 on every row.  The
quantisation is the JAX package's, clip(x, 0, 1) * 255 + 0.5 truncated.
`read_png` reads such files back (it refuses other row filters).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG colour type -> channels (RGB, RGBA)


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


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit RGB or RGBA PNG with unfiltered
    rows, as `save_png` writes them."""
    data = open(path, "rb").read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0]:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only non-interlaced 8-bit RGB / RGBA PNGs are read")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if (raw[:, 0] != 0).any():
        raise ValueError(f"{path}: filtered PNG rows are not read")
    return raw[:, 1:].reshape(h, w, c).copy()


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
