"""Image export and import: PNG (LDR), and NPY or Radiance RGBE `.hdr` (HDR)
(port of vpt_tpu/io/image.py), and the image decoding that the glTF loader
and `load_hdr` use.

PNG is written with the standard library's `zlib` and `struct` alone:
`save_png` writes 8-bit RGB or RGBA, one IDAT chunk, filter 0 on every
row; the quantisation is the JAX package's, clip(x, 0, 1) * 255 + 0.5
truncated.

Reading gives what the JAX package gets from PIL, which opens a file by
its content:

- PNG: every colour type and bit depth (1-16), Adam7 interlacing, IDAT
  split over chunks, all five row filters (undone by the C codec,
  io/codec.py), tRNS;
- JPEG (io/jpeg.py): baseline, extended and progressive Huffman-coded, gray,
  YCbCr / RGB and CMYK / YCCK, any sampling factors libjpeg accepts, and the
  block smoothing libjpeg gives a progressive file whose first AC
  coefficients are incomplete;
- TIFF (io/tiff.py): strips and tiles, classic and BigTIFF, none / LZW /
  Deflate / PackBits, predictors 2 and 3, the modes PIL has for them;
- GIF (io/gif.py): the first frame, with its transparency index;
- BMP (io/bmp.py): every header, palettes, 16 / 24 / 32-bit, bit fields,
  RLE8 and RLE4;
- WebP (io/webp.py): lossless and lossy (with its ALPH chunk), the first
  frame of an animation, as "RGB" or "RGBA" as PIL's libwebp gives them.

The arrays are PIL's: a 16-bit RGB, RGBA or gray+alpha PNG gives its
samples' high bytes (the gray+alpha one as RGBA), a 16-bit gray one its
full uint16 values, a 1-bit gray one booleans and a 2- or 4-bit gray one
samples scaled to 0..255; a palette image its indices; a CMYK JPEG 255 -
its samples (PIL's "CMYK;I"); a float TIFF float32, a signed or 32-bit one
int32.  `load_png` is that array as float32 / 255, as the JAX package's
`load_png` gives it; `decode_rgba` expands it as PIL's `convert("RGBA")`
does (the glTF texture decode); `decode_samples` gives it as imageio's PIL
route gives it to the JAX package's `load_hdr` (a palette image as its RGB
colours).  Other files raise a ValueError: KTX2, OpenEXR, Radiance HDR and
PFM data, and the formats PIL opens that the port does not read yet whose
leading bytes name them (Netpbm P1-P6, QOI, DDS, JPEG 2000, SGI, AVIF, PSD),
each named; any other file, PIL's formats without such bytes (TGA, PCX,
ICO / CUR) among them, as a file of unknown format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from vpt_tpu_torch.io import bmp, codec, gif, tiff, webp
from vpt_tpu_torch.io.jpeg import decode_jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: first column, first row, column step, row step.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# Leading bytes of image formats that glTF assets or environment maps come
# in and that the port does not read, to name them in the refusal.
_OTHER_FORMATS = ((b"\xabKTX 20\xbb", "KTX2"), (b"\x76\x2f\x31\x01", "OpenEXR"),
                  (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"), (b"PF\n", "PFM"), (b"Pf\n", "PFM"))
# Leading bytes of formats PIL opens (so the JAX package reads them) that the
# port does not read yet (ROADMAP "Left").
_PIL_ONLY_FORMATS = (*((b"P" + bytes([c]), f"Netpbm (P{chr(c)})") for c in b"123456"), (b"qoif", "QOI"),
                     (b"DDS ", "DDS"), (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
                     (b"\xff\x4f\xff\x51", "JPEG 2000 (codestream)"), (b"\x01\xda", "SGI"), (b"8BPS", "PSD"))


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


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """(h, w, c) samples of (h, stride) unfiltered scanlines: uint16 for
    16-bit files (big-endian in the file), else uint8; samples under 8 bits
    unpacked high bits first."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, : 2 * w * c].view(">u2").astype(np.uint16).reshape(h, w, c)
    if depth == 8:
        return rows[:, : w * c].reshape(h, w, c)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w].reshape(h, w, 1)


def _decode_png(data: bytes, name: str):
    """(samples, depth, colour type, palette, tRNS bytes) of a PNG's bytes:
    the (H, W, c) samples (palette indices for colour type 3), the (n, 3)
    PLTE entries or None, the tRNS chunk or None."""
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(crc) < 4:
            raise ValueError(f"{name}: PNG file is truncated in chunk {kind!r}")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: CRC mismatch in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[: len(body) // 3 * 3].reshape(-1, 3)
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
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: unknown PNG colour type {ctype}")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: {depth}-bit PNGs of colour type {ctype} do not exist")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    if interlace > 1:
        raise ValueError(f"{name}: unknown PNG interlace method {interlace}")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: PNG image data is corrupt ({e})") from None
    c = _CHANNELS[ctype]
    bits, bpp = c * depth, max(1, c * depth // 8)
    if not interlace:
        samples = _samples(codec.png_unfilter(raw, h, (w * bits + 7) // 8, bpp), w, c, depth)
    else:  # Adam7: seven sub-images, each filtered on its own
        samples = np.zeros((h, w, c), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
            if pw == 0 or ph == 0:
                continue
            stride = (pw * bits + 7) // 8
            rows = codec.png_unfilter(raw[pos : pos + ph * (1 + stride)], ph, stride, bpp)
            samples[y0::dy, x0::dx] = _samples(rows, pw, c, depth)
            pos += ph * (1 + stride)
    return samples, depth, ctype, palette, trns


def _pil_image(data: bytes, name: str):
    """The image as PIL opens it: (array, mode, palette, transparency).
    The array is `np.asarray` of PIL's image; the palette is (256, 3)
    (unlisted entries black) for modes "P" and "PA", else None; the
    transparency is PIL's `info` value (a gray level, an RGB triple) or, for
    a palette image, its entries' alphas as a PNG tRNS chunk gives them, or
    None."""
    if data[:8] == _PNG_SIGNATURE:
        samples, depth, ctype, palette, trns = _decode_png(data, name)
    elif data[:3] == _JPEG_SOI:
        arr = decode_jpeg(data, name)
        return arr, "L" if arr.ndim == 2 else ("RGB", "CMYK")[arr.shape[2] == 4], None, None
    elif data[:4] in tiff.MAGIC:
        arr, mode, table = tiff.read_pil(data, name)
        return arr, mode, table, None
    elif data[:6] in (b"GIF87a", b"GIF89a"):
        arr, mode, table, index = gif.read_pil(data, name)
        if mode == "P" and index is not None:  # alpha 0 at the transparency index, as tRNS alphas
            return arr, mode, table, bytes([255] * index + [0])
        return arr, mode, table, index
    elif data[:2] == b"BM":
        arr, mode, table = bmp.read_pil(data, name)
        return arr, mode, table, None
    elif data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        arr, mode = webp.read_pil(data, name)
        return arr, mode, None, None
    else:
        kind = next((f for magic, f in _OTHER_FORMATS if data.startswith(magic)), None)
        if kind:
            raise ValueError(f"{name}: {kind} images are not read (only PNG, JPEG, TIFF, GIF, BMP and WebP)")
        kind = next((f for magic, f in _PIL_ONLY_FORMATS if data.startswith(magic)), None)
        if kind is None and data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
            kind = "AVIF"
        if kind:
            raise ValueError(f"{name}: {kind} images are not read yet (PIL opens them; the port reads PNG, JPEG, "
                             f"TIFF, GIF, BMP and WebP)")
        raise ValueError(f"{name}: a file of unknown format is not read (only PNG, JPEG, TIFF, GIF, BMP and WebP)")
    gray_key = struct.unpack(">H", trns[:2])[0] if trns is not None and len(trns) >= 2 else None
    rgb_key = struct.unpack(">3H", trns[:6]) if trns is not None and len(trns) >= 6 else None
    if ctype == 3:
        table = np.zeros((256, 3), np.uint8)
        table[: min(len(palette), 256)] = palette[:256]
        return samples[..., 0], "P", table, trns
    if depth == 16:
        if ctype == 0:
            return samples[..., 0], "I;16", None, gray_key
        samples = (samples >> 8).astype(np.uint8)
    if ctype == 0:
        if depth == 1:
            return samples[..., 0].astype(bool), "1", None, None if gray_key is None else 255 * bool(gray_key)
        scale = {2: 85, 4: 17, 8: 1}[depth]
        return samples[..., 0] * np.uint8(scale), "L", None, gray_key
    if ctype == 2:
        return samples, "RGB", None, rgb_key
    if ctype == 4 and depth == 16:  # PIL opens 16-bit gray+alpha as RGBA
        return samples[..., [0, 0, 0, 1]], "RGBA", None, None
    return samples, ("LA" if ctype == 4 else "RGBA"), None, None


def _palette_colours(indices, table, trns) -> np.ndarray:
    """Palette indices (H, W) to RGB, or RGBA where a tRNS chunk gives the
    entries' alphas (entries past its end are opaque)."""
    if trns is not None:
        alpha = np.full(256, 255, np.uint8)
        alpha[: min(len(trns), 256)] = np.frombuffer(trns[:256], np.uint8)
        table = np.concatenate([table, alpha[:, None]], axis=1)
    return table[indices]


def read_png(path: str) -> np.ndarray:
    """The uint8 pixels of a PNG: gray (H, W), gray+alpha (H, W, 2), RGB
    (H, W, 3) or RGBA (H, W, 4) as PIL opens it (1-bit gray as 0 / 255, a
    16-bit gray one as its uint16 values); a palette PNG as RGB, or RGBA
    when it carries tRNS alphas."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    arr, mode, table, trns = _pil_image(data, path)
    if mode == "P":
        return _palette_colours(arr, table, trns)
    return arr.astype(np.uint8) * np.uint8(255) if mode == "1" else arr


def _unit(arr: np.ndarray) -> np.ndarray:
    """float32 arr / 255, as PIL's arrays are scaled (divided in place)."""
    out = arr.astype(np.float32)
    out /= np.float32(255.0)
    return out


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """PIL's MULDIV255: a * b / 255, rounded, in integers."""
    t = a.astype(np.int32) * b + 128
    return ((t >> 8) + t) >> 8


def decode_rgba(data: bytes, name: str = "image") -> np.ndarray:
    """An image's bytes as (H, W, 4) float32 in [0, 1], expanded as PIL's
    `convert("RGBA")` expands each mode: gray g -> (g, g, g, 255) (16- and
    32-bit gray clipped to 0..255 first, float gray truncated), gray+alpha
    -> (g, g, g, a), RGB -> alpha 255, palette -> its entries with their
    alphas (a PNG's tRNS, a GIF's transparency index, a TIFF's alpha
    samples), CMYK -> RGB by PIL's cmyk2rgb (255 - k - (255 - k) * c / 255,
    rounded); a pixel whose gray or RGB value equals the tRNS key's low bytes
    gets alpha 0."""
    arr, mode, table, trns = _pil_image(data, name)
    if mode == "P":
        rgba = _palette_colours(arr, table, trns)
        if rgba.shape[2] == 3:
            rgba = np.concatenate([rgba, np.full(rgba.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        return _unit(rgba)
    if mode == "PA":
        return _unit(np.concatenate([table[arr[..., 0]], arr[..., 1:2]], axis=-1))
    if mode == "RGBA":
        return _unit(arr)
    if mode == "CMYK":
        nk = 255 - arr[..., 3:4].astype(np.int32)
        rgb = np.clip(nk - _muldiv255(arr[..., :3], nk), 0, 255)
        return _unit(np.concatenate([rgb, np.full(arr.shape[:2] + (1,), 255)], axis=-1).astype(np.uint8))
    if mode == "1":
        arr = arr.astype(np.uint8) * np.uint8(255)
    elif mode in ("I;16", "I;16B", "I"):
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    elif mode == "F":  # through "L": truncated, NaN as 0
        arr = np.where(arr >= 255.0, 255, np.where(arr > 0.0, arr, 0)).astype(np.uint8)
    rgba = np.empty(arr.shape[:2] + (4,), np.uint8)
    if mode == "LA":
        rgba[..., :3] = arr[..., :1]
        rgba[..., 3] = arr[..., 1]
    else:
        rgba[..., :3] = arr[..., None] if arr.ndim == 2 else arr
        rgba[..., 3] = 255
        if trns is not None:
            key = np.atleast_1d(np.asarray(trns, np.int64)) & 0xFF
            rgba[..., 3][(rgba[..., : key.size] == key).all(axis=-1)] = 0
    return _unit(rgba)


def decode_samples(data: bytes, name: str = "image") -> np.ndarray:
    """An image's samples as imageio reads them through PIL: PIL's array, a
    palette image converted to its RGB colours."""
    arr, mode, table, _ = _pil_image(data, name)
    return table[arr] if mode == "P" else arr


def load_png(path: str) -> np.ndarray:
    """The pixels of an image file, by its content, as float32 PIL array /
    255 (vpt_tpu's io/image.load_png): (H, W) for gray, 1-bit and palette
    images (palette indices), else (H, W, channels)."""
    with open(path, "rb") as f:
        arr = _pil_image(f.read(), path)[0]
    return np.asarray(arr, np.float32) / 255.0


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
