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
  frame of an animation, as "RGB" or "RGBA" as PIL's libwebp gives them;
- AVIF (io/avif.py, io/av1.py, csrc/av1dec.c): coded-lossless 8-bit AV1
  key frames in an image item or frame 0 of a sequence, with alpha, as
  "RGB" or "RGBA" as PIL's libavif gives them;
- TGA (io/tga.py), DDS with BC1-BC7 (io/dds.py, csrc/bcndec.c), Netpbm
  P1-P6 and gray PFM (io/netpbm.py), QOI (io/qoi.py), SGI (io/sgi.py), PCX
  (io/pcx.py), ICO and CUR (io/ico.py), PSD's merged image (io/psd.py) and
  headerless DIBs (io/bmp.py), each in the modes PIL gives.

PIL opens a file by trying its plugins in order (`_PLUGINS`; io/probe.py
tests the ones the port has no reader for), so a file without magic bytes
(TGA) is read only when no plugin before TGA's claims it.

The arrays are PIL's: a 16-bit RGB, RGBA or gray+alpha PNG gives its
samples' high bytes (the gray+alpha one as RGBA), a 16-bit gray one its
full uint16 values, a 1-bit gray one booleans and a 2- or 4-bit gray one
samples scaled to 0..255; a palette image its indices; a CMYK JPEG 255 -
its samples (PIL's "CMYK;I"); a float TIFF float32, a signed or 32-bit one
int32; a 16-bit Netpbm gray int32 ("I"), a PFM float32 ("F").  `load_png`
is that array as float32 / 255, as the JAX package's `load_png` gives it;
`decode_rgba` expands it as PIL's `convert("RGBA")` does (the glTF texture
decode); `decode_samples` gives it as imageio's PIL route gives it to the
JAX package's `load_hdr` (a palette image as its palette's colours).  Other
files raise a ValueError: KTX2, OpenEXR, Radiance HDR and colour PFM data,
which PIL does not open either, and the formats PIL opens that the port does
not read (AVIF that is not coded-lossless 8-bit, io/avif.py, and the
plugins of probe.UNPORTED), each named; any other file as a file of unknown
format.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from vpt_tpu_torch.io import (avif, blp, bmp, codec, dcx, dds, fits, fli, ftex, gbr, gif, icns, ico, im, iptc, jpeg2000, lab,
                              mcidas, msp, netpbm, pcd, pcx, pixar, probe, psd, qoi, raw, sgi, spider, sun, tga, tiff,
                              webp, xbm, xpm, xvthumb)
from vpt_tpu_torch.io.jpeg import decode_jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: first column, first row, column step, row step.
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# Leading bytes of image formats that glTF assets or environment maps come
# in and that neither PIL nor the port reads, to name them in the refusal.
_OTHER_FORMATS = ((b"\xabKTX 20\xbb", "KTX2"), (b"\x76\x2f\x31\x01", "OpenEXR"),
                  (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"), (b"PF\n", "PFM (colour)"))
_READ = ("PNG, JPEG, JPEG 2000, TIFF, GIF, BMP, WebP, TGA, DDS, Netpbm, QOI, SGI, PCX, ICO, CUR, PSD and PIL's "
         "other plugins but BUFR, EPS, GRIB, HDF5, MPEG and WMF")
# The plugins PIL 12.1 has that decode on neither machine, as the refusals
# name them, and why.
_UNPORTED_NAMES = {"BUFR": "BUFR", "EPS": "EPS (PostScript)", "GRIB": "GRIB", "HDF5": "HDF5",
                   "MPEG": "MPEG", "WMF": "WMF / EMF"}
_UNPORTED_WHY = {"BUFR": "PIL has no BUFR handler installed, so it raises too",
                 "GRIB": "PIL has no GRIB handler installed, so it raises too",
                 "HDF5": "PIL has no HDF5 handler installed, so it raises too",
                 "EPS": "PIL renders it with Ghostscript, which neither machine has",
                 "MPEG": "PIL has no MPEG decoder, so it raises too",
                 "WMF": "PIL renders it through Windows only, so it raises too"}


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


def _row_ends(w: int, h: int, bits: int, interlace: int) -> list:
    """The offsets in the inflated image data where each filtered row ends
    (the passes' rows in turn for Adam7)."""
    ends, pos = [], 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy))
        if pw and ph:
            ends += [pos + (k + 1) * (1 + (pw * bits + 7) // 8) for k in range(ph)]
            pos = ends[-1]
    return ends


def _inflate(idat: list, row_ends: list, name: str) -> tuple:
    """The image data as PIL's decoder inflates it, and the file offset
    where PIL stops reading it: fed an IDAT chunk ((offset, body) in idat),
    at most 65536 bytes of it, at a time, stopped once the last row is out,
    so that what follows in the bytes fed so far is checked (the Adler-32
    too) and what follows them is not; a stream that ends with a row's last
    bytes leaves the rows after it zero, as PIL leaves them."""
    need, d, parts, size, grew, end = row_ends[-1], zlib.decompressobj(), [], 0, False, 0
    try:
        for offset, body in idat:
            for at in range(0, max(len(body), 1), codec.PIL_BLOCK):
                piece = body[at : at + codec.PIL_BLOCK]
                parts.append(d.decompress(piece, need - size))
                size, grew, end = size + len(parts[-1]), bool(parts[-1]), offset + at + len(piece)
                if size >= need or d.eof:
                    break
            if size >= need or d.eof:
                break
    except zlib.error as e:
        raise ValueError(f"{name}: PNG image data is corrupt ({e})") from None
    if size < need and d.eof and grew and size in set(row_ends):  # the end came with a row's last bytes
        parts.append(bytes(need - size))
    return b"".join(parts), end


def _after_image(data: bytes, pos: int, trns, name: str):
    """PIL's reading of the chunks after the image data (from `pos`, past
    the CRC of the last IDAT it read): each up to IEND or a header that
    names no chunk must hold its data; a tRNS there sets the transparency.
    Returns the tRNS chunk."""
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        if kind == b"IEND" or not re.fullmatch(rb"\w{4}", kind):
            break
        if pos + 8 + length > len(data):
            raise ValueError(f"{name}: PNG file is truncated in chunk {kind!r}")
        if kind == b"tRNS":
            trns = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
    return trns


def _decode_png(data: bytes, name: str):
    """(samples, depth, colour type, palette, tRNS bytes) of a PNG's bytes:
    the (H, W, c) samples (palette indices for colour type 3), the (n, 3)
    PLTE entries or None, the tRNS chunk or None.  The chunks are read as
    PIL reads them: those before the first IDAT with their CRCs checked, the
    image data from that IDAT and the IDATs right after it (their CRCs
    unread, `_inflate`), and the chunks after the data PIL read
    (`_after_image`)."""
    pos, idat, header, palette, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if kind == b"IDAT":
            break
        crc = data[pos + 8 + length : pos + 12 + length]
        if not re.fullmatch(rb"\w{4}", kind):  # (PIL's SyntaxError: its Image.open tries the next plugin)
            raise probe.PassOn(f"{name}: broken PNG file (chunk {kind!r})")
        if len(crc) < 4:
            raise ValueError(f"{name}: PNG file is truncated in chunk {kind!r}")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise probe.PassOn(f"{name}: CRC mismatch in chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[: len(body) // 3 * 3].reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IEND":
            break
        pos += 12 + length
    while pos + 8 <= len(data) and data[pos + 4 : pos + 8] == b"IDAT":
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        idat.append((pos + 8, data[pos + 8 : pos + 8 + length]))
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
    c = _CHANNELS[ctype]
    bits, bpp = c * depth, max(1, c * depth // 8)
    raw, end = _inflate(idat, _row_ends(w, h, bits, interlace), name)
    raw = np.frombuffer(raw, np.uint8)
    trns = _after_image(data, end + 4, trns, name)
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


def _png(data: bytes, name: str) -> tuple:
    """A PNG as PIL opens it: (array, mode, palette, transparency)."""
    samples, depth, ctype, palette, trns = _decode_png(data, name)
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


def _gif(data: bytes, name: str) -> tuple:
    arr, mode, table, index = gif.read_pil(data, name)
    if mode == "P" and index is not None:  # alpha 0 at the transparency index, as tRNS alphas
        return arr, mode, table, bytes([255] * index + [0])
    return arr, mode, table, index


def _dib(data: bytes, name: str) -> tuple:
    hd = ico.bitmap_header(data, 0, name)
    if hd["width"] <= 0 or hd["height"] <= 0:
        raise probe.PassOn(f"{name}: DIB of {hd['width']}x{hd['height']} pixels")
    return bmp.decode(data, hd, name)


def _icns_png(name: str):
    def png(data: bytes) -> tuple:  # PIL's ICNS image takes the PNG's pixels and palette, not its transparency
        try:
            arr, mode, table, _ = _png(data, name)
        except probe.PassOn as e:
            raise ValueError(str(e)) from None
        return arr, mode, table
    return png


def _ico_png(name: str):
    def png(data: bytes) -> tuple:
        arr, mode, table, _ = _png(data, name)  # PIL keeps the entry's pixels and palette, not its transparency
        return arr, mode, table
    return png


# PIL 12.1's plugins in the order `Image.open` tries them, each with its
# `_accept` test of the file's first 16 bytes (None: PIL registers none, the
# plugin is tried on every file: IM, IMT, IPTC, PCD, SPIDER, TGA) and its reader, which returns (array, mode,
# palette) or (array, mode, palette, transparency), raises probe.PassOn where
# PIL tries the next plugin, and raises a ValueError where PIL refuses the
# file.  A plugin that decodes on neither machine (probe.UNPORTED) has no
# reader: its test is probe's.
_PLUGINS = (
    ("BMP", lambda d: d[:2] == b"BM", lambda d, n, f: bmp.read_pil(d, n)),
    ("DIB", lambda d: d[:4] in (b"\x0c\0\0\0", b"(\0\0\0", b"4\0\0\0", b"8\0\0\0", b"@\0\0\0", b"l\0\0\0",
                                b"|\0\0\0"), lambda d, n, f: _dib(d, n)),
    ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), lambda d, n, f: _gif(d, n)),
    ("JPEG", lambda d: d[:3] == _JPEG_SOI, lambda d, n, f: _jpeg(d, n)),
    ("PPM", netpbm.accept, lambda d, n, f: netpbm.read_pil(d, n)),
    ("PNG", lambda d: d[:8] == _PNG_SIGNATURE, lambda d, n, f: _png(d, n)),
    ("AVIF", probe.ACCEPT["AVIF"], lambda d, n, f: (*avif.read_pil(d, n), None)),
    ("BLP", blp.accept, lambda d, n, f: blp.read_pil(d, n)),
    ("BUFR", probe.UNPORTED["BUFR"], None),
    ("CUR", lambda d: d[:4] == b"\0\0\2\0", lambda d, n, f: ico.read_cur(d, n)),
    ("PCX", pcx.accept, lambda d, n, f: pcx.read_pil(d, n, f)),
    ("DCX", dcx.accept, dcx.read_pil),
    ("DDS", lambda d: d[:4] == b"DDS ", lambda d, n, f: dds.read_pil(d, n)),
    ("EPS", probe.UNPORTED["EPS"], None),
    ("FITS", fits.accept, fits.read_pil),
    ("FLI", fli.accept, lambda d, n, f: fli.read_pil(d, n)),
    ("FTEX", ftex.accept, ftex.read_pil),
    ("GBR", gbr.accept, gbr.read_pil),
    ("GRIB", probe.UNPORTED["GRIB"], None),
    ("HDF5", probe.UNPORTED["HDF5"], None),
    ("JPEG2000", jpeg2000.accept, lambda d, n, f: jpeg2000.read_pil(d, n)),
    ("ICNS", icns.accept, lambda d, n, f: icns.read_pil(d, n, f, _icns_png(n), rgba8)),
    ("ICO", lambda d: d[:4] == b"\0\0\1\0", lambda d, n, f: ico.read_ico(d, n, _ico_png(n))),
    ("IM", None, im.read_pil),
    ("IMT", None, im.read_imt),
    ("IPTC", None, lambda d, n, f: iptc.read_pil(d, n, _iptc_inner)),
    ("MCIDAS", mcidas.accept, mcidas.read_pil),
    ("MPEG", probe.UNPORTED["MPEG"], None),
    ("TIFF", lambda d: d[:4] in tiff.MAGIC, lambda d, n, f: tiff.read_pil(d, n)),
    ("MSP", msp.accept, lambda d, n, f: msp.read_pil(d, n)),
    ("PCD", None, lambda d, n, f: pcd.read_pil(d, n)),
    ("PIXAR", pixar.accept, pixar.read_pil),
    ("PSD", lambda d: d[:4] == b"8BPS", lambda d, n, f: psd.read_pil(d, n)),
    ("QOI", lambda d: d[:4] == b"qoif", lambda d, n, f: qoi.read_pil(d, n)),
    ("SGI", sgi.accept, lambda d, n, f: sgi.read_pil(d, n)),
    ("SPIDER", None, spider.read_pil),
    ("SUN", sun.accept, lambda d, n, f: sun.read_pil(d, n)),
    ("TGA", None, lambda d, n, f: tga.read_pil(d, n)),
    ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", lambda d, n, f: (*webp.read_pil(d, n), None)),
    ("WMF", probe.UNPORTED["WMF"], None),
    ("XBM", xbm.accept, lambda d, n, f: xbm.read_pil(d, n)),
    ("XPM", xpm.accept, lambda d, n, f: xpm.read_pil(d, n)),
    ("XVTHUMB", xvthumb.accept, xvthumb.read_pil),
)


def _iptc_inner(data: bytes, name: str) -> tuple:
    """IPTC's image data as PIL's `Image.open` of it opens it."""
    return _open(data, name)[1:]


# The readers whose `np.asarray` differs from the loaded image (io/icns.py,
# io/iptc.py), as `_open(asarray=True)` reads them.
_AS_ARRAY = {"ICNS": lambda d, n, f: icns.read_pil(d, n, f, _icns_png(n), rgba8, asarray=True),
             "IPTC": lambda d, n, f: iptc.read_pil(d, n, _iptc_inner, asarray=True)}


def _jpeg(data: bytes, name: str) -> tuple:
    arr = decode_jpeg(data, name)
    return arr, "L" if arr.ndim == 2 else ("RGB", "CMYK")[arr.shape[2] == 4], None


class Unidentified(ValueError):
    """No plugin of PIL's claims the file (PIL's UnidentifiedImageError)."""


def _open(data: bytes, name: str, from_file: bool = False, asarray: bool = False) -> tuple:
    """The image as PIL's `Image.open` opens it: (format, array, mode,
    palette, transparency), trying PIL's plugins in its order.  `from_file`:
    PIL reads a file from a path (True or raw.PATH: a real file, whose seek
    before its start a PCX reader refuses, and which PIL may map), or from a
    file object (raw.FILE_OBJECT: imageio's way, a real file but no map),
    not from memory.  `asarray`: the array as `np.asarray` of the
    opened image gives it, where that differs from the loaded image (an icns
    image not in RGBA, io/icns.py; IPTC image data of another size than its
    records', io/iptc.py)."""
    from_file = raw.PATH if from_file is True else int(from_file)
    for fmt, accept, read in _PLUGINS:
        if accept is not None and not accept(data if read is None else data[:16]):
            continue
        if read is None:
            raise ValueError(f"{name}: {_UNPORTED_NAMES[fmt]} images are not read (PIL's {fmt} plugin claims the "
                             f"file, and {_UNPORTED_WHY[fmt]}; the port reads {_READ})")
        try:
            out = (_AS_ARRAY.get(fmt, read) if asarray else read)(data, name, from_file)
        except probe.PassOn:
            continue
        return (fmt, *out) if len(out) == 4 else (fmt, *out, None)
    kind = next((f for magic, f in _OTHER_FORMATS if data.startswith(magic)), None)
    if kind:
        raise Unidentified(f"{name}: {kind} images are not read (PIL does not open them either)")
    raise Unidentified(f"{name}: a file of unknown format is not read (only {_READ})")


def _pil_image(data: bytes, name: str, from_file: bool = False, asarray: bool = False):
    """The image as PIL opens it: (array, mode, palette, transparency).
    The array is `np.asarray` of PIL's image; the palette is (256, 3), or
    (256, 4) for an RGBA palette (unlisted entries black), for modes "P" and
    "PA", None for other modes and a palette image without one; the
    transparency is PIL's `info` value (a gray level, an RGB triple) or, for
    a palette image, its entries' alphas as a PNG tRNS chunk gives them, or
    None."""
    return _open(data, name, from_file, asarray)[1:]


# Bits per pixel of PIL's raw packer for each mode: `np.asarray` of a PIL
# image goes through `tobytes`, whose encoder refuses a row wider than
# INT_MAX // bits - 7 pixels with a MemoryError.
_RAW_BITS = {"1": 1, "L": 8, "P": 8, "I;16": 16, "I;16L": 16, "I;16B": 16, "LA": 16, "PA": 16, "RGB": 24, "LAB": 24,
             "YCbCr": 24, "RGBA": 32,
             "CMYK": 32, "I": 32, "F": 32}


def _as_array_check(width: int, mode: str, name: str) -> None:
    bits = _RAW_BITS.get(mode, 32)
    if width > 0x7FFFFFFF // bits - 7:
        raise ValueError(f"{name}: a row of {width} {mode} pixels is more than PIL's tobytes (np.asarray) packs")


def _palette_colours(indices, table, trns) -> np.ndarray:
    """Palette indices (H, W) to RGB, or RGBA where the palette has alphas
    or a tRNS chunk gives the entries' alphas (entries past its end are
    opaque); a palette image without a palette is black, as PIL gives it."""
    if table is None:
        table = np.zeros((256, 3), np.uint8)
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


def _ycbcr_to_rgb(arr: np.ndarray) -> np.ndarray:
    """PIL's YCbCr -> RGB conversion (ConvertYCbCr.c) of (H, W, 3) uint8."""
    tab = jpeg2000._ycc_tables().astype(np.int32)
    y, cb, cr = (arr[..., k].astype(np.int32) for k in range(3))
    rgb = np.stack([y + (tab[cr] >> 6), y + ((tab[256 + cb] + tab[512 + cr]) >> 6), y + (tab[768 + cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def rgba8(arr: np.ndarray, mode: str, table, trns) -> np.ndarray:
    """PIL's `convert("RGBA")` of an image as (H, W, 4) uint8 (see
    decode_rgba)."""
    if mode == "P":  # the palette as 256 RGBA entries, then one lookup
        lut = _palette_colours(np.arange(256), table, trns)
        if lut.shape[1] == 3:
            lut = np.concatenate([lut, np.full((256, 1), 255, np.uint8)], axis=-1)
        return lut.astype(np.uint8)[arr]
    if mode == "PA":
        return np.concatenate([table[arr[..., 0]][..., :3], arr[..., 1:2]], axis=-1)
    if mode == "RGBA":
        return arr
    if mode == "LAB":  # LittleCMS's Lab -> sRGB; alpha is the image's pad byte, which a PSD leaves 0
        rgb = lab.to_rgb(arr)
        return np.concatenate([rgb, np.zeros(rgb.shape[:2] + (1,), np.uint8)], axis=-1)
    if mode == "CMYK":
        nk = 255 - arr[..., 3:4].astype(np.int32)
        rgb = np.clip(nk - _muldiv255(arr[..., :3], nk), 0, 255)
        return np.concatenate([rgb, np.full(arr.shape[:2] + (1,), 255)], axis=-1).astype(np.uint8)
    if mode == "YCbCr":
        arr = _ycbcr_to_rgb(arr)
    elif mode == "1":
        arr = arr.astype(np.uint8) * np.uint8(255)
    elif mode in ("I;16", "I;16L", "I;16B", "I"):
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
            if isinstance(trns, bytes):
                raise ValueError("a transparency key of bytes on an image of mode " + mode +
                                 " (PIL cannot convert it to RGBA)")
            key = np.atleast_1d(np.asarray(trns, np.int64)) & 0xFF
            rgba[..., 3][(rgba[..., : key.size] == key).all(axis=-1)] = 0
    return rgba


def decode_rgba(data: bytes, name: str = "image", from_file: bool = False) -> np.ndarray:
    """An image's bytes as (H, W, 4) float32 in [0, 1], expanded as PIL's
    `convert("RGBA")` expands each mode: gray g -> (g, g, g, 255) (16- and
    32-bit gray clipped to 0..255 first, float gray truncated), gray+alpha
    -> (g, g, g, a), RGB -> alpha 255, palette -> its entries with their
    alphas (a PNG's tRNS, a GIF's transparency index, a TIFF's alpha
    samples, the bytes of an XPM's transparent key), CMYK -> RGB by PIL's
    cmyk2rgb (255 - k - (255 - k) * c / 255, rounded), YCbCr -> RGB by
    PIL's tables; a pixel whose gray or RGB value equals the tRNS key's low
    bytes gets alpha 0; Lab -> sRGB as LittleCMS transforms it for PIL
    (io/lab.py), alpha 0 (PIL's pad byte, which its PSD reader leaves 0).
    `from_file`: the bytes are a file's
    that PIL opens by its path (a glTF image's URI), not from memory."""
    arr, mode, table, trns = _pil_image(data, name, from_file)
    _as_array_check(arr.shape[1], "RGBA", name)
    try:
        return _unit(rgba8(arr, mode, table, trns))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def decode_samples(data: bytes, name: str = "image", from_file: bool = False) -> np.ndarray:
    """An image's samples as imageio reads them through PIL: PIL's array, a
    palette image converted to its palette's colours (RGB, or RGBA for an
    RGBA palette).  imageio reads no PSD (its plugin cannot seek a PSD's
    first frame) and no palette image without a palette: both raise a
    ValueError, as imageio raises.  `from_file` as for _open (imageio hands
    PIL a file object, raw.FILE_OBJECT)."""
    fmt, arr, mode, table, _ = _open(data, name, from_file, asarray=True)
    if fmt == "PSD":
        raise ValueError(f"{name}: imageio reads no PSD file (its Pillow plugin cannot seek the first frame)")
    if fmt == "SPIDER":
        spider.read_pil(data, name, from_file, imageio=True)
    if fmt == "ICNS" and mode == "P":
        raise ValueError(f"{name}: imageio cannot convert an icns image of mode P (it has no palette of its own)")
    _as_array_check(arr.shape[1], ("RGBA" if table.shape[1] == 4 else "RGB") if mode == "P" and table is not None
                    else mode, name)
    if mode == "P":
        if table is None:
            raise ValueError(f"{name}: a palette image without a palette (imageio cannot convert it)")
        return table[arr]
    return arr


def load_png(path: str) -> np.ndarray:
    """The pixels of an image file, by its content, as float32 PIL array /
    255 (vpt_tpu's io/image.load_png): (H, W) for gray, 1-bit and palette
    images (palette indices), else (H, W, channels)."""
    with open(path, "rb") as f:
        arr, mode = _pil_image(f.read(), path, from_file=True, asarray=True)[:2]
    _as_array_check(arr.shape[1], mode, path)
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
