"""TIFF files as OpenCV 5.0's TiffDecoder (grfmt_tiff.cpp, over libtiff
4.7) reads their first page with `IMREAD_COLOR`.

OpenCV takes 1-, 8- and 16-bit samples, and 4-bit palette ones; for an
8-bit result every page goes through libtiff's RGBA reader
(TIFFReadRGBAStrip / Tile, `TIFFRGBAImageOK` first), whose conversions
this module copies:

- gray (min-is-black, or min-is-white inverted): 1 bit as 0 / 255, 8 bits
  as they are, 16 bits by their high byte; an alpha sample is dropped (a
  16-bit tile the right edge clips is walked as libtiff walks it,
  `_clipped_gray16`);
- RGB: 8 bits as they are, 16 bits as (x + 128) // 257; unassociated
  alpha premultiplies them, (c x a + 127) // 255 of the 8-bit values, then
  goes; associated or unused extra samples are dropped; contiguous or
  planar;
- palette (1, 4, 8 bits): a colour map whose entries are all below 256 is
  taken as 8-bit, else each entry's high byte;
- CMYK (8 bits): each of R, G, B = (255 - K) x (255 - C) // 255;
- YCbCr (8 bits, contiguous, subsampling 1x1 to 4x4): the data units of
  the subsampling (its luma samples, then Cb and Cr) through libtiff's
  TIFFYCbCrtoRGB, with its float32-built tables from the YCbCrCoefficients
  and ReferenceBlackWhite tags (or their defaults);
- JPEG-compressed 8-bit contiguous gray, RGB or YCbCr: each strip decoded
  by libjpeg after the JPEGTables stream (io/jpeg.decode_jpeg), YCbCr
  converted to RGB by libjpeg (libtiff's JPEGCOLORMODE_RGB), gray and RGB
  samples as they are (JCS_UNKNOWN).

Floating-point, 32- and 64-bit, 2-bit and 4-bit gray samples fail, as do
other photometric interpretations.  CIE Lab data and other JPEG-compressed
layouts, which OpenCV's libtiff reads, the port does not (ROADMAP "Not
ported"): they raise a ValueError that names them.  The Orientation
tag is applied as EXIF orientations are (exif.apply_orientation).  A
horizontal predictor is undone only under LZW and Deflate (libtiff's
predictor runs inside those codecs).  A strip that fails to decode is not
an error: its bytes decoded before the fault and zeros are converted (the
predictor not undone); an LZW code past the table stops the decode
there, as libtiff's does; a PackBits fault gives no bytes.  Strips or
tiles the offsets do not list decode as failed ones (as does an
uncompressed one cut short); one of no bytes or past the end of the file,
or missing offsets, fail the image; missing byte counts are estimated as
libtiff estimates them.  A palette image whose colour
map is missing reads, as libtiff's directory reader makes it, as gray (RGB
for 3 samples) at 8 bits or more.  An uncompressed strip cut short, a
single-valued tag (width, samples per pixel, rows per strip, ...) of
another count or a non-integer type, per-sample values that differ, a
bad sample format, planar configuration or extra sample, bits per sample
or a sample format whose values lie past the end of the file, a directory
cut short or of more than 4096 entries fails, as in libtiff.  The port reads no compression but
none, LZW, Deflate and PackBits; another one OpenCV's libtiff decodes
(JPEG, CCITT, ...) raises a ValueError naming it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from vpt_tpu_torch.io import codec, exif, tiff
from vpt_tpu_torch.io.jpeg import decode_jpeg

MAGIC = tiff.MAGIC
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1), 7: ("B", 1),
          8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}
# The codecs of OpenCV's libtiff that the port does not read.  A scheme
# libtiff does not know decodes nothing ("not implemented"): its strips read
# as failed ones, zeros.
_COMPRESSION_NAMES = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 6: "old JPEG", 7: "JPEG",
                      32771: "CCITT RLEW", 32809: "ThunderScan", 32766: "NeXT", 32908: "Pixar film",
                      32909: "Pixar log", 32947: "DCS", 34661: "JBIG", 34676: "SGILog", 34677: "SGILog24",
                      34887: "LERC", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 50002: "JPEG XL"}


_YCBCR_SUBSAMPLING = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
# Tags libtiff reads as one integer, failing the directory on another count
# or type (TIFFFetchNormalTag).
_SINGLE = (256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323, 332)
# The tags of this module libtiff's directory reader reads: another type fails it.
_KNOWN = _SINGLE + (258, 273, 279, 320, 324, 325, 338, 339, 347, 529, 530, 532)
_INTEGER = (1, 3, 4, 6, 8, 9, 16, 17)


def claims(sig: bytes) -> bool:
    return sig[:4] in MAGIC


class _Fail(Exception):
    pass


def _first_ifd(data: bytes) -> tuple:
    """(byte order, {tag: values}) of the first directory."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if big:
        if len(data) < 16:
            raise _Fail("BigTIFF header is cut short")
        (offset,) = struct.unpack_from(order + "Q", data, 8)
        count_fmt, entry, vsize = "Q", 20, 8
    else:
        if len(data) < 8:
            raise _Fail("TIFF header is cut short")
        (offset,) = struct.unpack_from(order + "I", data, 4)
        count_fmt, entry, vsize = "H", 12, 4
    head = struct.calcsize(count_fmt)
    if offset + head > len(data):
        raise _Fail("the first directory lies past the end of the file")
    (n,) = struct.unpack_from(order + count_fmt, data, offset)
    if n > 4096:
        raise _Fail("a directory of more than 4096 entries (libtiff's sanity check)")
    if offset + head + n * entry > len(data):
        raise _Fail("the first directory is cut short (libtiff: can not read TIFF directory)")
    tags = {}
    for i in range(n):
        e = offset + head + i * entry
        code, kind = struct.unpack_from(order + "HH", data, e)
        (count,) = struct.unpack_from(order + ("Q" if big else "I"), data, e + 4)
        if kind not in _TYPES or code in tags:
            if code in _KNOWN and code not in tags:
                raise _Fail(f"tag {code} of type {kind} (libtiff: incompatible type)")
            continue
        if code in _SINGLE and (count != 1 or kind not in _INTEGER):
            raise _Fail(f"tag {code} of type {kind} and count {count} (libtiff: incorrect count or type)")
        if code in (258, 338, 339) and kind not in _INTEGER:
            raise _Fail(f"tag {code} of type {kind} (libtiff: incompatible type)")
        fmt, size = _TYPES[kind]
        total = count * size
        if total <= vsize:
            at = e + 4 + vsize
        else:
            (at,) = struct.unpack_from(order + ("Q" if big else "I"), data, e + 4 + vsize)
            if at + total > len(data):
                if code in (258, 339):
                    raise _Fail(f"tag {code}'s values lie past the end of the file (libtiff: IO error)")
                continue  # (libtiff drops the tag)
        vals = struct.unpack_from(order + fmt[0] * (count * len(fmt)), data, at)
        if code in (258, 339) and len(set(vals)) > 1:
            raise _Fail(f"tag {code} differs between samples (libtiff: cannot handle different values per sample)")
        if (code == 339 and not 1 <= vals[0] <= 6) or (code == 284 and vals[0] not in (1, 2)) or (
                code == 338 and any(v > 2 for v in vals)):
            raise _Fail(f"tag {code} of value {vals[:4]} (libtiff: bad value)")
        tags[code] = vals
    return order, tags


def _one(tags: dict, code: int, default):
    v = tags.get(code)
    return default if not v else v[0]


def _decode(page, compression: int, raw: bytes, need: int) -> tuple:
    """(the bytes of a strip or tile libtiff's codec writes, whether it
    decoded whole).  libtiff's RGBA reader does not stop at a strip that
    fails to decode: it converts the buffer, the bytes decoded before the
    fault and zeros after them (and the predictor not undone)."""
    if compression == 1:  # (cut short, DumpModeDecode copies nothing)
        return (np.frombuffer(raw, np.uint8), True) if len(raw) >= need else (np.zeros(0, np.uint8), False)
    if compression not in (5, 8, 32946, 32773):
        return np.zeros(0, np.uint8), False
    if compression in (8, 32946):
        d = zlib.decompressobj()
        try:
            out = d.decompress(raw, need)
            return np.frombuffer(out, np.uint8), len(out) >= need
        except zlib.error:
            d, parts = zlib.decompressobj(), []
            try:
                for i in range(len(raw)):
                    parts.append(d.decompress(raw[i : i + 1]))
            except zlib.error:
                pass
            return np.frombuffer(b"".join(parts)[:need], np.uint8), False
    if compression == 5:
        try:
            dec, complete = codec.tiff_lzw(raw, need, partial=True)
        except ValueError:
            return np.zeros(0, np.uint8), False
        return dec, complete and dec.size >= need
    try:
        dec = tiff._decompress(page, raw, None)
    except ValueError:
        return np.zeros(0, np.uint8), False
    return dec, dec.size >= need


def _jpeg_rgb(raw: bytes, tags: dict, rows: int, width: int, contig: int) -> np.ndarray:
    """A JPEG-compressed strip or tile as libtiff's JPEG codec gives it to
    the RGBA reader, the JPEGTables stream read first: YCbCr through
    libjpeg's own YCbCr -> RGB (JPEGCOLORMODE_RGB), gray and RGB as their
    samples (JCS_UNKNOWN); zeros where libjpeg fails or the image is not the
    strip's size."""
    tables = bytes(tags.get(347, ()))
    stream = tables[:-2] + raw[2:] if tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8" else raw
    try:
        img = decode_jpeg(stream, "strip", stdio=True, color="ycc" if _one(tags, 262, None) == 6 else "raw")
    except ValueError:
        img = None
    if img is not None and img.ndim == 2:
        img = img[..., None]
    if img is None or img.shape != (rows, width, contig):
        return np.zeros((rows, width, contig), np.uint8)
    return img


def _clipped_gray16(seg: np.ndarray, npix: int) -> np.ndarray:
    """A 16-bit gray tile (rows, tw, samples) that the image's right edge
    clips, as libtiff's put16bitbwtile walks its native-endian buffer: it
    skips the tile's (tw - npix) unused pixels as that many bytes, not
    samples, so each row after the first starts short of its place."""
    rows, tw, contig = seg.shape
    raw = np.ascontiguousarray(seg, "<u2").view(np.uint8).reshape(-1)
    out = np.zeros_like(seg)
    for r in range(rows):
        at = r * (npix * 2 * contig + (tw - npix))
        out[r, :npix] = raw[at : at + npix * 2 * contig].view("<u2").reshape(npix, contig)
    return out


def _subsampling(tags: dict):
    """The YCbCr subsampling of 8-bit 3-sample contiguous YCbCr data (libtiff's
    default 2 x 2), or None."""
    if _one(tags, 262, None) != 6 or _one(tags, 258, 1) != 8 or _one(tags, 277, 1) != 3 or _one(tags, 284, 1) != 1:
        return None
    sub = tags.get(530, (2, 2))
    return (sub[0], sub[1]) if len(sub) >= 2 else (2, 2)


def _units(buf: np.ndarray, rows: int, width: int, sub: tuple) -> np.ndarray:
    """A strip of YCbCr data units as (rows, width, 3) Y, Cb, Cr samples:
    each pixel its unit's luma sample and the unit's chroma."""
    sh, sv = sub
    ur, uc = -(-rows // sv), -(-width // sh)
    u = buf.reshape(ur, uc, sh * sv + 2)
    luma = u[..., : sh * sv].reshape(ur, uc, sv, sh).transpose(0, 2, 1, 3).reshape(ur * sv, uc * sh)
    cb = np.repeat(np.repeat(u[..., -2], sv, 0), sh, 1)
    cr = np.repeat(np.repeat(u[..., -1], sv, 0), sh, 1)
    return np.stack([luma, cb, cr], -1)[:rows, :width]


def _ycbcr_rgb(ycc: np.ndarray, tags: dict) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit tables and TIFFYCbCrtoRGB (float32 set-up,
    16-bit fixed-point conversion)."""
    f32 = np.float32
    luma = tags.get(529)
    luma = [f32(n / d) if d else f32("nan") for n, d in zip(luma[0::2], luma[1::2])] if luma and len(luma) >= 6 \
        else [f32(0.299), f32(0.587), f32(0.114)]
    rbw = tags.get(532)
    rbw = [f32(n / d) if d else f32("nan") for n, d in zip(rbw[0::2], rbw[1::2])] if rbw and len(rbw) >= 12 \
        else [f32(v) for v in (0, 255, 128, 255, 128, 255)]
    if not all(np.isfinite(v) for v in luma + rbw) or luma[1] == 0 or luma[2] == 0 or rbw[0] == rbw[1] \
            or rbw[2] == rbw[3] or rbw[4] == rbw[5]:
        raise _Fail("invalid YCbCrCoefficients or ReferenceBlackWhite values")

    def fix(x):  # FIX(CLAMP(x, 0, 2)): (int32)(x * 65536 + 0.5), the product in float
        return int(np.float64(np.float32(min(max(x, f32(0)), f32(2))) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * luma[0]
    f2 = luma[0] * f1 / luma[1]
    f3 = f32(2) - f32(2) * luma[2]
    f4 = luma[2] * f3 / luma[1]
    d1, d2, d3, d4 = fix(f1), -fix(f2), fix(f3), -fix(f4)
    x = np.arange(256, dtype=np.int64) - 128

    def code2v(c, rb, rw, cr):
        v = (np.asarray(c - int(rb), np.float32) * f32(cr)) / f32(rw - rb if rw - rb != 0 else 1)
        return np.clip(v, f32(-128 * 32), f32(128 * 32)).astype(np.int64)  # CLAMPw, then truncation

    cr_v = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb_v = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    cr_r = (d1 * cr_v + (1 << 15)) >> 16
    cb_b = (d3 * cb_v + (1 << 15)) >> 16
    cr_g = d2 * cr_v
    cb_g = d4 * cb_v + (1 << 15)
    y_tab = code2v(x + 128, rbw[0], rbw[1], 255)
    y, cb, cr = (ycc[..., i].astype(np.int64) for i in range(3))
    yv = y_tab[np.minimum(y, 255)]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _strip_data(data: bytes, tags: dict, name: str) -> tuple:
    """((H, W, samples) of the page as libtiff's codecs decode it: 8- or
    16-bit integers, 1- and 4-bit values; YCbCr data as Y, Cb, Cr per
    pixel; JPEG data as libjpeg's output, bits)."""
    width, length = _one(tags, 256, 0), _one(tags, 257, 0)
    bits = _one(tags, 258, 1)
    spp = _one(tags, 277, 1)
    planar = _one(tags, 284, 1)
    compression = _one(tags, 259, 1)
    predictor = _one(tags, 317, 1)
    fillorder = _one(tags, 266, 1)
    tiled = 322 in tags and 323 in tags
    jpeg = compression == 7 and bits == 8 and planar == 1 and _one(tags, 262, None) in (1, 2, 6)
    if compression in _COMPRESSION_NAMES and not jpeg:
        raise ValueError(f"{name}: TIFF compression {_COMPRESSION_NAMES.get(compression, compression)}, which "
                         f"OpenCV's libtiff may decode and the port does not read")
    if tiled:
        tw, tl = _one(tags, 322, 0), _one(tags, 323, 0)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        tw, tl = width, min(_one(tags, 278, length) or length, length)
        offsets, counts = tags.get(273), tags.get(279)
    if tw <= 0 or tl <= 0:
        raise _Fail("strips or tiles of no size")
    if not offsets:
        raise _Fail("no strip or tile offsets (libtiff: missing required tag)")
    if not counts:  # libtiff's EstimateStripByteCounts
        if compression == 1:
            counts = ((tl if tiled else min(tl, length)) * ((tw * spp * bits + 7) // 8 if planar == 1 else
                                                             (tw * bits + 7) // 8),) * len(offsets)
        else:
            ends = sorted(set(offsets) | {len(data)})
            counts = tuple(max(next((e for e in ends if e > o), len(data)) - o, 0) for o in offsets)
    planes = spp if planar == 2 else 1
    contig = spp if planar == 1 else 1
    nx, ny = -(-width // tw), -(-length // tl)
    missing = max(nx * ny * planes - min(len(offsets), len(counts)), 0)  # (libtiff reads them as failed strips)
    offsets, counts = tuple(offsets) + (None,) * missing, tuple(counts) + (None,) * missing
    dtype = np.dtype((">" if tags["order"] == ">" else "<") + ("u2" if bits == 16 else "u1"))
    row_bytes = (tw * contig * bits + 7) // 8
    sub = None if jpeg else _subsampling(tags)
    if sub is not None:  # a row of YCbCr data units: h x v luma samples each, then Cb and Cr
        row_bytes = -(-tw // sub[0]) * (sub[0] * sub[1] + 2)
    out = np.zeros((planes, ny * tl, nx * tw, contig), np.uint16 if bits == 16 else np.uint8)
    page = tiff._Page(data, tags["order"], {"compression": (compression,)}, name)
    for i in range(nx * ny * planes):
        pl, rest = divmod(i, nx * ny)
        ty, tx = divmod(rest, nx)
        rows = tl if tiled else min(tl, length - ty * tl)
        need = (-(-rows // sub[1]) if sub else rows) * row_bytes
        at, n = offsets[i], counts[i]
        if at is None or n is None:
            continue
        if n == 0 or at + n > len(data):
            raise _Fail("a strip or tile of no bytes or past the end of the file (libtiff: read error)")
        raw = data[at : at + n]
        if fillorder == 2:
            raw = tiff._REVERSE_BITS[np.frombuffer(raw, np.uint8)].tobytes()
        if jpeg:
            out[pl, ty * tl : ty * tl + rows, tx * tw : (tx + 1) * tw] = _jpeg_rgb(raw, tags, rows, tw, contig)
            continue
        dec, whole = _decode(page, compression, raw, need)
        buf = np.zeros(need, np.uint8)
        buf[: min(dec.size, need)] = dec[:need]
        if sub is not None:
            out[pl, ty * tl : ty * tl + rows, tx * tw : (tx + 1) * tw] = _units(buf, rows, tw, sub)
            continue
        seg = buf.reshape(rows, row_bytes)
        if bits == 16:
            seg = seg.view(dtype).astype(np.uint16).reshape(rows, tw * contig)
        elif bits < 8:
            vals = np.unpackbits(seg, axis=1).reshape(rows, -1, bits)
            seg = (vals << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(-1).astype(np.uint8)[:, : tw * contig]
        seg = seg.reshape(rows, tw, contig)
        if predictor == 2 and compression in (5, 8, 32946) and whole:
            seg = np.cumsum(seg.astype(np.int64), axis=1).astype(seg.dtype)
        npix = width - tx * tw
        if bits == 16 and tiled and npix < tw and _one(tags, 262, None) in (0, 1):
            seg = _clipped_gray16(seg, npix)
        out[pl, ty * tl : ty * tl + rows, tx * tw : (tx + 1) * tw] = seg
    out = out[:, :length, :width]
    return (out[0] if planes == 1 else np.concatenate(list(out), axis=-1)), bits


def read(data: bytes, name: str) -> tuple:
    """The first page as (H, W, 3) uint8 RGB, oriented, and no EXIF."""
    try:
        order, tags = _first_ifd(data)
        tags["order"] = order
        return _read(data, tags, name), None
    except (_Fail, struct.error) as e:
        raise ValueError(f"{name}: TIFF that OpenCV does not read ({e})") from None


def _read(data: bytes, tags: dict, name: str) -> np.ndarray:
    width, length = _one(tags, 256, 0), _one(tags, 257, 0)
    bits = _one(tags, 258, 1)
    spp = _one(tags, 277, 1)
    extra = tags.get(338, ())
    fmt = _one(tags, 339, 1)
    if width <= 0 or length <= 0:
        raise _Fail("an image of no size")
    photometric = _one(tags, 262, None)
    colors = spp - len(extra)
    if photometric is None:
        raise _Fail("no PhotometricInterpretation tag (OpenCV asks libtiff for it)")
    if photometric == 3 and len(tags.get(320, ())) != 3 << bits:  # libtiff's TIFFReadDirectory
        if bits < 8:
            raise _Fail("a palette image without its colour map")
        photometric = 2 if spp == 3 else 1
    if not (bits in (1, 8, 16) or (bits == 4 and photometric == 3)):
        raise _Fail(f"{bits}-bit samples")
    if fmt == 3:
        raise _Fail("floating-point samples")
    if photometric in (0, 1):
        if _one(tags, 284, 1) == 1 and spp != 1 and bits < 8:
            raise _Fail("contiguous gray data of several samples under 8 bits")
    elif photometric == 2:
        if colors < 3:
            raise _Fail("RGB of fewer than 3 colour channels")
    elif photometric == 3:
        if _one(tags, 284, 1) == 1 and spp != 1 and bits < 8:
            raise _Fail("contiguous palette data of several samples under 8 bits")
    elif photometric == 5:
        if _one(tags, 332, 1) != 1 or spp < 4 or bits != 8:
            raise _Fail("separated data that is not 8-bit CMYK")
    elif photometric == 6 and _one(tags, 259, 1) == 7:
        if _subsampling(tags) is None:
            raise _Fail("JPEG-compressed YCbCr data other than 8-bit contiguous 3 samples")
        photometric = 2  # (libtiff's RGBA reader has libjpeg convert it)
    elif photometric == 6:
        if _subsampling(tags) is None or _subsampling(tags) not in _YCBCR_SUBSAMPLING:
            raise _Fail("YCbCr data other than 8-bit contiguous 3 samples at subsampling 1, 2 or 4")
    else:
        if photometric == 8:
            raise ValueError(f"{name}: CIE Lab TIFF data, which OpenCV's libtiff converts and the port does not read")
        raise _Fail(f"photometric interpretation {photometric}")
    codec.check_cv_size(width, length, name)
    px, bits = _strip_data(data, tags, name)
    if photometric in (0, 1):
        v = px[..., 0]
        if bits == 16:
            v = v >> 8
        elif bits == 1:
            v = v * 255
        v = v.astype(np.uint8)
        if photometric == 0:
            v = 255 - v
        rgb = np.repeat(v[..., None], 3, axis=-1)
    elif photometric == 2:
        c = px.astype(np.int64)
        if bits == 16:
            c = (c + 128) // 257
        rgb = c[..., :3]
        if extra and extra[0] == 2 and spp > 3:
            rgb = (rgb * c[..., 3:4] + 127) // 255
        rgb = rgb.astype(np.uint8)
    elif photometric == 3:
        n = 1 << bits
        cmap = np.asarray(tags[320][: 3 * n], np.int64).reshape(3, n)
        if cmap.max(initial=0) >= 256:
            cmap = cmap >> 8
        rgb = cmap[:, px[..., 0]].transpose(1, 2, 0).astype(np.uint8)
    elif photometric == 5:
        c = px.astype(np.int64)
        k = 255 - c[..., 3:4]
        rgb = (k * (255 - c[..., :3]) // 255).astype(np.uint8)
    else:
        rgb = _ycbcr_rgb(px, tags)
    return exif.apply_orientation(rgb, _one(tags, 274, 1))
