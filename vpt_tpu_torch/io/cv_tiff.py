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

- CIE L*a*b* (8 or 16 bits, 3 contiguous samples): libtiff's float32
  conversion through XYZ and the sRGB display's gamma tables
  (`_cielab_rgb`, equal to OpenCV's on all 2**24 8-bit inputs).

Floating-point, 32- and 64-bit, 2-bit and 4-bit gray samples fail, as do
other photometric interpretations.  Other JPEG-compressed layouts, which
OpenCV's libtiff reads, the port does not (ROADMAP "Not ported"): they
raise a ValueError that names them.  The Orientation
tag is applied as EXIF orientations are (exif.apply_orientation).  A
horizontal predictor is undone only under LZW and Deflate (libtiff's
predictor runs inside those codecs).  A strip that fails to decode is not
an error: its bytes decoded before the fault and zeros are converted (the
predictor not undone); an LZW code past the table stops the decode
there, as libtiff's does; PackBits runs are cut at the strip's end and a
literal run the data cannot fill is dropped, as libtiff's decoder does.  Strips or
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
# Tags libtiff reads as one integer (TIFFFetchNormalTag): those of _STRICT
# fail the directory on another count or type, the others it drops (it reads
# them with recovery).
_SINGLE = (256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323, 332)
# The tags of this module libtiff's directory reader reads without recovery:
# a type it cannot read fails it; it drops the others' unreadable entries.
_STRICT = (256, 257, 259, 277, 278, 284, 322, 323, 258, 273, 279, 324, 325, 338, 339)
_INTEGER = (1, 3, 4, 6, 8, 9, 16, 17)
_STRILE = (273, 279, 324, 325)  # strip and tile offsets and byte counts


def claims(sig: bytes) -> bool:
    return sig[:4] in MAGIC


class _Fail(Exception):
    pass


def _first_ifd(data: bytes) -> tuple:
    """(byte order, {tag: values}, the next directory's offset) of the
    first directory."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if big:
        if len(data) < 16:
            raise _Fail("BigTIFF header is cut short")
        (offset,) = struct.unpack_from(order + "Q", data, 8)
    else:
        if len(data) < 8:
            raise _Fail("TIFF header is cut short")
        (offset,) = struct.unpack_from(order + "I", data, 4)
    return (order, *_ifd(data, order, big, offset))


def _ifd(data: bytes, order: str, big: bool, offset: int) -> tuple:
    """({tag: values}, the next directory's offset, 0 for none) of the
    directory at `offset`, as libtiff's TIFFReadDirectory reads it (raising
    _Fail where it fails)."""
    count_fmt, entry, vsize = ("Q", 20, 8) if big else ("H", 12, 4)
    head = struct.calcsize(count_fmt)
    if offset + head > len(data):
        raise _Fail("the first directory lies past the end of the file")
    (n,) = struct.unpack_from(order + count_fmt, data, offset)
    if n > 4096:
        raise _Fail("a directory of more than 4096 entries (libtiff's sanity check)")
    if offset + head + n * entry > len(data):
        raise _Fail("the first directory is cut short (libtiff: can not read TIFF directory)")
    end = offset + head + n * entry
    nxt = struct.unpack_from(order + ("Q" if big else "I"), data, end)[0] if end + vsize <= len(data) else 0
    tags = {"entries": []}
    for i in range(n):
        e = offset + head + i * entry
        code, kind = struct.unpack_from(order + "HH", data, e)
        (count,) = struct.unpack_from(order + ("Q" if big else "I"), data, e + 4)
        tags["entries"].append((kind, count))
        if kind not in _TYPES or code in tags:
            if code in _STRICT and code not in tags:
                raise _Fail(f"tag {code} of type {kind} (libtiff: incompatible type)")
            continue
        if code in _SINGLE and (count != 1 or kind not in _INTEGER):
            if code in _STRICT:
                raise _Fail(f"tag {code} of type {kind} and count {count} (libtiff: incorrect count or type)")
            continue
        if code in (258, 338, 339) and kind not in _INTEGER:
            raise _Fail(f"tag {code} of type {kind} (libtiff: incompatible type)")
        if code in _STRILE:  # read when the strips are known (_strile)
            tags[code] = (kind, count, e)
            continue
        fmt, size = _TYPES[kind]
        total = count * size
        if total <= vsize:
            at = e + 4 + vsize
        else:
            (at,) = struct.unpack_from(order + ("Q" if big else "I"), data, e + 4 + vsize)
            if at + total > len(data):
                if code in (258, 338, 339):
                    raise _Fail(f"tag {code}'s values lie past the end of the file (libtiff: IO error)")
                continue  # (libtiff drops the tag)
        vals = struct.unpack_from(order + fmt[0] * (count * len(fmt)), data, at)
        if (code == 339 and not 1 <= vals[0] <= 6) or (code == 284 and vals[0] not in (1, 2)) or (
                code == 338 and any(v > 2 for v in vals)):
            raise _Fail(f"tag {code} of value {vals[:4]} (libtiff: bad value)")
        tags[code] = vals
    spp = _one(tags, 277, 1)
    for code in (258, 339):  # TIFFReadDirEntryPersampleShort: one value, or one per sample (the first spp equal)
        vals = tags.get(code, ())
        if len(vals) > 1 and (len(vals) < spp or len(set(vals[:spp])) > 1):
            raise _Fail(f"tag {code} of {len(vals)} values for {spp} samples (libtiff: per-sample values)")
    return tags, nxt


def _byte_counts(data: bytes, tags: dict, offsets: tuple, counts, tiled: bool, unit: int, est_rows: int,
                 planar: int, spp: int, compression: int) -> tuple:
    """The byte counts libtiff's directory reader settles on: the tag's, or
    its estimate (EstimateStripByteCounts) where the tag is missing (a
    single strip, or one per plane, only), bogus for a single strip
    (ByteCountLooksBad) or, uncompressed, differs between the first two of
    more than two contiguous strips.  `unit`: a tile's bytes, or a row's;
    `est_rows`: the rows per strip the estimate takes."""
    n = len(offsets)
    size = len(data)
    if counts is None:
        if (planar == 1 and n > 1) or (planar == 2 and n != spp):
            raise _Fail("no strip byte counts for several strips (libtiff: missing required tag)")
    elif n == 1 and not tiled:
        off, cnt = offsets[0], counts[0]
        bad = off != 0 and (cnt == 0 or (compression == 1 and (off <= size and cnt > size - off or
                                                             cnt < unit * _one(tags, 257, 0))))
        if not bad:
            return counts
    elif not (planar == 1 and n > 2 and compression == 1 and counts[0] != counts[1] and counts[0] and counts[1]):
        return counts
    if compression != 1:
        big = data[2:4] in (b"+\0", b"\0+")
        entries = tags["entries"]
        space = (16 + 8 + 20 * len(entries) + 8) if big else (8 + 2 + 12 * len(entries) + 4)
        for kind, count in entries:
            if kind not in _TYPES:
                raise _Fail(f"a tag of unknown type {kind} (libtiff cannot estimate the strip byte counts)")
            total = _TYPES[kind][1] * count
            space += total if total > (8 if big else 4) else 0
        space = size if size < space else size - space
        if planar == 2:
            space //= spp
        est = [space] * n
        if offsets[-1] + space > size:
            est[-1] = 0 if offsets[-1] >= size else size - offsets[-1]
        return tuple(est)
    return (unit if tiled else unit * est_rows,) * n


def _check_tiles(tags: dict, width: int, length: int, spp: int, bits: int) -> None:
    """OpenCV's checks of the tile or strip it reads at a time
    (TiffDecoder::readData): the tag's raw rows per strip (0 and 2**32 - 1
    meaning the image's height) or tile size, as int, in 1..2**24, and the
    tile's bytes under 1 GiB."""
    if 322 in tags and 323 in tags:
        tw, th = _one(tags, 322, 0) or width, _one(tags, 323, 0)
    else:
        tw, th = width, _one(tags, 278, 0xFFFFFFFF)
        th = length if th == 0xFFFFFFFF else th
    th = th or length
    as_int = [v - (1 << 32) if v >= 1 << 31 else v for v in (tw, th)]
    if not all(0 < v <= 1 << 24 for v in as_int) or tw * th * spp * max(1, bits // 8) >= 1 << 30:
        raise _Fail(f"tiles or strips of {tw}x{th} pixels (OpenCV's tile checks)")


def _strile(data: bytes, tags: dict, code: int, n: int):
    """A strip or tile offset or byte count array as libtiff reads it for n
    strips (TIFFFetchStripThing): its first min(count, n) values, inline
    where the tag's whole array would fit its entry, padded with zeros to
    n; None without the tag.  An array libtiff cannot read (past the end of
    the file, a type it does not convert, a negative value) fails."""
    if code not in tags:
        return None
    kind, count, e = tags[code]
    big = data[2:4] in (b"+\0", b"\0+")
    order, vsize = tags["order"], 8 if big else 4
    if kind not in _INTEGER + (13, 18):
        raise _Fail(f"tag {code} of type {kind} (libtiff: cannot read it as an array of integers)")
    fmt, size = _TYPES[kind]
    m = min(count, n)
    vals = ()
    if m:
        if min(count, 10) * size <= vsize:
            at = e + 4 + vsize
        else:
            (at,) = struct.unpack_from(order + ("Q" if big else "I"), data, e + 4 + vsize)
        if at + m * size > len(data):
            raise _Fail(f"tag {code}'s values lie past the end of the file (libtiff: IO error)")
        vals = struct.unpack_from(order + fmt * m, data, at)
        if min(vals) < 0:
            raise _Fail(f"tag {code} holds a negative value (libtiff: bad value)")
    return tuple(vals) + (0,) * (n - m)


def _next_page(data: bytes, order: str, first: int, nxt: int) -> None:
    """OpenCV's `imreadmulti` reads the next page's header after the first
    page's pixels (TiffDecoder::nextPage): where libtiff reads that
    directory but it holds no PhotometricInterpretation, OpenCV's header
    reader throws and the whole read fails; a directory libtiff cannot read
    (or one it has read, a loop) just ends the pages."""
    if not nxt or nxt == first:
        return
    try:
        tags, _ = _ifd(data, order, data[2:4] in (b"+\0", b"\0+"), nxt)
    except (_Fail, struct.error):
        return
    if 262 not in tags:
        raise _Fail("the second page has no PhotometricInterpretation tag (OpenCV's nextPage throws reading it)")


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
    dec = codec.packbits_libtiff(raw, need)
    return dec, dec.size >= need


def _tables_prefix(tables: bytes) -> bytes:
    """What libjpeg keeps of the JPEGTables stream, which libtiff reads on
    its own before each strip (tables only): SOI and the whole marker
    segments up to EOI or the data's end (garbage between them skipped, a
    segment cut short dropped), as the head of the strip's stream.  Tables
    that do not start with SOI or hold a frame or scan fail the image
    (libtiff: "Bogus JPEGTables field")."""
    if not tables:
        return b"\xff\xd8"
    if tables[:2] != b"\xff\xd8":
        raise _Fail("JPEG tables that do not start with SOI (libtiff: bogus JPEGTables field)")
    pos, out = 2, [b"\xff\xd8"]
    while True:
        pos = tables.find(b"\xff", pos)
        while 0 <= pos < len(tables) - 1 and tables[pos + 1] == 0xFF:
            pos += 1
        if pos < 0 or pos + 1 >= len(tables):
            break
        marker = tables[pos + 1]
        if marker == 0xD9:
            break
        if marker == 0x00 or 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC) or marker == 0xDA:
            raise _Fail("JPEG tables holding a frame or scan (libtiff: bogus JPEGTables field)")
        if pos + 4 > len(tables):
            break
        end = pos + 2 + struct.unpack_from(">H", tables, pos + 2)[0]
        if end > len(tables):
            break
        out.append(tables[pos:end])
        pos = end
    return b"".join(out)


def _jpeg_rgb(raw: bytes, tags: dict, rows: int, width: int, contig: int, last: bool) -> np.ndarray:
    """A JPEG-compressed strip or tile as libtiff's JPEG codec gives it to
    the RGBA reader, the JPEGTables stream read first: YCbCr through
    libjpeg's own YCbCr -> RGB (JPEGCOLORMODE_RGB), gray and RGB as their
    samples (JCS_UNKNOWN).  What libjpeg refuses before the scan data
    (JPEGPreDecode: the header, the tables, the first scan's set-up), a
    stream larger than the strip (but for the last strip's rows) or of
    another component count fails the image, as libtiff fails the strip
    before the RGBA reader has its buffer; a smaller one gives zeros."""
    stream = _tables_prefix(bytes(tags.get(347, ()))) + raw[2:] if raw[:2] == b"\xff\xd8" else raw
    try:
        img = decode_jpeg(stream, "strip", stdio=True, color="ycc" if _one(tags, 262, None) == 6 else "raw")
    except ValueError as e:
        raise _Fail(f"libjpeg refuses a strip or tile ({e})") from None
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c != contig:
        raise _Fail("a JPEG strip or tile of another component count (libtiff: improper JPEG component count)")
    if w == width and h > rows and last:
        img, h = img[:rows], rows
    if w > width or h > rows:
        raise _Fail("a JPEG strip or tile larger than its place (libtiff: exceeds expected dimensions)")
    if (h, w) != (rows, width):
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
    else:
        tw, tl = width, min(_one(tags, 278, length) or length, length)
    if tw <= 0 or tl <= 0:
        raise _Fail("strips or tiles of no size")
    planes = spp if planar == 2 else 1
    contig = spp if planar == 1 else 1
    nx, ny = -(-width // tw), -(-length // tl)
    nstrips = nx * ny * planes
    # Strip and tile tags fill the same arrays in libtiff: the later entry wins.
    ocode = max((c for c in (273, 324) if c in tags), key=lambda c: tags[c][2], default=None)
    ccode = max((c for c in (279, 325) if c in tags), key=lambda c: tags[c][2], default=None)
    if ocode is None:
        raise _Fail("no strip or tile offsets (libtiff: missing required tag)")
    offsets = _strile(data, tags, ocode, nstrips)
    counts = None if ccode is None else _strile(data, tags, ccode, nstrips)
    row_bytes = (tw * contig * bits + 7) // 8
    scanline = row_bytes  # libtiff's TIFFScanlineSize (or a tile's row)
    ycc = _subsampling(tags)
    if ycc is not None:  # a scanline's share of a row of YCbCr data units
        scanline = -(-tw // ycc[0]) * (ycc[0] * ycc[1] + 2) // ycc[1]
    counts = _byte_counts(data, tags, offsets, counts, tiled, scanline * (tl if tiled else 1), length // ny,
                          planar, spp, compression)
    dtype = np.dtype((">" if tags["order"] == ">" else "<") + ("u2" if bits == 16 else "u1"))
    sub = None if jpeg else ycc
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
        if n == 0 or at + n > len(data):  # (a later plane's strip fails after the reader has its buffer: zeros)
            if pl:
                continue
            raise _Fail("a strip or tile of no bytes or past the end of the file (libtiff: read error)")
        raw = data[at : at + n]
        if fillorder == 2:
            raw = tiff._REVERSE_BITS[np.frombuffer(raw, np.uint8)].tobytes()
        if jpeg:
            out[pl, ty * tl : ty * tl + rows, tx * tw : (tx + 1) * tw] = _jpeg_rgb(
                raw, tags, rows, tw, contig, not tiled and ty == ny - 1)
            continue
        dec, whole = _decode(page, compression, raw, need)
        buf = np.zeros(need, np.uint8)
        buf[: min(dec.size, need)] = dec[:need]
        if sub is not None:
            out[pl, ty * tl : ty * tl + rows, tx * tw : (tx + 1) * tw] = _units(buf, rows, tw, sub)
            continue
        seg = buf.reshape(rows, row_bytes)
        if bits == 16:  # (libtiff swaps a big-endian file's words after a whole decode only)
            seg = seg.view(dtype if whole else "<u2").astype(np.uint16).reshape(rows, tw * contig)
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
        order, tags, nxt = _first_ifd(data)
        tags["order"] = order
        rgb = _read(data, tags, name)
        big = data[2:4] in (b"+\0", b"\0+")
        _next_page(data, order, struct.unpack_from(order + ("Q" if big else "I"), data, 8 if big else 4)[0], nxt)
        return rgb, None
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
        if bits not in (8, 16):  # (libtiff's RGBA reader has no routine for it)
            raise _Fail(f"{bits}-bit RGB")
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
    elif photometric == 8:
        if spp != 3 or colors != 3 or bits not in (8, 16) or _one(tags, 284, 1) != 1:
            raise _Fail("CIE Lab data that is not 3 contiguous 8- or 16-bit samples")
    else:
        raise _Fail(f"photometric interpretation {photometric}")
    codec.check_cv_size(width, length, name)
    _check_tiles(tags, width, length, spp, bits)
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
    elif photometric == 8:
        rgb = _cielab_rgb(px, bits, tags.get(318))
    else:
        rgb = _ycbcr_rgb(px, tags)
    return exif.apply_orientation(rgb, _one(tags, 274, 1))


_LAB_TABLE = None


def _cielab_rgb(px: np.ndarray, bits: int, white) -> np.ndarray:
    """CIE L*a*b* samples to RGB as libtiff's RGBA reader converts them
    (tif_color.c in float32, as initCIELabConversion sets it up): L*a*b* to
    XYZ against the WhitePoint tag (CIE D50 without it), XYZ to the sRGB
    display's luminances, each through the 1,501-entry gamma 2.4 table."""
    global _LAB_TABLE
    f32 = np.float32
    if _LAB_TABLE is None:
        i = np.arange(1501, dtype=np.float64)
        _LAB_TABLE = (f32(255) * np.power(i / 1500, 1.0 / float(f32(2.4))).astype(f32)).astype(f32)
    if white is not None and len(white) == 4:  # one RATIONAL pair each, as floats
        white = tuple(f32(0) if d == 0 else f32(n) / f32(d) for n, d in (white[:2], white[2:]))
    else:
        s = f32(f32(96.425) + f32(100.0)) + f32(82.468)
        white = (f32(96.425) / s, f32(100.0) / s)
    wx, wy = white
    if wy == 0:
        raise _Fail("a WhitePoint of y 0 (libtiff: invalid value)")
    y0 = f32(100.0)
    x0, z0 = wx / wy * y0, (f32(1.0) - wx - wy) / wy * y0
    if bits == 8:
        lv = (px[..., 0].astype(np.uint32) * 257).astype(f32)
        av = (px[..., 1].astype(np.uint8).view(np.int8).astype(np.int32) * 256).astype(f32)
        bv = (px[..., 2].astype(np.uint8).view(np.int8).astype(np.int32) * 256).astype(f32)
    else:
        lv = px[..., 0].astype(f32)
        av, bv = (px[..., k].astype(np.uint16).view(np.int16).astype(f32) for k in (1, 2))
    lum = lv * f32(100.0) / f32(65535.0)
    small = lum < f32(8.856)
    y_small = lum * y0 / f32(903.292)
    cby = np.where(small, f32(7.787) * (y_small / y0) + f32(16.0) / f32(116.0), (lum + f32(16.0)) / f32(116.0))
    y = np.where(small, y_small, y0 * cby * cby * cby).astype(f32)

    def axis(t, w0):
        return np.where(t < f32(0.2069), w0 * (t - f32(0.13793)) / f32(7.787), w0 * t * t * t).astype(f32)

    x = axis(av / f32(256.0) / f32(500.0) + cby, x0)
    z = axis(cby - bv / f32(256.0) / f32(200.0), z0)
    step = f32(99.0) / f32(1500)
    out = []
    for row in ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416), (0.0556, -0.2040, 1.0570)):
        m = [f32(v) for v in row]
        lin = np.clip((m[0] * x + m[1] * y) + m[2] * z, f32(1.0), f32(100.0)).astype(f32)
        idx = np.minimum(((lin - f32(1.0)) / step).astype(np.int64), 1500)
        out.append(np.minimum(np.floor(_LAB_TABLE[idx].astype(np.float64) + 0.5), 255))
    return np.stack(out, -1).astype(np.uint8)
