"""TIFF decoding (TIFF 6.0, BigTIFF) to the arrays that imageio and PIL give.

One parser, two results, because the JAX package reads a TIFF two ways:

- `read_array` is what imageio's bundled tifffile gives `load_hdr` for a
  `.tif` / `.tiff` file: the first series of pages (one page, several pages
  of one shape stacked, or the shape a tifffile-written JSON description
  gives), its dtype kept (uint / int 8-64, float16 / 32 / 64, bool for
  1-bit), planar data as (samples, height, width) as tifffile returns it,
  palette indices as they are and min-is-white samples not inverted;
- `read_pil` is what PIL's TiffImagePlugin opens for a glTF texture (and
  for imageio's PIL route): (array, mode, palette) for the layouts in PIL's
  table of modes that the port reads (bilevel, 2-, 4- and 8-bit gray,
  16-bit gray as "I;16" / "I;16B", 16- and 32-bit signed and 32-bit
  unsigned gray as "I", 32-bit float gray as "F", gray+alpha, RGB, RGBA
  with associated or unassociated alpha, RGB with unused extra samples,
  16-bit RGB(A) as its high bytes, palette (with alpha), CMYK), planar
  8-bit data interleaved.

Both read strips and tiles, II and MM byte orders, compression 1, 5 (LZW),
8 and 32946 (Deflate, the standard library's zlib) and 32773 (PackBits),
predictor 2 (horizontal) and 3 (floating point) and fill order 2.  The hot
loops (LZW, PackBits, the predictors) are the C codec's (io/codec.py).  The
readers differ where the libraries differ, and each copies its own: tifffile
takes the first `rows-per-strip x width` samples of each decoded strip in
order, zero-fills short ones and refuses the floating-point predictor in
tiled files; PIL reads the byte-swapped values libtiff hands it for a
compressed big-endian 32-bit or signed 16-bit file.  What neither reads, or
the port does not (other compressions, YCbCr, LAB, mixed bit depths,
orientations 5-8, 3-D images), raises a ValueError that names it.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.probe import PassOn

# Tag number -> name, for the tags the readers look at.
_TAGS = {256: "width", 257: "length", 258: "bits", 259: "compression", 262: "photometric", 266: "fillorder",
         270: "description", 273: "strip_offsets", 274: "orientation", 277: "spp", 278: "rows_per_strip",
         279: "strip_counts", 284: "planar", 317: "predictor", 320: "colormap", 322: "tile_width",
         323: "tile_length", 324: "tile_offsets", 325: "tile_counts", 338: "extra", 339: "sample_format",
         32997: "depth", 32998: "tile_depth"}
# Tag type -> (struct code, size).
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("2I", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("i", 4), 10: ("2i", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8), 17: ("q", 8),
          18: ("Q", 8)}
MAGIC = (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")  # classic TIFF and BigTIFF, each byte order
_COMPRESSIONS = (1, 5, 8, 32773, 32946)
# tifffile's SAMPLE_DTYPES: (sample format, bits) -> dtype character.
_DTYPES = {(1, 1): "?", (1, 64): "Q", (2, 8): "b", (2, 16): "h", (2, 32): "i", (2, 64): "q", (3, 16): "e",
           (3, 32): "f", (3, 64): "d"}
_DTYPES.update({(1, b): "B" for b in range(2, 9)})
_DTYPES.update({(1, b): "H" for b in range(9, 17)})
_DTYPES.update({(1, b): "I" for b in range(17, 33)})
_REVERSE_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


class _Page:
    """One image file directory: its tags (missing ones at tifffile's
    defaults) and the file it lives in."""

    def __init__(self, data: bytes, order: str, tags: dict, name: str):
        self.data, self.order, self.name = data, order, name
        self.tags = tags

        def one(key, default):
            v = tags.get(key)
            return default if v is None else v[0]

        self.width, self.length = one("width", 0), one("length", 0)
        self.depth = one("depth", 1)
        self.spp = one("spp", 1)
        self.compression = one("compression", 1)
        self.photometric = one("photometric", 0)
        self.planar = one("planar", 1)
        self.predictor = one("predictor", 1)
        self.fillorder = one("fillorder", 1)
        self.orientation = one("orientation", 1)
        bits = tags.get("bits", (1,))
        bits = bits[: self.spp] if len(bits) > 1 else bits
        self.bits = bits[0] if all(b == bits[0] for b in bits) else tuple(bits)
        fmt = tags.get("sample_format", (1,))
        fmt = fmt[: self.spp] if len(fmt) > 1 else fmt
        self.sample_format = fmt[0] if all(f == fmt[0] for f in fmt) else tuple(fmt)
        self.rows_per_strip = one("rows_per_strip", 2**32 - 1)
        if "rows_per_strip" not in tags or len(tags["rows_per_strip"]) > 1:
            self.rows_per_strip = self.length
        self.tiled = "tile_width" in tags and "tile_length" in tags
        self.tile_width, self.tile_length = one("tile_width", 0), one("tile_length", 0)
        self.tile_depth = one("tile_depth", 1)
        key = "tile_offsets" if "tile_offsets" in tags else "strip_offsets"
        self.offsets = tuple(tags.get(key, (0,)))
        key = "tile_counts" if "tile_counts" in tags else "strip_counts"
        self.counts = tuple(tags[key]) if key in tags else None
        desc = tags.get("description")
        self.description = desc if isinstance(desc, str) else ""
        # tifffile's page shape: (planes, depth, length, width, contiguous samples)
        if self.photometric == 2 or self.spp > 1:
            if self.planar == 1:
                self.shape6 = (1, 1, self.depth, self.length, self.width, self.spp)
                self.shape = (self.length, self.width, self.spp)
            else:
                self.shape6 = (1, self.spp, self.depth, self.length, self.width, 1)
                self.shape = (self.spp, self.length, self.width)
        else:
            self.shape6 = (1, 1, self.depth, self.length, self.width, 1)
            self.shape = (self.length, self.width)
        if self.depth != 1:
            self.shape = self.shape6[1:] if self.planar == 2 else self.shape6[2:]

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")


def _ifds(data: bytes, name: str) -> tuple:
    """(byte order, [tag dict per IFD]) of a TIFF file."""
    if len(data) < 8 or data[:2] not in (b"II", b"MM"):
        raise ValueError(f"{name} is not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    version = struct.unpack(order + "H", data[2:4])[0]
    if version == 42:
        big, offset = False, struct.unpack(order + "I", data[4:8])[0]
    elif version == 43:
        if len(data) < 16 or struct.unpack(order + "HH", data[4:8]) != (8, 0):
            raise ValueError(f"{name}: BigTIFF header is bad")
        big, offset = True, struct.unpack(order + "Q", data[8:16])[0]
    else:
        raise ValueError(f"{name}: TIFF version {version} is not TIFF (42) or BigTIFF (43)")
    count_fmt, entry_size, off_fmt = ("Q", 20, "Q") if big else ("H", 12, "I")
    value_size = 8 if big else 4
    ifds, seen = [], set()
    while offset and offset not in seen and len(ifds) < 1024:
        seen.add(offset)
        head = struct.calcsize(count_fmt)
        if offset + head > len(data):
            raise ValueError(f"{name}: TIFF directory offset {offset} is past the end of the file")
        (n,) = struct.unpack(order + count_fmt, data[offset : offset + head])
        if n > 4096 or offset + head + n * entry_size > len(data):
            raise ValueError(f"{name}: TIFF directory at {offset} is corrupt")
        tags = {}
        for i in range(n):
            e = offset + head + i * entry_size
            code, kind = struct.unpack(order + "HH", data[e : e + 4])
            (count,) = struct.unpack(order + off_fmt, data[e + 4 : e + 4 + value_size])
            if code not in _TAGS or kind not in _TYPES or code in tags:
                continue
            fmt, size = _TYPES[kind]
            total = count * size
            if total <= value_size:
                raw = data[e + 4 + value_size : e + 4 + value_size + total]
            else:
                (at,) = struct.unpack(order + off_fmt, data[e + 4 + value_size : e + 4 + 2 * value_size])
                if at < 8 or at + total > len(data):
                    continue  # tifffile skips a tag whose value lies outside the file
                raw = data[at : at + total]
            if kind == 2:
                value = raw.split(b"\0", 1)[0].strip()
                try:
                    value = value.decode("ascii")
                except UnicodeDecodeError:
                    pass
            elif fmt[0] == "2":  # rationals: (numerator, denominator) pairs
                value = struct.unpack(f"{order}{2 * count}{fmt[1]}", raw)
                value = tuple(zip(value[0::2], value[1::2]))
            else:
                value = struct.unpack(f"{order}{count}{fmt}", raw)
            tags[_TAGS[code]] = value
        ifds.append(tags)
        end = offset + head + n * entry_size
        nxt = data[end : end + value_size]
        offset = struct.unpack(order + off_fmt, nxt)[0] if len(nxt) == value_size else 0
    if not ifds:
        raise ValueError(f"{name}: TIFF file has no image directory")
    return order, ifds


def _segment(page: _Page, i: int) -> bytes:
    """The stored bytes of strip or tile i (bit order reversed for fill order 2)."""
    at, n = page.offsets[i], page.counts[i]
    raw = page.data[at : at + n]
    if page.fillorder == 2:
        raw = _REVERSE_BITS[np.frombuffer(raw, np.uint8)].tobytes()
    return raw


def _decompress(page: _Page, raw: bytes, size=None) -> np.ndarray:
    """The first `size` bytes of a decompressed strip or tile (fewer where
    it holds fewer; all of them for size None).  The whole of it is
    decoded, so that a fault anywhere in it raises, as in tifffile."""
    c = page.compression
    if c == 1:
        return np.frombuffer(raw[:size], np.uint8)
    if c in (5, 32773):
        decode = codec.tiff_lzw if c == 5 else codec.packbits
        try:
            if size is None:
                size = decode(raw, 0, count=True)
            return decode(raw, size)
        except ValueError as e:
            page.fail(f"TIFF {e}")
    try:
        out = zlib.decompress(raw)
    except zlib.error as e:
        page.fail(f"TIFF Deflate data is corrupt ({e})")
    return np.frombuffer(out, np.uint8)[:size]


def _check(page: _Page) -> None:
    """Refuse what neither reader takes, or the port does not."""
    if page.compression not in _COMPRESSIONS:
        page.fail(f"TIFF compression {page.compression} is not read (only none, LZW, Deflate and PackBits)")
    if page.width <= 0 or page.length <= 0 or page.spp <= 0:
        page.fail("TIFF image has no pixels")
    codec.check_size(page.width, page.length * page.spp, page.name)
    if isinstance(page.bits, tuple) or isinstance(page.sample_format, tuple):
        page.fail("TIFF images whose samples differ in bits or format are not read")
    if page.depth != 1:
        page.fail("3-D TIFF images (ImageDepth) are not read")
    if page.predictor not in (1, 2, 3):
        page.fail(f"TIFF predictor {page.predictor} is not read")
    if page.tiled and (page.tile_width <= 0 or page.tile_length <= 0 or page.tile_depth != 1):
        page.fail("TIFF tiles are of bad size")
    n_seg = len(page.offsets)
    if page.counts is None or len(page.counts) != n_seg:
        page.fail("TIFF strip or tile byte counts are missing or do not match the offsets")


def _samples(page: _Page, raw: np.ndarray, dtype: np.dtype, runlen: int, native: bool) -> np.ndarray:
    """The samples of one decompressed strip or tile, as tifffile unpacks
    them: whole items of `dtype` in the file's byte order (or as native bytes
    for the floating-point predictor), or 1-, 2- and 4-bit samples with each
    run of `runlen` starting on a byte."""
    bits = page.bits
    if bits in (8, 16, 32, 64):
        item = bits // 8
        raw = raw[: raw.size // item * item]
        dt = dtype.newbyteorder("=") if native else dtype.newbyteorder(page.order)
        return raw.view(dt)
    if bits == 1:
        b = np.unpackbits(raw)
        if runlen % 8:
            padded = runlen + 8 - runlen % 8
            if b.size % padded:
                page.fail("TIFF 1-bit strip does not hold whole rows")
            b = b.reshape(-1, padded)[:, :runlen].reshape(-1)
        return b.astype(bool)
    if bits not in (2, 4):
        page.fail(f"{bits}-bit TIFF samples are not read (tifffile reads 1, 2, 4, 8, 16, 32 and 64)")
    skip = (8 - runlen * bits % 8) % 8
    rows = raw.size * 8 // (runlen * bits + skip)
    per = 8 // bits
    row_bytes = (runlen * bits + skip) // 8
    b = raw[: rows * row_bytes].reshape(rows, row_bytes)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    vals = ((b[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, row_bytes * per)[:, :runlen]
    return vals.reshape(-1).astype(np.uint8)


def _to_native(a: np.ndarray) -> np.ndarray:
    return a.astype(a.dtype.newbyteorder("="), copy=False) if a.dtype.byteorder not in ("=", "|") else a


def _unpredict2(a: np.ndarray, rows_shape: tuple) -> np.ndarray:
    """tifffile's horizontal predictor: a cumulative sum along the width, per
    contiguous sample, in the samples' own type (integers wrap)."""
    a = np.ascontiguousarray(_to_native(a)).reshape(rows_shape)  # (..., width, samples)
    if a.dtype.kind in "iu" and a.dtype.itemsize in (1, 2, 4, 8):
        flat = a.reshape(-1, rows_shape[-2] * rows_shape[-1])
        codec.tiff_unpredict(flat, rows_shape[-1])
        return flat.reshape(rows_shape)
    return np.cumsum(a, axis=-2, dtype=a.dtype)


def _unpredict3(a: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """tifffile's floating-point predictor over the page's 6-D array of raw
    native-order items."""
    shape = a.shape
    rows = int(np.prod(shape[:-2]))
    out = codec.tiff_unpredict_float(np.ascontiguousarray(a).view(np.uint8), rows, shape[-2] * shape[-1],
                                     shape[-1], dtype.itemsize)
    return out.view(dtype.newbyteorder("=")).reshape(shape)


def _page_array(page: _Page) -> np.ndarray:
    """One page as tifffile's TiffPage.asarray gives it (squeezed to its shape)."""
    _check(page)
    char = _DTYPES.get((page.sample_format, page.bits))
    if char is None:
        page.fail(f"TIFF data type not read (sample format {page.sample_format}, {page.bits} bits)")
    dtype = np.dtype(char)
    shape6 = page.shape6
    count = int(np.prod(shape6))
    contiguous = _contiguous(page)
    if contiguous is not None:
        at = page.offsets[0]
        n = count * dtype.itemsize
        if at + n > len(page.data):
            page.fail("TIFF image data is short of its size")
        raw = np.frombuffer(page.data, np.uint8, n, at)
        if page.fillorder == 2:
            raw = _REVERSE_BITS[raw]
        result = np.array(raw.view(dtype.newbyteorder(page.order)), dtype.newbyteorder("=")).reshape(shape6)
        tiled_segments = False
    elif page.tiled:
        if page.predictor == 3:
            page.fail("the floating-point predictor in tiled TIFFs is not read (tifffile refuses it)")
        result = _tiles(page, dtype)
        tiled_segments = True
    else:
        result = _strips(page, dtype, count).reshape(shape6)
        tiled_segments = False
    if page.predictor == 2 and not tiled_segments:
        result = _unpredict2(result, shape6)
    elif page.predictor == 3 and not tiled_segments:
        if dtype.kind != "f":
            page.fail("the floating-point predictor on integer TIFF samples is not read (tifffile refuses it)")
        result = _unpredict3(result, dtype)
    return result.reshape(page.shape)


def _contiguous(page: _Page):
    """tifffile's is_contiguous: uncompressed 8-64-bit data stored in one run."""
    if page.compression != 1 or page.bits not in (8, 16, 32, 64):
        return None
    if page.tiled and (page.width != page.tile_width or page.length % page.tile_length or page.tile_width % 16
                       or page.tile_length % 16):
        return None
    offs, counts = page.offsets, page.counts
    if len(offs) == 1 or all(offs[i] + counts[i] == offs[i + 1] or counts[i + 1] == 0 for i in range(len(offs) - 1)):
        return offs[0]
    return None


def _strips(page: _Page, dtype: np.dtype, count: int) -> np.ndarray:
    result = np.zeros(count, dtype.newbyteorder("="))
    strip_size = page.rows_per_strip * page.width * (page.spp if page.planar == 1 else 1)
    runlen = page.width * (page.spp if page.planar == 1 else 1)
    native = page.predictor == 3
    item_bits = page.bits
    index = 0
    for i in range(len(page.offsets)):
        want = max(min(strip_size, count - index), 0)
        nbytes = want * item_bits // 8 if item_bits >= 8 else None
        strip = _samples(page, _decompress(page, _segment(page, i), nbytes), dtype, runlen, native)
        size = min(strip.size, want)
        result[index : index + size] = strip[:size]
        index += size
    return result


def _tiles(page: _Page, dtype: np.dtype) -> np.ndarray:
    tw, tl = page.tile_width, page.tile_length
    nx, ny = -(-page.width // tw), -(-page.length // tl)
    planes = page.spp if page.planar == 2 else 1
    contig = page.spp if page.planar == 1 else 1
    tile_shape = (1, tl, tw, contig)
    tile_count = tl * tw * contig
    codec.check_size(nx * tw, ny * tl * planes * contig, page.name)
    full = np.zeros((1, planes, 1, ny * tl, nx * tw, contig), dtype.newbyteorder("="))
    item_bits = page.bits
    runlen = tw * contig
    for i in range(len(page.offsets)):  # tiles past the last are refused, missing ones stay zero
        pl, rest = divmod(i, nx * ny)
        if pl >= planes:
            page.fail("TIFF has more tiles than its size holds")
        ty, tx = divmod(rest, nx)
        nbytes = tile_count * item_bits // 8 if item_bits >= 8 else None
        tile = _samples(page, _decompress(page, _segment(page, i), nbytes), dtype, runlen, False)
        t = np.zeros(tile_count, full.dtype)
        s = min(tile.size, tile_count)
        t[:s] = tile[:s]
        t = t.reshape(tile_shape)
        if page.predictor == 2:
            t = _unpredict2(t, tile_shape)
        full[0, pl, :, ty * tl : (ty + 1) * tl, tx * tw : (tx + 1) * tw, :] = t
    return full[..., : page.length, : page.width, :]


def _series_pages(pages: list) -> tuple:
    """(pages, shape) of tifffile's first series: a tifffile-written JSON
    "shape" description over the first page(s), else every page of the
    first page's shape."""
    first = pages[0]
    desc = first.description
    shape = None
    if desc[:6] == "shape=":
        try:
            shape = tuple(int(v) for v in desc[7:-1].split(",") if v.strip())
        except ValueError:
            first.fail("TIFF has a bad shape description")
    elif desc[:1] == "{" and '"shape":' in desc:
        try:
            shape = tuple(int(v) for v in json.loads(desc)["shape"]) if desc[-1:] == "}" else None
        except (ValueError, KeyError, TypeError):
            shape = None
        if shape is None:
            first.fail("TIFF has a bad JSON description")
    if shape is not None:
        size, page_size = int(np.prod(shape)), int(np.prod(first.shape))
        n, mod = divmod(size, page_size) if page_size else (0, 1)
        if not mod and 1 <= n <= len(pages):
            return pages[:n], shape
    key = first.shape + (first.compression in _COMPRESSIONS,)
    same = [p for p in pages if p.shape + (p.compression in _COMPRESSIONS,) == key]
    return same, ((len(same),) + first.shape if len(same) > 1 else first.shape)


def read_array(data: bytes, name: str = "image") -> np.ndarray:
    """A TIFF's first series as imageio's tifffile gives it to `load_hdr`."""
    order, ifds = _ifds(data, name)
    pages = [_Page(data, order, tags, name) for tags in ifds]
    group, shape = _series_pages(pages)
    arrays = [_page_array(p) for p in group]
    out = arrays[0] if len(arrays) == 1 else np.stack(arrays)
    try:
        return out.reshape(shape)
    except ValueError:
        return out


# ------------------------------------------------------------- PIL's view

# PIL's OPEN_INFO for what the port reads: (photometric, sample format, bits
# per sample, extra samples) -> (mode, PIL's raw mode).  The byte order and
# the fill order are handled around it.
_PIL_MODES = {
    (0, 1, (1,), ()): ("1", "1;I"), (1, 1, (1,), ()): ("1", "1"),
    (0, 1, (2,), ()): ("L", "L;2I"), (1, 1, (2,), ()): ("L", "L;2"),
    (0, 1, (4,), ()): ("L", "L;4I"), (1, 1, (4,), ()): ("L", "L;4"),
    (0, 1, (8,), ()): ("L", "L;I"), (1, 1, (8,), ()): ("L", "L"), (1, 2, (8,), ()): ("L", "L"),
    (0, 1, (16,), ()): ("I;16", "I;16"), (1, 1, (16,), ()): ("I;16", "I;16"),
    (1, 2, (16,), ()): ("I", "I;16S"), (0, 3, (32,), ()): ("F", "F;32F"), (1, 3, (32,), ()): ("F", "F;32F"),
    (1, 1, (32,), ()): ("I", "I;32N"), (1, 2, (32,), ()): ("I", "I;32S"),
    (1, 1, (8, 8), (2,)): ("LA", "LA"),
    (2, 1, (8, 8, 8), ()): ("RGB", "RGB"), (2, 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"), (2, 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"), (2, 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"), (2, 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"), (2, 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, 1, (16, 16, 16), ()): ("RGB", "RGB;16"), (2, 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"), (2, 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
    (2, 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
    (3, 1, (1,), ()): ("P", "P;1"), (3, 1, (2,), ()): ("P", "P;2"), (3, 1, (4,), ()): ("P", "P;4"),
    (3, 1, (8,), ()): ("P", "P"), (3, 1, (8, 8), (0,)): ("P", "PX"), (3, 1, (8, 8), (2,)): ("PA", "PA"),
    (5, 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"), (5, 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"), (5, 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
    (6, 1, (8,), ()): ("L", "L"),
}
# Keys PIL reads from little-endian files only.
_II_ONLY = {(1, 1, (32,), ()), (0, 1, (16,), ())}
# Keys PIL has a fill-order-2 mode for, which an uncompressed file needs (a
# compressed one goes through libtiff, which reverses the bits itself).
_FILL2 = {(p, 1, (b,), ()) for p in (0, 1) for b in (1, 2, 4, 8)} | {(2, 1, (8, 8, 8), ()), (1, 1, (16,), ())} | {
    (3, 1, (b,), ()) for b in (1, 2, 4, 8)}


def _pil_key(page: _Page, tags: dict) -> tuple:
    """PIL's mode key of a page: (photometric, sample format, bits, extra)."""
    fmt = tuple(tags.get("sample_format", (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bits = tuple(tags.get("bits", (1,)))
    extra = tuple(tags.get("extra", ()))
    spp = page.spp
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp:
        page.fail("TIFF has an unknown data organization (bits per sample do not match the samples)")
    if len(fmt) != 1:
        page.fail(f"TIFF sample formats {fmt} are not read")
    return page.photometric, fmt[0], bits, extra


def _spec_samples(page: _Page) -> np.ndarray:
    """The page's samples decoded to the specification, (length, width,
    spp) native-order (planar data interleaved; sub-byte samples as uint8)."""
    _check(page)
    bits = page.bits
    if bits in (8, 16, 32, 64):
        dtype = np.dtype({1: "u", 2: "i", 3: "f"}.get(page.sample_format, "u") + str(bits // 8))
    elif bits in (1, 2, 4):
        dtype = np.dtype(np.uint8)
    else:
        page.fail(f"{bits}-bit TIFF samples are not read")
    if page.predictor == 3 and dtype.kind != "f":
        page.fail("the floating-point predictor on integer TIFF samples is not read")
    planes = page.spp if page.planar == 2 else 1
    contig = page.spp if page.planar == 1 else 1
    w, h = page.width, page.length
    out = np.zeros((planes, h, w, contig), dtype)
    if page.tiled:
        sw, sh = page.tile_width, page.tile_length
        codec.check_size(sw, sh * page.spp, page.name)
    else:
        sw, sh = w, min(page.rows_per_strip, h) or h
    nx, ny = -(-w // sw), -(-h // sh)
    if len(page.offsets) < planes * nx * ny:
        page.fail("TIFF has fewer strips or tiles than its size needs")
    row_bytes = -(-sw * contig * bits // 8)
    for i in range(planes * nx * ny):
        pl, rest = divmod(i, nx * ny)
        ty, tx = divmod(rest, nx)
        rows = sh if page.tiled else min(sh, h - ty * sh)
        raw = _decompress(page, _segment(page, i), rows * row_bytes)
        if raw.size < rows * row_bytes:
            page.fail("TIFF strip or tile data is short of its size")
        raw = raw.reshape(rows, row_bytes)
        if bits >= 8:
            if page.predictor == 3:
                vals = codec.tiff_unpredict_float(raw, rows, sw * contig, contig, dtype.itemsize).view(dtype)
            else:
                vals = _to_native(raw.view(dtype.newbyteorder(page.order)))
            vals = np.ascontiguousarray(vals).reshape(rows, sw, contig)
            if page.predictor == 2:
                vals = _unpredict2(vals, (rows, sw, contig))
        else:
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            vals = ((raw[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)[:, : sw * contig]
            vals = vals.reshape(rows, sw, contig)
        y0, x0 = ty * sh, tx * sw
        hh, ww = min(rows, h - y0), min(sw, w - x0)
        out[pl, y0 : y0 + hh, x0 : x0 + ww] = vals[:hh, :ww]
    return np.moveaxis(out, 0, -1).reshape(h, w, planes * contig) if planes > 1 else out[0]


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's unpacker for associated alpha: c * 255 / a (clipped), 0 where a is 0."""
    a = rgba[..., 3:4].astype(np.int32)
    rgb = rgba[..., :3].astype(np.int32)
    out = np.where(a == 255, rgb, np.minimum(rgb * 255 // np.maximum(a, 1), 255))
    out = np.where(a == 0, 0, out)
    return np.concatenate([out, a], axis=-1).astype(np.uint8)


def _raw_planar(page: _Page, raw: str) -> np.ndarray:
    """An uncompressed planar image as PIL's raw decoder reads it: each
    band's strips or tiles as 8-bit samples (the band letter of PIL's raw
    mode), one byte per pixel from the start of each row, whatever the
    samples' width."""
    bands = raw.split(";")[0]
    if len(bands) != page.spp or not set(bands) <= set("RGBAL") or page.fillorder != 1:
        page.fail(f"planar TIFF of PIL raw mode {raw} is not read")
    w, h = page.width, page.length
    tw, th = (page.tile_width, page.tile_length) if page.tiled else (w, min(page.rows_per_strip, h) or h)
    nx, ny = -(-w // tw), -(-h // th)
    if len(page.offsets) != page.spp * nx * ny:
        page.fail("planar TIFF has a strip or tile count PIL does not read")
    out = np.zeros((h, w, page.spp), np.uint8)
    row_bits = tw * page.bits * page.spp
    for i, at in enumerate(page.offsets):
        layer, rest = divmod(i, nx * ny)
        ty, tx = divmod(rest, nx)
        x0, y0 = tx * tw, ty * th
        pw, ph = min(tw, w - x0), min(th, h - y0)
        step = int(row_bits / 8 / page.spp) if x0 + tw > w else pw
        need = (ph - 1) * step + pw
        if at + need > len(page.data):
            page.fail("TIFF file is truncated")
        rows = np.lib.stride_tricks.as_strided(np.frombuffer(page.data, np.uint8, need, at), (ph, pw), (step, 1))
        out[y0 : y0 + ph, x0 : x0 + pw, layer] = rows
    return out


def read_pil(data: bytes, name: str = "image") -> tuple:
    """A TIFF's first page as PIL opens it: (array, mode, palette), the
    palette (256, 3) uint8 for modes "P" and "PA", else None."""
    order, ifds = _ifds(data, name)
    tags = ifds[0]
    page = _Page(data, order, tags, name)
    # (What PIL's _open refuses with a SyntaxError passes the file on to its next plugin.)
    if order == ">" and data[2:4] == b"\0+":
        raise PassOn(f"{name}: big-endian BigTIFF (PIL finds no dimensions in it)")
    if page.compression not in _COMPRESSIONS:
        page.fail(f"TIFF compression {page.compression} is not read (only none, LZW, Deflate and PackBits)")
    if page.orientation in (5, 6, 7, 8):
        page.fail(f"TIFF orientation {page.orientation} is not read")
    key = _pil_key(page, tags)
    if key not in _PIL_MODES or (order == ">" and key in _II_ONLY):
        raise PassOn(f"{name}: TIFF layout (photometric {key[0]}, sample format {key[1]}, bits {key[2]}, extra "
                     f"samples {key[3]}) that PIL has no mode for (unknown pixel mode)")
    if page.compression == 1 and page.fillorder == 2 and (key not in _FILL2 or (order == ">" and key[2] == (16,))):
        raise PassOn(f"{name}: a TIFF layout with fill order 2 that PIL has no mode for (unknown pixel mode)")
    if page.compression == 1 and not ({"strip_offsets", "tile_offsets"} & set(tags)):
        raise PassOn(f"{name}: TIFF without strip or tile offsets (PIL: unknown data organization)")
    if page.compression not in (5, 8, 32946):
        page.predictor = 1  # neither PIL's raw decoder nor libtiff's PackBits codec applies a predictor
    mode, raw = _PIL_MODES[key]
    if mode in ("P", "PA") and tags.get("colormap") is None:
        raise PassOn(f"{name}: palette TIFF without a ColorMap (PIL: KeyError in its _setup)")
    if page.planar == 2 and page.compression == 1:
        return _raw_planar(page, raw), mode, None
    s = _spec_samples(page)
    if page.compression != 1 and order == ">" and raw in ("F;32F", "I;32S", "I;16S"):
        s = s.byteswap()  # libtiff hands PIL native-order samples, which it swaps as big-endian ones
    palette = None
    if raw in ("1", "1;I"):
        arr = s[..., 0].astype(bool)
        arr = ~arr if raw == "1;I" else arr
    elif raw in ("L;2", "L;4", "L;2I", "L;4I"):
        v = s[..., 0] * np.uint8(85 if raw.startswith("L;2") else 17)
        arr = 255 - v if raw.endswith("I") else v
    elif raw == "L;I":
        arr = 255 - s[..., 0]
    elif raw == "L":
        arr = s[..., 0].view(np.uint8)
    elif raw == "I;16":
        arr = s[..., 0].astype(np.uint16 if order == "<" else ">u2")
        mode = "I;16" if order == "<" else "I;16B"
    elif raw in ("I;16S", "I;32S", "I;32N"):
        arr = s[..., 0].astype(np.int32)
    elif raw == "F;32F":
        arr = s[..., 0].astype(np.float32)
    elif mode in ("P", "PA"):
        pal = (np.asarray(tags["colormap"], np.int64) // 256).astype(np.uint8)
        n = len(pal) // 3
        palette = np.zeros((256, 3), np.uint8)
        palette[: min(n, 256)] = pal.reshape(3, n).T[:256]
        arr = s[..., 0] if mode == "P" else s[..., :2]
    else:
        if key[2][0] == 16:
            s = (s >> 8).astype(np.uint8)
        if raw.startswith("RGBa"):
            arr = _unpremultiply(s[..., :4])
        else:
            arr = s[..., : {"RGB": 3, "RGBA": 4, "LA": 2, "CMYK": 4}[mode]]
    return np.ascontiguousarray(arr), mode, palette
