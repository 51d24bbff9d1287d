"""AVIF decoding to what PIL 12.1 opens, as its libavif 1.3.0 (with dav1d)
decodes an image for it.

PIL's AVIF plugin hands libavif the whole file; libavif parses the
ISOBMFF container, decodes the AV1 data and converts YUV to 8-bit RGB or
RGBA.  This module parses the container as libavif does for PIL:

- `ftyp` first, with `avif` or `avis` among its brands;
- `meta` (`hdlr` pict, `pitm`, `iinf` / `infe` v2-3, `iloc` v0-2 with
  construction methods 0 (file offset) and 1 (`idat`), several extents,
  `iprp` / `ipco` / `ipma`, `iref`): the primary item, its properties
  (`ispe`, `av1C`, `pixi`, `colr` nclx and ICC, `irot` / `imir` / `clap`,
  which libavif leaves to PIL and PIL to no one: the pixels are not
  turned), and its alpha item, the `av01` item whose `auxC` names alpha and
  whose `auxl` reference points at it, premultiplied where a `prem`
  reference says so;
- `moov` / `trak` (`tkhd`, `tref`, `mdia` / `hdlr` pict, `stbl` / `stco`
  / `co64` / `stsz`) of an `avis` sequence: PIL opens frame 0, the first
  sample of the colour track, with the alpha track's (`auxl` in `tref`).

The AV1 data is decoded by io/av1.py (csrc/av1dec.c), and the conversion
to RGB(A) is libavif's as PIL asks for it (csrc/av1dec.c
`vpt_avif_rgb`): libyuv's 8-bit fixed-point matrices (full-range BT.601
for PIL's files, `kYuvJPEGConstants`), its bilinear chroma upsampling
for 4:2:0 and 4:2:2 (libavif's AUTOMATIC), alpha unpremultiplied by
libyuv's ARGBUnattenuate; gray without alpha and the matrices libyuv has
no constants for go through libavif's own float path.  The matrix comes
from the `colr` nclx box, else from the AV1 sequence header.

What libavif refuses raises: a parse failure as PIL's SyntaxError (so
`Image.open` tries the next plugin: `probe.PassOn`), the rest as a
ValueError.  What this slice of the port does not decode (io/av1.py:
lossy frames, 10 / 12 bits, intrabc, film grain, and `grid` / `iovl`
derived images) raises a ValueError naming it and its ROADMAP item.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from vpt_tpu_torch.io import av1, codec, probe

GRID = "a derived image (`grid` / `iovl` items; ROADMAP Queue 1, the `grid` and OpenCV AVIF slice)"


class _Parse(Exception):
    """libavif's AVIF_RESULT_BMFF_PARSE_FAILED / INVALID_FTYP (PIL's SyntaxError)."""


def _boxes(data: bytes, start: int, end: int) -> list:
    """(type, payload start, payload end) of each box in data[start:end]."""
    out, pos = [], start
    while pos < end:
        if pos + 8 > end:
            raise _Parse("box header cut short")
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise _Parse("box header cut short")
            size = struct.unpack(">Q", data[pos + 8 : pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise _Parse(f"box {kind!r} runs past its parent")
        out.append((kind, pos + head, pos + size))
        pos += size
    return out


class _Reader:
    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end = data, pos, end

    def u(self, n: int) -> int:
        if self.pos + n > self.end:
            raise _Parse("box payload cut short")
        v = int.from_bytes(self.data[self.pos : self.pos + n], "big")
        self.pos += n
        return v

    def full(self) -> tuple:
        v = self.u(4)
        return v >> 24, v & 0xFFFFFF


class _Item:
    def __init__(self, item_id: int):
        self.id, self.type, self.props, self.extents, self.method = item_id, b"", [], [], 0
        self.refs = {}  # reference type -> [to ids]


def _meta(data: bytes, start: int, end: int) -> dict:
    r = _Reader(data, start, end)
    r.full()
    items, props, primary, idat, handler = {}, [], None, None, None

    def item(i):
        return items.setdefault(i, _Item(i))
    for kind, s, e in _boxes(data, r.pos, end):
        b = _Reader(data, s, e)
        if kind == b"hdlr":
            b.full()
            b.u(4)
            handler = data[b.pos : b.pos + 4]
        elif kind == b"pitm":
            v, _ = b.full()
            primary = b.u(2 if v == 0 else 4)
        elif kind == b"idat":
            idat = (s, e)
        elif kind == b"iloc":
            v, _ = b.full()
            if v > 2:
                raise _Parse(f"iloc version {v}")
            sizes = b.u(2)
            off_size, len_size, base_size = sizes >> 12, (sizes >> 8) & 15, (sizes >> 4) & 15
            index_size = sizes & 15 if v in (1, 2) else 0
            count = b.u(2 if v < 2 else 4)
            for _ in range(count):
                it = item(b.u(2 if v < 2 else 4))
                if v in (1, 2):
                    it.method = b.u(2) & 15
                b.u(2)  # data_reference_index
                base = b.u(base_size) if base_size else 0
                for _ in range(b.u(2)):
                    if index_size:
                        b.u(index_size)
                    off = b.u(off_size) if off_size else 0
                    length = b.u(len_size) if len_size else 0
                    it.extents.append((base + off, length))
        elif kind == b"iinf":
            v, _ = b.full()
            b.u(2 if v == 0 else 4)
            for k2, s2, e2 in _boxes(data, b.pos, e):
                if k2 != b"infe":
                    continue
                c = _Reader(data, s2, e2)
                v2, _ = c.full()
                if v2 < 2:
                    continue
                it = item(c.u(2 if v2 == 2 else 4))
                c.u(2)  # item_protection_index
                it.type = data[c.pos : c.pos + 4]
        elif kind == b"iprp":
            for k2, s2, e2 in _boxes(data, s, e):
                if k2 == b"ipco":
                    props = _boxes(data, s2, e2)
                elif k2 == b"ipma":
                    c = _Reader(data, s2, e2)
                    v2, flags = c.full()
                    for _ in range(c.u(4)):
                        it = item(c.u(2 if v2 < 1 else 4))
                        for _ in range(c.u(1)):
                            a = c.u(2) if flags & 1 else c.u(1)
                            idx = a & (0x7FFF if flags & 1 else 0x7F)
                            if idx:
                                if idx > len(props):
                                    raise _Parse("ipma names a property that is not there")
                                it.props.append(props[idx - 1])
        elif kind == b"iref":
            v, _ = b.full()
            n = 2 if v == 0 else 4
            for k2, s2, e2 in _boxes(data, b.pos, e):
                c = _Reader(data, s2, e2)
                src = item(c.u(n))
                for _ in range(c.u(2)):
                    src.refs.setdefault(k2, []).append(c.u(n))
    return {"items": items, "primary": primary, "idat": idat, "handler": handler}


def _extent_data(data: bytes, it: _Item, meta: dict) -> bytes:
    if it.method == 1:
        if meta["idat"] is None:
            raise _Parse("construction method 1 without an idat box")
        base, end = meta["idat"]
    elif it.method == 0:
        base, end = 0, len(data)
    else:
        raise ValueError("AVIF item stored by construction method 2 (item offset) is not read")
    out = b""
    for off, length in it.extents:
        if length == 0:
            length = end - base - off
        if base + off + length > end:
            raise ValueError("AVIF item data runs past the file (libavif: truncated data)")
        out += data[base + off : base + off + length]
    return out


def _prop(it: _Item, kind: bytes):
    return next(((s, e) for k, s, e in it.props if k == kind), None)


def _colr(data: bytes, it_props) -> dict:
    """The nclx box's CICP and range, if the item has one."""
    for k, s, e in it_props:
        if k == b"colr" and data[s : s + 4] == b"nclx" and e - s >= 11:
            cp, tc, mc = struct.unpack(">HHH", data[s + 4 : s + 10])
            return {"cp": cp, "tc": tc, "mc": mc, "full": data[s + 10] >> 7}
    return None


def _track_sample0(data: bytes, trak: tuple) -> tuple:
    """(track id, handler, the track its `auxl` reference names or None,
    sample 0's bytes) of a `trak` box: sample 0 starts chunk 0."""
    tid, handler, aux, chunk0, size0 = None, None, None, None, None
    stack = [trak]
    while stack:
        s, e = stack.pop()
        for kind, s2, e2 in _boxes(data, s, e):
            if kind in (b"mdia", b"minf", b"stbl"):
                stack.append((s2, e2))
            elif kind == b"tref":
                for k3, s3, e3 in _boxes(data, s2, e2):
                    if k3 == b"auxl" and e3 - s3 >= 4:
                        aux = int.from_bytes(data[s3 : s3 + 4], "big")
            elif kind == b"tkhd":
                r = _Reader(data, s2, e2)
                v, _ = r.full()
                r.u(16 if v == 1 else 8)
                tid = r.u(4)
            elif kind == b"hdlr":
                handler = data[s2 + 8 : s2 + 12]
            elif kind in (b"stco", b"co64"):
                r = _Reader(data, s2, e2)
                r.full()
                if r.u(4):
                    chunk0 = r.u(4 if kind == b"stco" else 8)
            elif kind == b"stsz":
                r = _Reader(data, s2, e2)
                r.full()
                size, count = r.u(4), r.u(4)
                size0 = size if size else (r.u(4) if count else None)
    if chunk0 is None or size0 is None:
        raise _Parse("track without its first sample")
    if chunk0 + size0 > len(data):
        raise ValueError("AVIF sample runs past the file (libavif: truncated data)")
    return tid, handler, aux, data[chunk0 : chunk0 + size0]


def _parse(data: bytes) -> dict:
    """The colour and alpha AV1 data libavif decodes for PIL's frame 0, and
    the properties that shape the conversion."""
    top = _boxes(data, 0, len(data))
    if not top or top[0][0] != b"ftyp":
        raise _Parse("no ftyp box first (libavif: invalid ftyp)")
    _, s, e = top[0]
    if e - s < 8:
        raise _Parse("ftyp box cut short")
    brands = [data[s : s + 4]] + [data[i : i + 4] for i in range(s + 8, e - 3, 4)]
    if b"avif" not in brands and b"avis" not in brands:
        raise _Parse("ftyp has neither the avif nor the avis brand (libavif: invalid ftyp)")
    meta = next(((s, e) for k, s, e in top if k == b"meta"), None)
    moov = next(((s, e) for k, s, e in top if k == b"moov"), None)
    out = {"colr": None, "alpha": None, "premultiplied": False}
    if moov is not None and b"avis" in brands:
        tracks = [_track_sample0(data, (s, e)) for k, s, e in _boxes(data, *moov) if k == b"trak"]
        color = next((t for t in tracks if t[2] is None and t[1] == b"pict"), None)
        if color is None:
            raise _Parse("sequence without a colour track")
        out["color"] = color[3]
        alpha = next((t for t in tracks if t[2] == color[0]), None)
        if alpha is not None:
            out["alpha"] = alpha[3]
        if meta is not None:
            m = _meta(data, *meta)
            if m["primary"] in m["items"]:
                out["colr"] = _colr(data, m["items"][m["primary"]].props)
        return out
    if meta is None:
        raise _Parse("no meta box (libavif: no content)")
    m = _meta(data, *meta)
    if m["handler"] != b"pict":
        raise _Parse("meta handler is not pict")
    items = m["items"]
    if m["primary"] is None or m["primary"] not in items:
        raise _Parse("no primary item")
    it = items[m["primary"]]
    if it.type in (b"grid", b"iovl"):
        raise av1.Refused("", GRID)
    if it.type != b"av01":
        raise _Parse(f"primary item of type {it.type!r}")
    if _prop(it, b"ispe") is None:
        raise _Parse("primary item without ispe")
    if _prop(it, b"av1C") is None:
        raise _Parse("primary item without av1C")
    out["color"] = _extent_data(data, it, m)
    out["colr"] = _colr(data, it.props)
    for other in items.values():
        if other is it or it.id not in other.refs.get(b"auxl", []):
            continue
        aux = _prop(other, b"auxC")
        if aux is None:
            continue
        urn = data[aux[0] + 4 : aux[1]].split(b"\0")[0]
        if urn in (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1"):
            if other.type in (b"grid", b"iovl"):
                raise av1.Refused("", GRID)
            out["alpha"] = _extent_data(data, other, m)
            out["premultiplied"] = other.id in it.refs.get(b"prem", [])
            break
    return out


# matrix coefficients -> libyuv constants (full, limited) as libavif picks them
_LIBYUV = {1: ("F709", "H709"), 2: ("JPEG", "I601"), 5: ("JPEG", "I601"), 6: ("JPEG", "I601"),
           9: ("V2020", None)}
_KINDS = {"JPEG": 0, "I601": 1, "F709": 2, "H709": 3, "V2020": 4}
# what libavif itself refuses: identity with subsampled chroma, and these matrices
_LIBAVIF_REFUSES = (3, 10, 11, 13, 14)
MATRIX = ("AVIF matrix coefficients {} at {} range{} (libavif's own conversion paths for other matrices than "
          "BT.601 / BT.709 / unspecified / full-range BT.2020 / 4:4:4 identity; ROADMAP Queue 1, the `grid` and "
          "OpenCV AVIF slice)")


def read_pil(data: bytes, name: str = "image") -> tuple:
    """Frame 0 as PIL opens it: ((H, W, 4) uint8 and mode "RGBA" where an
    alpha item or track is present, else (H, W, 3) uint8 and "RGB")."""
    try:
        parts = _parse(data)
    except _Parse as e:
        raise probe.PassOn(f"{name}: AVIF container refused ({e})") from None
    except av1.Refused as e:
        raise av1.Refused(name, e.feature) from None
    except (ValueError, struct.error) as e:
        raise ValueError(f"{name}: {e}") from None
    seq, hdr, (y, u, v) = av1.decode(parts["color"], name)
    alpha = None
    if parts["alpha"] is not None:
        aseq, ahdr, (a, _, _) = av1.decode(parts["alpha"], f"{name} (alpha)")
        if a.shape != y.shape:
            raise ValueError(f"{name}: AVIF alpha plane of another size than the image")
        if not aseq["full_range"]:
            raise ValueError(f"{name}: AVIF limited-range alpha is not read")
        alpha = np.ascontiguousarray(a)
    colr = parts["colr"]
    mc = colr["mc"] if colr else seq["mc"]
    full = colr["full"] if colr else seq["full_range"]
    return rgb(y, u, v, alpha, seq, mc, full, parts["premultiplied"], name), ("RGBA" if alpha is not None else "RGB")


def rgb(y, u, v, alpha, seq: dict, mc: int, full: int, premultiplied: bool, name: str) -> np.ndarray:
    """libavif's avifImageYUVToRGB as PIL calls it (8-bit RGB or RGBA)."""
    h, w = y.shape
    mono = u is None
    if mc in _LIBAVIF_REFUSES or (mc == 8 and not full) or (mc == 0 and not mono and (seq["ssx"] or seq["ssy"])):
        raise ValueError(f"{name}: AVIF matrix coefficients {mc} with this chroma (libavif refuses the conversion)")
    if mono and alpha is None:
        kind = 7  # gray: libavif's own path, Y alone
    elif mc == 0 and not mono:
        kind = 6  # identity: G = Y, B = U, R = V
    elif mc in _LIBYUV and _LIBYUV[mc][0 if full else 1]:
        kind = _KINDS[_LIBYUV[mc][0 if full else 1]]
    else:
        raise av1.Refused(name, MATRIX.format(mc, "full" if full else "limited", " with alpha" if mono else ""))
    ch = 4 if alpha is not None else 3
    out = np.empty((h, w, ch), np.uint8)
    zero = np.zeros((1, 1), np.uint8)
    u = zero if mono else np.ascontiguousarray(u)
    v = zero if mono else np.ascontiguousarray(v)
    y = np.ascontiguousarray(y)
    a = alpha if alpha is not None else zero
    p = ctypes.c_void_p
    prm = np.array([w, h, u.shape[1], seq["ssx"], seq["ssy"], int(mono), kind, int(bool(full)), ch,
                    int(premultiplied)], np.int32)
    rc = codec.av1_library().vpt_avif_rgb(p(y.ctypes.data), p(u.ctypes.data), p(v.ctypes.data), p(a.ctypes.data),
                                          p(prm.ctypes.data), p(out.ctypes.data))
    codec.av1_check(rc, name)
    return out
