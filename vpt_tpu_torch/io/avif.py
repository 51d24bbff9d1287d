"""AVIF decoding to what PIL 12.1 opens, as its libavif 1.3.0 (with dav1d)
decodes an image for it.

PIL's AVIF plugin hands libavif the whole file; libavif parses the
ISOBMFF container, decodes the AV1 data and converts YUV to 8-bit RGB or
RGBA.  This module parses the container as libavif does for PIL:

- the top-level boxes as libavif walks them: `ftyp` first, with `avif` or
  `avis` among its brands; `ftyp`, `meta` and `moov` read whole, any other
  box skipped by its size, the walk ended once the boxes the brands need
  are seen (a broken box after them is never read);
- `meta` (`hdlr` pict first, `pitm`, `iinf` / `infe` v2-3, `iloc` v0-2 with
  construction methods 0 (file offset) and 1 (`idat`), several extents,
  `iprp` / `ipco` / `ipma`, `iref` v0-1): the primary item, its properties
  (`ispe`, `av1C`, `pixi`, `colr` nclx and ICC, `irot` / `imir` / `clap`,
  which libavif leaves to PIL and PIL to no one: the pixels are not
  turned), its Exif and XMP items' data, and its alpha item, the `av01`
  item whose `auxC` names alpha and whose `auxl` reference points at it
  (libavif passes over one without data or with an essential property it
  does not know, and refuses one without `av1C`), premultiplied where a
  `prem` reference says so; with libavif's checks of each box and
  property it parses (versions, strings, counts, no box of size 0 below
  the top level, pixi's planes and depth against av1C's);
- `moov` / `trak` (`tkhd`, `tref`, `edts` / `elst`, `mdia` / `hdlr` pict,
  `stbl` / `stsd` / `stts` / `stsc` / `stco` / `co64` / `stsz`) of an
  `avis` sequence: PIL opens frame 0, the first sample of the colour
  track (the first `av01` one without `auxl`), with the alpha track's
  (`auxl` in `tref`, an alpha `auxi`); every sample must lie in the file.

The AV1 data is decoded by io/av1.py (csrc/av1dec.c), and the conversion
to RGB(A) is libavif's as PIL asks for it (csrc/av1dec.c
`vpt_avif_rgb`): libyuv's 8-bit fixed-point matrices (full-range BT.601
for PIL's files, `kYuvJPEGConstants`), its bilinear chroma upsampling
for 4:2:0 and 4:2:2 (libavif's AUTOMATIC), alpha unpremultiplied by
libyuv's ARGBUnattenuate, limited-range alpha widened as libavif widens
it; gray without alpha and the matrices libyuv has no constants for go
through libavif's own float path.  The matrix comes from the `colr` nclx
box, else from the AV1 sequence header.

What libavif refuses raises: a parse failure as PIL's SyntaxError (so
`Image.open` tries the next plugin: `probe.PassOn`), the rest as a
ValueError.  What this slice of the port does not decode (io/av1.py: the
lossy AVIF slice's second half, 10 / 12 bits, intrabc, film grain; a
frame libavif scales to its `ispe` or `tkhd` size, and `grid` / `iovl`
derived images)
raises a ValueError naming it and its ROADMAP item.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from vpt_tpu_torch.io import av1, codec, probe

SCALED = ("a {}x{} frame in an item or track whose ispe or tkhd says {}x{} (libavif scales the frame to it with "
          "libyuv; ROADMAP Queue 1, the lossy AVIF slice, second half)")
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
            raise _Parse(f"box {kind!r} of size 0 inside another box")
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
        self.content_type, self.unsupported_essential = b"", False
        self.refs = {}  # reference type -> [to ids]


def _string(data: bytes, pos: int, end: int, box: str) -> int:
    """The position past a null-terminated string (libavif's avifROStreamReadString)."""
    z = data.find(b"\0", pos, end)
    if z < 0:
        raise _Parse(f"{box} string without its terminator")
    return z + 1


def _handler(data: bytes, s: int, e: int) -> bytes:
    """An hdlr box's handler type, with libavif's checks: version 0, pre_defined 0, a name."""
    r = _Reader(data, s, e)
    if r.full()[0] != 0:
        raise _Parse("hdlr version is not 0")
    if r.u(4):
        raise _Parse("hdlr pre_defined is not 0")
    kind = data[r.pos : r.pos + 4]
    r.u(4)
    for _ in range(3):
        r.u(4)
    _string(data, r.pos, e, "hdlr")
    return kind


def _meta(data: bytes, start: int, end: int) -> dict:
    r = _Reader(data, start, end)
    if r.full()[0] != 0:
        raise _Parse("meta version is not 0")
    items, props, primary, idat, handler = {}, [], None, None, None

    def item(i):
        return items.setdefault(i, _Item(i))
    children = _boxes(data, r.pos, end)
    if not children or children[0][0] != b"hdlr":
        raise _Parse("meta without hdlr as its first box")
    seen = set()
    for kind, s, e in children:
        b = _Reader(data, s, e)
        if kind in seen and kind in (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref"):
            raise _Parse(f"meta holds two {kind!r} boxes")
        seen.add(kind)
        if kind == b"hdlr":
            handler = _handler(data, s, e) if handler is None else handler
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
            if any(n not in (0, 4, 8) for n in (off_size, len_size, base_size, index_size)):
                raise _Parse("iloc of a field size other than 0, 4 or 8")
            count = b.u(2 if v < 2 else 4)
            for _ in range(count):
                item_id = b.u(2 if v < 2 else 4)
                if not item_id:
                    raise _Parse("iloc names item 0")
                it = item(item_id)
                if v in (1, 2):
                    method = b.u(2)
                    if method >> 4:
                        raise _Parse("iloc with its reserved bits set")
                    it.method = method
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
            if v > 1:
                raise _Parse(f"iinf version {v}")
            count = b.u(2 if v == 0 else 4)
            entries = _boxes(data, b.pos, e)
            if count > len(entries):
                raise _Parse("iinf names more entries than it holds")
            for k2, s2, e2 in entries[:count]:
                if k2 != b"infe":
                    raise _Parse("iinf holds a box that is not infe")
                c = _Reader(data, s2, e2)
                v2, _ = c.full()
                if v2 not in (2, 3):
                    raise _Parse(f"infe version {v2}")
                item_id = c.u(2 if v2 == 2 else 4)
                if not item_id:
                    raise _Parse("infe names item 0")
                it = item(item_id)
                c.u(2)  # item_protection_index
                it.type = data[c.pos : c.pos + 4]
                c.u(4)
                end = _string(data, c.pos, e2, "infe")  # item_name
                if it.type == b"mime":
                    z = _string(data, end, e2, "infe")  # content_type
                    it.content_type = data[end : z - 1]
        elif kind == b"iprp":
            children = _boxes(data, s, e)
            if not children or children[0][0] != b"ipco":
                raise _Parse("iprp without ipco as its first box")
            props = _boxes(data, children[0][1], children[0][2])
            for k3, s3, e3 in props:
                _check_property(data, k3, s3, e3)
            mapped, kinds = set(), set()
            for k2, s2, e2 in children[1:]:
                if k2 != b"ipma":
                    raise _Parse("iprp holds a box that is not ipma")
                c = _Reader(data, s2, e2)
                v2, flags = c.full()
                if (v2, flags) in kinds:
                    raise _Parse("two ipma boxes of one version and flags")
                kinds.add((v2, flags))
                last = 0
                for _ in range(c.u(4)):
                    item_id = c.u(2 if v2 < 1 else 4)
                    if item_id in mapped or item_id <= last:
                        raise _Parse("ipma item ids not increasing, or one twice")
                    mapped.add(item_id)
                    last = item_id
                    it = item(item_id)
                    for _ in range(c.u(1)):
                        a = c.u(2) if flags & 1 else c.u(1)
                        idx = a & (0x7FFF if flags & 1 else 0x7F)
                        if not idx and a:
                            raise _Parse("ipma marks property 0 essential")
                        if idx:
                            if idx > len(props):
                                raise _Parse("ipma names a property that is not there")
                            it.props.append(props[idx - 1])
                            if a >> (15 if flags & 1 else 7) and props[idx - 1][0] not in _KNOWN_PROPERTIES:
                                it.unsupported_essential = True
        elif kind == b"iref":
            v, _ = b.full()
            n = 2 if v == 0 else 4
            for k2, s2, e2 in _boxes(data, b.pos, e) if v < 2 else []:  # libavif passes over later versions
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


# the properties libavif parses: an essential property of another type makes it pass over the item
_KNOWN_PROPERTIES = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir", b"pixi", b"a1op",
                     b"lsel", b"a1lx", b"clli")


def _check_property(data: bytes, kind: bytes, s: int, e: int) -> None:
    """libavif's parse of the properties it knows, each checked where it
    sits in ipco (associated or not): av1C's marker and version, pixi's."""
    if kind == b"av1C" and (e - s < 4 or data[s] != 0x81):
        raise _Parse("av1C without marker 1 and version 1")
    if kind == b"ispe" and (e - s < 12 or data[s] != 0):
        raise _Parse("ispe of a version other than 0")
    if kind == b"colr" and data[s : s + 4] == b"nclx" and (e - s < 11 or data[s + 10] & 0x7F):
        raise _Parse("nclx colr with its reserved bits set")
    if kind in (b"irot", b"imir") and (e - s < 1 or data[s] >> (2 if kind == b"irot" else 1)):
        raise _Parse(f"{kind.decode()} with its reserved bits set")
    if kind == b"auxC":
        r = _Reader(data, s, e)
        if r.full()[0] != 0:
            raise _Parse("auxC version is not 0")
        _string(data, r.pos, e, "auxC")
    if kind == b"pixi":
        r = _Reader(data, s, e)
        if r.full()[0] != 0:
            raise _Parse("pixi version is not 0")
        n = r.u(1)
        if n == 0 or n > 4:
            raise ValueError(f"AVIF pixi of {n} planes (libavif: not implemented)")
        depths = [r.u(1) for _ in range(n)]
        if len(set(depths)) > 1:
            raise ValueError("AVIF pixi of planes of different depths (libavif: not implemented)")


def _av1c_depth(data: bytes, it: _Item) -> int:
    s, _ = _prop(it, b"av1C")
    return 12 if data[s + 2] & 0x20 else 10 if data[s + 2] & 0x40 else 8


def _check_pixi(data: bytes, it: _Item) -> None:
    """avifDecoderItemValidateProperties: pixi's depth is av1C's."""
    pixi = _prop(it, b"pixi")
    if pixi is not None and data[pixi[0] + 5] != _av1c_depth(data, it):
        raise _Parse("pixi depth is not av1C's")


def _prop(it: _Item, kind: bytes):
    return next(((s, e) for k, s, e in it.props if k == kind), None)


def _ispe(data: bytes, it: _Item):
    """The item's ispe (width, height), or None; libavif's default limits
    (a side of at most 32768, at most 16384² samples) refuse the rest."""
    box = _prop(it, b"ispe")
    if box is None:
        return None
    r = _Reader(data, *box)
    r.full()
    w, h = r.u(4), r.u(4)
    if not w or not h or w > 32768 or h > 32768 or w * h > 16384 * 16384:
        raise _Parse(f"ispe of {w}x{h} (libavif: outside its size limits)")
    return w, h


def _colr(data: bytes, it_props) -> dict:
    """The nclx box's CICP and range, if the item has one."""
    for k, s, e in it_props:
        if k == b"colr" and data[s : s + 4] == b"nclx" and e - s >= 11:
            cp, tc, mc = struct.unpack(">HHH", data[s + 4 : s + 10])
            return {"cp": cp, "tc": tc, "mc": mc, "full": data[s + 10] >> 7}
    return None


ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


def _track_sample0(data: bytes, trak: tuple) -> tuple:
    """(track id, handler, the track its `auxl` reference names or None,
    sample 0's bytes, the auxiliary type its sample entry's auxi names, the
    media timescale (0 without an mdhd), the sample entry's format, the
    tkhd's (width, height)) of a `trak` box."""
    tid, handler, aux, urn, chunks, sizes, stsc, timescale = None, None, None, None, [], [], [], 0
    dims, fmt = None, None
    stack = [trak]
    while stack:
        s, e = stack.pop()
        boxes = _boxes(data, s, e)
        kinds = [k for k, _, _ in boxes]
        if (s, e) == trak and b"tkhd" not in kinds:
            raise _Parse("trak without tkhd")
        for twice in (b"tkhd", b"edts", b"stbl"):
            if kinds.count(twice) > 1:
                raise _Parse(f"two {twice!r} boxes in one parent")
        for kind, s2, e2 in boxes:
            if kind in (b"mdia", b"minf", b"stbl"):
                stack.append((s2, e2))
            elif kind == b"mdhd":
                r = _Reader(data, s2, e2)
                v, _ = r.full()
                if v > 1:
                    raise _Parse("mdhd of a version above 1")
                r.u(16 if v else 8)
                timescale = r.u(4)
            elif kind == b"edts":
                elst = [(s3, e3) for k3, s3, e3 in _boxes(data, s2, e2) if k3 == b"elst"]
                if len(elst) != 1:
                    raise _Parse("edts without exactly one elst")
                r = _Reader(data, *elst[0])
                v, _ = r.full()
                if v > 1:
                    raise _Parse("elst of a version above 1")
                if r.u(4) != 1:
                    raise _Parse("elst of more or fewer entries than 1")
                if not r.u(8 if v else 4):
                    raise _Parse("elst with a segment_duration of 0")
            elif kind == b"tref":
                for k3, s3, e3 in _boxes(data, s2, e2):
                    if k3 == b"auxl" and e3 - s3 >= 4:
                        aux = int.from_bytes(data[s3 : s3 + 4], "big")
            elif kind == b"tkhd":
                r = _Reader(data, s2, e2)
                v, _ = r.full()
                if v > 1:
                    raise _Parse("tkhd of a version above 1")
                r.u(16 if v == 1 else 8)
                tid = r.u(4)
                r.u(12 if v == 1 else 8)
                r.u(52)
                dims = (r.u(4) >> 16, r.u(4) >> 16)
            elif kind == b"hdlr":
                handler = _handler(data, s2, e2)
            elif kind == b"stsd":
                r = _Reader(data, s2, e2)
                if r.full()[0] > 1:
                    raise _Parse("stsd of a version above 1")
                entries = r.u(4)
                if entries > len(_boxes(data, r.pos, e2)):
                    raise _Parse("stsd names more entries than it holds")
                for fmt, s3, e3 in _boxes(data, r.pos, e2)[:1]:  # the sample entry: 78 bytes, then its boxes
                    for k4, s4, e4 in _boxes(data, s3 + 78, e3) if s3 + 78 <= e3 else []:
                        _check_property(data, k4, s4, e4)
                        if k4 == b"auxi":
                            urn = data[s4 + 4 : e4].split(b"\0")[0]
            elif kind == b"stts":
                r = _Reader(data, s2, e2)
                r.full()
                if r.pos + 4 + 8 * r.u(4) > e2:
                    raise _Parse("stts names more entries than it holds")
            elif kind == b"stsc":
                r = _Reader(data, s2, e2)
                r.full()
                n = r.u(4)
                stsc = [(r.u(4), r.u(4), r.u(4))[:2] for _ in range(n)]
                if stsc and stsc[0][0] != 1 or any(a[0] >= b[0] for a, b in zip(stsc, stsc[1:])):
                    raise _Parse("stsc chunks not from 1, strictly increasing")
            elif kind in (b"stco", b"co64"):
                r = _Reader(data, s2, e2)
                r.full()
                chunks = [r.u(4 if kind == b"stco" else 8) for _ in range(r.u(4))]
            elif kind == b"stsz":
                r = _Reader(data, s2, e2)
                r.full()
                size, count = r.u(4), r.u(4)
                sizes = [size] * count if size else [r.u(4) for _ in range(count)]
    # libavif places every sample (chunk offsets, stsc's samples per chunk, stsz's sizes) and
    # refuses a sample that stsz does not size or that runs past the file
    samples = []
    for c, off in enumerate(chunks):
        for _ in range(next((n for first, n in reversed(stsc) if first <= c + 1), 0)):
            if len(samples) == len(sizes):
                raise _Parse("stsc places more samples than stsz sizes")
            if off + sizes[len(samples)] > len(data):
                raise _Parse("sample runs past the file (libavif: truncated data)")
            samples.append((off, sizes[len(samples)]))
            off += samples[-1][1]
    if not samples:
        raise _Parse("track without its first sample")
    off, size = samples[0]
    return tid, handler, aux, data[off : off + size], urn, timescale, fmt, dims


def _top(data: bytes) -> tuple:
    """(the ftyp brands, the top-level boxes) as libavif's avifParse walks
    them: ftyp first; ftyp, meta and moov read whole, any other box skipped
    by its size unread; the walk ended once ftyp and what its brands need
    (meta for `avif`, moov for `avis`) are seen."""
    top, pos, brands = [], 0, None
    while pos < len(data):
        if pos + 8 > len(data):
            raise _Parse("box header cut short")
        size, kind = struct.unpack(">I4s", data[pos : pos + 8])
        head, to_end = 8, size == 0
        if size == 1:
            if pos + 16 > len(data):
                raise _Parse("box header cut short")
            size, head = struct.unpack(">Q", data[pos + 8 : pos + 16])[0], 16
        elif to_end:
            size = len(data) - pos
        if size < head:
            raise _Parse(f"box {kind!r} smaller than its header")
        if brands is None and kind != b"ftyp":
            raise _Parse("no ftyp box first (libavif: invalid ftyp)")
        if kind in (b"ftyp", b"meta", b"moov"):
            if pos + size > len(data):
                raise _Parse(f"box {kind!r} runs past the file (libavif: truncated data)")
            top.append((kind, pos + head, pos + size))
        elif to_end:
            raise _Parse(f"box {kind!r} of size 0 before the boxes the brands need (libavif: truncated data)")
        if kind == b"ftyp":
            s, e = pos + head, pos + size
            if e - s < 8 or (e - s) % 4:
                raise _Parse("ftyp box of a size that is not 8 and a whole number of brands")
            brands = [data[s : s + 4]] + [data[i : i + 4] for i in range(s + 8, e, 4)]
            if b"avif" not in brands and b"avis" not in brands:
                raise _Parse("ftyp has neither the avif nor the avis brand (libavif: invalid ftyp)")
        pos += size
        kinds = [k for k, _, _ in top]
        if (b"avif" not in brands or b"meta" in kinds) and (b"avis" not in brands or b"moov" in kinds):
            break
    if brands is None:
        raise _Parse("no ftyp box first (libavif: invalid ftyp)")
    return brands, top


def _parse(data: bytes) -> dict:
    """The colour and alpha AV1 data libavif decodes for PIL's frame 0, and
    the properties that shape the conversion."""
    brands, top = _top(data)
    meta = next(((s, e) for k, s, e in top if k == b"meta"), None)
    moov = next(((s, e) for k, s, e in top if k == b"moov"), None)
    out = {"colr": None, "alpha": None, "premultiplied": False}
    if moov is not None and b"avis" in brands:
        tracks = [_track_sample0(data, (s, e)) for k, s, e in _boxes(data, *moov) if k == b"trak"]
        color = next((t for t in tracks if t[2] is None and t[6] == b"av01"), None)
        if color is None:
            raise _Parse("sequence without a colour track")
        if not color[5]:  # PIL divides the frame's timestamp by the track's timescale
            raise ValueError("AVIF sequence whose colour track has no timescale (PIL divides by it)")
        out["color"] = color[3]
        out["ispe"] = color[7]  # libavif scales a frame to its track's tkhd size, as to an item's ispe
        alpha = next((t for t in tracks if t[2] == color[0] and t[4] in ALPHA_URNS and t[6] == b"av01"), None)
        if alpha is not None:
            out["alpha"], out["alpha_ispe"] = alpha[3], alpha[7]
        if meta is not None:
            m = _meta(data, *meta)
            if m["primary"] in m["items"]:
                primary = m["items"][m["primary"]]
                if primary.extents and primary.type == b"av01" and not primary.unsupported_essential \
                        and _ispe(data, primary) is None:
                    raise _Parse("primary item without ispe")
                out["colr"] = _colr(data, primary.props)
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
    if it.unsupported_essential:
        raise ValueError("AVIF primary item with an essential property libavif does not know (libavif: missing "
                         "image item)")
    if it.type in (b"grid", b"iovl"):
        raise av1.Refused("", GRID)
    if it.type != b"av01":
        raise _Parse(f"primary item of type {it.type!r}")
    if _prop(it, b"ispe") is None:
        raise _Parse("primary item without ispe")
    if _prop(it, b"av1C") is None:
        raise _Parse("primary item without av1C")
    _check_pixi(data, it)
    for other in items.values():  # libavif reads the Exif and XMP items of the primary item while parsing
        if it.id in other.refs.get(b"cdsc", []) and (other.type == b"Exif" or (
                other.type == b"mime" and other.content_type == b"application/rdf+xml")):
            try:
                _extent_data(data, other, m)
            except ValueError:
                raise _Parse(f"metadata item {other.id} runs past the file (libavif: truncated data)") from None
    out["color"] = _extent_data(data, it, m)
    out["colr"] = _colr(data, it.props)
    out["ispe"] = _ispe(data, it)
    for other in items.values():
        if other is it or it.id not in other.refs.get(b"auxl", []):
            continue
        # libavif passes over an item without data, of a type it does not decode, or with an
        # essential property it does not know; an AV1 image item it keeps must have av1C
        if not other.extents or other.type not in (b"av01", b"grid", b"iovl") or other.unsupported_essential:
            continue
        if other.type == b"av01" and _prop(other, b"av1C") is None:
            raise _Parse(f"AV1 item {other.id} without av1C")
        aux = _prop(other, b"auxC")
        if aux is not None and data[aux[0] + 4 : aux[1]].split(b"\0")[0] in ALPHA_URNS:
            if other.type in (b"grid", b"iovl"):
                raise av1.Refused("", GRID)
            _check_pixi(data, other)
            out["alpha"] = _extent_data(data, other, m)
            out["alpha_ispe"] = _ispe(data, other)
            out["premultiplied"] = other.id in it.refs.get(b"prem", [])
            break
    return out


# matrix coefficients -> libyuv constants (full, limited) as libavif picks them
_LIBYUV = {1: ("F709", "H709"), 2: ("JPEG", "I601"), 5: ("JPEG", "I601"), 6: ("JPEG", "I601"),
           9: ("V2020", None)}
_KINDS = {"JPEG": 0, "I601": 1, "F709": 2, "H709": 3, "V2020": 4}
# what libavif itself refuses: identity with subsampled chroma, these matrices, and 16 and above
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
    _same_size(hdr, parts.get("ispe"), name)
    alpha = None
    if parts["alpha"] is not None:
        aseq, ahdr, (a, _, _) = av1.decode(parts["alpha"], f"{name} (alpha)")
        _same_size(ahdr, parts.get("alpha_ispe"), name)
        if a.shape != y.shape:
            raise ValueError(f"{name}: AVIF alpha plane of another size than the image")
        alpha = np.ascontiguousarray(a)
        if not aseq["full_range"]:  # libavif's avifLimitedToFullY: C division, truncating, then clamped
            t = (alpha.astype(np.int32) - 16) * 255 + 109
            alpha = np.clip(np.sign(t) * (np.abs(t) // 219), 0, 255).astype(np.uint8)
    colr = parts["colr"]
    mc = colr["mc"] if colr else seq["mc"]
    full = colr["full"] if colr else seq["full_range"]
    return rgb(y, u, v, alpha, seq, mc, full, parts["premultiplied"], name), ("RGBA" if alpha is not None else "RGB")


def _same_size(hdr: dict, ispe, name: str) -> None:
    if ispe is not None and ispe != (hdr["width"], hdr["height"]):
        raise av1.Refused(name, SCALED.format(hdr["width"], hdr["height"], *ispe))


def rgb(y, u, v, alpha, seq: dict, mc: int, full: int, premultiplied: bool, name: str) -> np.ndarray:
    """libavif's avifImageYUVToRGB as PIL calls it (8-bit RGB or RGBA)."""
    h, w = y.shape
    mono = u is None
    if (mc in _LIBAVIF_REFUSES or mc >= 16 or (mc == 8 and not full)
            or (mc == 0 and not mono and (seq["ssx"] or seq["ssy"]))):
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
