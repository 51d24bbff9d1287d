"""JPEG 2000 test files, each made from a seed of its name: `CASES[name]` is
(extension, function) and `case_bytes(name)` the file.

- "pil-*": PIL 12.1's writer (OpenJPEG 2.5.4's encoder) at its options:
  5/3 and 9/7, `mct` on and off, 1-6 resolutions, code-block and precinct
  sizes, the five progression orders, tiles with `tile_offset` and
  `offset`, quality layers (rates and dB), PLT, a comment, signed samples,
  modes L / LA / RGB / RGBA / I;16, JP2 files and raw codestreams, at odd
  sizes (37x29 and the like) so that code-blocks, precincts and tiles are
  cut at the edges;
- "cv-*": OpenCV's writer (its own OpenJPEG 2.5.3): 8- and 16-bit gray,
  BGR and BGRA, lossless and at a rate;
- "box-*": JP2 files built here around those codestreams, for what no
  writer here makes: a `pclr` palette (with repeated entries, 3 or 4
  columns, over 8 bits) with `cmap`, `cdef`, CMYK, sYCC, gray, ICC and
  unknown colour spaces, `res `, boxes after the codestream box, a `jp2c`
  box of length 0, an `ihdr` whose size is not the codestream's;
- "cs-*": codestreams edited here: every code-block style bit (bypass,
  reset, terminate-all, vertically causal, predictable termination,
  segmentation symbols, high-throughput), RGN shifts, POC, COM / CRG / TLM
  / PLM and unknown markers, SOP / EPH flags, subsampled components, other
  precisions, a tile split into tile-parts (TNsot set or 0), Psot 0.
  Edits change what the entropy-coded data means, so most decode to other
  pixels: OpenJPEG's decode of them is what the port is held to.

`mutants(name, seed, n)` are corrupt copies (a byte set, the file cut, a
byte put in).  Used by tests/test_torch_jpeg2000.py and
tests/make_torch_jpeg2000.py; needs PIL and OpenCV.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
from PIL import Image

SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
CASES = {}


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def case(name: str, ext: str = ".jp2"):
    def register(fn):
        CASES[name] = (ext, fn)
        return fn
    return register


def case_bytes(name: str) -> bytes:
    return CASES[name][1](_rng(name))


def image(rng, h: int, w: int, c: int, depth: int = 8) -> np.ndarray:
    """A smooth ramp with noise: partly compressible, every sample used."""
    ramp = np.add.outer(np.arange(h) * 5, np.arange(w) * 3)[..., None] + np.arange(c) * 40
    top = (1 << depth) - 1
    noise = rng.integers(0, max(top // 6, 2), (h, w, c))
    arr = (ramp * (top // 255 or 1) + noise) % (top + 1)
    arr = arr.astype(np.uint16 if depth > 8 else np.uint8)
    return arr[..., 0] if c == 1 else arr


def pil_j2k(arr: np.ndarray, mode: str | None = None, **kw) -> bytes:
    im = Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)
    out = io.BytesIO()
    im.save(out, format="JPEG2000", **kw)
    return out.getvalue()


_CHANNELS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _pil(rng, mode: str, h: int = 29, w: int = 37, **kw) -> bytes:
    if mode == "I;16":
        return pil_j2k(image(rng, h, w, 1, 16), **kw)
    return pil_j2k(image(rng, h, w, _CHANNELS[mode]), mode, **kw)


for _mode in ("L", "LA", "RGB", "RGBA", "I;16"):
    for _irr in (False, True):
        for _raw in (False, True):
            @case(f"pil-{_mode.replace(';', '')}-{'97' if _irr else '53'}-{'j2k' if _raw else 'jp2'}",
                  ".j2k" if _raw else ".jp2")
            def _(rng, mode=_mode, irr=_irr, raw=_raw):
                return _pil(rng, mode, irreversible=irr, no_jp2=raw)
for _n in range(1, 7):
    @case(f"pil-res{_n}")
    def _(rng, n=_n):  # six resolutions need 32 samples each way
        return _pil(rng, "RGB", *((37, 29) if n < 6 else (67, 71)), num_resolutions=n)
for _cb in ((4, 4), (8, 16), (16, 8), (32, 32), (4, 64), (64, 16)):
    @case(f"pil-cblk{_cb[0]}x{_cb[1]}")
    def _(rng, cb=_cb):
        return _pil(rng, "RGB", 37, 29, codeblock_size=cb)
for _ps in ((32, 64), (64, 32), (128, 128)):
    @case(f"pil-prc{_ps[0]}x{_ps[1]}")
    def _(rng, ps=_ps):
        return _pil(rng, "RGB", 61, 53, precinct_size=ps, codeblock_size=(8, 8))
for _prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
    for _layers in (None, (40, 20, 5)):
        @case(f"pil-{_prog.lower()}-{'layers' if _layers else 'one'}")
        def _(rng, prog=_prog, layers=_layers):
            return _pil(rng, "RGB", 61, 53, progression=prog, precinct_size=(32, 32), codeblock_size=(8, 8),
                        quality_layers=list(layers) if layers else None, irreversible=bool(layers))
for _k, (_ts, _to, _off) in enumerate((((16, 16), None, None), ((16, 24), (3, 5), (7, 9)), ((32, 32), (0, 0), (5, 3)),
                                        ((20, 20), (1, 2), (10, 11)))):
    @case(f"pil-tiles{_k}-53")
    def _(rng, ts=_ts, to=_to, off=_off):
        return _pil(rng, "RGB", 53, 61, tile_size=ts, **({"tile_offset": to} if to else {}),
                    **({"offset": off} if off else {}))
    if _ts != (16, 24):  # OpenJPEG's 9/7 encoder asserts on that layout's one-sample tile edges
        @case(f"pil-tiles{_k}-97-rgba")
        def _(rng, ts=_ts, to=_to, off=_off):
            return _pil(rng, "RGBA", 53, 61, irreversible=True, tile_size=ts, **({"tile_offset": to} if to else {}),
                        **({"offset": off} if off else {}))
for _q in ((30,), (50, 30, 10), (80, 40, 20, 10, 5)):
    @case(f"pil-rates{len(_q)}")
    def _(rng, q=_q):
        return _pil(rng, "RGB", 53, 61, quality_layers=list(q))
    @case(f"pil-db{len(_q)}")
    def _(rng, q=_q):
        return _pil(rng, "RGB", 53, 61, quality_mode="dB", quality_layers=[x + 20 for x in q][::-1])
case("pil-plt")(lambda rng: _pil(rng, "RGB", 53, 61, plt=True))
case("pil-comment", ".j2k")(lambda rng: _pil(rng, "RGB", 53, 61, comment="vpt_tpu", no_jp2=True))
case("pil-signed-L")(lambda rng: _pil(rng, "L", 53, 61, signed=True))
case("pil-signed-RGB-97")(lambda rng: _pil(rng, "RGB", 53, 61, signed=True, irreversible=True))
case("pil-mct0-97")(lambda rng: _pil(rng, "RGB", 53, 61, mct=0, irreversible=True))
case("pil-1x1")(lambda rng: _pil(rng, "RGB", 1, 1))
case("pil-1x40", ".j2k")(lambda rng: _pil(rng, "L", 1, 40, no_jp2=True))
case("pil-40x1")(lambda rng: _pil(rng, "L", 40, 1))


def _cv(rng, c: int, depth: int, params=()) -> bytes:
    import cv2

    ok, enc = cv2.imencode(".jp2", image(rng, 67, 71, c, depth), list(params))
    assert ok
    return enc.tobytes()


for _c, _name in ((1, "gray"), (3, "bgr"), (4, "bgra")):
    for _depth in (8, 16):
        @case(f"cv-{_name}{_depth}")
        def _(rng, c=_c, depth=_depth):
            return _cv(rng, c, depth)


@case("cv-bgr8-rate")
def _(rng):
    import cv2

    return _cv(rng, 3, 8, (cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 200))


# ---------------------------------------------------------------------------
# JP2 boxes around a codestream


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2(cs: bytes, h: int, w: int, nc: int, bpc: int = 7, colr=(1, 16), header=(), after_header=(),
        after=(), jp2c_length=None, brand=b"jp2 ") -> bytes:
    """A JP2 file: signature, file type, header (ihdr, colr, then `header`'s
    boxes), `after_header`'s boxes, the codestream box, `after`'s boxes."""
    ihdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    meth, spec = colr if colr else (None, None)
    colr_box = b"" if colr is None else box(b"colr", struct.pack(">BBB", meth, 0, 0) + (
        struct.pack(">I", spec) if meth == 1 else spec))
    jp2c = box(b"jp2c", cs) if jp2c_length is None else struct.pack(">I", jp2c_length) + b"jp2c" + cs
    return (SIGNATURE + box(b"ftyp", brand + b"\0\0\0\0" + b"jp2 ") + box(b"jp2h", ihdr + colr_box + b"".join(header))
            + b"".join(after_header) + jp2c + b"".join(after))


def pclr(entries, depths) -> bytes:
    body = struct.pack(">HB", len(entries), len(depths)) + bytes(depths)
    for e in entries:
        body += b"".join(v.to_bytes((d & 0x7F) // 8 + 1, "big") for v, d in zip(e, depths))
    return box(b"pclr", body)


def cmap(n: int) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(n)))


def _indices(rng, h: int, w: int, n: int, c: int = 1) -> bytes:
    idx = rng.integers(0, n, (h, w)).astype(np.uint8)
    if c == 2:
        return pil_j2k(np.stack([idx, rng.integers(0, 256, (h, w)).astype(np.uint8)], -1), "LA", no_jp2=True)
    return pil_j2k(idx, no_jp2=True)


def _palette(rng, n: int, npc: int, repeats: bool = True) -> list:
    pal = [tuple(int(v) for v in rng.integers(0, 256, npc)) for _ in range(n)]
    if repeats:
        pal[3] = pal[1]
        pal[7] = pal[0]
    return pal


@case("box-pclr-rgb")
def _(rng):
    return jp2(_indices(rng, 21, 23, 12), 21, 23, 1, header=(pclr(_palette(rng, 12, 3), [7, 7, 7]), cmap(3)))


@case("box-pclr-rgba")
def _(rng):
    return jp2(_indices(rng, 21, 23, 12), 21, 23, 1, header=(pclr(_palette(rng, 12, 4), [7] * 4), cmap(4)))


@case("box-pclr-la")
def _(rng):
    return jp2(_indices(rng, 21, 23, 10, 2), 21, 23, 2, header=(pclr(_palette(rng, 10, 3), [7, 7, 7]), cmap(3)))


@case("box-pclr-9bit")
def _(rng):  # PIL compares the raw depth byte (8 for 9 bits) with 8: a palette
    return jp2(_indices(rng, 21, 23, 12), 21, 23, 1, header=(pclr(_palette(rng, 12, 3), [8, 8, 8]), cmap(3)))


@case("box-pclr-16bit")
def _(rng):  # over 8 bits: PIL keeps "L"
    pal = [tuple(int(v) * 200 for v in e) for e in _palette(rng, 12, 3)]
    return jp2(_indices(rng, 21, 23, 12), 21, 23, 1, header=(pclr(pal, [15, 15, 15]), cmap(3)))


@case("box-pclr-1col")
def _(rng):
    return jp2(_indices(rng, 21, 23, 6), 21, 23, 1, header=(pclr(_palette(rng, 6, 1, False), [7]), cmap(1)))


@case("box-pclr-300")
def _(rng):  # more colours than PIL's palette holds: PIL refuses
    pal = [(k % 256, k // 256, 7) for k in range(300)]
    return jp2(_indices(rng, 21, 23, 200), 21, 23, 1, header=(pclr(pal, [7, 7, 7]), cmap(3)))


@case("box-cdef-rgba")
def _(rng):
    cdef = box(b"cdef", struct.pack(">H", 4) + b"".join(struct.pack(">HHH", i, t, a) for i, t, a in
                                                         ((0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0))))
    return jp2(pil_j2k(image(rng, 21, 23, 4), "RGBA", no_jp2=True), 21, 23, 4, header=(cdef,))


for _cs, _nc, _mode in ((12, 4, "RGBA"), (18, 3, "RGB"), (18, 4, "RGBA"), (17, 4, "RGBA"), (17, 3, "RGB"),
                        (16, 1, "L"), (24, 3, "RGB"), (14, 3, "RGB"), (99, 3, "RGB")):
    @case(f"box-colr{_cs}-{_nc}")
    def _(rng, cs=_cs, nc=_nc, mode=_mode):
        arr = image(rng, 21, 23, nc)
        return jp2(pil_j2k(arr, mode, no_jp2=True), 21, 23, nc, colr=(1, cs))


case("box-icc")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3, colr=(2, b"ICCPROFILE")))
case("box-meth3")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3, colr=(3, b"\0\0\0\0")))
case("box-no-colr")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 2), "LA", no_jp2=True), 21, 23, 2, colr=None))
case("box-colr-twice")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3,
                                       header=(box(b"colr", struct.pack(">BBBI", 1, 0, 0, 18)),)))
case("box-res")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3,
                                header=(box(b"res ", box(b"resc", struct.pack(">HHHHBB", 72, 1, 96, 1, 2, 2))),)))
case("box-xml-between")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3,
                                        after_header=(box(b"xml ", b"<a/>"),)))
case("box-uuid-after")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3,
                                       after=(box(b"uuid", bytes(20)),)))
case("box-ihdr-after")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3,
                                       after=(box(b"ihdr", struct.pack(">IIHBBBB", 21, 23, 3, 7, 7, 0, 0)),)))
case("box-jp-after")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3,
                                     after=(box(b"jP  ", b"\x0d\x0a\x87\x0a"),)))
case("box-jp2c-len0")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3, jp2c_length=0))
case("box-jpx-brand")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 21, 23, 3, brand=b"jpx "))
case("box-ihdr-size")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 3), no_jp2=True), 22, 23, 3))
case("box-16bit")(lambda rng: jp2(pil_j2k(image(rng, 21, 23, 1, 16), no_jp2=True), 21, 23, 1, bpc=15, colr=(1, 17)))


# ---------------------------------------------------------------------------
# Codestream edits


def markers(cs: bytes) -> list:
    """(offset, marker, segment length) of the main header's markers, up to
    and with the first SOT."""
    out, p = [], 2
    while p + 4 <= len(cs):
        m, length = struct.unpack_from(">HH", cs, p)
        out.append((p, m, length))
        if m == 0xFF90:
            break
        p += 2 + length
    return out


def _at(cs: bytes, marker: int) -> int:
    return next(p for p, m, _ in markers(cs) if m == marker)


def insert_main(cs: bytes, seg: bytes) -> bytes:
    sot = _at(cs, 0xFF90)
    return cs[:sot] + seg + cs[sot:]


def _base(rng, mode: str = "RGB", **kw) -> bytes:
    return _pil(rng, mode, 29, 37, no_jp2=True, **kw)


for _bits in (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x03, 0x09, 0x28, 0x40):
    @case(f"cs-style{_bits:02x}", ".j2k")
    def _(rng, bits=_bits):
        cs = bytearray(_base(rng))
        cs[_at(cs, 0xFF52) + 12] = bits  # SPcod: levels, width, height, style, transform
        return bytes(cs)

    @case(f"cs-style{_bits:02x}-97", ".j2k")
    def _(rng, bits=_bits):
        cs = bytearray(_base(rng, irreversible=True, quality_layers=[30, 10]))
        cs[_at(cs, 0xFF52) + 12] = bits
        return bytes(cs)
for _shift in (1, 3, 7, 20, 31):
    @case(f"cs-rgn{_shift}", ".j2k")
    def _(rng, shift=_shift):
        return insert_main(_base(rng), struct.pack(">HHBBB", 0xFF5E, 5, 1, 0, shift))
case("cs-poc2", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HH", 0xFF5F, 16) + struct.pack(
    ">BBHBBBBBHBBB", 0, 0, 1, 3, 3, 2, 3, 0, 1, 33, 3, 0)))
case("cs-poc-cprl", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HHBBHBBB", 0xFF5F, 9, 0, 0, 1, 33,
                                                                            3, 4)))
case("cs-markers", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HHH", 0xFF64, 8, 1) + b"abcd" + struct.pack(
    ">HH", 0xFF63, 14) + bytes(12) + struct.pack(">HHBB", 0xFF55, 4, 0, 0) + struct.pack(">HHB", 0xFF57, 3, 0)))
case("cs-unknown-marker", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HH", 0xFF30, 4) + b"xx"))
for _scod in (2, 4):
    @case(f"cs-scod{_scod}", ".j2k")
    def _(rng, scod=_scod):
        cs = bytearray(_base(rng))
        cs[_at(cs, 0xFF52) + 4] |= scod
        return bytes(cs)
for _comps, _dxy in (((1, 2), (2, 2)), ((1,), (2, 1)), ((0,), (1, 2)), ((0, 1, 2), (3, 3))):
    @case(f"cs-sub{''.join(map(str, _comps))}-{_dxy[0]}x{_dxy[1]}", ".j2k")
    def _(rng, comps=_comps, dxy=_dxy):
        cs = bytearray(_base(rng))
        p = _at(cs, 0xFF51) + 4 + 36
        for c in comps:
            cs[p + 3 * c + 1 : p + 3 * c + 3] = bytes(dxy)
        return bytes(cs)
for _prec in (4, 12, 16, 24):
    for _signed in (False, True):
        @case(f"cs-prec{_prec}{'s' if _signed else ''}", ".j2k")
        def _(rng, prec=_prec, signed=_signed):
            cs = bytearray(_base(rng, "L"))
            cs[_at(cs, 0xFF51) + 4 + 36] = (0x80 if signed else 0) | (prec - 1)
            return bytes(cs)


def split_tile(cs: bytes, frac: float, tnsot: int) -> bytes:
    """The first tile's data split into two tile-parts at `frac`."""
    sot = _at(cs, 0xFF90)
    psot = struct.unpack_from(">I", cs, sot + 6)[0]
    sod = cs.index(b"\xff\x93", sot + 12)
    data, rest = cs[sod + 2 : sot + psot], cs[sot + psot :]
    k = int(len(data) * frac)
    head = cs[sot + 12 : sod]
    return (cs[:sot] + struct.pack(">HHHIBB", 0xFF90, 10, 0, 14 + len(head) + k, 0, tnsot) + head + b"\xff\x93"
            + data[:k] + struct.pack(">HHHIBB", 0xFF90, 10, 0, 14 + len(data) - k, 1, tnsot) + b"\xff\x93" + data[k:]
            + rest)


case("cs-tileparts", ".j2k")(lambda rng: split_tile(_base(rng), 0.5, 2))
case("cs-tileparts-tn0", ".j2k")(lambda rng: split_tile(_base(rng), 0.3, 0))
case("cs-tileparts-tiny", ".j2k")(lambda rng: split_tile(_base(rng), 0.01, 2))


@case("cs-psot0", ".j2k")
def _(rng):
    cs = bytearray(_base(rng))
    sot = _at(cs, 0xFF90)
    cs[sot + 6 : sot + 10] = bytes(4)
    return bytes(cs)


def mutants(name: str, seed: int, n: int) -> list:
    """n corrupt copies of case `name`: a byte set, the file cut, or a byte
    put in, at a place drawn from the seed."""
    data = case_bytes(name)
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    out = []
    for _ in range(n):
        d = bytearray(data)
        kind, pos = int(rng.integers(0, 3)), int(rng.integers(0, len(d)))
        if kind == 0:
            d[pos] = int(rng.integers(0, 256))
        elif kind == 1:
            del d[pos:]
        else:
            d[pos:pos] = bytes([int(rng.integers(0, 256))])
        out.append(bytes(d))
    return out


class _Bits:
    """OpenJPEG's packet-header bit reader (a byte after 0xFF holds 7 bits)."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.buf, self.ct = data, 0, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.pos < len(self.data):
                self.buf |= self.data[self.pos]
                self.pos += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        return sum(self.bit() << i for i in range(n - 1, -1, -1))

    def align(self) -> int:
        if (self.buf & 0xFF) == 0xFF:
            self.ct = 0
            self.bit()
        return self.pos


def _packet(data: bytes) -> tuple:
    """(header bytes, body bytes) of the first packet of a single-layer
    codestream whose packets each hold one code-block, included."""
    b = _Bits(data)
    assert b.bit() == 1 and b.bit() == 1  # present, included
    while b.bit() == 0:  # zero bit-planes
        pass
    if not b.bit():
        passes = 1
    elif not b.bit():
        passes = 2
    elif (n := b.bits(2)) != 3:
        passes = 3 + n
    elif (n := b.bits(5)) != 31:
        passes = 6 + n
    else:
        passes = 37 + b.bits(7)
    lblock = 3
    while b.bit():
        lblock += 1
    length = b.bits(lblock + passes.bit_length() - 1)
    end = b.align()
    return data[:end], data[end : end + length]


def _repacked(rng, ppm: bool = False, ppt: bool = False, sop: bool = False, eph: bool = False) -> bytes:
    """An RGB codestream of one resolution, layer and code-block per
    component, its packet headers moved to a PPM or PPT marker and / or
    SOP and EPH markers put around them (Scod set to say so).  Every
    variant holds the same pixels (one seed), so each decodes as the plain
    one does."""
    del rng
    cs = bytearray(pil_j2k(image(np.random.default_rng(2000), 21, 23, 3), no_jp2=True, num_resolutions=1))
    cod = _at(cs, 0xFF52)
    cs[cod + 4] |= (2 if sop else 0) | (4 if eph else 0)
    cs = bytes(cs)
    sot = _at(cs, 0xFF90)
    psot = struct.unpack_from(">I", cs, sot + 6)[0]
    sod = cs.index(b"\xff\x93", sot + 12)
    data, headers, bodies = cs[sod + 2 : sot + psot], [], []
    for _ in range(3):
        head, body = _packet(data)
        data = data[len(head) + len(body) :]
        headers.append(head + (b"\xff\x92" if eph else b""))
        bodies.append(body)
    assert not data
    sops = [struct.pack(">HHH", 0xFF91, 4, k) if sop else b"" for k in range(3)]
    if ppm or ppt:
        stream = b"".join(s + body for s, body in zip(sops, bodies))
    else:
        stream = b"".join(s + h + body for s, h, body in zip(sops, headers, bodies))
    all_heads = b"".join(headers)
    tile_head = struct.pack(">HHB", 0xFF61, 3 + len(all_heads), 0) + all_heads if ppt else b""
    main = cs[:sot]
    if ppm:
        main += struct.pack(">HHBI", 0xFF60, 7 + len(all_heads), 0, len(all_heads)) + all_heads
    tile = struct.pack(">HHHIBB", 0xFF90, 10, 0, 14 + len(tile_head) + len(stream), 0, 1) + tile_head
    return main + tile + b"\xff\x93" + stream + cs[sot + psot :]


case("cs-ppm", ".j2k")(lambda rng: _repacked(rng, ppm=True))
case("cs-ppt", ".j2k")(lambda rng: _repacked(rng, ppt=True))
case("cs-sop-eph", ".j2k")(lambda rng: _repacked(rng, sop=True, eph=True))
case("cs-ppm-sop-eph", ".j2k")(lambda rng: _repacked(rng, ppm=True, sop=True, eph=True))
case("cs-ppt-eph", ".j2k")(lambda rng: _repacked(rng, ppt=True, eph=True))
case("cs-repacked", ".j2k")(lambda rng: _repacked(rng))


def _mct(index: int, kind: int, element: int, values) -> bytes:
    """An MCT marker: record `index`, array type `kind` (1 decorrelation,
    2 offsets), elements int16 (0), int32 (1), float32 (2) or float64 (3)."""
    fmt = ">" + "hifd"[element] * len(values)
    body = struct.pack(">HHH", 0, (element << 10) | (kind << 8) | index, 0) + struct.pack(fmt, *values)
    return struct.pack(">HH", 0xFF74, 2 + len(body)) + body


def _mcc(index: int, deco: int, offset: int, n: int = 3) -> bytes:
    """An MCC marker: one array-based collection of components 0..n-1."""
    comps = bytes(range(n))
    body = (struct.pack(">HBHH", 0, index, 0, 1) + b"\x01" + struct.pack(">H", n) + comps + struct.pack(">H", n) + comps
            + struct.pack(">I", (1 << 16) | (offset << 8) | deco)[1:])
    return struct.pack(">HH", 0xFF75, 2 + len(body)) + body


def _mco(*indices) -> bytes:
    return struct.pack(">HHB", 0xFF77, 3 + len(indices), len(indices)) + bytes(indices)


# Part 2 markers, which OpenJPEG reads though it applies no custom
# transform: an MCO resets the DC level shifts, or sets them from an
# offset array; a CBD sets the components' precision.
case("cs-cbd", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HHH", 0xFF78, 7, 3) + bytes([0x07, 0x0B, 0x86])))
case("cs-cbd-gray16", ".j2k")(lambda rng: insert_main(_base(rng, "L"), struct.pack(">HHH", 0xFF78, 5, 1) + bytes([0x8F])))
case("cs-cbd-wrong-count", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HHH", 0xFF78, 7, 2) + bytes(3)))
case("cs-mco-none", ".j2k")(lambda rng: insert_main(_base(rng), _mco()))
case("cs-mco-offsets", ".j2k")(lambda rng: insert_main(_base(rng), _mct(1, 2, 0, (100, 7, -60)) + _mcc(4, 0, 1) + _mco(4)))
case("cs-mco-offsets-97", ".j2k")(lambda rng: insert_main(_base(rng, irreversible=True),
                                                          _mct(1, 2, 2, (90.5, 3.0, -2e10)) + _mcc(4, 0, 1) + _mco(4)))
case("cs-mco-decorrelation", ".j2k")(lambda rng: insert_main(_base(rng), _mct(2, 1, 3, (1.0,) * 9) + _mcc(5, 2, 0)
                                                             + _mco(5)))
case("cs-mco-bad-size", ".j2k")(lambda rng: insert_main(_base(rng), _mct(2, 1, 1, (1,) * 8) + _mcc(5, 2, 0) + _mco(5)))
case("cs-mco-unknown", ".j2k")(lambda rng: insert_main(_base(rng), _mco(9)))
case("cs-mcc-missing-array", ".j2k")(lambda rng: insert_main(_base(rng), _mcc(5, 3, 0)))
case("cs-mct-spanning", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HHHHH", 0xFF74, 10, 1, 0x201, 0)
                                                        + bytes(2)))
case("cs-cap-cpf", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HHIH", 0xFF50, 8, 1 << 17, 0x0002)
                                                   + struct.pack(">HHH", 0xFF59, 4, 0)))
case("cs-cap-empty", ".j2k")(lambda rng: insert_main(_base(rng), struct.pack(">HH", 0xFF50, 2)))
