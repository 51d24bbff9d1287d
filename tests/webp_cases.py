"""The WebP files of tests/test_torch_webp.py, each made from a numpy seed
of its name when asked for: what PIL's encoder (libwebp) writes, lossless
and lossy, with and without alpha, still and animated; and what a small RIFF
writer here builds from PIL's chunks: extended files with metadata and
unknown chunks, alpha flags that disagree with the chunks, an animation's
first frame at an offset inside a larger canvas, ALPH chunks under each
filter (raw, and lossless through a VP8L stream whose green is the alpha),
and the container faults PIL refuses.

`CASES` maps a case's name to its builder; `case_bytes(name)` gives its
bytes; `REFUSED` names the cases PIL refuses.  Needs PIL; no JAX.
"""

from __future__ import annotations

import functools
import io
import struct
import zlib

import numpy as np
from PIL import Image


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def field(rng, h: int, w: int, c: int) -> np.ndarray:
    """(h, w, c) uint8: smooth colour ramps, a bright spot and noise; a
    fourth channel is a soft disc with noisy edges (an alpha mask)."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w, 2)
    base = np.stack([np.sin(5 * x + 2 * y + k) * 0.4 + 0.5 for k in range(min(c, 3))], axis=-1)
    base[(x - 0.6) ** 2 + (y - 0.3) ** 2 < 0.02] *= 1.8
    if c == 4:
        disc = np.clip(1.6 - 4.0 * np.hypot(x - 0.45, y - 0.55), 0.0, 1.0)
        base = np.concatenate([base, disc[..., None]], axis=-1)
    return np.clip((base + rng.normal(0.0, 0.03, base.shape)) * 255, 0, 255).astype(np.uint8)


def pil_webp(arr: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(arr).save(out, format="WEBP", **kw)
    return out.getvalue()


def pil_animation(frames, **kw) -> bytes:
    out = io.BytesIO()
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(out, format="WEBP", save_all=True, append_images=ims[1:], duration=40, **kw)
    return out.getvalue()


# ----------------------------------------------------------- RIFF writer


def chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a WebP file's top-level chunks."""
    pos, out = 12, []
    while pos + 8 <= len(data):
        kind, n = data[pos : pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((kind, data[pos + 8 : pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def chunk(kind: bytes, payload: bytes) -> bytes:
    return kind + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1 else b"")


def riff(parts) -> bytes:
    """A RIFF / WEBP file of (fourcc, payload) chunks or chunk bytes."""
    body = b"WEBP" + b"".join(p if isinstance(p, bytes) else chunk(*p) for p in parts)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w: int, h: int, flags: int) -> tuple:
    return b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")


def anim(background: int = 0xFF336699, loops: int = 0) -> tuple:
    return b"ANIM", struct.pack("<IH", background, loops)


def anmf(x: int, y: int, w: int, h: int, parts, duration: int = 40, bits: int = 0) -> tuple:
    """An animation frame at (x, y) (even): its header, then its ALPH / VP8 / VP8L chunks."""
    head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, duration)) + bytes([bits])
    return b"ANMF", head + b"".join(chunk(*p) for p in parts)


ALPHA, ANIMATION, ICC, EXIF, XMP = 0x10, 0x02, 0x20, 0x08, 0x04


def image_chunks(arr: np.ndarray, **kw) -> list:
    """The ALPH / VP8 / VP8L chunks PIL writes for arr (its VP8X chunk dropped)."""
    return [c for c in chunks(pil_webp(arr, **kw)) if c[0] != b"VP8X"]


def forward_filter(alpha: np.ndarray, kind: int) -> np.ndarray:
    """The ALPH filter `kind` (0 none, 1 horizontal, 2 vertical, 3 gradient)
    whose inverse libwebp applies: the first row of every filter
    predicts from the left (0 before the first pixel), the first column of
    the later rows from above."""
    a = alpha.astype(np.int32)
    if kind == 0:
        return alpha.copy()
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if kind == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def alph_chunk(alpha: np.ndarray, kind: int, lossless: bool, pre: int = 0, method=None) -> tuple:
    """An ALPH chunk of the (h, w) plane under filter `kind`: raw bytes, or
    a header-less VP8L stream (PIL's lossless encoding of an image whose
    green is the filtered plane, its 5-byte VP8L header cut off)."""
    filtered = forward_filter(alpha, kind)
    if lossless:
        rgb = np.zeros(alpha.shape + (3,), np.uint8)
        rgb[..., 1] = filtered
        body = chunks(pil_webp(rgb, lossless=True))[0][1][5:]
    else:
        body = filtered.tobytes()
    header = (int(lossless) if method is None else method) | kind << 2 | pre << 4
    return b"ALPH", bytes([header]) + body


CASES = {}


def case(name: str):
    def add(fn):
        CASES[name] = lambda: fn(_rng(name))
        return fn
    return add


# ------------------------------------------------------- PIL's encoder

for _m in range(7):
    for _q in (0, 50, 100):
        @case(f"lossless-rgba-m{_m}-q{_q}")
        def _(rng, m=_m, q=_q):
            return pil_webp(field(rng, 29, 37, 4), lossless=True, method=m, quality=q)

for _m in (0, 3, 6):
    @case(f"lossless-rgb-m{_m}")
    def _(rng, m=_m):
        return pil_webp(field(rng, 31, 26, 3), lossless=True, method=m)

for _exact in (False, True):
    for _q in (0, 100):
        @case(f"lossless-transparent-exact-{int(_exact)}-q{_q}")
        def _(rng, exact=_exact, q=_q):
            a = field(rng, 24, 30, 4)
            a[..., 3] = np.where(a[..., 3] > 128, 255, 0)
            return pil_webp(a, lossless=True, exact=exact, quality=q)

for _n in (2, 3, 4, 5, 16, 17, 256):
    for _c in (3, 4):
        @case(f"lossless-palette-{_n}-colours-{'rgba' if _c == 4 else 'rgb'}")
        def _(rng, n=_n, c=_c):
            palette = rng.integers(0, 256, (n, 4)).astype(np.uint8)
            return pil_webp(palette[rng.integers(0, n, (23, 41))][..., :c], lossless=True, method=4)

for _q in (0, 1, 50, 75, 100):
    for _m in (0, 4, 6):
        @case(f"lossy-rgb-q{_q}-m{_m}")
        def _(rng, q=_q, m=_m):
            return pil_webp(field(rng, 35, 43, 3), quality=q, method=m)

for _aq in (0, 20, 50, 90, 100):
    @case(f"lossy-rgba-alpha-q{_aq}")
    def _(rng, aq=_aq):
        return pil_webp(field(rng, 35, 43, 4), quality=75, alpha_quality=aq)

@case("lossy-rgba-opaque")
def _(rng):
    a = field(rng, 21, 19, 4)
    a[..., 3] = 255
    return pil_webp(a, quality=60)

for _h, _w in ((1, 1), (1, 37), (29, 1), (17, 33), (49, 47), (2, 2), (16, 48)):
    for _kind in ("lossless", "lossy", "lossy-alpha"):
        @case(f"size-{_kind}-{_h}x{_w}")
        def _(rng, h=_h, w=_w, kind=_kind):
            a = field(rng, h, w, 3 if kind == "lossy" else 4)
            return pil_webp(a, lossless=kind == "lossless", quality=70, alpha_quality=60)

for _kind in ("lossless", "lossy", "lossy-rgb"):
    @case(f"animation-{_kind}")
    def _(rng, kind=_kind):
        frames = [field(rng, 20, 30, 3 if kind == "lossy-rgb" else 4) for _ in range(3)]
        return pil_animation(frames, lossless=kind == "lossless", quality=70)


# --------------------------------------------------------- RIFF writer


@case("vp8x-iccp-exif-xmp")
def _(rng):
    parts = image_chunks(field(rng, 18, 22, 4), quality=80)
    return riff([vp8x(22, 18, ALPHA | ICC | EXIF | XMP), (b"ICCP", bytes(rng.integers(0, 256, 131).astype(np.uint8))),
                 *parts, (b"EXIF", b"Exif\0\0MM\0*" + bytes(9)), (b"XMP ", b"<x:xmpmeta/>")])


@case("vp8x-metadata-unflagged-and-unknown-chunks")
def _(rng):
    parts = image_chunks(field(rng, 18, 22, 3), lossless=True)
    return riff([vp8x(22, 18, 0), (b"ICCP", b"icc"), (b"ABCD", bytes(7)), *parts, (b"XMP ", b"<x/>"),
                 (b"zzzz", b"")])


@case("vp8x-alpha-flag-without-alph")
def _(rng):
    return riff([vp8x(20, 14, ALPHA), *image_chunks(field(rng, 14, 20, 3), quality=70)])


@case("vp8x-alph-without-alpha-flag")
def _(rng):
    return riff([vp8x(20, 14, 0), *image_chunks(field(rng, 14, 20, 4), quality=70)])


@case("vp8x-alph-without-alpha-flag-after-iccp")
def _(rng):
    return riff([vp8x(20, 14, ICC), (b"ICCP", b"abc"), *image_chunks(field(rng, 14, 20, 4), quality=70)])


@case("vp8x-alpha-flag-vp8l-without-alpha")
def _(rng):
    return riff([vp8x(20, 14, ALPHA), *image_chunks(field(rng, 14, 20, 3), lossless=True)])


@case("vp8x-no-flag-vp8l-with-alpha")
def _(rng):
    return riff([vp8x(20, 14, 0), *image_chunks(field(rng, 14, 20, 4), lossless=True)])


@case("vp8x-alph-after-image-without-flag")
def _(rng):
    alph, image = image_chunks(field(rng, 14, 20, 4), quality=70)
    return riff([vp8x(20, 14, 0), image, alph])


@case("simple-vp8-then-alph")
def _(rng):
    alph, image = image_chunks(field(rng, 14, 20, 4), quality=70)
    return riff([image, alph])


@case("simple-vp8l-then-unknown-chunk")
def _(rng):
    return riff([*image_chunks(field(rng, 14, 20, 4), lossless=True), (b"JUNK", bytes(5))])


@case("riff-followed-by-bytes")
def _(rng):
    return pil_webp(field(rng, 14, 20, 3), quality=70) + bytes(13)


for _kind, _w, _h, _x, _y in (("lossy-alpha", 12, 9, 6, 4), ("lossless", 11, 7, 28, 22), ("lossy", 40, 30, 0, 0)):
    @case(f"animation-first-frame-{_kind}-{_w}x{_h}-at-{_x}-{_y}")
    def _(rng, kind=_kind, w=_w, h=_h, x=_x, y=_y):
        first = image_chunks(field(rng, h, w, 3 if kind == "lossy" else 4), lossless=kind == "lossless", quality=70)
        second = image_chunks(field(rng, 30, 40, 4), quality=50)
        return riff([vp8x(40, 30, ANIMATION | ALPHA), anim(), anmf(x, y, w, h, first), anmf(0, 0, 40, 30, second)])


@case("animation-without-alpha-flag")
def _(rng):
    first = image_chunks(field(rng, 9, 12, 4), quality=70)
    return riff([vp8x(20, 16, ANIMATION), anim(0xFFFF0000), anmf(4, 2, 12, 9, first)])


@case("animation-two-anim-chunks")
def _(rng):
    first = image_chunks(field(rng, 16, 20, 4), lossless=True)
    return riff([vp8x(20, 16, ANIMATION | ALPHA), anim(), anim(0x12345678, 3), anmf(0, 0, 20, 16, first)])


@case("animation-frame-with-unknown-chunk")
def _(rng):
    """An unknown chunk inside an ANMF chunk, after the frame's image: the
    demuxer reads on from it as a chunk of the file."""
    first = image_chunks(field(rng, 16, 20, 3), quality=70)
    return riff([vp8x(20, 16, ANIMATION), anim(), anmf(0, 0, 20, 16, first + [(b"XTRA", bytes(6))])])


for _filter in range(4):
    for _lossless in (False, True):
        @case(f"alph-{'lossless' if _lossless else 'raw'}-filter-{_filter}")
        def _(rng, kind=_filter, lossless=_lossless):
            a = field(rng, 19, 27, 4)
            image = image_chunks(a[..., :3], quality=80)
            return riff([vp8x(27, 19, ALPHA), alph_chunk(a[..., 3], kind, lossless), *image])


@case("alph-preprocessing-bit")
def _(rng):
    a = field(rng, 12, 15, 4)
    return riff([vp8x(15, 12, ALPHA), alph_chunk(a[..., 3], 1, True, pre=1), *image_chunks(a[..., :3], quality=80)])


@case("alph-raw-longer-than-the-plane")
def _(rng):
    a = field(rng, 12, 15, 4)
    kind, body = alph_chunk(a[..., 3], 2, False)
    return riff([vp8x(15, 12, ALPHA), (kind, body + bytes(9)), *image_chunks(a[..., :3], quality=80)])


# ------------------------------------------------------ what PIL refuses

REFUSED = set()


def refused(name: str):
    REFUSED.add(name)
    return case(name)


@refused("alph-raw-shorter-than-the-plane")
def _(rng):
    a = field(rng, 12, 15, 4)
    kind, body = alph_chunk(a[..., 3], 0, False)
    return riff([vp8x(15, 12, ALPHA), (kind, body[:-3]), *image_chunks(a[..., :3], quality=80)])


for _header in (2, 3, 0x21, 0x41):
    @refused(f"alph-header-{_header:#04x}")
    def _(rng, header=_header):
        a = field(rng, 12, 15, 4)
        kind, body = alph_chunk(a[..., 3], 0, True)
        return riff([vp8x(15, 12, ALPHA), (kind, bytes([header]) + body[1:]), *image_chunks(a[..., :3], quality=80)])


@refused("alph-empty")
def _(rng):
    a = field(rng, 12, 15, 4)
    return riff([vp8x(15, 12, ALPHA), (b"ALPH", b"\x01"), *image_chunks(a[..., :3], quality=80)])


@refused("vp8x-alph-after-image-with-flag")
def _(rng):
    alph, image = image_chunks(field(rng, 14, 20, 4), quality=70)
    return riff([vp8x(20, 14, ALPHA), image, alph])


@refused("vp8x-canvas-differs-from-image")
def _(rng):
    return riff([vp8x(21, 14, 0), *image_chunks(field(rng, 14, 20, 3), quality=70)])


@refused("vp8x-reserved-flag")
def _(rng):
    return riff([vp8x(20, 14, 0x01), *image_chunks(field(rng, 14, 20, 3), quality=70)])


@refused("vp8x-chunk-of-12-bytes")
def _(rng):
    kind, body = vp8x(20, 14, 0)
    return riff([(kind, body + bytes(2)), *image_chunks(field(rng, 14, 20, 3), quality=70)])


@refused("vp8x-second-image")
def _(rng):
    parts = image_chunks(field(rng, 14, 20, 3), quality=70)
    return riff([vp8x(20, 14, 0), *parts, *parts])


@refused("animation-frame-off-the-canvas")
def _(rng):
    first = image_chunks(field(rng, 9, 12, 4), quality=70)
    return riff([vp8x(20, 16, ANIMATION | ALPHA), anim(), anmf(10, 2, 12, 9, first)])


@refused("animation-frame-before-anim")
def _(rng):
    first = image_chunks(field(rng, 16, 20, 4), lossless=True)
    return riff([vp8x(20, 16, ANIMATION | ALPHA), anmf(0, 0, 20, 16, first), anim()])


@refused("animation-flag-on-a-still-image")
def _(rng):
    return riff([vp8x(20, 14, ANIMATION), *image_chunks(field(rng, 14, 20, 3), quality=70)])


@refused("riff-size-past-the-file")
def _(rng):
    data = bytearray(pil_webp(field(rng, 14, 20, 3), quality=70))
    data[4:8] = struct.pack("<I", len(data) - 8 + 2)
    return bytes(data)


@refused("chunk-size-past-the-riff")
def _(rng):
    (kind, body), = image_chunks(field(rng, 14, 20, 3), lossless=True)
    return riff([kind + struct.pack("<I", len(body) + 40) + body])


@refused("riff-data-ends-inside-a-chunk-header")
def _(rng):
    return riff([*image_chunks(field(rng, 14, 20, 3), lossless=True), b"JUNK"])


for _kind in ("lossless", "lossy"):
    @refused(f"{_kind}-stream-cut-short")
    def _(rng, kind=_kind):
        (fourcc, body), = image_chunks(field(rng, 24, 30, 3), lossless=kind == "lossless", quality=90)
        return riff([(fourcc, body[: len(body) * 2 // 3])])


@functools.lru_cache(maxsize=None)
def case_bytes(name: str) -> bytes:
    return CASES[name]()
