"""Files that imageio hands to its OpenCV plugin, for the port's OpenCV
route (vpt_tpu_torch/io/opencv.py): each a name -> bytes builder, made from a
seed with numpy, PIL's and OpenCV's writers and hand-built headers.
`tests/make_torch_opencv.py` writes them to tests/torch_opencv/; the
fixtures there are what the tests read.  `mutants` gives corrupt copies for
the sweep against cv2 (tests/opencv_sweep.py).
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

CASES = {}


def case(name: str):
    def add(fn):
        CASES[name] = lambda: fn(np.random.default_rng(zlib.crc32(name.encode())))
        return fn
    return add


def field(rng, h: int, w: int, c: int) -> np.ndarray:
    """A smooth 8-bit image with noise (so codecs see structure)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 11 + y * 5 + 40 * k) % 256 for k in range(c)], -1)
    return np.clip(base + rng.integers(-12, 13, base.shape), 0, 255).astype(np.uint8)


def _pil(arr, fmt: str, mode: str | None = None, **kw) -> bytes:
    from PIL import Image

    im = Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)
    out = io.BytesIO()
    im.save(out, format=fmt, **kw)
    return out.getvalue()


# ------------------------------------------------------------------ Radiance


def _rgbe(rng, h: int, w: int) -> np.ndarray:
    px = rng.integers(0, 256, (h, w, 4), np.uint8)
    px[..., 3] = rng.integers(118, 140, (h, w))
    px[: h // 2, : w // 3] = px[0, 0]  # runs for the RLE
    px[-1, -1, 3] = 0
    return px


def rle_scanline(row: np.ndarray) -> bytes:
    """A new-style RLE Radiance scanline of (w, 4) RGBE bytes."""
    out = bytearray(b"\x02\x02" + struct.pack(">H", len(row)))
    for c in range(4):
        ch, i = row[:, c], 0
        while i < len(ch):
            j = i
            while j < len(ch) and ch[j] == ch[i] and j - i < 127:
                j += 1
            if j - i >= 3:
                out += bytes([128 + j - i, ch[i]])
                i = j
                continue
            k = i
            while k < len(ch) and k - i < 128 and not (k + 2 < len(ch) and ch[k] == ch[k + 1] == ch[k + 2]):
                k += 1
            out += bytes([k - i]) + ch[i:k].tobytes()
            i = k
    return bytes(out)


def _hdr(px: np.ndarray, head: bytes = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n", rle: bool = False,
         size: bytes | None = None) -> bytes:
    h, w = px.shape[:2]
    body = b"".join(rle_scanline(px[y]) for y in range(h)) if rle else px.tobytes()
    return head + (size if size is not None else b"-Y %d +X %d\n" % (h, w)) + body


@case("hdr-flat-23x17.hdr")
def _(rng):
    return _hdr(_rgbe(rng, 17, 23))


@case("hdr-rle-31x9.hdr")
def _(rng):
    return _hdr(_rgbe(rng, 9, 31), rle=True)


@case("hdr-rle-then-flat-12x6.hdr")
def _(rng):
    px = _rgbe(rng, 6, 12)
    return _hdr(px[:3], rle=True, size=b"-Y 6 +X 12\n") + px[3:].tobytes()


@case("hdr-narrow-5x4.hdr")
def _(rng):
    return _hdr(_rgbe(rng, 4, 5))


@case("hdr-old-rle-9x4.hdr")
def _(rng):
    px = _rgbe(rng, 4, 9)
    px[1, 3] = (1, 1, 1, 5)  # an old-style run: OpenCV reads it as a pixel
    return _hdr(px)


@case("hdr-rgbe-magic-comments-10x7.hdr")
def _(rng):
    head = b"#?RGBE\n# made by hand\nEXPOSURE=2.5\nGAMMA=1.0\nFORMAT=32-bit_rle_rgbe\nSOFTWARE=x\n\n"
    return _hdr(_rgbe(rng, 7, 10), head=head, size=b"-Y  7  +X  10 \n", rle=True)


@case("hdr-long-comment-line-9x5.hdr")
def _(rng):
    head = b"#?RADIANCE\n# " + b"x" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n"
    return _hdr(_rgbe(rng, 5, 9), head=head)


@case("hdr-overflow-exponents-8x3.hdr")
def _(rng):
    px = rng.integers(0, 256, (3, 8, 4), np.uint8)
    px[..., 3] = rng.choice([1, 100, 136, 150, 160, 200, 255], (3, 8))
    return _hdr(px)


@case("hdr-sky-64x32.hdr")
def _(rng):
    from vpt_tpu_torch.io.image import save_radiance_hdr
    from vpt_tpu_torch.scene.envmap import default_sky
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sky.hdr")
        save_radiance_hdr(path, default_sky((32, 64)))
        with open(path, "rb") as f:
            return f.read()


@case("hdr-opencv-writer-rle-20x11.hdr")
def _(rng):
    import cv2

    img = (rng.random((11, 20, 3)) * 4).astype(np.float32)
    return cv2.imencode(".hdr", img)[1].tobytes()


@case("hdr-plus-y-refused-8x4.hdr")
def _(rng):
    return _hdr(_rgbe(rng, 4, 8), size=b"+Y 4 +X 8\n")


@case("hdr-no-format-refused-8x4.hdr")
def _(rng):
    return _hdr(_rgbe(rng, 4, 8), head=b"#?RADIANCE\n\n")


@case("hdr-crlf-format-refused-8x4.hdr")
def _(rng):
    return _hdr(_rgbe(rng, 4, 8), head=b"#?RADIANCE\r\nFORMAT=32-bit_rle_rgbe\r\n\r\n")


@case("hdr-rle-truncated-refused-16x6.hdr")
def _(rng):
    return _hdr(_rgbe(rng, 6, 16), rle=True)[:-9]


@case("hdr-rle-bad-run-refused-16x2.hdr")
def _(rng):
    line = bytearray(rle_scanline(_rgbe(rng, 1, 16)[0]))
    line[4] = 128 + 40  # a run past the end of the channel
    return b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 16\n" + bytes(line) * 2


# ---------------------------------------------------------------- Sun raster


def _ras(w, h, depth, data, kind=1, maptype=0, cmap=b""):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind, maptype, len(cmap)) + cmap + data


def _ras_rows(rng, w, h, depth):
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    return rng.integers(0, 256, pitch * h, np.uint8).tobytes()


for _depth in (1, 8, 24, 32):
    for _kind in (0, 1, 2, 3):
        for _map in ((0, 1) if _depth <= 8 else (0,)):
            _n = f"ras-d{_depth}-t{_kind}" + ("-cmap" if _map else "") + ("-refused" if _kind > 1 else "") + \
                "-13x7.ras"

            def _ras_case(rng, depth=_depth, kind=_kind, cmap=_map):
                table = rng.integers(0, 256, 3 * (1 << depth) - (3 if depth == 8 else 0), np.uint8).tobytes() \
                    if cmap else b""
                return _ras(13, 7, depth, _ras_rows(rng, 13, 7, depth), kind, 1 if cmap else 0, table)
            CASES[_n] = (lambda fn, n: (lambda: fn(np.random.default_rng(zlib.crc32(n.encode())))))(_ras_case, _n)


@case("ras-truncated-refused-13x7.ras")
def _(rng):
    return _ras(13, 7, 24, _ras_rows(rng, 13, 7, 24))[:-5]


# ----------------------------------------------------------------------- BMP

_BMP_FROM_FORMAT_CASES = ("bmp-24-h40", "bmp-32-h124", "bmp-16-555-h40", "bmp-p1-h12", "bmp-p4-h40-top-down",
                          "bmp-p8-h108", "bmp-p8-short-table-h40", "bmp-bitfields-565-h40", "bmp-bitfields-rgba-h124",
                          "bmp-bitfields-bgra-h40", "bmp-bitfields-xbgr-h56", "bmp-rle8-delta", "bmp-rle4-delta",
                          "bmp-rle8-runs-h40", "bmp-rle4-noise-h40", "bmp-24-h12")
for _n in _BMP_FROM_FORMAT_CASES:
    CASES[f"{_n}.bmp"] = (lambda n: (lambda: __import__("format_cases").case_bytes(n)))(_n)


@case("bmp-32-bitfields-10bit-h124-9x5.bmp")
def _(rng):
    v = rng.integers(0, 1 << 30, (5, 9), np.uint32)
    data = v.astype("<u4").tobytes()
    info = struct.pack("<IiiHHIIiiII", 124, 9, 5, 1, 32, 3, len(data), 0, 0, 0, 0)
    info += struct.pack("<IIII", 0x3FF00000, 0xFFC00, 0x3FF, 0) + b"\0" * (124 - 56)
    return b"BM" + struct.pack("<IHHI", 14 + 124 + len(data), 0, 0, 14 + 124) + info + data


@case("bmp-truncated-refused-9x5.bmp")
def _(rng):
    return _pil(field(rng, 5, 9, 3), "BMP")[:-7]


# ----------------------------------------------------------------------- PAM


def _pam(w, h, depth, maxval, tupltype, data, extra=b""):
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, depth, maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + extra + b"ENDHDR\n" + data


for _d, _mv, _tt in ((3, 255, b"RGB"), (3, 255, None), (1, 255, b"GRAYSCALE"), (3, 65535, b"RGB"),
                     (1, 4095, b"GRAYSCALE"), (1, 1, b"BLACKANDWHITE"), (3, 100, b"RGB"), (4, 255, b"RGB_ALPHA"),
                     (2, 255, b"GRAYSCALE_ALPHA"), (3, 255, b"GRAYSCALE"), (4, 255, None)):
    _n = f"pam-d{_d}-m{_mv}-{(_tt or b'none').decode().lower()}" + (
        "-port-refuses" if _d in (2, 4) and _tt else "-refused" if (_tt == b"GRAYSCALE" and _d == 3) or (
            _d == 4 and not _tt) else "") + "-11x6.pam"

    def _pam_case(rng, d=_d, mv=_mv, tt=_tt):
        n = 11 * 6 * d
        vals = rng.integers(0, mv + 1, n) if mv > 1 else rng.integers(0, 256, n)
        data = vals.astype(">u2" if mv > 255 else np.uint8).tobytes()
        return _pam(11, 6, d, mv, tt, data, b"# a comment\n")
    CASES[_n] = (lambda fn, n: (lambda: fn(np.random.default_rng(zlib.crc32(n.encode())))))(_pam_case, _n)


# -------------------------------------------------------- Netpbm and PFM


@case("ppm-p6-16bit-9x5.ppm")
def _(rng):
    return b"P6\n9 5\n65535\n" + rng.integers(0, 65536, 9 * 5 * 3).astype(">u2").tobytes()


@case("pgm-p2-ascii-7x3.pgm")
def _(rng):
    return b"P2\n7 3\n200\n" + " ".join(str(v) for v in rng.integers(0, 201, 21)).encode() + b"\n"


@case("pfm-colour-6x4.pfm")
def _(rng):
    return b"PF\n6 4\n-1.0\n" + (rng.random((4, 6, 3)) * 300).astype("<f4").tobytes()


# ---------------------------------------------------------------------- JPEG


def _exif(orientation: int, order: str = "<") -> bytes:
    from PIL import Image

    e = Image.Exif()
    e.endian = order
    e[0x0112] = orientation
    e[0x010F] = "vpt"
    return e.tobytes()


@case("jpeg-420-q80-23x17.jpg")
def _(rng):
    return _pil(field(rng, 17, 23, 3), "JPEG", quality=80)


@case("jpeg-444-progressive-23x17.jpg")
def _(rng):
    return _pil(field(rng, 17, 23, 3), "JPEG", quality=90, subsampling=0, progressive=True)


@case("jpeg-gray-23x17.jpg")
def _(rng):
    return _pil(field(rng, 17, 23, 1)[..., 0], "JPEG", quality=85)


@case("jpeg-cmyk-adobe-16x9.jpg")
def _(rng):
    return _pil(field(rng, 9, 16, 4), "JPEG", mode="CMYK", quality=90)


@case("jpeg-ycck-16x9.jpg")
def _(rng):
    import format_writers as fw

    planes = [field(rng, 9, 16, 1)[..., 0].astype(np.float64) for _ in range(4)]
    return fw.encode_jpeg(planes, [(1, 1)] * 4, adobe=2)


for _o in range(1, 9):
    CASES[f"jpeg-exif-orientation-{_o}-7x4.jpg"] = (lambda o: (lambda: _pil(
        field(np.random.default_rng(o), 4, 7, 3), "JPEG", quality=95, exif=_exif(o, "<" if o % 2 else ">"))))(_o)


@case("jpeg-xmp-before-exif-7x4.jpg")
def _(rng):
    data = _pil(field(rng, 4, 7, 3), "JPEG", quality=95, exif=_exif(6))
    xmp = b"http://ns.adobe.com/xap/1.0/\0<x/>"
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(xmp) + 2) + xmp + data[2:]


@case("jpeg-truncated-progressive-23x17.jpg")
def _(rng):
    data = _pil(field(rng, 17, 23, 3), "JPEG", quality=90, progressive=True)
    return data[: len(data) * 2 // 3]


@case("jpeg-truncated-baseline-23x17.jpg")
def _(rng):
    data = _pil(field(rng, 17, 23, 3), "JPEG", quality=90)
    return data[: len(data) - 40]


@case("jpeg-header-only-refused-23x17.jpg")
def _(rng):
    data = _pil(field(rng, 17, 23, 3), "JPEG", quality=90)
    return data[: data.index(b"\xff\xda")]


def _torch_jpeg(name: str):
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "torch_jpeg", name), "rb") as f:
        return f.read()


for _n in ("arith-ycc420-q50-37x29.jpg", "arith-prog-cmyk-37x29.jpg", "lossless-rgb-p1-pt0-37x29.jpg",
           "lossless-gray-p1-37x29.jpg"):
    CASES["jpeg-" + _n.replace("lossless-gray", "lossless-gray-refused")] = (lambda n: (lambda: _torch_jpeg(n)))(_n)


# ----------------------------------------------------------------------- PNG


@case("png-gray1-13x7.png")
def _(rng):
    return _pil(field(rng, 7, 13, 1)[..., 0] > 128, "PNG")


for _bits in (2, 4):
    CASES[f"png-gray{_bits}-13x7.png"] = (lambda b: (lambda: __import__("gltf_scenes").encode_png(
        (field(np.random.default_rng(b), 7, 13, 1) >> (8 - b)).astype(np.uint8), depth=b)))(_bits)


@case("png-gray16-13x7.png")
def _(rng):
    import gltf_scenes

    return gltf_scenes.encode_png(rng.integers(0, 65536, (7, 13, 1)).astype(np.uint16))


@case("png-rgb16-13x7.png")
def _(rng):
    import gltf_scenes

    return gltf_scenes.encode_png(rng.integers(0, 65536, (7, 13, 3)).astype(np.uint16))


@case("png-rgba16-13x7.png")
def _(rng):
    import gltf_scenes

    return gltf_scenes.encode_png(rng.integers(0, 65536, (7, 13, 4)).astype(np.uint16))


@case("png-rgba8-13x7.png")
def _(rng):
    return _pil(field(rng, 7, 13, 4), "PNG")


@case("png-la8-13x7.png")
def _(rng):
    return _pil(field(rng, 7, 13, 2), "PNG", mode="LA")


@case("png-rgb8-interlaced-13x7.png")
def _(rng):
    import gltf_scenes

    return gltf_scenes.encode_png(field(rng, 7, 13, 3), interlace=True)


for _bits in (1, 2, 4, 8):
    def _png_palette(rng, bits=_bits):
        from PIL import Image

        im = Image.fromarray(rng.integers(0, 1 << bits, (7, 13)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 * (1 << bits) - (3 if bits > 1 else 0), np.uint8).tobytes())
        out = io.BytesIO()
        im.save(out, "PNG", bits=bits, transparency=bytes(rng.integers(0, 256, 1 << bits, np.uint8)))
        return out.getvalue()
    CASES[f"png-palette{_bits}-trns-13x7.png"] = (lambda fn, n: (lambda: fn(np.random.default_rng(
        zlib.crc32(n.encode())))))(_png_palette, f"png-palette{_bits}")


@case("png-exif-orientation-6-7x4.png")
def _(rng):
    return _pil(field(rng, 4, 7, 3), "PNG", exif=_exif(6))


@case("png-apng-default-is-frame-11x6.png")
def _(rng):
    from PIL import Image

    frames = [Image.fromarray(field(rng, 6, 11, 4)) for _ in range(3)]
    out = io.BytesIO()
    frames[0].save(out, "PNG", save_all=True, append_images=frames[1:])
    return out.getvalue()


@case("png-apng-default-not-a-frame-11x6.png")
def _(rng):
    from PIL import Image

    frames = [Image.fromarray(field(rng, 6, 11, 4)) for _ in range(3)]
    out = io.BytesIO()
    frames[0].save(out, "PNG", save_all=True, append_images=frames[1:], default_image=True)
    return out.getvalue()


@case("png-bad-idat-crc-refused-13x7.png")
def _(rng):
    data = bytearray(_pil(field(rng, 7, 13, 3), "PNG"))
    at = data.index(b"IDAT")
    (n,) = struct.unpack(">I", data[at - 4 : at])
    data[at + 4 + n] ^= 0xFF
    return bytes(data)


@case("png-bad-text-crc-13x7.png")
def _(rng):
    data = _pil(field(rng, 7, 13, 3), "PNG")
    body = b"Comment\0hello"
    chunk = struct.pack(">I", len(body)) + b"tEXt" + body + struct.pack(">I", zlib.crc32(b"tEXt" + body) ^ 1)
    return data[:33] + chunk + data[33:]


@case("png-truncated-refused-13x7.png")
def _(rng):
    return _pil(field(rng, 7, 13, 3), "PNG")[:-20]


# ---------------------------------------------------------------------- TIFF


def _tiff(arr, **kw):
    import format_writers as fw

    return fw.encode_tiff(arr, **kw)


@case("tiff-rgb8-lzw-predictor-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 3), compression=5, predictor=2, rows_per_strip=4)


@case("tiff-rgb16-deflate-19x11.tif")
def _(rng):
    return _tiff(rng.integers(0, 65536, (11, 19, 3)).astype(np.uint16), compression=8, predictor=2)


@case("tiff-rgb16-planar-mm-19x11.tif")
def _(rng):
    return _tiff(rng.integers(0, 65536, (11, 19, 3)).astype(np.uint16), planar=2, order=">")


@case("tiff-gray16-tiled-40x35.tif")
def _(rng):
    return _tiff(rng.integers(0, 65536, (35, 40)).astype(np.uint16), tile=(16, 16), compression=32773)


@case("tiff-gray8-min-is-white-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 1)[..., 0], photometric=0)


@case("tiff-bilevel-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 1)[..., 0] > 120, compression=32773)


@case("tiff-palette8-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 1)[..., 0], photometric=3, colormap=rng.integers(0, 65536, (3, 256)))


@case("tiff-palette4-8bit-colormap-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 1)[..., 0] >> 4, photometric=3, bits=4, colormap=rng.integers(0, 256, (3, 16)))


@case("tiff-cmyk-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 4), photometric=5)


@case("tiff-rgba8-unassociated-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 4), extra=(2,))


@case("tiff-rgba16-unassociated-19x11.tif")
def _(rng):
    return _tiff(rng.integers(0, 65536, (11, 19, 4)).astype(np.uint16), extra=(2,))


@case("tiff-gray-alpha-19x11.tif")
def _(rng):
    return _tiff(field(rng, 11, 19, 2), photometric=1, extra=(2,))


for _o in (2, 5, 6, 8):
    CASES[f"tiff-orientation-{_o}-9x5.tif"] = (lambda o: (lambda: _raw_tiff(
        9, 5, field(np.random.default_rng(o), 5, 9, 3).tobytes(), {258: (3, [8, 8, 8]), 262: (3, [2]),
                                                                   274: (3, [o]), 277: (3, [3])})))(_o)


@case("tiff-two-pages-13x7.tif")
def _(rng):
    from PIL import Image

    pages = [Image.fromarray(field(rng, 7, 13, 3)), Image.fromarray(field(rng, 7, 13, 3))]
    out = io.BytesIO()
    pages[0].save(out, "TIFF", save_all=True, append_images=pages[1:])
    return out.getvalue()


def _raw_tiff(w: int, h: int, strip: bytes, tags: dict) -> bytes:
    """A little-endian one-strip TIFF of raw strip bytes and its tags
    ({code: (type, values)}, SHORT 3, LONG 4, RATIONAL 5 as pairs)."""
    base = {256: (4, [w]), 257: (4, [h]), 259: (3, [1]), 273: (4, [8]), 278: (4, [h]), 279: (4, [len(strip)]),
            284: (3, [1])}
    base.update(tags)
    body = bytearray(b"II*\0\0\0\0\0" + strip + b"\0" * (len(strip) & 1))
    blobs, entries = bytearray(), []
    ifd = len(body)
    extra_at = ifd + 2 + 12 * len(base) + 4
    for code in sorted(base):
        kind, values = base[code]
        raw = b"".join(struct.pack("<II", *v) for v in values) if kind == 5 else struct.pack(
            "<" + {3: "H", 4: "I"}[kind] * len(values), *values)
        if len(raw) <= 4:
            value = raw.ljust(4, b"\0")
        else:
            value = struct.pack("<I", extra_at + len(blobs))
            blobs += raw
        entries.append(struct.pack("<HHI", code, kind, len(values)) + value)
    body[4:8] = struct.pack("<I", ifd)
    return bytes(body + struct.pack("<H", len(base)) + b"".join(entries) + b"\0\0\0\0" + blobs)


@case("tiff-ycbcr-22-17x11.tif")
def _(rng):
    units = rng.integers(0, 256, (6, 9, 6), np.uint8)
    units[..., :4] = np.sort(units[..., :4], axis=-1)
    return _raw_tiff(17, 11, units.tobytes(), {258: (3, [8, 8, 8]), 262: (3, [6]), 277: (3, [3]),
                                               530: (3, [2, 2]), 532: (5, [(0, 1), (255, 1), (128, 1), (255, 1),
                                                                            (128, 1), (255, 1)])})


@case("tiff-ycbcr-41-coefficients-17x11.tif")
def _(rng):
    units = rng.integers(0, 256, (11, 5, 6), np.uint8)
    return _raw_tiff(17, 11, units.tobytes(), {258: (3, [8, 8, 8]), 262: (3, [6]), 277: (3, [3]),
                                               529: (5, [(2125, 10000), (7154, 10000), (721, 10000)]),
                                               530: (3, [4, 1])})


@case("tiff-ycbcr-pil-lzw-17x11.tif")
def _(rng):
    return _pil_mode(field(rng, 11, 17, 3), "YCbCr", compression="tiff_lzw")


def _pil_mode(arr, mode, **kw) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(out, "TIFF", **kw)
    return out.getvalue()


@case("tiff-jpeg-rgb-40x33.tif")
def _(rng):
    return _pil_mode(field(rng, 33, 40, 3), "RGB", compression="jpeg", quality=90)


@case("tiff-jpeg-ycbcr-tiled-40x33.tif")
def _(rng):
    return _pil_mode(field(rng, 33, 40, 3), "YCbCr", compression="jpeg", tile=(16, 16))


@case("tiff-cielab-17x11.tif")
def _(rng):
    return _pil_mode(field(rng, 11, 17, 3), "LAB")


def _lab_tiff(px: np.ndarray, bits: int, white=None, order: str = "<") -> bytes:
    """An uncompressed CIE L*a*b* TIFF of (h, w, 3) samples (a*, b* as
    two's complement), with a WhitePoint tag of (x num, x den, y num, y
    den) rationals where given."""
    h, w, _ = px.shape
    data = px.astype(order + ("u1" if bits == 8 else "u2")).tobytes()
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 3, "bits"), (259, 3, 1, 1), (262, 3, 1, 8),
               (273, 4, 1, "data"), (277, 3, 1, 3), (278, 4, 1, h), (279, 4, 1, len(data)), (284, 3, 1, 1)]
    blobs = {"bits": struct.pack(order + "3H", bits, bits, bits)}
    if white is not None:
        entries.append((318, 5, 2, "white"))
        blobs["white"] = struct.pack(order + "4I", *white)
    pos, offsets, tail = 8 + 2 + 12 * len(entries) + 4, {}, b""
    for key, blob in blobs.items():
        offsets[key], tail, pos = pos, tail + blob, pos + len(blob)
    offsets["data"] = pos
    out = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "IH", 8, len(entries))
    for tag, kind, count, value in sorted(entries):
        if isinstance(value, str):
            out += struct.pack(order + "HHII", tag, kind, count, offsets[value])
        elif kind == 3:
            out += struct.pack(order + "HHIHH", tag, kind, count, value, 0)
        else:
            out += struct.pack(order + "HHII", tag, kind, count, value)
    return out + struct.pack(order + "I", 0) + tail + data


@case("tiff-cielab-16bit-be-17x11.tif")
def _(rng):
    return _lab_tiff(rng.integers(0, 65536, (11, 17, 3)), 16, order=">")


@case("tiff-cielab-whitepoint-d65-17x11.tif")
def _(rng):
    return _lab_tiff(rng.integers(0, 256, (11, 17, 3)), 8, white=(3127, 10000, 3290, 10000))


@case("tiff-float32-refused-13x7.tif")
def _(rng):
    return _tiff(rng.random((7, 13, 3)).astype(np.float32))


@case("tiff-gray2-refused-13x7.tif")
def _(rng):
    return _tiff(field(rng, 7, 13, 1)[..., 0] >> 6, bits=2)


@case("tiff-deflate-corrupt-strip-19x11.tif")
def _(rng):
    data = bytearray(_tiff(field(rng, 11, 19, 3), compression=8, rows_per_strip=4))
    data[8 + 30] ^= 0x5A  # a fault inside the first strip's stream: libtiff converts what decoded
    return bytes(data)


@case("tiff-truncated-refused-19x11.tif")
def _(rng):
    return _raw_tiff(19, 11, field(rng, 11, 19, 3).tobytes()[:300], {258: (3, [8, 8, 8]), 262: (3, [2]),
                                                                       277: (3, [3]), 279: (4, [627])})


# ---------------------------------------------------------------------- WebP


@case("webp-lossy-23x17.webp")
def _(rng):
    return _pil(field(rng, 17, 23, 3), "WEBP", quality=80)


@case("webp-lossless-alpha-23x17.webp")
def _(rng):
    return _pil(field(rng, 17, 23, 4), "WEBP", lossless=True)


@case("webp-lossy-alpha-23x17.webp")
def _(rng):
    return _pil(field(rng, 17, 23, 4), "WEBP", quality=70)


@case("webp-exif-orientation-8-7x4.webp")
def _(rng):
    return _pil(field(rng, 4, 7, 3), "WEBP", lossless=True, exif=_exif(8))


@case("webp-animated-11x6.webp")
def _(rng):
    from PIL import Image

    frames = [Image.fromarray(field(rng, 6, 11, 3)) for _ in range(3)]
    out = io.BytesIO()
    frames[0].save(out, "WEBP", save_all=True, append_images=frames[1:], lossless=True)
    return out.getvalue()


@case("webp-truncated-refused-23x17.webp")
def _(rng):
    return _pil(field(rng, 17, 23, 3), "WEBP", quality=80)[:-30]


# ----------------------------------------------------------------------- GIF


@case("gif-transparent-frames-13x9.gif")
def _(rng):
    from PIL import Image

    frames = []
    for _ in range(3):
        im = Image.fromarray(rng.integers(0, 16, (9, 13)).astype(np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 48, np.uint8).tobytes())
        frames.append(im)
    out = io.BytesIO()
    frames[0].save(out, "GIF", save_all=True, append_images=frames[1:], transparency=3, background=5, disposal=2)
    return out.getvalue()


for _n in ("gif-local-interlaced-inside-transparent", "gif-global-rows-inside", "gif-256-colours-table-resets",
           "gif-global-rows-past", "gif-codes-end-early"):
    CASES[f"{_n}.gif"] = (lambda n: (lambda: __import__("format_cases").case_bytes(n)))(_n)


@case("gif-no-trailer-refused-13x9.gif")
def _(rng):
    return _pil(rng.integers(0, 256, (9, 13), np.uint8), "GIF")[:-1]


# -------------------------------------------------------------- JPEG 2000


def _jp2_case(name: str) -> bytes:
    import jpeg2000_cases

    return jpeg2000_cases.case_bytes(name)


for _n in ("pil-RGB-97-jp2", "pil-RGBA-53-jp2", "cv-bgr16", "box-pclr-rgb", "box-pclr-9bit", "box-cdef-rgba",
           "box-colr18-3", "box-colr17-3", "cs-prec12", "pil-L-53-j2k", "pil-signed-RGB-97", "cs-sub12-2x2",
           "box-colr12-4"):
    CASES[f"j2k-{_n}.jp2"] = (lambda n: (lambda: _jp2_case(n)))(_n)


@case("j2k-rgb-12bit-48x40.jp2")
def _(rng):
    import cv2

    ok, out = cv2.imencode(".jp2", (rng.integers(0, 4096, (40, 48, 3))).astype(np.uint16) << 4)
    assert ok
    return out.tobytes()


@case("j2k-truncated-19x11.jp2")
def _(rng):
    data = _pil(field(rng, 11, 19, 3), "JPEG2000", irreversible=True)
    return data[: len(data) * 3 // 4]


# ----------------------------------------------------------------------- AVIF


@case("avif-port-refuses-13x7.avif")
def _(rng):
    return _pil(field(rng, 7, 13, 3), "AVIF", quality=80)


# ------------------------------------------------------------------ sweeps

# Corrupt copies that `python tests/opencv_sweep.py 8 22` and `8 23` found
# the port reading otherwise than `cv2` and that it now reads as `cv2` does,
# kept as files of tests/torch_opencv/ named "sweep-SEED-FORMAT-FILE-K"
# (tests/opencv_sweep.py's own names): the files they were cut from are
# not all remade byte for byte (tifffile writes the date), so the bytes are
# the record, and their builder reads them back.
_HERE = os.path.dirname(os.path.abspath(__file__))
for _name in sorted(os.listdir(os.path.join(_HERE, "torch_opencv"))):
    if _name.startswith("sweep-"):
        CASES[_name] = lambda _p=os.path.join(_HERE, "torch_opencv", _name): open(_p, "rb").read()


# ------------------------------------------------------------------ mutants


def mutants(data: bytes, seed: int, n: int, keep: int = 4) -> list:
    """n corrupt copies of a file: bytes set at random past the first
    `keep`, cuts and insertions, one to three edits each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            r = rng.random()
            if r < 0.6 and len(b) > keep:
                b[int(rng.integers(keep, len(b)))] = int(rng.integers(0, 256))
            elif r < 0.8:
                b = b[: int(rng.integers(keep, len(b) + 1))]
            elif len(b) > keep:
                b.insert(int(rng.integers(keep, len(b))), int(rng.integers(0, 256)))
        out.append(bytes(b))
    return out
