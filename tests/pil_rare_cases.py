"""The image files of the port's tests of PIL's rarer plugins
(tests/test_torch_pil_rare.py) and of tests/make_torch_pil_rare.py, each
made from a numpy seed when asked for: what PIL writes (BLP1 / BLP2
palettes, icns, IM, MSP v1, SPIDER, XBM, PCX pages) and what only
tests/pil_rare_writers.py builds (every other layout of DCX, FTEX,
XV thumbnails, PIXAR, McIdas, SPIDER, IM, IM Tools, GIMP brushes, FITS, Sun
rasters, MSP, XBM, XPM, BLP, icns, FLI / FLC, IPTC and PhotoCD).

`CASES` maps a case's name to (file extension, builder); `case_bytes(name)`
gives its bytes; `mutants(name, seed, n)` gives n corrupt copies (a byte
set, the file cut, a byte put in).  `EXTENSIONS` holds each format's
extensions, under each of which `load_hdr` reads a file.  The large files
(the PhotoCD cases, the timing textures and the FITS sky) come from
`pil_rare_writers.generated()`, which needs no PIL.  Needs PIL; no JAX.
"""

from __future__ import annotations

import functools
import io
import struct
import zlib

import numpy as np
from PIL import Image

import pil_rare_writers as w

CASES = {}
EXTENSIONS = {"dcx": (".dcx",), "ftex": (".ftc", ".ftu"), "xvthumb": (".xvthumb",), "pixar": (".pxr",),
              "mcidas": (".mcidas",), "spider": (".spider",), "im": (".im",), "imt": (".imt",), "gbr": (".gbr",),
              "fits": (".fits", ".fit"), "sun": (".ras",), "msp": (".msp",), "xbm": (".xbm",), "xpm": (".xpm",),
              "blp": (".blp",), "icns": (".icns",), "fli": (".fli", ".flc"), "iptc": (".iim",), "pcd": (".pcd",),
              "never": (".bin",)}


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def case(name: str):
    def register(fn):
        CASES[name] = (EXTENSIONS[name.split("-")[0]][0], fn)
        return fn
    return register


def image(rng, h: int, w: int, c: int) -> np.ndarray:
    """(h, w, c) uint8: flat patches (runs for the RLE coders), ramps and noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (5 + k) + y * (3 + 2 * k)) % 256 for k in range(c)], axis=-1).astype(np.uint8)
    patch = ((x // 4 + y // 3) % 3 == 0)[..., None]
    noise = rng.integers(0, 256, (h, w, c), np.uint8)
    return np.where(patch, np.uint8(77), np.where(rng.random((h, w, 1)) < 0.3, noise, base)).astype(np.uint8)


def _pil(img: Image.Image, fmt: str, **kw) -> bytes:
    out = io.BytesIO()
    img.save(out, format=fmt, **kw)
    return out.getvalue()


def _pil_image(rng, mode: str, h: int = 9, w: int = 13) -> Image.Image:
    rgb = Image.fromarray(image(rng, h, w, 3))
    if mode == "P":
        return rgb.quantize(11)
    if mode in ("LA", "RGBA"):
        im = rgb.convert(mode)
        im.putalpha(Image.fromarray(image(rng, h, w, 1)[..., 0]))
        return im
    if mode in ("I", "F", "I;16"):
        return Image.fromarray((image(rng, h, w, 1)[..., 0].astype(np.int32) * 97 - 3000).astype(
            {"I": np.int32, "F": np.float32, "I;16": np.uint16}[mode]) if mode != "I;16" else
            (image(rng, h, w, 1)[..., 0].astype(np.uint16) * 251))
    return rgb.convert(mode)


# -------------------------------------------------------------------- DCX

for _mode in ("1", "L", "P", "RGB"):
    @case(f"dcx-{_mode}")
    def _(rng, mode=_mode):
        pages = [_pil(_pil_image(rng, mode, 7, 11), "PCX"), _pil(_pil_image(rng, "RGB", 5, 6), "PCX")]
        return w.dcx(pages)


@case("dcx-no-page")  # an empty directory: PIL's DCX passes it on
def _(rng):
    return w.dcx([])[:8] + bytes(24)


@case("dcx-short-8-bit")  # an 8-bit page in a file under 769 bytes: no palette
def _(rng):
    return w.dcx([_pil(Image.fromarray(rng.integers(0, 4, (3, 6), np.uint8)), "PCX")])


# ------------------------------------------------------------------- FTEX

@case("ftex-rgb")
def _(rng):
    return w.ftex(7, 5, 1, image(rng, 5, 7, 3).tobytes())


for _wh in ((8, 8), (13, 6)):
    @case(f"ftex-dxt1-{_wh[0]}x{_wh[1]}")
    def _(rng, wh=_wh):
        return w.ftex(wh[0], wh[1], 0, w.bc1_blocks(rng, ((wh[0] + 3) // 4) * ((wh[1] + 3) // 4)))


@case("ftex-two-formats")
def _(rng):
    return w.ftex(4, 4, 1, bytes(48), formats=2)


@case("ftex-kind-3")
def _(rng):
    return w.ftex(4, 4, 3, bytes(48))


# ---------------------------------------------------------------- XVThumb

@case("xvthumb-basic")
def _(rng):
    return w.xvthumb(rng.integers(0, 256, (6, 9), np.uint8))


@case("xvthumb-comments")
def _(rng):
    return w.xvthumb(image(rng, 5, 4, 1)[..., 0], comments=(b"#IMGINFO:4x5 RGB", b"#a", b"#b"))


# ------------------------------------------------------------------ PIXAR

@case("pixar-rgb")
def _(rng):
    return w.pixar(image(rng, 6, 10, 3))


@case("pixar-other-mode")  # channels 8: PIL's PIXAR gives no mode, the file passes on
def _(rng):
    return w.pixar(image(rng, 3, 4, 3), channels=8)


# ----------------------------------------------------------------- McIdas

for _nb in (1, 2, 4):
    for _prefix in (0, 3):
        @case(f"mcidas-{_nb}-prefix{_prefix}")
        def _(rng, nb=_nb, prefix=_prefix):
            top = {1: 256, 2: 65536, 4: 1 << 31}[nb]
            return w.mcidas(rng.integers(-top if nb == 4 else 0, top, (5, 7), np.int64), nb, prefix,
                            256 + 4 * prefix)


# ----------------------------------------------------------------- SPIDER

@case("spider-pil")
def _(rng):
    return _pil(_pil_image(rng, "F", 6, 8), "SPIDER")


@case("spider-little")
def _(rng):
    return w.spider((rng.random((5, 9)) * 300 - 20).astype(np.float32), big=False)


@case("spider-stack")
def _(rng):
    return w.spider((rng.random((4, 6)) * 50).astype(np.float32), stack=2)


# --------------------------------------------------------------------- IM

for _mode in ("1", "L", "P", "RGB", "RGBA", "LA", "CMYK", "YCbCr", "I", "F", "I;16", "I;16B"):
    @case(f"im-pil-{_mode.replace(';', '')}")
    def _(rng, mode=_mode):
        if mode in ("YCbCr", "CMYK"):
            img = Image.frombytes(mode, (9, 7), image(rng, 7, 9, 3 if mode == "YCbCr" else 4).tobytes())
        elif mode == "I;16B":
            img = Image.fromarray(image(rng, 7, 9, 1)[..., 0].astype(np.uint16) * 251).convert("I").convert("I;16B")
        else:
            img = _pil_image(rng, mode, 7, 9)
        return _pil(img, "IM")


for _kind, _type, _raw in (("rgb3", "RGB3 image", lambda rng: image(rng, 4, 5, 3).transpose(2, 0, 1)),
                           ("b2", "B2 image", lambda rng: np.packbits(rng.integers(0, 2, (4, 16), np.uint8), 1)),
                           ("b4", "B4 image", lambda rng: rng.integers(0, 256, (4, 3), np.uint8)),
                           ("l32s", "L 32S image", lambda rng: rng.integers(-9, 9000, (4, 5), np.int32)),
                           ("l16s-float", "L 16S image", lambda rng: rng.integers(-900, 900, (4, 5), np.int16)),
                           ("l8-float", "L 8 image", lambda rng: rng.integers(0, 256, (4, 5), np.uint8)),
                           ("l32f", "L 32F image", lambda rng: rng.random((4, 5)).astype(np.float32) * 9),
                           ("lstar12", "L*12 image", lambda rng: rng.integers(0, 256, (4, 30), np.uint8)),
                           ("lstar5", "L*5 image", lambda rng: rng.integers(0, 256, (4, 5), np.uint8)),
                           ("x24", "X 24 image", lambda rng: image(rng, 4, 5, 3)),
                           ("rgbx", "RGBX image", lambda rng: image(rng, 4, 5, 4).transpose(0, 2, 1)),
                           ("la", "LA image", lambda rng: image(rng, 4, 5, 2).transpose(0, 2, 1)),
                           ("pa", "PA image", lambda rng: image(rng, 4, 5, 2).transpose(0, 2, 1)),
                           ("plain-p", "P", lambda rng: rng.integers(0, 256, (4, 5), np.uint8)),
                           ("l16b", "L 16B image", lambda rng: rng.integers(0, 65536, (4, 5), np.uint16).astype(">u2"))):
    @case(f"im-type-{_kind}")
    def _(rng, typ=_type, raw=_raw):
        body = np.ascontiguousarray(raw(rng)).tobytes()
        h = 4
        wd = 5 if typ not in ("B2 image", "B4 image", "L*12 image") else {"B2 image": 8, "B4 image": 6,
                                                                          "L*12 image": 20}[typ]
        return w.im({"Image type": typ, "Image size (x*y)": f"{wd}*{h}", "Name": "x"}, body)


for _lut in ("grey-ramp", "grey-curve", "colour"):
    for _mode in ("L", "LA"):
        @case(f"im-lut-{_lut}-{_mode}")
        def _(rng, lut=_lut, mode=_mode):
            ramp = np.arange(256, dtype=np.uint8)
            planes = {"grey-ramp": [ramp] * 3, "grey-curve": [ramp[::-1]] * 3,
                      "colour": [rng.integers(0, 256, 256, np.uint8) for _ in range(3)]}[lut]
            body = image(rng, 4, 5, len(mode)).transpose(0, 2, 1).tobytes()
            typ = "Greyscale image" if mode == "L" else "LA image"
            return w.im({"Image type": typ, "Image size (x*y)": "5*4"}, body, lut=np.concatenate(planes).tobytes())


@case("im-nul-end")  # the header ends at a NUL; the data after the next ^Z
def _(rng):
    return w.im({"Image type": "L 1 image", "Image size (x*y)": "8*2", "Comment": "c"}, b"junk\x1a" + bytes(range(2)),
                end=b"\0")


@case("im-float-size")
def _(rng):
    return w.im({"Image type": "Greyscale image", "Image size (x*y)": "4.5*2"}, bytes(20))


# -------------------------------------------------------------------- IMT

@case("imt-basic")
def _(rng):
    return w.imt(rng.integers(0, 256, (5, 7), np.uint8))


@case("imt-comments")
def _(rng):
    return w.imt(image(rng, 4, 6, 1)[..., 0], extra=b"* a comment\nframes 1\n")


# -------------------------------------------------------------------- GBR

for _v in (1, 2):
    for _c in (1, 4):
        @case(f"gbr-v{_v}-{'L' if _c == 1 else 'RGBA'}")
        def _(rng, v=_v, c=_c):
            px = image(rng, 6, 5, c)
            return w.gbr(px[..., 0] if c == 1 else px, version=v)


# ------------------------------------------------------------------- FITS

for _bits in (8, 16, 32, -32, -64):
    @case(f"fits-bitpix{_bits}")
    def _(rng, bits=_bits):
        img = {8: lambda: rng.integers(0, 256, (6, 7)), 16: lambda: rng.integers(-30000, 30000, (6, 7)),
               32: lambda: rng.integers(-2 ** 30, 2 ** 30, (6, 7)),
               -32: lambda: rng.random((6, 7)) * 4 - 1, -64: lambda: rng.random((6, 7)) * 4 - 1}[bits]()
        return w.fits(img, bits)


@case("fits-naxis1")
def _(rng):
    data = w.fits(rng.integers(0, 256, (1, 9)), 8)
    return data.replace(b"NAXIS   =                    2", b"NAXIS   =                    1", 1)


@case("fits-unpadded-comments")
def _(rng):
    return w.fits(rng.integers(0, 256, (3, 5)), 8, extra=["COMMENT   made here", "BZERO   =                    0 / x"],
                  pad=False)


for _zbits in (8, 16, 32, -32):
    @case(f"fits-gzip{_zbits}")
    def _(rng, zbits=_zbits):
        return w.fits_gzip(rng.integers(0, 2 ** 20, (5, 6)), zbits)


# -------------------------------------------------------------------- SUN

def _sun_lines(rng, h: int, wd: int, depth: int) -> np.ndarray:
    stride = ((wd * depth + 15) // 16) * 2
    return image(rng, h, stride, 1)[..., 0]


for _depth in (1, 4, 8, 24, 32):
    for _ftype in (1, 3, 2):
        @case(f"sun-{_depth}-type{_ftype}")
        def _(rng, depth=_depth, ftype=_ftype):
            wd, h = 11, 6
            lines = _sun_lines(rng, h, wd, depth)
            if ftype == 2:
                raw = image(rng, h, (wd * depth + 7) // 8, 1)[..., 0].tobytes()
                raw = raw[:20] + b"\x80" + raw[21:]
                return w.sun(lines, wd, depth, 2, rle_stream=w.sun_rle_encode(raw))
            return w.sun(lines, wd, depth, ftype)


for _ftype in (1, 2):
    @case(f"sun-8-palette-type{_ftype}")
    def _(rng, ftype=_ftype):
        wd, h = 9, 5
        cmap = rng.integers(0, 256, 3 * 40, np.uint8).tobytes()
        idx = rng.integers(0, 45, (h, 10), np.uint8)
        if ftype == 2:
            return w.sun(idx, wd, 8, 2, cmap=cmap, rle_stream=w.sun_rle_encode(idx[:, :wd].tobytes()))
        return w.sun(idx, wd, 8, 1, cmap=cmap)


@case("sun-rle-long-run")  # a run of 200 across three scanlines
def _(rng):
    return w.sun(np.zeros((5, 8), np.uint8), 8, 8, 2, rle_stream=b"\x80\xc7\x33" + bytes(range(40)))


@case("sun-palette-on-rgb")
def _(rng):
    return w.sun(_sun_lines(rng, 3, 4, 24), 4, 24, 1, cmap=bytes(range(12)))


# -------------------------------------------------------------------- MSP

@case("msp-v1")
def _(rng):
    return _pil(_pil_image(rng, "1", 9, 20), "MSP")


for _wd in (16, 21):
    @case(f"msp-v2-w{_wd}")
    def _(rng, wd=_wd):
        h = 7
        bits = image(rng, h, wd, 1)[..., 0] > 100
        packed = np.packbits(bits, axis=1)
        rows = [w.msp_encode_row(r.tobytes(), rng) for r in packed]
        rows[2] = b""
        return w.msp_v2(rows, wd)


@case("msp-v2-uneven-rows")  # rows of other lengths than a line: PIL joins them all
def _(rng):
    rows = [bytes((0, 5, 0xF0)), bytes((3, 1, 2, 3)), bytes((0, 2, 0x0F, 2, 9, 9))]
    return w.msp_v2(rows, 24)


# -------------------------------------------------------------------- XBM

@case("xbm-pil")
def _(rng):
    return _pil(_pil_image(rng, "1", 7, 13), "XBM")


@case("xbm-hotspot-upper")
def _(rng):
    return w.xbm(rng.integers(0, 2, (5, 17)), hot=(2, 3), upper=True)


# -------------------------------------------------------------------- XPM

@case("xpm-p")
def _(rng):
    return w.xpm(rng.integers(0, 5, (6, 7)), ["#ff0000", "#00ff00", "#123456", "#abcdef", "#000000"])


@case("xpm-p-2cpp")
def _(rng):
    cols = ["#%06x" % int(v) for v in rng.integers(0, 1 << 24, 70)]
    return w.xpm(rng.integers(0, 70, (5, 8)), cols, cpp=2, header=False)


@case("xpm-rgb")  # more than 256 colours: mode RGB
def _(rng):
    cols = ["#%06x" % int(v) for v in rng.integers(0, 1 << 24, 300)]
    return w.xpm(rng.integers(0, 300, (4, 9)), cols, cpp=2)


@case("xpm-none-unused")
def _(rng):
    return w.xpm(rng.integers(0, 3, (3, 4)), ["#102030", "#405060", "#708090", "None"])


@case("xpm-none-used")
def _(rng):
    return w.xpm(rng.integers(0, 4, (3, 4)), ["#102030", "#405060", "#708090", "None"])


# -------------------------------------------------------------------- BLP

for _version in ("BLP1", "BLP2"):
    @case(f"blp-pil-{_version}")
    def _(rng, version=_version):
        return _pil(_pil_image(rng, "P", 8, 12), "BLP", blp_version=version)


for _ae, _alpha in ((0, 0), (0, 1), (1, 1), (7, 1), (1, 0), (7, 0)):
    for _wh in ((8, 8), (10, 6)):
        @case(f"blp-dxt{ {0: 1, 1: 3, 7: 5}[_ae] }-alpha{_alpha}-{_wh[0]}x{_wh[1]}")
        def _(rng, ae=_ae, alpha=_alpha, wh=_wh):
            n = ((wh[0] + 3) // 4) * ((wh[1] + 3) // 4)
            if ae == 0:
                body = w.bc1_blocks(rng, n)
            else:
                body = b"".join(rng.integers(0, 256, 8, np.uint8).tobytes() + w.bc1_blocks(rng, 1) for _ in range(n))
            return w.blp2(wh[0], wh[1], 2, alpha, ae, body)


@case("blp-blp2-raw-alpha")
def _(rng):
    return w.blp2(5, 4, 1, 8, 8, rng.integers(0, 256, 20, np.uint8).tobytes(),
                  palette=rng.integers(0, 256, 1024, np.uint8).tobytes())


@case("blp-blp1-palette-alpha")
def _(rng):
    return w.blp1_palette(5, 4, rng.integers(0, 256, 20, np.uint8).tobytes(),
                          rng.integers(0, 256, 1024, np.uint8).tobytes(), alpha=8)


for _mode in ("L", "RGB", "CMYK"):
    @case(f"blp-blp1-jpeg-{_mode}")
    def _(rng, mode=_mode):
        img = Image.fromarray(image(rng, 12, 10, 3)).convert(mode)
        jpeg = _pil(img, "JPEG", quality=90)
        return w.blp1_jpeg(10, 12, jpeg, 160, gap=7)


@case("blp-blp1-jpeg-ycck")  # Adobe transform 2: PIL's BLP decoder still has libjpeg read it as CMYK
def _(rng):
    jpeg = bytearray(_pil(Image.fromarray(image(rng, 12, 10, 3)).convert("CMYK"), "JPEG", quality=90))
    at = jpeg.index(b"\xff\xeeAdobe"[:2] + b"\x00\x0eAdobe")
    jpeg[at + 15] = 2
    return w.blp1_jpeg(10, 12, bytes(jpeg), 160, gap=7)


@case("blp-blp2-dxt-other")  # alpha encoding 8: PIL refuses it
def _(rng):
    return w.blp2(4, 4, 2, 1, 8, bytes(16))


# ------------------------------------------------------------------- ICNS

@case("icns-pil")
def _(rng):
    return _pil(Image.fromarray(image(rng, 32, 32, 4)), "ICNS")


@case("icns-rle-mask")
def _(rng):
    rgb = image(rng, 16, 16, 3)
    mask = image(rng, 16, 16, 1)[..., 0]
    return w.icns([(b"is32", w.icns_rle(rgb, rng)), (b"s8mk", mask.tobytes())])


@case("icns-rle-no-mask-48")
def _(rng):
    return w.icns([(b"ih32", w.icns_rle(image(rng, 48, 48, 3), rng))])


@case("icns-raw-rgb-32")
def _(rng):
    rgb = image(rng, 32, 32, 3)
    return w.icns([(b"il32", rgb.tobytes()), (b"l8mk", image(rng, 32, 32, 1).tobytes())])


@case("icns-it32")
def _(rng):
    rgb = image(rng, 128, 128, 3)
    return w.icns([(b"it32", bytes(4) + w.icns_rle(rgb, rng)), (b"t8mk", image(rng, 128, 128, 1).tobytes())])


for _code, _side in ((b"ic07", 128), (b"ic08", 256), (b"icp6", 64), (b"ic12", 64), (b"icp5", 32), (b"ic11", 32)):
    @case(f"icns-png-{_code.decode()}")
    def _(rng, code=_code, side=_side):
        png = _pil(Image.fromarray(image(rng, side, side, 4)), "PNG")
        return w.icns([(code, png), (b"is32", w.icns_rle(image(rng, 16, 16, 3), rng))])


@case("icns-png-p")
def _(rng):
    png = _pil(_pil_image(rng, "P", 16, 16), "PNG")
    return w.icns([(b"icp4", png), (b"is32", w.icns_rle(image(rng, 16, 16, 3), rng))])


@case("icns-png-small")  # an 8x8 PNG in a 16x16 slot: a size PIL accepts
def _(rng):
    return w.icns([(b"icp4", _pil(Image.fromarray(image(rng, 8, 8, 3)), "PNG"))])


@case("icns-jp2")
def _(rng):
    return w.icns([(b"ic11", _pil(Image.fromarray(image(rng, 32, 32, 3)), "JPEG2000"))])


# -------------------------------------------------------------------- FLI

def _fli_pal(rng, n: int = 40):
    return [(2, [tuple(int(v) for v in rng.integers(0, 64, 3)) for _ in range(n)])]


for _kind in ("brun", "copy", "black", "lc", "ss2", "colour4"):
    @case(f"fli-{_kind}")
    def _(rng, kind=_kind):
        wd, h = 12, 7
        px = (image(rng, h, wd, 1)[..., 0] % 40).astype(np.uint8)
        chunks = [w.fli_colour(_fli_pal(rng), 4 if kind == "colour4" else 11)]
        if kind in ("brun", "colour4"):
            chunks.append(w.fli_brun(px, rng))
        elif kind == "copy":
            chunks.append(w.fli_copy(px))
        elif kind == "black":  # a chunk needs 10 bytes after it: BLACK is never last
            chunks += [w.fli_copy(px), w.fli_black(), w.fli_lc({3: [(2, b"\x21\x22")]}, 3, 1)]
        elif kind == "lc":
            chunks += [w.fli_copy(px), w.fli_lc({2: [(1, b"\x05\x06\x07"), (2, (3, 9))], 4: [(0, (2, 1))]}, 1, 5)]
        else:
            chunks += [w.fli_copy(px), w.fli_ss2([([], [(1, b"\x01\x02\x03\x04"), (2, (2, (7, 8)))]),
                                                  ([0xFFFF], [(0, b"\x0a\x0b")]), ([0x8033], [])])]
        return w.fli(wd, h, [chunks, [w.fli_black()]], magic=0xAF11 if kind == "colour4" else 0xAF12)


@case("fli-prefix-chunk")  # an FLC prefix chunk before the first frame: PIL decodes from byte 128
def _(rng):
    px = (image(rng, 4, 6, 1)[..., 0] % 9).astype(np.uint8)
    prefix = struct.pack("<IH", 16, 0xF100) + bytes(10)
    return w.fli(6, 4, [[w.fli_colour(_fli_pal(rng, 9)), w.fli_copy(px)]], prefix=prefix)


# ------------------------------------------------------------------- IPTC

@case("iptc-raw-l")
def _(rng):
    px = image(rng, 5, 7, 1)[..., 0].tobytes()
    return w.iptc(7, 5, [px[:13], px[13:]])


for _mode, _layers in (("rgb", 3), ("cmyk", 4)):
    @case(f"iptc-raw-{_mode}-band")
    def _(rng, layers=_layers):
        return w.iptc(6, 4, [image(rng, 4, 6, 1)[..., 0].tobytes()], layers=layers, component=1, band=2)


@case("iptc-jpeg-l")
def _(rng):
    return w.iptc(8, 6, [_pil(Image.fromarray(image(rng, 6, 8, 1)[..., 0]), "JPEG")], compression=5)


for _long in ("iim", "pil"):  # the standard's extended size PIL reads as 0; the form it reads
    @case(f"iptc-long-field-{_long}")
    def _(rng, long=_long):
        return w.iptc(5, 3, [image(rng, 3, 5, 1)[..., 0].tobytes()], long=long)


# -------------------------------------------------------------------- PCD

for _orientation in (0, 1, 3):
    @case(f"pcd-orientation{_orientation}")
    def _(rng, orientation=_orientation):
        return w.pcd_case(orientation)


# ------------------------------------- plugins that decode on neither machine

NEVER = {
    "bufr": b"BUFR" + bytes(60),
    "grib": b"GRIB\0\0\0\x01" + bytes(60),
    "hdf5": b"\x89HDF\r\n\x1a\n" + bytes(60),
    "eps": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 8 6\n%%EndComments\n0 0 moveto\nshowpage\n%%EOF\n",
    "mpeg": b"\0\0\x01\xb3\x01\x00\x10" + bytes(60),
    "wmf": b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<4hH", 0, 0, 72, 36, 72) + bytes(6) + b"\x01\x00\t\x00" +
           bytes(40),
}
for _fmt in NEVER:
    @case(f"never-{_fmt}")
    def _(rng, fmt=_fmt):
        return NEVER[fmt]


def names(prefixes) -> list:
    return [n for n in CASES if n.split("-")[0] in prefixes]


@functools.lru_cache(maxsize=None)
def case_bytes(name: str) -> bytes:
    return CASES[name][1](_rng(name))


def mutants(name: str, seed: int, n: int) -> list:
    """n corrupt copies of case `name`: one to three edits each (a byte set
    to a random value, the file cut short, a random byte put in), seeded;
    the edits fall in the first 4 KB of a large file."""
    rng = np.random.default_rng(seed * 7919 + zlib.crc32(name.encode()))
    data = case_bytes(name)
    out = []
    for _ in range(n):
        d = bytearray(data)
        span = min(len(d), 4096) if len(d) < 200_000 else len(d)
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.integers(0, 3))
            if kind == 0 and d:
                d[int(rng.integers(0, min(span, len(d))))] = int(rng.integers(0, 256))
            elif kind == 1 and len(d) > 1:
                del d[int(rng.integers(1, len(d))) :]
            else:
                d.insert(int(rng.integers(0, min(span, len(d)) + 1)), int(rng.integers(0, 256)))
        out.append(bytes(d))
    return out
