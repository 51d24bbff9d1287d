"""The image files of the port's TGA, DDS, Netpbm, QOI, SGI, PCX, ICO / CUR
and PSD tests (tests/test_torch_tga_pcx.py, test_torch_dds.py,
test_torch_netpbm_qoi_sgi.py, test_torch_ico_psd.py) and of
tests/make_torch_pil_formats.py, each made from a numpy seed when asked for:
what PIL writes (TGA raw and RLE, DDS DXT1/3/5, BC2/BC3/BC5 and raw, PPM,
QOI, SGI, PCX, ICO with PNG and BMP entries) and what only
tests/pil_format_writers.py builds (BC4, BC5S, BC6H and BC7 from random
blocks, RLE packets over scanlines, colour maps, ASCII Netpbm with comments,
16-bit and RLE SGI, PCX planes, CUR, PSD in every mode).

`CASES` maps a case's name to (file extension, builder); `case_bytes(name)`
gives its bytes; `mutants(name, seed, n)` gives n corrupt copies (a byte
flipped, the file cut, a byte put in).  Needs PIL; no JAX.
"""

from __future__ import annotations

import functools
import io
import struct
import zlib

import numpy as np
from PIL import Image

import pil_format_writers as pw

CASES = {}
# Each format's extensions: load_hdr reads a file under each (imageio
# routes .pbm and .pfm to OpenCV, the rest to PIL).
EXTENSIONS = {"tga": (".tga", ".icb", ".vda", ".vst"), "pcx": (".pcx",), "dds": (".dds",),
              "ppm": (".ppm", ".pgm", ".pnm", ".pbm", ".pfm"), "qoi": (".qoi",), "sgi": (".sgi", ".rgb", ".rgba", ".bw"),
              "ico": (".ico",), "cur": (".cur",), "psd": (".psd",)}


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
    return rgb.convert(mode)


# -------------------------------------------------------------------- TGA

for _mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
    for _rle in (False, True):
        for _orient in (1, -1):
            @case(f"tga-pil-{_mode}-{'rle' if _rle else 'raw'}-{'top' if _orient == 1 else 'bottom'}")
            def _(rng, mode=_mode, rle=_rle, orient=_orient):
                return _pil(_pil_image(rng, mode), "TGA", rle=rle, orientation=orient, id_section=b"vpt")


for _flags in (0x00, 0x10, 0x20, 0x30, 0x28, 0x0F):
    @case(f"tga-rgb24-flags-{_flags:02x}")
    def _(rng, flags=_flags):
        return pw.tga(image(rng, 7, 11, 3), 2, 24, flags=flags, ident=b"id field")


for _kind, _it, _depth, _c in (("rgb24", 10, 24, 3), ("rgba32", 10, 32, 4), ("gray8", 11, 8, 1),
                               ("graya16", 11, 16, 2), ("bgra15", 10, 16, 2), ("map8", 9, 8, 1)):
    @case(f"tga-rle-cross-{_kind}")
    def _(rng, it=_it, depth=_depth, c=_c, kind=_kind):
        px = image(rng, 6, 9, c)
        cmap = {}
        if kind == "map8":
            px = rng.integers(0, 20, (6, 9, 1), np.uint8)
            cmap = dict(colour_map=rng.integers(0, 256, 20 * 3, np.uint8).tobytes(), map_depth=24)
        return pw.tga(px, it, depth, flags=0x20, packets=pw.rle_packets(px, cross=True, rng=rng), **cmap)

for _kind, _packets in (("run-across", [("raw", 7), ("run", 4), ("raw", 16)]),
                        ("raw-over-3-lines", [("raw", 20), ("run", 2), ("raw", 5)])):
    @case(f"tga-rle-{_kind}")
    def _(rng, packets=_packets):
        return pw.tga(image(rng, 3, 9, 3), 10, 24, flags=0x20, packets=packets)


@case("tga-bgra15-raw")
def _(rng):
    return pw.tga(rng.integers(0, 256, (5, 6, 2), np.uint8), 2, 16, flags=0x00)


for _start, _mdepth in ((0, 16), (3, 16), (0, 24), (5, 24), (0, 15), (0, 32)):
    @case(f"tga-colour-map-{_mdepth}-start-{_start}")
    def _(rng, start=_start, mdepth=_mdepth):
        n = 14
        entry = 2 if mdepth in (15, 16) else mdepth // 8
        return pw.tga(rng.integers(0, start + n + 2, (5, 7, 1), np.uint8), 1, 8, flags=0x20,
                      colour_map=rng.integers(0, 256, n * entry, np.uint8).tobytes(), map_start=start,
                      map_depth=mdepth)


@case("tga-gray1-raw")
def _(rng):
    return pw.tga(np.packbits(rng.integers(0, 2, (4, 16), np.uint8), axis=1)[..., None], 3, 1, flags=0x00)


@case("tga-type1-no-map")
def _(rng):
    return pw.tga(rng.integers(0, 256, (3, 4, 1), np.uint8), 1, 8)


@case("tga-type3-24-bit")
def _(rng):
    return pw.tga(rng.integers(0, 256, (3, 4, 3), np.uint8), 3, 24)


@case("tga-cur-magic")  # \0\0\2\0: CUR's magic; CUR passes it on (no cursors), TGA reads it
def _(rng):
    return pw.tga(image(rng, 4, 5, 3), 2, 24, flags=0x20)


@case("tga-pcx-magic")  # id length 10, map type 0, a stray map length: PCX reads a bad size, passes it on
def _(rng):
    data = bytearray(pw.tga(image(rng, 4, 5, 3), 2, 24, flags=0x20, ident=bytes(10)))
    data[5] = 7
    return bytes(data)


@case("tga-pcx-magic-claimed")  # id length 10 and map type 0: PCX reads a 1x1 size and refuses the mode
def _(rng):
    return pw.tga(image(rng, 4, 5, 3), 2, 24, flags=0x20, ident=bytes(10))


@case("tga-iptc-magic")  # id length 0x1C and map type 1 look like an IPTC field; the next is none
def _(rng):
    return pw.tga(rng.integers(0, 4, (3, 4, 1), np.uint8), 1, 8, flags=0x20, ident=bytes(28),
                  colour_map=bytes(12), map_depth=24)


# -------------------------------------------------------------------- PCX

for _mode in ("1", "L", "P", "RGB"):
    for _w in (13, 16):
        @case(f"pcx-pil-{_mode}-w{_w}")
        def _(rng, mode=_mode, w=_w):
            return _pil(_pil_image(rng, mode, 9, w), "PCX")


for _planes in (2, 4):
    for _w in (3, 9, 16):
        @case(f"pcx-{_planes}-planes-w{_w}")
        def _(rng, planes=_planes, w=_w):
            s = (w + 7) // 8
            stride = s + s % 2
            lines = rng.integers(0, 256, (5, planes * stride), np.uint8)
            return pw.pcx(lines, w, 5, 1, planes, version=2, header_palette=rng.integers(0, 256, 48, np.uint8).tobytes(),
                          stride=stride + 1)


@case("pcx-rgb-odd-stride")
def _(rng):
    w = 7
    lines = rng.integers(0, 256, (4, 3 * 8), np.uint8)
    return pw.pcx(lines, w, 4, 8, 3, stride=9)


@case("pcx-gray-palette")
def _(rng):
    ramp = bytes(np.repeat(np.arange(256, dtype=np.uint8), 3))
    return pw.pcx(rng.integers(0, 256, (30, 40), np.uint8), 40, 30, 8, 1, tail_palette=ramp)


@case("pcx-8-bit-short")  # under 769 bytes: PIL's seek to the palette fails on a file, not in memory
def _(rng):
    return pw.pcx(rng.integers(0, 4, (3, 6), np.uint8), 6, 3, 8, 1)


@case("pcx-run-over-line")
def _(rng):
    head = pw.pcx(np.zeros((2, 4), np.uint8), 4, 2, 8, 1)[:128]
    return head + bytes([0xC6, 9, 0xC2, 7]) + bytes(800)


@case("pcx-version-3")
def _(rng):
    return pw.pcx(rng.integers(0, 256, (3, 8), np.uint8), 8, 3, 8, 1, version=3)


# -------------------------------------------------------------------- DDS

for _mode, _fmts in (("RGB", (None, "DXT1", "DXT3", "DXT5", "BC2", "BC3", "BC5")),
                     ("RGBA", (None, "DXT1", "DXT3", "DXT5", "BC2", "BC3")), ("L", (None,)), ("LA", (None,))):
    for _fmt in _fmts:
        for _h, _w in ((8, 12), (9, 13)):
            @case(f"dds-pil-{_mode}-{_fmt or 'raw'}-{_w}x{_h}")
            def _(rng, mode=_mode, fmt=_fmt, h=_h, w=_w):
                return _pil(_pil_image(rng, mode, h, w), "DDS", **({"pixel_format": fmt} if fmt else {}))


_BC = {"bc1": (1, {"fourcc": b"DXT1"}), "bc2": (2, {"fourcc": b"DXT3"}), "bc3": (3, {"fourcc": b"DXT5"}),
       "bc4-ati1": (4, {"fourcc": b"ATI1"}), "bc4u": (4, {"fourcc": b"BC4U"}), "bc4-dx10": (4, {"dxgi": 80}),
       "bc5-ati2": (5, {"fourcc": b"ATI2"}), "bc5s": (5, {"fourcc": b"BC5S"}), "bc5s-dx10": (5, {"dxgi": 84}),
       "bc6h-uf16": (6, {"dxgi": 95}), "bc6h-sf16": (6, {"dxgi": 96}), "bc7": (7, {"dxgi": 98}),
       "bc7-srgb": (7, {"dxgi": 99}), "bc1-dx10": (1, {"dxgi": 71}), "bc3-dx10": (3, {"dxgi": 77})}
for _name, (_kind, _kw) in _BC.items():
    for _h, _w in ((16, 32), (7, 10)):
        @case(f"dds-{_name}-{_w}x{_h}")
        def _(rng, kind=_kind, kw=_kw, h=_h, w=_w):
            return pw.dds(w, h, pw.bc_blocks(rng, w, h, kind), **kw)


@case("dds-bc7-mips")  # mip levels after the first surface: skipped
def _(rng):
    return pw.dds(16, 16, pw.bc_blocks(rng, 16, 16, 7) + pw.bc_blocks(rng, 8, 8, 7) + pw.bc_blocks(rng, 4, 4, 7),
                  dxgi=98, mipmaps=3)


for _name, (_bits, _masks, _alpha) in {"rgb565": (16, (0xF800, 0x7E0, 0x1F, 0), False),
                                       "argb1555": (16, (0x7C00, 0x3E0, 0x1F, 0x8000), True),
                                       "bgr24": (24, (0xFF0000, 0xFF00, 0xFF, 0), False),
                                       "abgr32": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), True),
                                       "odd-masks": (24, (0x0F0, 0x30F, 0, 0xFF0000), True)}.items():
    @case(f"dds-masks-{_name}")
    def _(rng, bits=_bits, masks=_masks, alpha=_alpha):
        flags = pw.DDPF_RGB | (pw.DDPF_ALPHAPIXELS if alpha else 0)
        return pw.dds(5, 3, rng.integers(0, 256, 5 * 3 * bits // 8, np.uint8).tobytes(), pfflags=flags,
                      bitcount=bits, masks=masks)


@case("dds-masks-short")  # PIL reads missing pixels as zeros
def _(rng):
    return pw.dds(5, 3, rng.integers(0, 256, 20, np.uint8).tobytes(), pfflags=pw.DDPF_RGB, bitcount=32,
                  masks=(0xFF0000, 0xFF00, 0xFF, 0))


@case("dds-palette")
def _(rng):
    return pw.dds(6, 4, rng.integers(0, 256, 1024 + 24, np.uint8).tobytes(), pfflags=pw.DDPF_PALETTEINDEXED8,
                  bitcount=8)


@case("dds-r8g8b8a8")
def _(rng):
    return pw.dds(3, 5, rng.integers(0, 256, 60, np.uint8).tobytes(), dxgi=28)


@case("dds-dxt2-refused")
def _(rng):
    return pw.dds(4, 4, bytes(16), fourcc=b"DXT2")


@case("dds-bc7-truncated")
def _(rng):
    return pw.dds(8, 8, pw.bc_blocks(rng, 8, 8, 7)[:-5], dxgi=98)


# ----------------------------------------------------------------- Netpbm

for _mode in ("1", "L", "RGB", "I"):
    @case(f"ppm-pil-{_mode}")
    def _(rng, mode=_mode):
        im = _pil_image(rng, "L" if mode == "I" else mode)
        if mode == "I":
            im = Image.fromarray(rng.integers(0, 65536, (9, 13)).astype(np.int32), "I")
        return _pil(im, "PPM")


for _magic, _c, _maxval in (("P1", 1, None), ("P2", 1, 255), ("P2", 1, 100), ("P2", 1, 1000), ("P3", 3, 255),
                            ("P3", 3, 7), ("P3", 3, 40000)):
    @case(f"ppm-ascii-{_magic}-max{_maxval}")
    def _(rng, magic=_magic, c=_c, maxval=_maxval):
        top = 1 if maxval is None else maxval
        samples = rng.integers(0, top + 1, (5, 7, c))
        return pw.netpbm_ascii(magic, samples, maxval)


for _magic, _c, _maxval in (("P5", 1, 100), ("P5", 1, 1000), ("P5", 1, 65535), ("P6", 3, 31), ("P6", 3, 65535),
                            ("P6", 3, 300)):
    @case(f"ppm-binary-{_magic}-max{_maxval}")
    def _(rng, magic=_magic, c=_c, maxval=_maxval):
        samples = rng.integers(0, maxval + 1, (5, 7, c))
        data = samples.astype(">u2" if maxval > 255 else np.uint8).tobytes()
        return f"{magic}\n# c\n7 5\n{maxval}\n".encode() + data


for _order, _scale in (("<", -1.0), (">", 1.0), ("<", -2.5), (">", 0.5)):
    for _magic in ("Pf", "PF"):
        @case(f"ppm-pfm-{_magic}-{'le' if _order == '<' else 'be'}-{_scale}")
        def _(rng, order=_order, scale=_scale, magic=_magic):
            c = 1 if magic == "Pf" else 3
            v = rng.uniform(-20, 300, (4, 6, c)).astype(np.float32)
            v.reshape(-1)[:4] = [np.nan, np.inf, 254.5, 255.5]
            return f"{magic}\n6 4\n{scale}\n".encode() + v.astype(order + "f4").tobytes()


@case("ppm-p6-whitespace")
def _(rng):
    return b"P6\t7 \x0b5\r255\x0c" + rng.integers(0, 256, 105, np.uint8).tobytes()


@case("ppm-pil-cmyk-extension")
def _(rng):
    return b"P0CMYK\n3 2\n255\n" + rng.integers(0, 256, 24, np.uint8).tobytes()


@case("ppm-p2-value-too-large")
def _(rng):
    return b"P2\n2 1\n9\n4 10\n"


# -------------------------------------------------------------------- QOI

for _mode in ("RGB", "RGBA"):
    @case(f"qoi-pil-{_mode}")
    def _(rng, mode=_mode):
        return _pil(_pil_image(rng, mode, 11, 17), "QOI")


for _c, _channels in ((4, 4), (3, 3), (4, 5), (3, 4)):
    @case(f"qoi-every-op-{_c}-channels-{_channels}")
    def _(rng, c=_c, channels=_channels):
        img = image(rng, 12, 19, c)
        img[2, :] = img[2, 0]  # a long run
        img[5, 3:9] = img[5, 2] + np.array([1, 255, 0, 0][:c], np.uint8)  # small differences
        return pw.qoi(img, channels=channels, colorspace=1)


@case("qoi-no-end-marker")
def _(rng):
    return pw.qoi(image(rng, 4, 5, 4), end=False)


@case("qoi-truncated")
def _(rng):
    return pw.qoi(image(rng, 6, 7, 4), end=False)[:-9]


# -------------------------------------------------------------------- SGI

for _mode in ("L", "RGB", "RGBA"):
    @case(f"sgi-pil-{_mode}")
    def _(rng, mode=_mode):
        return _pil(_pil_image(rng, mode), "SGI")


for _z in (1, 3, 4):
    for _bpc in (1, 2):
        for _rle in (False, True):
            @case(f"sgi-{_z}-channels-{8 * _bpc}-bit-{'rle' if _rle else 'verbatim'}")
            def _(rng, z=_z, bpc=_bpc, rle=_rle):
                planes = np.moveaxis(image(rng, 6, 9, z), -1, 0).astype(np.uint16)
                if bpc == 2:
                    planes = planes * 257 + rng.integers(0, 256, planes.shape)
                return pw.sgi(planes.astype(np.uint8 if bpc == 1 else np.uint16), rle=rle, rng=rng)


@case("sgi-dimension-1")
def _(rng):
    return pw.sgi(rng.integers(0, 256, (1, 3, 8), np.uint8), dimension=1)


@case("sgi-rle-short-length")  # a row's length runs out before its terminator: PIL stops the image there
def _(rng):
    data = bytearray(pw.sgi(rng.integers(0, 256, (1, 4, 6), np.uint8), rle=True, rng=rng))
    struct.pack_into(">I", data, 512 + 16 + 4 * 2, 1)
    return bytes(data)


@case("sgi-rle-offset-past-end")
def _(rng):
    data = bytearray(pw.sgi(rng.integers(0, 256, (1, 4, 6), np.uint8), rle=True, rng=rng))
    struct.pack_into(">I", data, 512 + 4, len(data) + 10)
    return bytes(data)


# -------------------------------------------------------------------- ICO

for _mode, _bmps in (("RGBA", (False, True)), ("RGB", (False, True)), ("P", (False, True)), ("L", (False, True)),
                     ("LA", (False,))):
    for _bmp in _bmps:
        @case(f"ico-pil-{_mode}-{'bmp' if _bmp else 'png'}")
        def _(rng, mode=_mode, bmp=_bmp):
            im = _pil_image(rng, mode, 16, 16)
            kw = {"sizes": [(16, 16), (8, 8)]}
            if bmp:
                kw["bitmap_format"] = "bmp"
            return _pil(im, "ICO", **kw)


for _bits in (1, 4, 8, 24, 32):
    @case(f"ico-bmp-{_bits}-bit")
    def _(rng, bits=_bits):
        h, w = 6, 9
        pal = rng.integers(0, 256, (1 << bits, 3), np.uint8) if bits <= 8 else None
        px = rng.integers(0, 1 << min(bits, 8), (h, w), np.uint8) if bits <= 8 else \
            rng.integers(0, 256, (h, w, bits // 8), np.uint8)
        mask = rng.random((h, w)) < 0.3
        entry = pw.dib(px, bits, pal, mask)
        small = pw.dib(np.zeros((2, 2), np.uint8), 8, np.zeros((256, 3), np.uint8))
        return pw.icon_dir(1, [(2, 2, 0, 1, 8, small), (w, h, 0, 1, bits, entry)])


@case("ico-tie-smallest-depth")  # equal areas: PIL takes the smallest colour depth, then the first
def _(rng):
    a = pw.dib(rng.integers(0, 256, (4, 4, 3), np.uint8), 24)
    b = pw.dib(rng.integers(0, 16, (4, 4), np.uint8), 4, rng.integers(0, 256, (16, 3), np.uint8))
    return pw.icon_dir(1, [(4, 4, 0, 1, 24, a), (4, 4, 16, 1, 4, b)])


@case("ico-png-and-bmp")
def _(rng):
    png = _pil(_pil_image(rng, "RGBA", 12, 12), "PNG")
    bmp = pw.dib(rng.integers(0, 256, (8, 8, 3), np.uint8), 24)
    return pw.icon_dir(1, [(8, 8, 0, 1, 24, bmp), (12, 12, 0, 1, 32, png)])


@case("ico-top-down-bitmap")
def _(rng):
    return pw.icon_dir(1, [(5, 3, 0, 1, 24, pw.dib(rng.integers(0, 256, (3, 5, 3), np.uint8), 24, top_down=True))])


for _bits in (1, 8, 24, 32):
    @case(f"cur-{_bits}-bit")
    def _(rng, bits=_bits):
        h, w = 5, 7
        pal = rng.integers(0, 256, (1 << bits, 3), np.uint8) if bits <= 8 else None
        px = rng.integers(0, 1 << min(bits, 8), (h, w), np.uint8) if bits <= 8 else \
            rng.integers(0, 256, (h, w, bits // 8), np.uint8)
        return pw.icon_dir(2, [(w, h, 0, 2, 3, pw.dib(px, bits, pal, rng.random((h, w)) < 0.5))])


@case("cur-two-entries")  # the later entry is larger in both width and height bytes
def _(rng):
    a = pw.dib(rng.integers(0, 256, (3, 3, 3), np.uint8), 24)
    b = pw.dib(rng.integers(0, 256, (4, 6, 3), np.uint8), 24)
    return pw.icon_dir(2, [(3, 3, 0, 0, 0, a), (6, 4, 0, 0, 0, b)])


@case("cur-32-bit-at-22")  # one entry whose bitmap starts at byte 22: PIL reads BGRA
def _(rng):
    return pw.icon_dir(2, [(4, 3, 0, 0, 0, pw.dib(rng.integers(0, 256, (3, 4, 4), np.uint8), 32))])


# -------------------------------------------------------------------- PSD

_PSD_MODES = {"bitmap": (0, 1, 1), "gray": (1, 8, 1), "indexed": (2, 8, 1), "rgb": (3, 8, 3), "rgba": (3, 8, 4),
              "rgb5": (3, 8, 5), "cmyk": (4, 8, 4), "cmyka": (4, 8, 5), "multichannel": (7, 8, 2),
              "duotone": (8, 8, 1), "lab": (9, 8, 3)}
for _name, (_mode, _bits, _c) in _PSD_MODES.items():
    for _compression in (0, 1):
        @case(f"psd-{_name}-{'packbits' if _compression else 'raw'}")
        def _(rng, mode=_mode, bits=_bits, c=_c, compression=_compression):
            h, w = 5, 11
            rows = (w + 7) // 8 if bits == 1 else w
            planes = np.moveaxis(image(rng, h, rows, c), -1, 0).copy()
            palette = rng.integers(0, 256, 768, np.uint8).tobytes() if mode == 2 else b""
            res = b"8BIM" + struct.pack(">H", 1005) + b"\x01a" + struct.pack(">I", 3) + b"xyz\0"
            layers = struct.pack(">I", 4) + b"\0\0\0\0"
            return pw.psd(planes, mode, bits, compression=compression, palette=palette, resources=res, layers=layers)


@case("psd-indexed-no-palette")
def _(rng):
    return pw.psd(rng.integers(0, 256, (1, 3, 4), np.uint8), 2)


@case("psd-16-bit")  # PIL has no mode for it: the file passes on, and no plugin takes it
def _(rng):
    return pw.psd(rng.integers(0, 256, (3, 3, 8), np.uint8), 3, 16)


@case("psd-too-few-channels")
def _(rng):
    return pw.psd(rng.integers(0, 256, (2, 3, 4), np.uint8), 3)


@functools.lru_cache(maxsize=None)
def case_bytes(name: str) -> bytes:
    return CASES[name][1](_rng(name))


def names(prefixes: tuple) -> list:
    return sorted(n for n in CASES if n.split("-")[0] in prefixes)


def mutants(name: str, seed: int, n: int) -> list:
    """n corrupt copies of case `name`: one to three edits each (a byte set
    to a random value, the file cut short, a random byte put in), seeded."""
    rng = np.random.default_rng(seed * 7919 + zlib.crc32(name.encode()))
    data = case_bytes(name)
    out = []
    for _ in range(n):
        d = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            kind = int(rng.integers(0, 3))
            if kind == 0 and d:
                d[int(rng.integers(0, len(d)))] = int(rng.integers(0, 256))
            elif kind == 1 and len(d) > 1:
                del d[int(rng.integers(1, len(d))) :]
            else:
                d.insert(int(rng.integers(0, len(d) + 1)), int(rng.integers(0, 256)))
        out.append(bytes(d))
    return out
