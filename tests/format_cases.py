"""The image files of tests/test_torch_image_formats.py and
tests/make_torch_formats.py, each made from a numpy seed when asked for:
what PIL and imageio's bundled tifffile write (TIFF, GIF, BMP, CMYK and
progressive JPEGs), and what only tests/format_writers.py builds (BigTIFF,
LZW and the predictors in every layout, min-is-white, palette and sub-byte
TIFFs, GIFs with local tables, offset and interlaced frames, RLE8 / RLE4 and
bit-field BMPs, JPEGs at other sampling factors, Adobe CMYK and YCCK).

`CASES` maps a case's name to (file extension, builder); `case_bytes(name)`
gives its bytes.  Needs PIL and imageio; no JAX.
"""

from __future__ import annotations

import functools
import io
import zlib

import numpy as np
from imageio.plugins import _tifffile as bundled_tifffile
from PIL import Image

import format_writers as fw


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def field(rng, h: int, w: int, c: int, scale: float = 1.0) -> np.ndarray:
    """(h, w, c) float32: smooth colour ramps, a bright spot and noise."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w, 2)
    base = np.stack([np.sin(5 * x + 2 * y + k) * 0.4 + 0.5 for k in range(c)], axis=-1)
    base[(x - 0.6) ** 2 + (y - 0.3) ** 2 < 0.02] *= 6.0
    return ((base + rng.normal(0.0, 0.05, base.shape)) * scale).astype(np.float32)


def u8(rng, h: int, w: int, c: int) -> np.ndarray:
    return np.clip(field(rng, h, w, c, 255.0), 0, 255).astype(np.uint8)


def _tiffwriter(a: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    opts = {k: kw.pop(k) for k in ("byteorder", "bigtiff") if k in kw}
    with bundled_tifffile.TiffWriter(out, **opts) as w:
        w.save(a, **kw)
    return out.getvalue()


def _pil(img: Image.Image, fmt: str, **kw) -> bytes:
    out = io.BytesIO()
    img.save(out, format=fmt, **kw)
    return out.getvalue()


def _cut_progressive(img: np.ndarray, scans: int, **kw) -> bytes:
    """A progressive JPEG of PIL's cut after its first `scans` scans, with
    its EOI: the later coefficients stay incomplete (libjpeg smooths)."""
    data = _pil(Image.fromarray(img), "JPEG", progressive=True, **kw)
    starts = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[: starts[scans]] + b"\xff\xd9"


CASES = {}


def case(name: str, ext: str):
    def add(fn):
        CASES[name] = (ext, lambda: fn(_rng(name)))
        return fn
    return add


# --------------------------------------------- TIFF: imageio's TiffWriter

_TW = {
    "f32-rgb": (np.float32, 3, {}), "f32-rgb-zlib": (np.float32, 3, dict(compress=6)),
    "f32-rgb-tiles": (np.float32, 3, dict(tile=(16, 16))), "f32-rgb-tiles-zlib": (np.float32, 3, dict(tile=(16, 16),
                                                                                                       compress=6)),
    "f32-rgb-planar": (np.float32, 3, dict(planarconfig="separate")),
    "f32-rgb-planar-zlib": (np.float32, 3, dict(planarconfig="separate", compress=6, rowsperstrip=3)),
    "f32-rgb-big-endian": (np.float32, 3, dict(byteorder=">")),
    "f32-rgb-big-endian-zlib": (np.float32, 3, dict(byteorder=">", compress=6)),
    "f32-rgb-bigtiff": (np.float32, 3, dict(bigtiff=True)), "f16-rgb": (np.float16, 3, {}),
    "f16-rgb-zlib": (np.float16, 3, dict(compress=6)), "f64-rgb": (np.float64, 3, {}),
    "f64-rgb-tiles": (np.float64, 3, dict(tile=(16, 16))), "f32-rgba": (np.float32, 4, {}),
    "f32-gray": (np.float32, 1, {}), "f32-gray-big-endian-zlib": (np.float32, 1, dict(byteorder=">", compress=6)),
    "u16-rgb-predictor": (np.uint16, 3, dict(compress=6, predictor=True)),
    "u16-rgb-predictor-tiles": (np.uint16, 3, dict(compress=6, predictor=True, tile=(16, 16))),
    "u16-gray": (np.uint16, 1, {}), "i16-gray-zlib": (np.int16, 1, dict(compress=6)), "i32-gray": (np.int32, 1, {}),
    "u32-gray-zlib": (np.uint32, 1, dict(compress=6)), "u8-rgb": (np.uint8, 3, {}),
    "u8-rgb-predictor": (np.uint8, 3, dict(compress=6, predictor=True, rowsperstrip=4)),
}


def _tw_case(name, dtype, c, kw):
    @case(f"tifffile-{name}", ".tif")
    def _(rng):
        dt = np.dtype(dtype)
        a = field(rng, 20, 37, c, 40.0 if dt.kind == "f" else 0.18 * float(np.iinfo(dt).max))
        if dt.kind != "f":
            a = np.clip(a - a.mean() if dt.kind == "i" else a, np.iinfo(dt).min, np.iinfo(dt).max)
        a = a.astype(dtype)
        return _tiffwriter(a[..., 0] if c == 1 else a if "planar" not in name else np.moveaxis(a, -1, 0), **kw)


for _n, (_d, _c, _k) in _TW.items():
    _tw_case(_n, _d, _c, _k)


@case("tifffile-bool", ".tif")
def _(rng):
    return _tiffwriter(rng.random((9, 13)) > 0.5)


@case("tifffile-two-pages", ".tif")
def _(rng):
    return _tiffwriter(u8(rng, 2 * 9, 11, 3).reshape(2, 9, 11, 3))


# ------------------------------------------------------------- TIFF: PIL

for _mode in ("RGB", "L", "RGBA", "1", "I;16", "F", "CMYK", "LA", "P"):
    for _comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "tiff_deflate"):
        def _pil_tiff(rng, mode=_mode, comp=_comp):
            if mode in ("RGB", "RGBA", "CMYK", "LA"):
                img = Image.fromarray(u8(rng, 13, 17, len(mode)), mode)
            elif mode == "P":
                img = Image.fromarray(u8(rng, 13, 17, 3)).convert("P")
            elif mode == "1":
                img = Image.fromarray(rng.random((13, 17)) > 0.5)
            elif mode == "I;16":
                img = Image.fromarray(field(rng, 13, 17, 1, 11000.0)[..., 0].astype(np.uint16))
            elif mode == "F":
                img = Image.fromarray(field(rng, 13, 17, 1, 300.0)[..., 0])
            else:
                img = Image.fromarray(u8(rng, 13, 17, 1)[..., 0])
            return _pil(img, "TIFF", **({} if comp == "raw" else {"compression": comp}))
        CASES[f"pil-tiff-{_mode.replace(';', '')}-{_comp}"] = (".tif", functools.partial(
            lambda fn, n: fn(_rng(n)), _pil_tiff, f"pil-tiff-{_mode}-{_comp}"))


# ---------------------------------------------- TIFF: format_writers.py

_COMPRESSION_NAMES = {1: "none", 5: "lzw", 8: "deflate", 32773: "packbits"}


def is_bigtiff(name: str) -> bool:
    """Whether a case of the layout matrix below is written as BigTIFF (half of them, by name)."""
    return zlib.crc32(name.encode()) % 2 == 0


for _order in "<>":
    for _comp in (1, 5, 8, 32773):
        for _pred in (1, 2, 3):
            for _lay in ("strips", "tiles", "planar"):
                _name = f"spec-{'ii' if _order == '<' else 'mm'}-{_COMPRESSION_NAMES[_comp]}-p{_pred}-{_lay}"

                def _spec(rng, order=_order, comp=_comp, pred=_pred, lay=_lay, name=_name):
                    a = field(rng, 21, 35, 3, 40.0)
                    if pred == 2:
                        a = (a * 250).astype(np.uint16)
                    kw = dict(order=order, big=is_bigtiff(name), compression=comp, predictor=pred)
                    kw.update({"strips": dict(rows_per_strip=5), "tiles": dict(tile=(16, 16)),
                               "planar": dict(planar=2, rows_per_strip=8)}[lay])
                    return fw.encode_tiff(a, **kw)
                CASES[_name] = (".tif", functools.partial(lambda fn, n: fn(_rng(n)), _spec, _name))

_SPEC_MODES = {
    "min-is-white": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0], photometric=0),
    "gray-4bit": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0] >> 4, bits=4),
    "min-is-white-2bit": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0] >> 6, bits=2, photometric=0),
    "bilevel": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0] > 128),
    "bilevel-min-is-white": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0] > 128, photometric=0),
    "palette-8bit": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0], photometric=3,
                                     colormap=rng.integers(0, 65536, (3, 256))),
    "palette-4bit": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0] >> 4, photometric=3, bits=4,
                                     colormap=rng.integers(0, 65536, (3, 16))),
    "palette-alpha": lambda rng: dict(samples=u8(rng, 13, 17, 2), photometric=3, extra=(2,),
                                      colormap=rng.integers(0, 65536, (3, 256))),
    "rgb-associated-alpha": lambda rng: dict(samples=u8(rng, 13, 17, 4), extra=(1,)),
    "rgb-unassociated-alpha": lambda rng: dict(samples=u8(rng, 13, 17, 4), extra=(2,)),
    "rgb-unused-extra": lambda rng: dict(samples=u8(rng, 13, 17, 4), extra=(0,)),
    "rgb16-alpha": lambda rng: dict(samples=(field(rng, 13, 17, 4, 11000.0)).astype(np.uint16), extra=(2,)),
    "gray-alpha": lambda rng: dict(samples=u8(rng, 13, 17, 2), photometric=1, extra=(2,)),
    "cmyk": lambda rng: dict(samples=u8(rng, 13, 17, 4), photometric=5),
    "i16": lambda rng: dict(samples=(field(rng, 13, 17, 1, 5000.0)[..., 0] - 9000).astype(np.int16)),
    "i32": lambda rng: dict(samples=(field(rng, 13, 17, 1, 2e8)[..., 0] - 1e8).astype(np.int32)),
    "u32": lambda rng: dict(samples=(field(rng, 13, 17, 1, 6e8)[..., 0]).astype(np.uint32)),
    "i8": lambda rng: dict(samples=(field(rng, 13, 17, 1, 200.0)[..., 0] - 100).astype(np.int8)),
    "u64": lambda rng: dict(samples=(field(rng, 13, 17, 1, 1e12)[..., 0]).astype(np.uint64)),
    "f32-gray": lambda rng: dict(samples=field(rng, 13, 17, 1, 300.0)[..., 0]),
    "f64-predictor3": lambda rng: dict(samples=field(rng, 13, 17, 3, 40.0).astype(np.float64), predictor=3),
    "f16-predictor3": lambda rng: dict(samples=field(rng, 13, 17, 3, 40.0).astype(np.float16), predictor=3),
    "fill-order-2": lambda rng: dict(samples=u8(rng, 13, 17, 3), fillorder=2),
    "bilevel-fill-order-2": lambda rng: dict(samples=u8(rng, 13, 17, 1)[..., 0] > 100, fillorder=2),
    "shaped-description": lambda rng: dict(samples=field(rng, 13, 17, 3, 40.0),
                                           description='{"shape": [1, 13, 17, 3]}'),
    "u16-rgb-planar": lambda rng: dict(samples=field(rng, 13, 17, 3, 11000.0).astype(np.uint16), planar=2),
}
for _mode, _fn in _SPEC_MODES.items():
    for _comp in (1, 5, 8, 32773):
        for _order in "<>":
            _name = f"spec-{_mode}-{_COMPRESSION_NAMES[_comp]}-{'ii' if _order == '<' else 'mm'}"
            if (_comp, _order) not in ((1, "<"), (5, ">"), (8, "<"), (32773, ">")) and _mode not in (
                    "min-is-white", "palette-8bit", "rgb-associated-alpha", "i16", "f32-gray"):
                continue

            def _spec_mode(rng, fn=_fn, comp=_comp, order=_order):
                kw = fn(rng)
                return fw.encode_tiff(kw.pop("samples"), compression=comp, order=order, rows_per_strip=5, **kw)
            CASES[_name] = (".tif", functools.partial(lambda fn, n: fn(_rng(n)), _spec_mode, _name))


# -------------------------------------------------------------------- GIF

for _inter in (False, True):
    for _where in ("global", "local"):
        for _trns in (None, 5):
            for _place in ("full", "inside", "past"):
                _name = f"gif-{_where}-{'interlaced' if _inter else 'rows'}-{_place}" + (
                    "-transparent" if _trns is not None else "")

                def _gif(rng, inter=_inter, where=_where, trns=_trns, place=_place):
                    idx = rng.integers(0, 16, (13, 17)).astype(np.uint8)
                    kw = {"full": {}, "inside": dict(screen=(25, 20), offset=(5, 4)),
                          "past": dict(screen=(10, 8), offset=(5, 4))}[place]
                    return fw.encode_gif(idx, rng.integers(0, 256, (16, 3)), interlace=inter, local=where == "local",
                                         transparency=trns, **kw)
                CASES[_name] = (".gif", functools.partial(lambda fn, n: fn(_rng(n)), _gif, _name))


@case("gif-256-colours-table-resets", ".gif")
def _(rng):
    return fw.encode_gif(rng.integers(0, 256, (70, 90)).astype(np.uint8), rng.integers(0, 256, (256, 3)))


@case("gif-gray-ramp-table", ".gif")
def _(rng):
    return fw.encode_gif(rng.integers(0, 4, (9, 11)).astype(np.uint8), np.repeat(np.arange(4)[:, None], 3, 1),
                         transparency=2)


@case("gif-indices-past-the-table", ".gif")
def _(rng):
    return fw.encode_gif(rng.integers(0, 200, (9, 11)).astype(np.uint8), rng.integers(0, 256, (4, 3)), min_size=8)


@case("gif-87a-interlaced-5-rows", ".gif")
def _(rng):
    return fw.encode_gif(rng.integers(0, 16, (5, 7)).astype(np.uint8), rng.integers(0, 256, (16, 3)), interlace=True,
                         version=b"GIF87a")


@case("gif-pil-rgb", ".gif")
def _(rng):
    return _pil(Image.fromarray(u8(rng, 20, 30, 3)), "GIF")


@case("gif-pil-gray", ".gif")
def _(rng):
    return _pil(Image.fromarray(u8(rng, 20, 30, 1)[..., 0]), "GIF")


@case("gif-codes-end-early", ".gif")
def _(rng):
    idx = rng.integers(0, 16, (13, 17)).astype(np.uint8)
    return fw.encode_gif(idx, rng.integers(0, 256, (16, 3)), lzw=fw.gif_lzw(idx.tobytes()[:100], 4))


# -------------------------------------------------------------------- BMP

_PALETTE = np.random.default_rng(3).integers(0, 256, (256, 3))
for _hdr in (12, 40, 108, 124):
    for _td in (False, True) if _hdr != 12 else (False,):
        for _kind in ("24", "32", "16-555", "p1", "p4", "p8", "gray8", "bw1", "p8-short-table"):
            _name = f"bmp-{_kind}-h{_hdr}" + ("-top-down" if _td else "")

            def _bmp(rng, hdr=_hdr, td=_td, kind=_kind):
                if kind in ("24", "32", "16-555"):
                    return fw.encode_bmp(u8(rng, 11, 13, 3), bits=int(kind[:2]), header=hdr, top_down=td)
                if kind == "gray8":
                    return fw.encode_bmp(rng.integers(0, 256, (11, 13)), bits=8, header=hdr, top_down=td,
                                         palette=np.repeat(np.arange(256)[:, None], 3, 1))
                if kind == "bw1":
                    return fw.encode_bmp(rng.integers(0, 2, (11, 13)), bits=1, header=hdr, top_down=td,
                                         palette=[[0, 0, 0], [255, 255, 255]])
                if kind == "p8-short-table":
                    return fw.encode_bmp(rng.integers(0, 40, (11, 13)), bits=8, header=hdr, top_down=td,
                                         palette=_PALETTE[:20])
                bits = int(kind[1:])
                return fw.encode_bmp(rng.integers(0, 1 << bits, (11, 13)), bits=bits, header=hdr, top_down=td,
                                     palette=_PALETTE[: 1 << bits])
            CASES[_name] = (".bmp", functools.partial(lambda fn, n: fn(_rng(n)), _bmp, _name))

_MASKS = {"565": (16, (0xF800, 0x7E0, 0x1F)), "555": (16, (0x7C00, 0x3E0, 0x1F)),
          "bgrx": (32, (0xFF0000, 0xFF00, 0xFF, 0)), "bgra": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
          "rgba": (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)), "abgr": (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
          "xbgr": (32, (0xFF000000, 0xFF0000, 0xFF00, 0)), "bgar": (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
          "rgb-green-high": (32, (0xFF, 0xFF000000, 0xFF0000, 0))}
for _hdr in (40, 56, 124):
    for _m, (_bits, _mask) in _MASKS.items():
        _name = f"bmp-bitfields-{_m}-h{_hdr}"

        def _bf(rng, hdr=_hdr, bits=_bits, mask=_mask):
            return fw.encode_bmp(u8(rng, 11, 13, 4), bits=bits, header=hdr, compression=3, masks=mask)
        CASES[_name] = (".bmp", functools.partial(lambda fn, n: fn(_rng(n)), _bf, _name))

for _bits, _comp in ((8, 1), (4, 2)):
    for _img in ("noise", "runs"):
        for _hdr in (40, 124):
            _name = f"bmp-rle{_bits}-{_img}-h{_hdr}"

            def _rle(rng, bits=_bits, comp=_comp, img=_img, hdr=_hdr):
                n = 1 << bits
                idx = rng.integers(0, n, (11, 13)) if img == "noise" else np.repeat(
                    rng.integers(0, n, (11, 5)), 3, axis=1)[:, :13]
                return fw.encode_bmp(idx, bits=bits, header=hdr, palette=_PALETTE[:n], compression=comp)
            CASES[_name] = (".bmp", functools.partial(lambda fn, n: fn(_rng(n)), _rle, _name))
    _name = f"bmp-rle{_bits}-delta"

    def _delta(rng, bits=_bits, comp=_comp):
        n = 1 << bits
        idx = np.repeat(rng.integers(0, n, (11, 5)), 3, axis=1)[:, :13]
        return fw.encode_bmp(idx, bits=bits, palette=_PALETTE[:n], compression=comp, rle_delta_at=(3, 3))
    CASES[_name] = (".bmp", functools.partial(lambda fn, n: fn(_rng(n)), _delta, _name))

for _mode in ("RGB", "P", "1", "L", "RGBA"):
    def _pil_bmp(rng, mode=_mode):
        img = {"RGB": lambda: Image.fromarray(u8(rng, 11, 13, 3)), "RGBA": lambda: Image.fromarray(u8(rng, 11, 13, 4)),
               "P": lambda: Image.fromarray(u8(rng, 11, 13, 3)).convert("P"),
               "1": lambda: Image.fromarray(rng.random((11, 13)) > 0.5),
               "L": lambda: Image.fromarray(u8(rng, 11, 13, 1)[..., 0])}[mode]()
        return _pil(img, "BMP")
    CASES[f"bmp-pil-{_mode}"] = (".bmp", functools.partial(lambda fn, n: fn(_rng(n)), _pil_bmp, f"bmp-pil-{_mode}"))


# ------------------------------------------------------------------- JPEG

_FACTORS = {"440": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)], "410": [(4, 2), (1, 1), (1, 1)],
            "mixed": [(2, 2), (1, 2), (2, 1)], "chroma-larger": [(1, 1), (2, 2), (1, 1)],
            "31": [(3, 1), (1, 1), (1, 1)], "1-4": [(1, 4), (1, 1), (1, 2)], "all-2x1": [(2, 1), (2, 1), (2, 1)],
            "fractional": [(3, 2), (2, 2), (1, 1)], "11-blocks": [(4, 2), (2, 1), (1, 1)]}
for _f, _fac in _FACTORS.items():
    for _size in ((37, 29), (9, 70)):
        _name = f"jpeg-sampling-{_f}-{_size[0]}x{_size[1]}"

        def _samp(rng, fac=_fac, size=_size):
            img = u8(rng, size[1], size[0], 3)
            return fw.encode_jpeg([img[..., i] for i in range(3)], fac, restart=3)
        CASES[_name] = (".jpg", functools.partial(lambda fn, n: fn(_rng(n)), _samp, _name))

for _adobe in (None, 0, 1, 2):
    for _fac in ("444", "420"):
        _name = f"jpeg-4-components-adobe-{_adobe}-{_fac}"

        def _four(rng, adobe=_adobe, fac=_fac):
            img = u8(rng, 29, 37, 4)
            factors = [(1, 1)] * 4 if fac == "444" else [(2, 2), (1, 1), (1, 1), (2, 2)]
            return fw.encode_jpeg([img[..., i] for i in range(4)], factors, adobe=adobe)
        CASES[_name] = (".jpg", functools.partial(lambda fn, n: fn(_rng(n)), _four, _name))

for _q in (50, 90):
    for _prog in (False, True):
        _name = f"jpeg-pil-cmyk-q{_q}" + ("-progressive" if _prog else "")

        def _cmyk(rng, q=_q, prog=_prog):
            return _pil(Image.fromarray(u8(rng, 29, 37, 4), "CMYK"), "JPEG", quality=q, progressive=prog)
        CASES[_name] = (".jpg", functools.partial(lambda fn, n: fn(_rng(n)), _cmyk, _name))

for _kind, _kw in (("gray", None), ("444", 0), ("422", 1), ("420", 2)):
    for _size in ((24, 16), (37, 29), (17, 70)):
        for _scans in (1, 2, 4):
            _name = f"jpeg-smoothing-{_kind}-{_size[0]}x{_size[1]}-{_scans}-scans"

            def _smooth(rng, kw=_kw, size=_size, scans=_scans):
                img = u8(rng, size[1], size[0], 3)
                if kw is None:
                    return _cut_progressive(img.mean(axis=-1).astype(np.uint8), scans, quality=40)
                return _cut_progressive(img, scans, quality=40, subsampling=kw)
            CASES[_name] = (".jpg", functools.partial(lambda fn, n: fn(_rng(n)), _smooth, _name))


# --------------------------------------------------- content under other names

@case("cross-tiff-named-png", ".png")
def _(rng):
    return fw.encode_tiff(u8(rng, 9, 11, 3), compression=5)


@case("cross-png-named-tif", ".tif")
def _(rng):
    return _pil(Image.fromarray(u8(rng, 9, 11, 3)), "PNG")


@case("cross-gif-named-bmp", ".bmp")
def _(rng):
    return fw.encode_gif(rng.integers(0, 16, (9, 11)).astype(np.uint8), rng.integers(0, 256, (16, 3)))


@functools.lru_cache(maxsize=None)
def case_bytes(name: str) -> bytes:
    return CASES[name][1]()
