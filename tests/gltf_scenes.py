"""glTF 2.0 files and PNG images for the loader tests and the chip smoke
run, written with numpy, json, zlib and the port's `save_png` alone (no
JAX, no PIL).

`GltfWriter` lays out accessors, buffer views, PNG or JPEG images,
textures, materials, meshes, nodes and a camera, and saves the document as
a `.glb` (images in buffer views), a `.gltf` with an external `.bin` buffer
and external image files, or a `.gltf` with `data:` URIs.  `scene_to_gltf`
writes a host `Scene` with one node per instance (instances of one mesh
and material share one glTF mesh), so `load_gltf` gives the same
instances, materials and texture slots back; `feature_scene`
writes a small document that touches every path of the loader.

`encode_png` writes any PNG (every colour type and bit depth, chosen row
filters, Adam7), the files PIL cannot write.  `IMAGE_FIXTURES` names the
decoder fixtures in tests/torch_images/ (written by
tests/make_torch_images.py with PIL): each NAME has NAME.ref.png beside
it, PIL's decode of it as 8-bit RGBA; the large `TIMING_JPEG` has the
sha256 of that decode in TIMING_JPEG.sha256 instead.  `FORMAT_FIXTURES`
names the TIFF, GIF, BMP and JPEG fixtures of tests/torch_formats/ and
their manifest.json, `WEBP_FIXTURES` the WebP ones of tests/torch_webp/,
`JPEG_FIXTURES` the arithmetic-coded and lossless JPEGs of tests/torch_jpeg/,
`PIL_FORMAT_FIXTURES` the TGA, DDS, Netpbm, QOI, SGI, PCX, ICO / CUR and PSD
ones of tests/torch_pil_formats/, `pil_rare_fixtures()` the files of PIL's
rarer plugins in tests/torch_pil_rare/.
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
import tempfile
import zlib

import numpy as np

from vpt_tpu_torch.io.image import _chunk, save_png

FLOAT, UBYTE, USHORT, UINT = 5126, 5121, 5123, 5125
_TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}
_EXTENSIONS = {"image/png": ".png", "image/jpeg": ".jpg"}

IMAGE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_images")
IMAGE_FIXTURES = (
    "jpeg_444_q50.jpg", "jpeg_444_q95.jpg", "jpeg_422_q50.jpg", "jpeg_422_q95.jpg", "jpeg_420_q50.jpg",
    "jpeg_420_q95.jpg", "jpeg_gray.jpg", "jpeg_optimize.jpg", "jpeg_restart.jpg", "jpeg_progressive_420.jpg",
    "jpeg_progressive_gray.jpg", "png16_rgb.png", "png16_rgba.png", "png16_gray.png", "png16_gray_alpha.png",
    "png_adam7_rgb8.png", "png_adam7_rgba16.png", "png_gray1.png", "png_gray2.png", "png_gray4.png",
)
TIMING_JPEG = "jpeg_1024_420.jpg"
# The TIFF, GIF, BMP and JPEG fixtures of tests/torch_formats/ (written by
# tests/make_torch_formats.py from tests/format_cases.py, each the case of
# its name): manifest.json holds, per file, the shape, dtype and sha256 of
# the bytes of the JAX package's decodes, its glTF texture decode ("rgba")
# and its load_hdr ("load_hdr").
FORMAT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_formats")
FORMAT_FIXTURES = (
    "tifffile-f32-rgb-zlib.tif", "tifffile-f16-rgb.tif", "tifffile-f64-rgb-tiles.tif", "tifffile-f32-rgb-planar.tif",
    "tifffile-f32-rgb-big-endian.tif", "tifffile-f32-rgb-bigtiff.tif", "tifffile-u16-rgb-predictor.tif",
    "spec-mm-lzw-p3-strips.tif", "spec-ii-lzw-p2-tiles.tif", "spec-palette-8bit-lzw-mm.tif",
    "spec-min-is-white-packbits-mm.tif", "pil-tiff-RGB-tiff_lzw.tif", "pil-tiff-CMYK-tiff_adobe_deflate.tif",
    "gif-local-interlaced-inside-transparent.gif", "gif-256-colours-table-resets.gif", "gif-pil-gray.gif",
    "bmp-rle8-runs-h40.bmp", "bmp-rle4-noise-h124.bmp", "bmp-bitfields-565-h56.bmp", "bmp-bitfields-bgra-h124.bmp",
    "bmp-p4-h12.bmp", "bmp-24-h40-top-down.bmp", "jpeg-pil-cmyk-q90.jpg", "jpeg-4-components-adobe-2-420.jpg",
    "jpeg-sampling-440-37x29.jpg", "jpeg-sampling-411-37x29.jpg", "jpeg-smoothing-420-17x70-2-scans.jpg",
    "jpeg-smoothing-gray-37x29-1-scans.jpg",
)
# The WebP fixtures of tests/torch_webp/ (written by tests/make_torch_webp.py:
# libwebp's encoder at settings PIL does not expose, cases of
# tests/webp_cases.py, and the two 2048x2048 textures chip_smoke.py phase 17b
# times), with a manifest.json as tests/torch_formats/ has.
WEBP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_webp")
WEBP_TIMING = ("timing-2048-lossy-alpha.webp", "timing-2048-lossless.webp")
WEBP_FIXTURES = (
    "vp8-filter-simple-sharpness-0.webp", "vp8-filter-simple-sharpness-4.webp", "vp8-filter-simple-sharpness-7.webp",
    *(f"vp8-filter-normal-sharpness-{s}.webp" for s in range(1, 8)), "vp8-filter-off.webp",
    "vp8-filter-strongest-q0.webp", "vp8-filter-auto.webp", "vp8-partitions-2.webp", "vp8-partitions-4.webp",
    "vp8-partitions-8.webp", *(f"vp8-segments-{s}.webp" for s in range(1, 5)), "vp8-sharp-yuv-m6.webp",
    *(f"vp8-alph-{c}-filter-{f}.webp" for c in ("raw", "lossless") for f in ("none", "fast", "best")),
    "vp8-alph-quantised-q30.webp", "vp8l-m0-q0.webp", "vp8l-m6-q100-exact.webp",
    *(f"alph-{c}-filter-{f}.webp" for c in ("raw", "lossless") for f in range(4)),
    "animation-first-frame-lossy-alpha-12x9-at-6-4.webp", *WEBP_TIMING,
)
# The arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG fixtures of
# tests/torch_jpeg/ (written by tests/make_torch_jpeg.py with libjpeg-turbo's
# encoder: PIL writes neither), with a manifest.json as tests/torch_formats/
# has; JPEG_TIMING are the two textures chip_smoke.py phase 17b times.
JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg")
JPEG_TIMING = ("timing-2048-arith-prog-ycc420.jpg", "timing-1024-lossless-rgb.jpg")
JPEG_FIXTURES = (
    "arith-gray-q50-37x29.jpg", *(f"arith-ycc{s}-q50-37x29.jpg" for s in ("444", "422", "420", "440")),
    "arith-rgb-adobe0-q75-37x29.jpg", "arith-cmyk-q75-37x29.jpg", "arith-ycck-q75-37x29.jpg",
    "arith-ycc420-q5-16bit-tables-37x29.jpg", "arith-ycc420-q95-37x29.jpg", "arith-ycc420-rst1-37x29.jpg",
    "arith-ycc444-rst3-37x29.jpg", "arith-gray-rst3-17x70.jpg", "arith-dac-L2-U6-K2-ycc420-37x29.jpg",
    "arith-dac-L0-U0-K63-gray-37x29.jpg", "arith-ycc420-1x1.jpg", "arith-ycc422-17x70.jpg",
    "arith-ycc420-rst3-255x3.jpg", "arith-prog-ycc420-37x29.jpg", "arith-prog-gray-37x29.jpg",
    "arith-prog-ycc444-q95-37x29.jpg", "arith-prog-cmyk-37x29.jpg", "arith-prog-rst2-ycc422-37x29.jpg",
    "arith-prog-sa-to-bit-0-ycc444-37x29.jpg", "arith-prog-smoothed-ycc420-37x29.jpg",
    "arith-prog-smoothed-gray-17x70.jpg", "arith-prog-ycc420-1x1.jpg", "arith-prog-ycc420-255x3.jpg",
    *(f"lossless-gray-p{p}-37x29.jpg" for p in range(1, 8)), "lossless-rgb-p1-pt0-37x29.jpg",
    "lossless-rgb-p4-pt1-37x29.jpg", "lossless-rgb-p7-pt3-37x29.jpg",
    *(f"lossless-rgb-sampling-{s}-p6-37x29.jpg" for s in ("11", "21", "22")), "lossless-cmyk-p5-37x29.jpg",
    "lossless-rgb-p2-rst-rows-2-37x29.jpg", "lossless-rgb-sampling-22-p4-rst-rows-1-37x29.jpg",
    "lossless-rgb-p3-per-component-scans-37x29.jpg", "lossless-gray-p7-1x1.jpg",
    "lossless-rgb-sampling-21-p5-17x70.jpg", "lossless-gray-p4-pt1-rst-rows-1-255x3.jpg",
    "lossless-rgb-restart-5-mcus-refused-37x29.jpg", "lossless-gray-6-bit-refused-37x29.jpg",
    "lossless-ycc-adobe-1-refused-37x29.jpg", "lossless-ycck-adobe-2-refused-37x29.jpg", *JPEG_TIMING,
)
# The TGA, DDS, Netpbm / PFM, QOI, SGI, PCX, ICO / CUR and PSD fixtures of
# tests/torch_pil_formats/ (written by tests/make_torch_pil_formats.py from
# tests/pil_format_cases.py, each the case of its name), with a
# manifest.json as tests/torch_formats/ has; it also holds the entries of
# PIL_FORMAT_TIMING, the three 2048x2048 textures chip_smoke.py phase 17b
# times, which are not committed: tests/pil_format_writers.timing_textures
# makes them from a seed.
PIL_FORMAT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_pil_formats")
PIL_FORMAT_TIMING = ("timing-bc7.dds", "timing-rle.tga", "timing-ops.qoi")
PIL_FORMAT_FIXTURES = (
    "tga-pil-RGBA-rle-bottom.tga", "tga-pil-P-raw-top.tga", "tga-pil-LA-rle-top.tga", "tga-rle-cross-rgb24.tga",
    "tga-rle-cross-map8.tga", "tga-bgra15-raw.tga", "tga-colour-map-16-start-3.tga", "tga-rgb24-flags-10.tga",
    "tga-cur-magic.tga", "tga-pcx-magic.tga", "tga-gray1-raw.tga", "pcx-pil-P-w13.pcx", "pcx-pil-RGB-w13.pcx",
    "pcx-pil-1-w13.pcx", "pcx-4-planes-w3.pcx", "pcx-2-planes-w9.pcx", "pcx-8-bit-short.pcx",
    "dds-pil-RGBA-DXT5-13x9.dds", "dds-pil-RGB-DXT1-13x9.dds", "dds-pil-RGB-BC5-13x9.dds", "dds-bc4-ati1-10x7.dds",
    "dds-bc5s-10x7.dds", "dds-bc6h-uf16-32x16.dds", "dds-bc6h-sf16-32x16.dds", "dds-bc7-32x16.dds",
    "dds-bc7-mips.dds", "dds-masks-argb1555.dds", "dds-palette.dds", "dds-pil-LA-raw-12x8.dds",
    "ppm-ascii-P1-maxNone.ppm", "ppm-ascii-P3-max7.ppm", "ppm-binary-P5-max1000.ppm", "ppm-binary-P6-max65535.ppm",
    "ppm-pil-1.ppm", "ppm-pfm-Pf-le--1.0.ppm", "ppm-pfm-PF-be-1.0.ppm", "qoi-every-op-4-channels-4.qoi",
    "qoi-every-op-3-channels-3.qoi", "sgi-3-channels-16-bit-rle.sgi", "sgi-4-channels-8-bit-rle.sgi",
    "sgi-1-channels-8-bit-verbatim.sgi", "sgi-rle-short-length.sgi", "ico-pil-RGBA-png.ico", "ico-bmp-4-bit.ico",
    "ico-bmp-32-bit.ico", "cur-8-bit.cur", "cur-32-bit-at-22.cur", "psd-rgba-packbits.psd", "psd-cmyk-raw.psd",
    "psd-indexed-packbits.psd", "psd-bitmap-raw.psd", "psd-gray-packbits.psd",
)
# The fixtures of PIL's rarer plugins (BLP, icns, DCX, FITS, FTEX, GBR, IM,
# IMT, MSP, SPIDER, Sun raster, XBM, XPM, XV thumbnails, FLI, IPTC, McIdas,
# PIXAR, and files of the plugins that decode on neither machine) in
# tests/torch_pil_rare/, written by tests/make_torch_pil_rare.py from
# tests/pil_rare_cases.py, with a manifest.json of the JAX package's four
# decodes of each ("rgba", "rgba_file", "load_png", "load_hdr"); it also
# holds the files tests/pil_rare_writers.generated() makes from seeds (the
# PhotoCD cases, the 2048x2048 timing textures, the 4096x2048 FITS sky).
PIL_RARE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_pil_rare")


def pil_rare_fixtures() -> tuple:
    """The committed files of tests/torch_pil_rare/, by name."""
    return tuple(sorted(f for f in os.listdir(PIL_RARE_DIR) if f != "manifest.json"))


# The JPEG 2000 fixtures of tests/torch_jpeg2000/ (written by
# tests/make_torch_jpeg2000.py: every case of tests/jpeg2000_cases.py under
# its name and extension, the two timing textures of JPEG2000_TIMING that
# chip_smoke.py phase 17b times, and JPEG2000_SKY, 17c's environment map),
# with a manifest.json as tests/torch_formats/ has, and pil_seconds.json,
# PIL's decode seconds of the timing textures where the fixtures were made.
JPEG2000_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg2000")
JPEG2000_TIMING = ("timing-2048-97-rate.jp2", "timing-1024-53-tiles.jp2")
JPEG2000_SKY = "sky-512x1024.jp2"
JPEG2000_EXTENSIONS = (".jp2", ".j2k", ".j2c", ".jpc", ".jpf", ".jpx")


def jpeg2000_fixtures() -> tuple:
    """The files of tests/torch_jpeg2000/ (the timing textures and the sky
    included), by name."""
    return tuple(sorted(f for f in os.listdir(JPEG2000_DIR) if f.endswith(JPEG2000_EXTENSIONS)))


# The AVIF fixtures of tests/torch_avif/ (written by tests/make_torch_avif.py
# from tests/avif_cases.py: lossless and lossy 8-bit files PIL writes, the
# files the port refuses by name, the three 1024x1024 timing textures
# AVIF_TIMING that chip_smoke.py phase 17b times and AVIF_SKY, 17c's
# environment map),
# with a manifest.json of the JAX package's four decodes of each, as
# tests/torch_pil_rare/ has.
AVIF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_avif")
AVIF_TIMING = ("timing-1024-soft-420.avif", "timing-1024-ramp-rgba.avif", "timing-1024-lossy-420.avif")
AVIF_SKY = "sky-1024x512.avif"


def avif_fixtures() -> tuple:
    """The files of tests/torch_avif/, by name."""
    return tuple(sorted(f for f in os.listdir(AVIF_DIR) if f.endswith(".avif")))


# Adam7 passes: first column, first row, column step, row step.
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def png_bytes(image) -> bytes:
    """A float [0, 1] or uint8 (H, W, 3 | 4) image as PNG bytes."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.png")
        save_png(path, image)
        with open(path, "rb") as f:
            return f.read()


def _pack_rows(sub: np.ndarray, depth: int) -> np.ndarray:
    """(h, stride) uint8 scanline bytes of (h, w, c) samples at `depth` bits."""
    h = sub.shape[0]
    if depth == 16:
        return sub.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return sub.astype(np.uint8).reshape(h, -1)
    bits = (sub[..., 0, None].astype(np.uint8) >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Filtered scanlines: row y with kinds[y % len(kinds)] (0 none, 1 sub,
    2 up, 3 average, 4 Paeth; PNG spec, section 9), its type byte first."""
    x = rows.astype(np.int16)
    h, stride = x.shape
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    kind = np.asarray(kinds, np.uint8)[np.arange(h) % len(kinds)]
    pred = np.zeros_like(x)
    for k in set(kind.tolist()) - {0}:
        rows_k = kind == k
        ak, bk, ck = a[rows_k], b[rows_k], c[rows_k]
        if k == 1:
            pred[rows_k] = ak
        elif k == 2:
            pred[rows_k] = bk
        elif k == 3:
            pred[rows_k] = (ak + bk) >> 1
        else:
            pa, pb, pc = np.abs(bk - ck), np.abs(ak - ck), np.abs(ak + bk - 2 * ck)
            pred[rows_k] = np.where((pa <= pb) & (pa <= pc), ak, np.where(pb <= pc, bk, ck))
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = kind
    out[:, 1:] = (x - pred) & 0xFF
    return out.tobytes()


def encode_png(samples, depth: int = 8, ctype=None, filters=(0,), interlace: bool = False, palette=None,
               trns: bytes | None = None) -> bytes:
    """A PNG of (H, W[, c]) samples: uint8 or uint16 values at `depth` bits
    (1, 2, 4, 8 or 16; palette indices for colour type 3, then `palette`
    is (n, 3) uint8), colour type `ctype` (by default from c: gray, gray +
    alpha, RGB, RGBA), row y of each (sub)image filtered with
    filters[y % len(filters)], Adam7-interlaced if `interlace`, with a
    tRNS chunk of the bytes `trns`."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    bpp = max(1, c * depth // 8)
    data = []
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = s[y0::dy, x0::dx]
        if sub.size:
            data.append(_filter_rows(_pack_rows(sub, depth), bpp, filters))
    out = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    out += [_chunk(b"IDAT", zlib.compress(b"".join(data), 6)), _chunk(b"IEND", b"")]
    return b"".join(out)


def _append_view(doc: dict, blob: bytearray, data: bytes, stride=None) -> int:
    """Append `data` to `blob` at a 4-byte boundary as a new buffer view."""
    blob += b"\0" * (-len(blob) % 4)
    v = {"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)}
    if stride is not None:
        v["byteStride"] = stride
    blob += data
    doc.setdefault("bufferViews", []).append(v)
    return len(doc["bufferViews"]) - 1


class GltfWriter:
    """Builds a glTF document and its one binary buffer."""

    def __init__(self):
        self.doc = {"asset": {"version": "2.0"}, "scenes": [{"nodes": []}], "scene": 0}
        self.bin = bytearray()
        self.images = []  # PNG (or other) bytes per image

    def _list(self, key):
        return self.doc.setdefault(key, [])

    def view(self, data: bytes, stride=None) -> int:
        return _append_view(self.doc, self.bin, data, stride)

    def accessor(self, arr, component=FLOAT) -> int:
        """A packed accessor over its own buffer view."""
        arr = np.asarray(arr)
        arr2 = arr.reshape(arr.shape[0], -1)
        dtype = {FLOAT: np.float32, UBYTE: np.uint8, USHORT: np.uint16, UINT: np.uint32}[component]
        view = self.view(np.ascontiguousarray(arr2, dtype).tobytes())
        return self._add_accessor(view, 0, arr2.shape[0], arr2.shape[1], component)

    def _add_accessor(self, view, offset, count, ncomp, component) -> int:
        acc = {"bufferView": view, "componentType": component, "count": int(count), "type": _TYPES[ncomp]}
        if offset:
            acc["byteOffset"] = offset
        self._list("accessors").append(acc)
        return len(self.doc["accessors"]) - 1

    def interleaved(self, *arrays) -> list:
        """Float32 attributes interleaved in one view with a byteStride, plus
        4 bytes of padding per element; one accessor each."""
        cols = [np.asarray(a, np.float32).reshape(len(a), -1) for a in arrays]
        n = cols[0].shape[0]
        packed = np.concatenate(cols + [np.zeros((n, 1), np.float32)], axis=1)
        view = self.view(packed.tobytes(), stride=packed.shape[1] * 4)
        out, off = [], 0
        for c in cols:
            out.append(self._add_accessor(view, off, n, c.shape[1], FLOAT))
            off += 4 * c.shape[1]
        return out

    def image(self, data: bytes, name=None, mime_type: str = "image/png") -> int:
        self.images.append(data)
        img = {"mimeType": mime_type}
        if name:
            img["name"] = name
        self._list("images").append(img)
        return len(self.images) - 1

    def texture(self, image: int) -> int:
        self._list("textures").append({"source": image})
        return len(self.doc["textures"]) - 1

    def material(self, **m) -> int:
        self._list("materials").append(m)
        return len(self.doc["materials"]) - 1

    def mesh(self, prims, name="mesh") -> int:
        self._list("meshes").append({"name": name, "primitives": prims})
        return len(self.doc["meshes"]) - 1

    def node(self, root=True, **n) -> int:
        self._list("nodes").append(n)
        idx = len(self.doc["nodes"]) - 1
        if root:
            self.doc["scenes"][0]["nodes"].append(idx)
        return idx

    def camera(self, yfov: float, aspect: float) -> int:
        self._list("cameras").append({"type": "perspective", "perspective": {
            "yfov": yfov, "aspectRatio": aspect, "znear": 0.01, "zfar": 1000.0}})
        return len(self.doc["cameras"]) - 1

    def save(self, path: str, layout: str = "glb") -> str:
        """Write the document: "glb", "external" (a .bin and PNG files
        beside the .gltf) or "data" (data: URIs)."""
        doc, blob = json.loads(json.dumps(self.doc)), bytearray(self.bin)
        if layout == "glb":
            for i, data in enumerate(self.images):
                doc["images"][i]["bufferView"] = _append_view(doc, blob, data)
        base = os.path.splitext(path)[0]
        blob = bytes(blob)
        doc["buffers"] = [{"byteLength": len(blob)}]
        if layout == "external":
            with open(base + ".bin", "wb") as f:
                f.write(blob)
            doc["buffers"][0]["uri"] = os.path.basename(base) + ".bin"
            for i, data in enumerate(self.images):
                name = f"{os.path.basename(base)}_{i}{_EXTENSIONS[doc['images'][i]['mimeType']]}"
                with open(os.path.join(os.path.dirname(path), name), "wb") as f:
                    f.write(data)
                doc["images"][i]["uri"] = name
        elif layout == "data":
            doc["buffers"][0]["uri"] = "data:application/octet-stream;base64," + base64.b64encode(blob).decode()
            for i, data in enumerate(self.images):
                doc["images"][i]["uri"] = f"data:{doc['images'][i]['mimeType']};base64," + base64.b64encode(data).decode()
        if layout == "glb":
            js = json.dumps(doc).encode()
            js += b" " * (-len(js) % 4)
            blob += b"\0" * (-len(blob) % 4)
            out = io.BytesIO()
            out.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
            out.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            out.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
            with open(path, "wb") as f:
                f.write(out.getvalue())
        else:
            with open(path, "w") as f:
                json.dump(doc, f)
        return path


def _material_json(m, tex_of) -> dict:
    """A Material as glTF: factors, textures and the three KHR extensions."""
    emissive = np.asarray(m.emissive_color, np.float64)
    strength = float(emissive.max()) if emissive.max() > 1.0 else 1.0
    out = {"name": m.name, "pbrMetallicRoughness": {
        "baseColorFactor": [float(c) for c in m.base_color] + [1.0],
        "metallicFactor": float(m.metallic), "roughnessFactor": float(m.roughness)}}
    ext = {}
    if emissive.any():
        out["emissiveFactor"] = (emissive / strength).tolist()
        if strength != 1.0:
            ext["KHR_materials_emissive_strength"] = {"emissiveStrength": strength}
    if m.transmission:
        ext["KHR_materials_transmission"] = {"transmissionFactor": float(m.transmission)}
    if m.ior != 1.5:
        ext["KHR_materials_ior"] = {"ior": float(m.ior)}
    if ext:
        out["extensions"] = ext
    if m.base_color_texture >= 3:
        out["pbrMetallicRoughness"]["baseColorTexture"] = {"index": tex_of(m.base_color_texture)}
    if m.normal_texture >= 3:
        out["normalTexture"] = {"index": tex_of(m.normal_texture)}
    if m.emissive_texture >= 3:
        out["emissiveTexture"] = {"index": tex_of(m.emissive_texture)}
    return out


def scene_to_gltf(scene, path: str, layout: str = "glb", images=None) -> str:
    """Write a host Scene (its env map aside) so that `load_gltf` gives its
    instances, materials and texture slots back: one glTF mesh per mesh and
    material (a glTF primitive carries its material, so a mesh drawn with
    two materials is written twice), one root node per instance (matrix),
    then the camera node.  Textures are written as 8-bit PNGs, except the
    slots of `images`, {slot: (bytes, mimeType)}, written as given."""
    w = GltfWriter()
    texture_of = {}
    images = images or {}

    def tex_of(slot):
        if slot not in texture_of:
            data, mime = images.get(slot) or (png_bytes(scene.textures[slot]), "image/png")
            texture_of[slot] = w.texture(w.image(data, name=f"texture {slot}", mime_type=mime))
        return texture_of[slot]

    for m in scene.materials:
        w._list("materials").append(_material_json(m, tex_of))
    mesh_ids = {}  # (mesh, material) -> glTF mesh: a primitive carries its material
    for inst in scene.instances:
        key = (inst.mesh, inst.material)
        if key not in mesh_ids:
            mesh = scene.meshes[inst.mesh]
            prim = {"attributes": {"POSITION": w.accessor(mesh.positions), "NORMAL": w.accessor(mesh.normals),
                                   "TEXCOORD_0": w.accessor(mesh.uvs)},
                    "indices": w.accessor(mesh.indices, UINT), "material": inst.material}
            mesh_ids[key] = w.mesh([prim], name=mesh.name)
        w.node(mesh=mesh_ids[key], name=inst.name,
               matrix=np.asarray(inst.transform, np.float32).T.reshape(-1).tolist())
    if scene.camera_view is not None:
        cam = w.camera(float(np.radians(scene.camera_fov_deg)), float(scene.camera_aspect))
        world = np.linalg.inv(np.asarray(scene.camera_view, np.float64)).astype(np.float32)
        w.node(camera=cam, name="camera", matrix=world.T.reshape(-1).tolist())
    return w.save(path, layout)


def feature_scene(path: str, layout: str, extra_png: bytes | None = None) -> str:
    """A small document that touches every path of the loader: u8, u16 and
    u32 indices; an interleaved view with a byteStride; a primitive without
    NORMAL and TEXCOORD_0 (face normals) and one without indices; TRS and
    matrix nodes in a hierarchy; a perspective camera under a parent; a
    metallicRoughness texture (split into roughness and metallic slots,
    shared by two materials), normal and emissive textures; the
    emissive-strength, transmission and ior extensions; and, with
    `extra_png`, those bytes as one more base-color image."""
    rng = np.random.default_rng(11)
    w = GltfWriter()
    tex = rng.random((6, 5, 4)).astype(np.float32)
    mr = w.texture(w.image(png_bytes(tex[..., :3]), name="metal-rough"))
    nrm = w.texture(w.image(png_bytes(tex), name="normal"))
    emi = w.texture(w.image(png_bytes(rng.random((3, 7, 3))), name="emissive"))
    base = w.texture(w.image(extra_png, name="extra")) if extra_png is not None else nrm
    m0 = w.material(name="metal", pbrMetallicRoughness={"metallicRoughnessTexture": {"index": mr},
                                                         "baseColorTexture": {"index": base},
                                                         "roughnessFactor": 0.4},
                    normalTexture={"index": nrm})
    m1 = w.material(name="lamp", emissiveFactor=[1.0, 0.5, 0.25], emissiveTexture={"index": emi},
                    extensions={"KHR_materials_emissive_strength": {"emissiveStrength": 12.0}},
                    pbrMetallicRoughness={"baseColorFactor": [0.2, 0.3, 0.4, 1.0], "metallicFactor": 0.0,
                                          "metallicRoughnessTexture": {"index": mr}})
    m2 = w.material(extensions={"KHR_materials_transmission": {"transmissionFactor": 1.0},
                                "KHR_materials_ior": {"ior": 1.33}},
                    pbrMetallicRoughness={"metallicFactor": 0.0, "roughnessFactor": 0.05})
    # A grid quad: 4x3 vertices, 12 triangles.
    gx, gy = np.meshgrid(np.linspace(-1, 1, 4), np.linspace(0, 1, 3), indexing="ij")
    pos = np.stack([gx, gy, 0.1 * gx * gy], -1).reshape(-1, 3).astype(np.float32)
    nrm_v = np.tile([0.0, 0.0, 1.0], (len(pos), 1)).astype(np.float32)
    uv = np.stack([gx / 2 + 0.5, gy], -1).reshape(-1, 2).astype(np.float32)
    quads = [(i * 3 + j, (i + 1) * 3 + j, i * 3 + j + 1, (i + 1) * 3 + j + 1) for i in range(3) for j in range(2)]
    idx = np.array([[a, b, c, b, d, c] for a, b, c, d in quads]).reshape(-1)
    p_acc, n_acc, t_acc = w.interleaved(pos, nrm_v, uv)  # byteStride 36
    grid_u16 = {"attributes": {"POSITION": p_acc, "NORMAL": n_acc, "TEXCOORD_0": t_acc},
                "indices": w.accessor(idx, USHORT), "material": m0}
    grid_u8 = {"attributes": {"POSITION": w.accessor(pos)}, "indices": w.accessor(idx, UBYTE), "material": m1}
    grid_u32 = {"attributes": {"POSITION": w.accessor(pos), "TEXCOORD_0": w.accessor(uv)},
                "indices": w.accessor(idx, UINT), "material": m2}
    soup = {"attributes": {"POSITION": w.accessor(pos[idx[:9]] + 2.0)}}  # no indices, default material
    ma = w.mesh([grid_u16, grid_u8], name="two-prims")
    mb = w.mesh([grid_u32, soup], name="u32-and-soup")
    child = w.node(root=False, mesh=mb, name="child", translation=[0.5, 0.0, -1.0],
                   rotation=[0.0, 0.38268343, 0.0, 0.9238795], scale=[1.0, 2.0, 0.5])
    cam = w.camera(0.7, 1.5)
    cam_node = w.node(root=False, camera=cam, name="cam", translation=[0.0, 1.0, 5.0])
    w.node(mesh=ma, name="parent", matrix=[1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0.25, -0.5, 0.0, 1],
           children=[child, cam_node])
    w.node(mesh=ma, name="second", rotation=[0.0, 0.0, 0.70710677, 0.70710677], translation=[3.0, 0.0, 0.0])
    return w.save(path, layout)
