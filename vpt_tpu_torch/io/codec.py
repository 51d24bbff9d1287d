"""The C image codec (csrc/imgcodec.c): the PNG row unfilter, the JPEG
entropy decoders (Huffman, arithmetic and lossless), inverse DCT and block
smoothing, the TIFF LZW and PackBits
decoders and predictors, the GIF LZW decoder, the BMP, TGA, PCX and SGI RLE
decoders, PSD's PackBits, the QOI decoder, the Lab -> sRGB lookup and PIL's
"bit", Sun raster RLE, Windows Paint, X bitmap, FLI and PhotoCD decoders; the
WebP decoders (csrc/webpdec.c): VP8L, VP8 key frames and ALPH planes; the
DDS block decoders (csrc/bcndec.c): BC1-BC7; and the JPEG 2000 decoder
(csrc/j2kdec.c).
Each is built with gcc into vpt_tpu_torch/build/ at first use and called
through ctypes,
which releases the interpreter lock, so `load_gltf`'s thread pool decodes
images in parallel.  A failed build raises; there is no Python decoder to
fall back to.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import threading

import numpy as np

from vpt_tpu_torch.accel.kernels import BUILD_DIR, CSRC_DIR, host_library

_SRC = os.path.join(CSRC_DIR, "imgcodec.c")
_LIB = os.path.join(BUILD_DIR, "libvpt_imgcodec.so")
_CMD = ("gcc", "-O3", "-shared", "-fPIC")
_lib = None
_lock = threading.Lock()

# The JPEG scan decoders' error codes.
JPEG_ERRORS = {
    -1: "truncated (the data ends inside a scan)",
    -3: "corrupt (a Huffman table that is no prefix code)",
    -6: "corrupt (bad scan parameters)",
    -7: "refused as PIL refuses it: an arithmetic-coded scan runs past a 65536-byte block of the file, and "
        "PIL hands libjpeg the file a block at a time while libjpeg's arithmetic decoder cannot wait for the next",
}
PIL_BLOCK = 65536  # the bytes PIL's ImageFile.load hands its decoder at a time (ImageFile.MAXBLOCK)
HUFF_WORDS = 16 + 256  # a Huffman table: counts of codes of length 1..16, then the symbols


def library():
    """The codec, built with gcc on first use (rebuilt when the source is newer)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(host_library(_SRC, _LIB, _CMD, "the image codec"))
            p = ctypes.c_void_p
            lib.vpt_png_unfilter.restype = ctypes.c_int
            lib.vpt_png_unfilter.argtypes = [p, p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
            lib.vpt_jpeg_scan.restype = ctypes.c_int64
            lib.vpt_jpeg_scan.argtypes = [p, ctypes.c_int64, ctypes.c_int, p, p, p, p] + [ctypes.c_int] * 8 + [p]
            lib.vpt_jpeg_arith_scan.restype = ctypes.c_int64
            lib.vpt_jpeg_arith_scan.argtypes = [p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, p, p, p, p] + \
                [ctypes.c_int] * 8 + [p]
            lib.vpt_jpeg_lossless_scan.restype = ctypes.c_int64
            lib.vpt_jpeg_lossless_scan.argtypes = [p, ctypes.c_int64, ctypes.c_int, p, p, p] + [ctypes.c_int] * 5
            lib.vpt_jpeg_qe_table.restype = ctypes.POINTER(ctypes.c_uint32)
            lib.vpt_jpeg_qe_table.argtypes = []
            lib.vpt_jpeg_idct.restype = None
            lib.vpt_jpeg_idct.argtypes = [p, ctypes.c_int64, ctypes.c_int64, p, p]
            i64 = ctypes.c_int64
            lib.vpt_jpeg_smooth.restype = None
            lib.vpt_jpeg_smooth.argtypes = [p, p, i64, i64, i64, ctypes.c_int, i64, p, p, p, i64]
            for name in ("vpt_tiff_lzw", "vpt_packbits"):
                getattr(lib, name).restype = i64
                getattr(lib, name).argtypes = [p, i64, p, i64]
            lib.vpt_tiff_unpredict.restype = None
            lib.vpt_tiff_unpredict.argtypes = [p, i64, i64, i64, ctypes.c_int]
            lib.vpt_tiff_unpredict_float.restype = None
            lib.vpt_tiff_unpredict_float.argtypes = [p, p, i64, i64, i64, ctypes.c_int]
            lib.vpt_gif_lzw.restype = ctypes.c_int
            lib.vpt_gif_lzw.argtypes = [p, i64, ctypes.c_int, p, i64, i64, ctypes.c_int]
            lib.vpt_bmp_rle.restype = i64
            lib.vpt_bmp_rle.argtypes = [p, i64, i64, i64, i64, ctypes.c_int, p, i64]
            lib.vpt_tga_rle.restype = i64
            lib.vpt_tga_rle.argtypes = [p, i64, ctypes.c_int, i64, i64, p, p]
            lib.vpt_pcx_rle.restype = i64
            lib.vpt_pcx_rle.argtypes = [p, i64, i64, i64, ctypes.c_int, i64, p, p]
            lib.vpt_packbits_rows.restype = i64
            lib.vpt_packbits_rows.argtypes = [p, i64, i64, i64, p, p]
            lib.vpt_sgi_rle.restype = i64
            lib.vpt_sgi_rle.argtypes = [p, i64, p, p, ctypes.c_int, i64, i64, ctypes.c_int, p, p]
            lib.vpt_qoi_decode.restype = ctypes.c_int
            lib.vpt_qoi_decode.argtypes = [p, i64, i64, ctypes.c_int, p]
            lib.vpt_lab_to_rgb.restype = None
            lib.vpt_lab_to_rgb.argtypes = [p, i64, p, p]
            lib.vpt_rgbe_cv.restype = ctypes.c_int
            lib.vpt_rgbe_cv.argtypes = [p, i64, i64, i64, p]
            lib.vpt_bit_decode.restype = ctypes.c_int
            lib.vpt_bit_decode.argtypes = [p, i64, p, i64, i64, ctypes.c_int]
            for name in ("vpt_sun_rle", "vpt_xbm_hex"):
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = [p, i64, i64, i64, p]
            lib.vpt_msp_rle.restype = ctypes.c_int
            lib.vpt_msp_rle.argtypes = [p, i64, i64, i64, p, i64, p]
            lib.vpt_pcd_planes.restype = ctypes.c_int
            lib.vpt_pcd_planes.argtypes = [p, i64, i64, i64, p]
            lib.vpt_fli_decode.restype = i64
            lib.vpt_packbits_libtiff.restype = i64
            lib.vpt_packbits_libtiff.argtypes = [p, i64, p, i64]
            lib.vpt_blp_dxt.restype = None
            lib.vpt_blp_dxt.argtypes = [p, i64, i64, ctypes.c_int, ctypes.c_int, p]
            lib.vpt_fli_decode.argtypes = [p, i64, p, i64, i64, p]
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


# PIL's decompression-bomb limit: Image.open refuses an image of more than
# twice Image.MAX_IMAGE_PIXELS pixels.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def check_size(w: int, h: int, name: str) -> None:
    """Refuse an image larger than PIL opens, before anything is allocated."""
    if w * h > MAX_PIXELS:
        raise ValueError(f"{name}: image of {w}x{h} pixels is larger than PIL opens ({MAX_PIXELS} pixels)")


CV_MAX_SIDE, CV_MAX_PIXELS = 1 << 20, 1 << 30  # OpenCV's CV_IO_MAX_IMAGE_WIDTH / HEIGHT and _PIXELS


def check_cv_size(w: int, h: int, name: str) -> None:
    """OpenCV's validateInputImageSize, which `imreadmulti` applies to every
    header it reads."""
    if not (0 < w <= CV_MAX_SIDE and 0 < h <= CV_MAX_SIDE and w * h <= CV_MAX_PIXELS):
        raise ValueError(f"{name}: an image of {w}x{h} pixels is larger than OpenCV reads (validateInputImageSize)")


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 scanlines from h * (1 + stride) filtered bytes (PNG
    filters 0-4; bpp bytes per complete pixel: 1, 2, 3, 4, 6 or 8, and 1
    for samples under 8 bits)."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < h * (1 + stride):
        raise ValueError(f"PNG image data is short: {raw.size} bytes for {h} rows of {1 + stride}")
    out = np.empty((h, stride), np.uint8)
    rc = library().vpt_png_unfilter(_ptr(raw), _ptr(out), h, stride, bpp)
    if rc == -(h + 1):
        raise ValueError(f"PNG unfilter: {bpp} bytes per pixel, rows of {stride} bytes")
    if rc:
        raise ValueError(f"unknown PNG row filter {int(raw[(-rc - 1) * (1 + stride)])} in row {-rc - 1}")
    return out


def _coef_pointers(coefs: list):
    for c in coefs:
        if c.dtype != np.int16 or not c.flags.c_contiguous:
            raise ValueError("coefficient arrays must be C-contiguous int16")
    return (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])


def jpeg_scan(data: np.ndarray, coefs: list, geom: np.ndarray, dc: np.ndarray, ac: np.ndarray, mcux: int, mcuy: int,
              ss: int, se: int, ah: int, al: int, progressive: bool, restart: int) -> tuple:
    """Decode one Huffman-coded scan whose entropy-coded data begins at
    data[0] into the scan's components' int16 coefficient arrays `coefs`
    (each (rows, geom bw, 64), C-contiguous).  geom: int32 (n, 5), per
    component h, v, bw, nbx, nby; dc, ac: int32 (n, HUFF_WORDS).  Returns
    (the offset of the marker after the scan, data.size if none; the iMCU
    row of the last MCU begun before the data ran dry, or -1); a code of
    JPEG_ERRORS raises a ValueError."""
    ptrs = _coef_pointers(coefs)
    geom, dc, ac = (np.ascontiguousarray(a, np.int32) for a in (geom, dc, ac))
    last_good = ctypes.c_int64(-1)
    ret = library().vpt_jpeg_scan(_ptr(data), data.size, len(coefs), ctypes.addressof(ptrs), _ptr(geom), _ptr(dc),
                                  _ptr(ac), mcux, mcuy, ss, se, ah, al, int(progressive), restart,
                                  ctypes.byref(last_good))
    if ret < 0:
        raise ValueError(JPEG_ERRORS.get(ret, f"error {ret}"))
    return int(ret), last_good.value


def jpeg_arith_scan(data: np.ndarray, limit: int, coefs: list, geom: np.ndarray, tables: np.ndarray,
                    conditioning: np.ndarray, mcux: int, mcuy: int, ss: int, se: int, ah: int, al: int,
                    progressive: bool, restart: int) -> tuple:
    """Decode one arithmetic-coded scan whose data begins at data[0] into
    `coefs` as jpeg_scan does; the decoder may fetch only data[:limit].
    tables: int32 (n, 2), per component its DC and AC statistics table;
    conditioning: int32 (48,), the DAC values L, U and K of tables 0-15.
    Returns what jpeg_scan returns."""
    ptrs = _coef_pointers(coefs)
    geom, tables, conditioning = (np.ascontiguousarray(a, np.int32) for a in (geom, tables, conditioning))
    last_good = ctypes.c_int64(-1)
    ret = library().vpt_jpeg_arith_scan(_ptr(data), data.size, limit, len(coefs), ctypes.addressof(ptrs), _ptr(geom),
                                        _ptr(tables), _ptr(conditioning), mcux, mcuy, ss, se, ah, al,
                                        int(progressive), restart, ctypes.byref(last_good))
    if ret < 0:
        raise ValueError(JPEG_ERRORS.get(ret, f"error {ret}"))
    return int(ret), last_good.value


def jpeg_lossless_scan(data: np.ndarray, planes: list, geom: np.ndarray, tables: np.ndarray, mcux: int,
                       imcu_rows: int, psv: int, pt: int, restart: int) -> int:
    """Decode one lossless Huffman-coded scan whose data begins at data[0]
    into the scan's components' uint16 (dh, dw) planes (C-contiguous; the
    samples before the point transform's shift).  geom: int32 (n, 4), per
    component h, v, dw, dh; tables: int32 (n, HUFF_WORDS) DC tables.
    Returns the offset of the marker after the scan (data.size if none)."""
    for p in planes:
        if p.dtype != np.uint16 or not p.flags.c_contiguous:
            raise ValueError("sample planes must be C-contiguous uint16")
    ptrs = (ctypes.c_void_p * len(planes))(*[_ptr(p) for p in planes])
    geom, tables = (np.ascontiguousarray(a, np.int32) for a in (geom, tables))
    ret = library().vpt_jpeg_lossless_scan(_ptr(data), data.size, len(planes), ctypes.addressof(ptrs), _ptr(geom),
                                           _ptr(tables), mcux, imcu_rows, psv, pt, restart)
    if ret < 0:
        raise ValueError(JPEG_ERRORS.get(ret, f"error {ret}"))
    return int(ret)


def qe_table() -> np.ndarray:
    """The C codec's copy of T.81 Table D.2 and the fixed 1/2 state: 114
    uint32, each Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
    Next_Index_LPS."""
    return np.ctypeslib.as_array(library().vpt_jpeg_qe_table(), (114,)).copy()


def jpeg_idct(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantise (qt: 64 values in natural order) and inverse-transform
    (nby, nbx, 64) int16 coefficients into a (nby * 8, nbx * 8) uint8 plane."""
    coefs = np.ascontiguousarray(coefs, np.int16)
    qt = np.ascontiguousarray(qt, np.int32)
    nby, nbx = coefs.shape[:2]
    plane = np.empty((nby * 8, nbx * 8), np.uint8)
    library().vpt_jpeg_idct(_ptr(coefs), nby, nbx, _ptr(qt), _ptr(plane))
    return plane


def jpeg_smooth(coefs: np.ndarray, nbx: int, nby: int, v: int, rows: int, qt: np.ndarray, bits: np.ndarray,
                prev_bits: np.ndarray, last_good: int) -> np.ndarray:
    """libjpeg-turbo's block smoothing of one progressive component: its
    MCU-padded (bh, bw, 64) int16 coefficients to the (nby, nbx, 64) blocks
    the IDCT takes (v: its vertical sampling factor; rows: the frame's iMCU
    rows; bits: the successive-approximation bit of coefficients 0..9, -1
    where never coded; prev_bits: the same before the component's last scan,
    used for the iMCU rows after last_good, the last the last scan decoded
    before its data ran dry)."""
    coefs = np.ascontiguousarray(coefs, np.int16)
    if coefs.ndim != 3 or coefs.shape[2] != 64 or nbx > coefs.shape[1] or nby > coefs.shape[0] or \
            coefs.shape[0] < rows * v or qt.size != 64 or bits.size != 10 or prev_bits.size != 10:
        raise ValueError("jpeg_smooth: the coefficients do not hold the component's blocks")
    out = np.empty((nby, nbx, 64), np.int16)
    qt, bits, prev_bits = (np.ascontiguousarray(a, np.int32) for a in (qt, bits, prev_bits))
    library().vpt_jpeg_smooth(_ptr(coefs), _ptr(out), coefs.shape[1], nbx, nby, v, rows, _ptr(qt), _ptr(bits),
                              _ptr(prev_bits), last_good)
    return out


_WEBP_SRC = os.path.join(CSRC_DIR, "webpdec.c")
_WEBP_LIB = os.path.join(BUILD_DIR, "libvpt_webpdec.so")
_webp_lib = None

# The WebP decoders' error codes (csrc/webpdec.c).
WEBP_ERRORS = {
    -1: "bad VP8L header",
    -2: "corrupt VP8L data (libwebp refuses the lossless stream)",
    -3: "out of memory",
    -4: "bad ALPH header",
    -5: "ALPH data shorter than the image",
    -10: "bad VP8 frame header",
    -11: "VP8 frame is no key frame",
    -12: "VP8 frame is not shown",
    -13: "bad VP8 start code",
    -14: "VP8 first partition is truncated or corrupt",
    -15: "VP8 token partitions are truncated",
    -16: "VP8 modes end early (premature end of partition 0)",
    -17: "VP8 coefficients end early (premature end of file)",
    -18: "out of memory",
    -19: "VP8 frame size differs from its header's",
}


def webp_library():
    """The WebP decoders (csrc/webpdec.c), built with gcc on first use
    (rebuilt when the source is newer)."""
    global _webp_lib
    with _lock:
        if _webp_lib is None:
            lib = ctypes.CDLL(host_library(_WEBP_SRC, _WEBP_LIB, _CMD, "the WebP decoders"))
            p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            for name in ("vpt_vp8l_decode", "vpt_vp8_decode"):
                getattr(lib, name).restype = i
                getattr(lib, name).argtypes = [p, i64, i, i, p, i64]
            lib.vpt_webp_alpha.restype = i
            lib.vpt_webp_alpha.argtypes = [p, i64, i, i, p]
            _webp_lib = lib
    return _webp_lib


def _webp_check(rc: int) -> None:
    if rc:
        raise ValueError(WEBP_ERRORS.get(rc, f"WebP decoder error {rc}"))


def _rgba_target(out: np.ndarray, width: int, height: int) -> int:
    if out.dtype != np.uint8 or out.shape != (height, width, 4) or out.strides[1:] != (4, 1):
        raise ValueError(f"the output must be ({height}, {width}, 4) uint8 rows of packed pixels")
    return out.strides[0]


def vp8l_decode(payload, width: int, height: int, out: np.ndarray) -> None:
    """A VP8L chunk's payload (the padding byte included) of a width x height
    image into `out`, (height, width, 4) uint8 RGBA (a view with packed
    pixels, rows at any stride)."""
    src = _bytes(payload)
    stride = _rgba_target(out, width, height)
    _webp_check(webp_library().vpt_vp8l_decode(_ptr(src), src.size, width, height, _ptr(out), stride))


def vp8_decode(payload, width: int, height: int, out: np.ndarray) -> None:
    """A VP8 key frame (its chunk's payload, the padding byte included) into
    `out` as vp8l_decode does, alpha 255."""
    src = _bytes(payload)
    stride = _rgba_target(out, width, height)
    _webp_check(webp_library().vpt_vp8_decode(_ptr(src), src.size, width, height, _ptr(out), stride))


def webp_alpha(payload, width: int, height: int) -> np.ndarray:
    """An ALPH chunk's payload (unpadded) as the (height, width) uint8 alpha plane."""
    src = _bytes(payload)
    out = np.empty((height, width), np.uint8)
    _webp_check(webp_library().vpt_webp_alpha(_ptr(src), src.size, width, height, _ptr(out)))
    return out


def _bytes(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else \
        np.ascontiguousarray(data, np.uint8)


def tiff_lzw(data, size: int, count: bool = False, partial: bool = False):
    """A TIFF LZW strip as imageio's tifffile decodes it: its first `size`
    bytes (fewer if it decodes to fewer), or with `count` the length of all
    of it.  A strip that does not begin with CLEAR, or holds a code that no
    table entry can be, raises a ValueError; with `partial`, (the first
    `size` bytes, whether no such code stopped the decode): the bytes
    decoded before that code (libtiff's LZWDecode stops there, "Using code
    not yet in table")."""
    src = _bytes(data)
    out = np.empty(max(size, 1), np.uint8)
    n = library().vpt_tiff_lzw(_ptr(src), src.size, _ptr(out), size)
    if n == -1:
        raise ValueError("LZW strip does not begin with a CLEAR code")
    if n < 0:
        if not partial:
            raise ValueError("LZW strip holds a code past its table")
        return out[: min(-2 - n, size)], False
    if partial:
        return out[: min(n, size)], True
    return int(n) if count else out[: min(n, size)]


def packbits(data, size: int, count: bool = False):
    """A PackBits run's first `size` decoded bytes (fewer if it decodes to
    fewer), or with `count` the length of all of it."""
    src = _bytes(data)
    out = np.empty(max(size, 1), np.uint8)
    n = library().vpt_packbits(_ptr(src), src.size, _ptr(out), size)
    return int(n) if count else out[: min(n, size)]


def tiff_unpredict(samples: np.ndarray, stride: int) -> None:
    """Undo TIFF's horizontal predictor in place on (rows, count) native
    unsigned or signed integer samples (stride: samples per pixel)."""
    if not samples.flags.c_contiguous or samples.dtype.itemsize not in (1, 2, 4, 8) or samples.ndim != 2 or stride < 1:
        raise ValueError("the predictor needs C-contiguous (rows, count) 8-64-bit samples and a stride of 1 or more")
    rows, count = samples.shape
    library().vpt_tiff_unpredict(_ptr(samples), rows, count, stride, samples.dtype.itemsize)


def tiff_unpredict_float(raw: np.ndarray, rows: int, count: int, stride: int, size: int) -> np.ndarray:
    """Undo TIFF's floating-point predictor: rows x (count samples of `size`
    bytes, as byte planes with byte differences at `stride`) to the samples'
    native bytes, (rows, count * size) uint8."""
    if size not in (2, 4, 8) or stride < 1:
        raise ValueError(f"the floating-point predictor takes 2-, 4- or 8-byte samples, not {size}")
    raw = np.array(raw, np.uint8).reshape(rows, count * size)
    out = np.empty_like(raw)
    library().vpt_tiff_unpredict_float(_ptr(raw), _ptr(out), rows, count, stride, size)
    return out


def gif_lzw(data: bytes, bits: int, w: int, h: int, interlace: bool) -> tuple:
    """A GIF frame's LZW data (its sub-blocks joined) as PIL decodes it:
    ((h, w) uint8 indices, status) with status 0 when the frame filled, 1 when
    EOI came first, 2 when the data ended first (indices past that point 0).
    A corrupt code raises a ValueError."""
    src = _bytes(data)
    out = np.zeros((h, w), np.uint8)
    rc = library().vpt_gif_lzw(_ptr(src), src.size, bits, _ptr(out), w, h, int(interlace))
    if rc == -2:
        raise ValueError(f"bad LZW code size {bits}")
    if rc < 0:
        raise ValueError("corrupt LZW data (a code past its table)")
    return out, rc


def bmp_rle(data, start: int, w: int, h: int, rle4: bool) -> np.ndarray:
    """BMP RLE8 / RLE4 data (starting at file offset `start`) as PIL's decoder
    gives it: up to w * h indices, one per byte.  A delta cut off inside its
    second pair raises a ValueError."""
    src = _bytes(data)
    out = np.empty(max(w * h, 1), np.uint8)
    n = library().vpt_bmp_rle(_ptr(src), src.size, start, w, h, int(rle4), _ptr(out), w * h)
    if n < 0:
        raise ValueError("RLE data ends inside a delta")
    return out[: min(n, w * h)]


RGBE_ERRORS = {-1: "RGBE read error (the data ends early)", -2: "RGBE bad file format: wrong scanline width",
               -3: "RGBE bad file format: bad scanline data"}


def rgbe_cv(data, w: int, h: int) -> np.ndarray:
    """A Radiance picture's pixels as OpenCV's rgbe.cpp reads them: (h, w, 4)
    RGBE bytes.  A ValueError with OpenCV's message where it fails."""
    src = _bytes(data)
    out = np.empty((h, w, 4), np.uint8)
    rc = library().vpt_rgbe_cv(_ptr(src), src.size, w, h, _ptr(out))
    if rc:
        raise ValueError(RGBE_ERRORS[rc])
    return out


def _rows_status(fn, data, rows: int, row_bytes: int, *args) -> tuple:
    src = _bytes(data)
    out = np.zeros((rows, row_bytes), np.uint8)
    status = ctypes.c_int(0)
    fn(_ptr(src), src.size, *args, _ptr(out), ctypes.byref(status))
    return out, status.value


def tga_rle(data, depth: int, row_bytes: int, rows: int) -> tuple:
    """A TGA RLE stream as PIL's decoder reads it: ((rows, row_bytes) uint8
    scanlines in stream order, status): 0 when all were decoded, 1 when the
    data ends first, -1 for a run packet across the end of a scanline."""
    return _rows_status(lambda src, n, out, st: library().vpt_tga_rle(src, n, depth, row_bytes, rows, out, st),
                        data, rows, row_bytes)


def pcx_rle(data, row_bytes: int, xsize: int, bits: int, rows: int) -> tuple:
    """A PCX RLE stream as PIL's decoder reads it (its planes moved together
    where the scanline is padded; bits: the unpacker's bits per pixel):
    ((rows, row_bytes) uint8, status): 0, 1 (the data ends first) or -1 (a
    run past the end of a scanline)."""
    return _rows_status(lambda src, n, out, st: library().vpt_pcx_rle(src, n, row_bytes, xsize, bits, rows, out, st),
                        data, rows, row_bytes)


def packbits_rows(data, row_bytes: int, rows: int) -> tuple:
    """PackBits scanlines as PIL's decoder reads a PSD channel (a packet cut
    at the end of its scanline): ((rows, row_bytes) uint8, status): 0, or 1
    when the data ends first."""
    return _rows_status(lambda src, n, out, st: library().vpt_packbits_rows(src, n, row_bytes, rows, out, st),
                        data, rows, row_bytes)


def sgi_rle(data, start: np.ndarray, length: np.ndarray, bands: int, xsize: int, ysize: int, bpc: int) -> tuple:
    """An RLE SGI image's scanlines (data: the file after its 512-byte
    header; start, length: its offset and length tables) as PIL's decoder
    reads them: ((ysize, xsize * bands * bpc) uint8 rows in file order, the
    number of rows decoded; the rest are zero).  A row that reaches outside
    the data raises a ValueError."""
    src = _bytes(data)
    start, length = (np.ascontiguousarray(a, np.uint32) for a in (start, length))
    out = np.zeros((ysize, xsize * bands * bpc), np.uint8)
    line = np.zeros(xsize * bands * bpc, np.uint8)
    rows = library().vpt_sgi_rle(_ptr(src), src.size, _ptr(start), _ptr(length), bands, xsize, ysize, bpc,
                                 _ptr(line), _ptr(out))
    if rows < 0:
        raise ValueError("SGI RLE data runs past its row or the file (image buffer overrun)")
    return out, int(rows)


def qoi_decode(data, pixels: int, channels: int) -> np.ndarray:
    """A QOI stream's first `pixels` pixels, (pixels, channels) uint8, as
    PIL's decoder reads them.  Data that ends first raises a ValueError."""
    src = _bytes(data)
    out = np.empty((pixels, channels), np.uint8)
    if library().vpt_qoi_decode(_ptr(src), src.size, pixels, channels, _ptr(out)):
        raise ValueError("QOI data ends before the last pixel (image file is truncated)")
    return out


def bit_decode(data, out: np.ndarray, bits: int) -> int:
    """PIL's "bit" decoder (ImImagePlugin's fill 3, pad 8) of data into the
    (h, w) float32 `out`, rows bottom-up: 0, or -1 when the data ends
    first."""
    src = _bytes(data)
    h, w = out.shape
    return library().vpt_bit_decode(_ptr(src), src.size, _ptr(out), w, h, bits)


def _lines(fn, data, row_bytes: int, rows: int, what: str) -> np.ndarray:
    src = _bytes(data)
    out = np.zeros((rows, row_bytes), np.uint8)
    if getattr(library(), fn)(_ptr(src), src.size, row_bytes, rows, _ptr(out)):
        raise ValueError(f"{what} data ends before the last scanline (PIL: image file is truncated)")
    return out


def sun_rle(data, row_bytes: int, rows: int) -> np.ndarray:
    """A Sun raster RLE stream as PIL's decoder reads it: (rows, row_bytes)
    uint8 scanlines (runs go on across them).  Data that ends first raises a
    ValueError."""
    return _lines("vpt_sun_rle", data, row_bytes, rows, "Sun raster RLE")


def xbm_hex(data, row_bytes: int, rows: int) -> np.ndarray:
    """An X bitmap's hex values as PIL's decoder reads them: (rows,
    row_bytes) uint8.  Data that ends first raises a ValueError."""
    return _lines("vpt_xbm_hex", data, row_bytes, rows, "XBM")


def msp_rle(data, h: int, blank: int, cap: int) -> tuple:
    """A Windows Paint v2 file's rows (data: the whole file) as PIL's
    MspDecoder writes them: (the first `cap` bytes, how many it wrote).  A
    file shorter than its row map or a row, or a run its row cuts, raises a
    ValueError."""
    src = _bytes(data)
    out = np.zeros(max(cap, 1), np.uint8)
    made = ctypes.c_int64(0)
    rc = library().vpt_msp_rle(_ptr(src), src.size, h, blank, _ptr(out), cap, ctypes.byref(made))
    if rc == -1:
        raise ValueError("truncated MSP file (PIL)")
    if rc:
        raise ValueError("corrupted MSP file: a run cut by its row's end (PIL)")
    return out[:cap], made.value


def pcd_planes(data, w: int, rows: int) -> np.ndarray:
    """A PhotoCD base image's planes as PIL's decoder reads them: (rows, w,
    3) Y, C1, C2.  Data that ends first raises a ValueError."""
    src = _bytes(data)
    out = np.zeros((rows, w, 3), np.uint8)
    if library().vpt_pcd_planes(_ptr(src), src.size, w, rows, _ptr(out)):
        raise ValueError("PhotoCD image data ends early (PIL: image file is truncated)")
    return out


def fli_decode(data, img: np.ndarray) -> tuple:
    """One call of PIL's FLI decoder on the bytes gathered so far, applied to
    the (h, w) uint8 `img`: (bytes consumed or -1, PIL's error code)."""
    src = _bytes(data)
    err = ctypes.c_int(0)
    h, w = img.shape
    n = library().vpt_fli_decode(_ptr(src), src.size, _ptr(img), w, h, ctypes.byref(err))
    return n, err.value


def packbits_libtiff(data, size: int) -> np.ndarray:
    """A PackBits strip as libtiff's decoder writes it into a buffer of
    `size` bytes: the bytes written (fewer where the data runs short)."""
    src = _bytes(data)
    out = np.zeros(max(size, 1), np.uint8)
    n = library().vpt_packbits_libtiff(_ptr(src), src.size, _ptr(out), size)
    return out[:n]


def blp_dxt(data, rows: int, blocks: int, kind: int, channels: int) -> bytes:
    """BLP2 DXT block rows (kind 1, 3 or 5) as PIL's Python decoders give
    them: per block row, its four pixel rows of 4 * blocks pixels of
    `channels` bytes."""
    src = _bytes(data)
    size = 8 if kind == 1 else 16
    if src.size < rows * blocks * size:
        raise ValueError("BLP DXT data ends before the last block")
    out = np.empty(rows * 4 * blocks * 4 * channels, np.uint8)
    library().vpt_blp_dxt(_ptr(src), rows, blocks, kind, channels, _ptr(out))
    return out.tobytes()


_BCN_SRC = os.path.join(CSRC_DIR, "bcndec.c")
def lab_to_rgb(lab: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 PIL Lab samples to sRGB through LittleCMS's
    tetrahedral interpolation of `grid` (io/lab.py: (33**3, 3) nodes)."""
    src = np.ascontiguousarray(lab, np.uint8)
    nodes = np.ascontiguousarray(grid, np.uint16)
    out = np.empty(src.shape, np.uint8)
    library().vpt_lab_to_rgb(_ptr(src), src.size // 3, _ptr(nodes), _ptr(out))
    return out


_BCN_LIB = os.path.join(BUILD_DIR, "libvpt_bcndec.so")
_bcn_lib = None


def bcn_library():
    """The DDS block decoders (csrc/bcndec.c), built with gcc on first use
    (rebuilt when the source is newer)."""
    global _bcn_lib
    with _lock:
        if _bcn_lib is None:
            lib = ctypes.CDLL(host_library(_BCN_SRC, _BCN_LIB, _CMD, "the DDS block decoders"))
            i64 = ctypes.c_int64
            lib.vpt_bcn_decode.restype = ctypes.c_int
            lib.vpt_bcn_decode.argtypes = [ctypes.c_void_p, i64, i64, i64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            _bcn_lib = lib
    return _bcn_lib


def bcn_decode(data, width: int, height: int, kind: int, sign: bool = False) -> np.ndarray:
    """BCn blocks (kind 1-7: BC1-BC7; sign: BC5's or BC6H's signed form) of a
    width x height surface as PIL decodes them: (height, width) uint8 for
    BC4, else (height, width, 4) RGBA.  Data that ends before the last block
    raises a ValueError."""
    src = _bytes(data)
    out = np.zeros((height, width) if kind == 4 else (height, width, 4), np.uint8)
    rc = bcn_library().vpt_bcn_decode(_ptr(src), src.size, width, height, kind, int(sign), _ptr(out))
    if rc:
        raise ValueError("DDS data ends before the last block (image file is truncated)" if rc > 0 else
                         f"unknown BCn kind {kind}")
    return out


_J2K_SRC = os.path.join(CSRC_DIR, "j2kdec.c")
_J2K_LIB = os.path.join(BUILD_DIR, "libvpt_j2kdec.so")
# OpenJPEG's 9/7 wavelet, ICT and dequantiser are float32 operation by
# operation: no contraction into fused multiply-adds.
_J2K_CMD = ("gcc", "-O3", "-shared", "-fPIC", "-ffp-contract=off")
_j2k_lib = None


def j2k_library():
    """The JPEG 2000 decoder (csrc/j2kdec.c), built with gcc on first use
    (rebuilt when the source is newer)."""
    global _j2k_lib
    with _lock:
        if _j2k_lib is None:
            lib = ctypes.CDLL(host_library(_J2K_SRC, _J2K_LIB, _J2K_CMD, "the JPEG 2000 decoder"))
            p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
            lib.vpt_j2k_open.restype = p
            lib.vpt_j2k_open.argtypes = [p, i64, u32, u32, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, i64]
            lib.vpt_j2k_close.restype = None
            lib.vpt_j2k_close.argtypes = [p]
            lib.vpt_j2k_info.restype = ctypes.c_int
            lib.vpt_j2k_info.argtypes = [p, p, i64]
            lib.vpt_j2k_decode.restype = ctypes.c_int
            lib.vpt_j2k_decode.argtypes = [p, ctypes.c_int, p, i64, i64, i64, p, ctypes.c_char_p, i64]
            lib.vpt_j2k_position.restype = i64
            lib.vpt_j2k_position.argtypes = [p]
            _j2k_lib = lib
    return _j2k_lib


class J2kCodestream:
    """A JPEG 2000 codestream after OpenJPEG's main-header read: `image` is
    (x0, y0, x1, y1, components), `comps` a (prec, sgnd, dx, dy) row per
    component.  `ihdr`: a JP2 file's image-header width and height, which
    the codestream's must equal (0, 0 for a raw codestream).  A header that
    OpenJPEG refuses raises a ValueError."""

    def __init__(self, data, ihdr=(0, 0)):
        self._src = _bytes(data)
        self._lib = j2k_library()
        rc, err = ctypes.c_int(0), ctypes.create_string_buffer(256)
        self._h = self._lib.vpt_j2k_open(_ptr(self._src), self._src.size, ihdr[0], ihdr[1], ctypes.byref(rc), err, 256)
        if not self._h:
            raise MemoryError("JPEG 2000 decoder: out of memory")
        if rc.value:
            self.close()
            raise ValueError(f"OpenJPEG refuses the codestream: {err.value.decode(errors='replace')}")
        info = np.zeros(5 + 4 * 16384, np.int64)
        self._lib.vpt_j2k_info(self._h, _ptr(info), info.size)
        self.image = tuple(int(v) for v in info[:5])
        self.comps = info[5 : 5 + 4 * self.image[4]].reshape(-1, 4)

    def decode(self, kind: int, out: np.ndarray, xsize: int, ysize: int, ycc: np.ndarray) -> int:
        """Decode every tile into `out` (PIL's image rows) through PIL's
        unpacker `kind`; returns the stream position after the codestream."""
        err = ctypes.create_string_buffer(256)
        rc = self._lib.vpt_j2k_decode(self._h, kind, _ptr(out), out.strides[0], xsize, ysize, _ptr(ycc), err, 256)
        if rc:
            raise ValueError(f"OpenJPEG fails to decode the codestream: {err.value.decode(errors='replace')}")
        return int(self._lib.vpt_j2k_position(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.vpt_j2k_close(self._h)
            self._h = None


_AV1_SRC = os.path.join(CSRC_DIR, "av1dec.c")  # its tables: csrc/av1dec_cdf.h
_AV1_LIB = os.path.join(BUILD_DIR, "libvpt_av1dec.so")
_av1_lib = None
AV1_ERRORS = {
    -1: "AV1 tile data is corrupt (a vertical partition in a 4:2:2 frame, which dav1d refuses)",
    -2: "out of memory",
    -3: "AV1 frame parameters outside what the decoder takes",
    -4: "AV1 tile is empty",
    -5: "AV1 tile data is corrupt (its symbol decoder reads more than 14 bits past the tile's end)",
    -6: ("AV1 tile data outside the specification: a transform's intermediate values leave 16 bits, which no "
         "conforming stream's do, and dav1d then saturates them at points of its own SIMD code (ROADMAP "
         "\"Known, kept\")"),
}


def av1_library():
    """The AV1 key-frame decoder and libavif's YUV -> RGB conversion
    (csrc/av1dec.c), built with gcc on first use (rebuilt when the source is
    newer)."""
    global _av1_lib
    with _lock:
        if _av1_lib is None:
            lib = ctypes.CDLL(host_library(_AV1_SRC, _AV1_LIB, _CMD, "the AV1 decoder"))
            p = ctypes.c_void_p
            lib.vpt_av1_decode.restype = ctypes.c_int
            lib.vpt_av1_decode.argtypes = [p, p, p, ctypes.c_int, p, p, p]
            lib.vpt_avif_rgb.restype = ctypes.c_int
            lib.vpt_avif_rgb.argtypes = [p, p, p, p, p, p]
            _av1_lib = lib
    return _av1_lib


def av1_check(rc: int, name: str) -> None:
    if rc:
        raise ValueError(f"{name}: {AV1_ERRORS.get(rc, f'AV1 decoder error {rc}')}")


def build_all() -> None:
    """Build every host codec of this module at once, one gcc process each,
    where its library is missing or older than its source; each loads when
    first used, as before."""
    builds = ((_SRC, _LIB, _CMD, "the image codec"), (_WEBP_SRC, _WEBP_LIB, _CMD, "the WebP decoders"),
              (_BCN_SRC, _BCN_LIB, _CMD, "the DDS block decoders"),
              (_J2K_SRC, _J2K_LIB, _J2K_CMD, "the JPEG 2000 decoder"), (_AV1_SRC, _AV1_LIB, _CMD, "the AV1 decoder"))
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for done in [pool.submit(host_library, *b) for b in builds]:
            done.result()
