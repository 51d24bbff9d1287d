"""The C image codec (csrc/imgcodec.c): the PNG row unfilter and the JPEG
entropy decoder and inverse DCT, built with gcc into vpt_tpu_torch/build/
at first use and called through ctypes, which releases the interpreter
lock, so `load_gltf`'s thread pool decodes images in parallel.  A failed
build raises; there is no Python decoder to fall back to.
"""

from __future__ import annotations

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

# vpt_jpeg_scan's error codes.
JPEG_ERRORS = {
    -1: "truncated (the data ends inside a scan)",
    -2: "corrupt (a bit string that is no Huffman code)",
    -3: "corrupt (a Huffman table that is no prefix code)",
    -4: "corrupt (a restart marker missing or out of place)",
    -5: "corrupt (a scan's data ends before its last block)",
    -6: "corrupt (bad scan parameters)",
}
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
            lib.vpt_jpeg_scan.argtypes = [p, ctypes.c_int64, ctypes.c_int, p, p, p, p] + [ctypes.c_int] * 8
            lib.vpt_jpeg_idct.restype = None
            lib.vpt_jpeg_idct.argtypes = [p, ctypes.c_int64, ctypes.c_int64, p, p]
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray) -> int:
    return arr.ctypes.data


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


def jpeg_scan(data: np.ndarray, coefs: list, geom: np.ndarray, dc: np.ndarray, ac: np.ndarray, mcux: int, mcuy: int,
              ss: int, se: int, ah: int, al: int, progressive: bool, restart: int) -> int:
    """Decode one scan whose entropy-coded data begins at data[0] into the
    scan's components' int16 coefficient arrays `coefs` (each (rows, geom
    bw, 64), C-contiguous).  geom: int32 (n, 5), per component h, v, bw,
    nbx, nby; dc, ac: int32 (n, HUFF_WORDS).  Returns the offset of the
    marker that ends the scan; a code of JPEG_ERRORS raises a ValueError."""
    for c in coefs:
        if c.dtype != np.int16 or not c.flags.c_contiguous:
            raise ValueError("coefficient arrays must be C-contiguous int16")
    ptrs = (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])
    geom, dc, ac = (np.ascontiguousarray(a, np.int32) for a in (geom, dc, ac))
    ret = library().vpt_jpeg_scan(_ptr(data), data.size, len(coefs), ctypes.addressof(ptrs), _ptr(geom), _ptr(dc),
                                  _ptr(ac), mcux, mcuy, ss, se, ah, al, int(progressive), restart)
    if ret < 0:
        raise ValueError(JPEG_ERRORS.get(ret, f"error {ret}"))
    return int(ret)


def jpeg_idct(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantise (qt: 64 values in natural order) and inverse-transform
    (nby, nbx, 64) int16 coefficients into a (nby * 8, nbx * 8) uint8 plane."""
    coefs = np.ascontiguousarray(coefs, np.int16)
    qt = np.ascontiguousarray(qt, np.int32)
    nby, nbx = coefs.shape[:2]
    plane = np.empty((nby * 8, nbx * 8), np.uint8)
    library().vpt_jpeg_idct(_ptr(coefs), nby, nbx, _ptr(qt), _ptr(plane))
    return plane
