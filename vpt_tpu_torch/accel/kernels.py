"""Build, load and count the hand-written CUDA kernels of vpt_tpu_torch/csrc.

The sources are compiled once per checkout, at first use, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC

into one shared library under `vpt_tpu_torch/build/` (git-ignored) and
loaded with ctypes: every entry point has a plain C interface, takes raw
device pointers and the CUDA stream, and returns `cudaGetLastError()`.
`--fmad=false` keeps nvcc from contracting products and sums into FMAs, so
the kernels' slab and Moller-Trumbore decisions round exactly like their
plain torch versions.

`LAUNCHES` counts the launches of each kernel: a wrapper adds one where it
launches its kernel and nowhere else.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("envelope.cu", "trace.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES = {"ray_keys": 0, "supertile_tables": 0, "stream": 0, "occlude": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vpt_ray_keys": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P],
    "vpt_supertile_tables": [_P, _P, _P, _P, _P, _I, _I, _F, _P, _P],
    "vpt_stream": [_P] * 16 + [_I] * 5 + [_F, _I] + [_P] * 5,
    "vpt_occlude": [_P] * 17 + [_I] * 5 + [_F, _I] + [_P] * 2,
}

_lib = None
build_seconds = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from csrc/ on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    out = os.path.join(BUILD_DIR, "libvpt_kernels.so")
    t0 = time.perf_counter()
    if not os.path.exists(out) or os.path.getmtime(out) < max(map(os.path.getmtime, srcs)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def ptr(t: torch.Tensor, dtype: torch.dtype) -> int:
    """The device pointer of a contiguous CUDA tensor of `dtype`."""
    if not t.is_cuda or not t.is_contiguous() or t.dtype != dtype:
        raise ValueError(f"kernel argument must be a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t.data_ptr()


def launch(name: str, counter: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a launch error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
