"""Build, load and count the hand-written CUDA kernels of vpt_tpu_torch/csrc.

Each source is compiled once per checkout, at first use (and again when it
or a header of csrc/ changes), into a shared library of its own under
`vpt_tpu_torch/build/` (git-ignored), one nvcc process per source, all
started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC

The libraries are loaded with ctypes: every entry point has a plain C
interface, takes raw device pointers and the CUDA stream, and returns
`cudaGetLastError()`.  `--fmad=false` keeps nvcc from contracting products
and sums into FMAs, so the kernels' slab and Moller-Trumbore decisions
round exactly like their plain torch versions.

`LAUNCHES` counts the launches of each kernel: a wrapper adds one where it
launches its kernel and nowhere else; a kernel inside a CUDA graph counts
once per run of its node (render/graphs.py).  Nothing here runs at import time.

The host C sources of csrc/ (the BVH builder, the LZ4 codec and the image
codec) are built into the same directory with g++ / gcc by `host_library`,
each at its first use.
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# The probe kernels of csrc/probe.cu (tools/hopper_probe.py) count under their probe's name.
PROBES = ("probe1", "probe2", "probe3", "probe4", "probe5", "probe6", "probe8", "probe9", "probe10", "probe11",
          "smem_probe")
LAUNCHES = {"ray_keys": 0, "supertile_tables": 0, "stream": 0, "occlude": 0, "visit": 0, "loop_cond": 0,
            **dict.fromkeys(PROBES, 0)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
_F = ctypes.c_float
SOURCES = {  # source -> {entry point: argument types}
    "envelope.cu": {
        "vpt_ray_keys": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P, _P],
        "vpt_supertile_tables": [_P, _P, _P, _P, _P, _I, _I, _F, _I, _P, _P],
    },
    "trace.cu": {
        "vpt_stream": [_P] * 19 + [_I] * 5 + [_F, _I] + [_P] * 5,
        "vpt_occlude": [_P] * 20 + [_I] * 5 + [_F, _I] + [_P] * 2,
    },
    "visit.cu": {"vpt_visit": [_P] * 15 + [_I] * 5 + [_F, _I, _I] + [_P] * 5},
    "probe.cu": {  # tools/hopper_probe.py
        "vpt_probe1": [_P] * 4,
        "vpt_probe2": [_P] + [_I] * 3 + [_P] * 3,
        "vpt_probe3": [_P] * 2 + [_I] * 2 + [_P] * 2,
        "vpt_probe4": [_P] * 2 + [_I] + [_P] * 2,
        "vpt_probe5": [_P, _I, _P, _P],
        "vpt_probe6": [_P, _I, _P, _P],
        "vpt_probe8": [_P, _I, _P, _P],
        "vpt_probe9": [_P] * 3,
        "vpt_probe10": [_P] * 2 + [_I] * 2 + [_P] * 2,
        "vpt_probe11": [_P, _I, _P, _P],
        "vpt_smem_probe": [_P, _I, _P, _P],
        "vpt_probe_error_name": [_I, _P, _I],  # no stream: the name of a CUDA error
    },
    "graph_loop.cu": {  # the dispatch graph's WHILE nodes and their condition (render/graphs.py)
        "vpt_graph_versions": [_P, _P],
        "vpt_graph_create": [_P],
        "vpt_graph_handle": [_P, _P],
        "vpt_graph_add_child": [_P, _P, _P, _P],
        "vpt_graph_add_cond": [_P, _P, _P, _L, _P, _L, _U, _I, _P, _P],
        "vpt_graph_add_while": [_P, _P, _U, _P, _P],
        "vpt_graph_bad_node": [_P, _P],
        "vpt_graph_count_nodes": [_P, _P],
        "vpt_graph_instantiate": [_P, _P],
        "vpt_graph_launch": [_P, _P],
        "vpt_graph_destroy": [_P, _P],
    },
}

_entry = None
build_seconds = None


def host_library(src: str, out: str, cmd: tuple, what: str) -> str:
    """`out`, the host C source `src` built by `cmd` (g++ or gcc and its
    flags) when `out` is missing or older than the source.  A failed build
    raises, naming `what`: there is no fallback."""
    if not os.path.exists(out) or os.path.getmtime(out) < os.path.getmtime(src):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([*cmd, src, "-o", tmp], capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed to build {what} from {src}:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library() -> dict:
    """Every entry point by name, its source built on first use."""
    global _entry, build_seconds
    if _entry is not None:
        return _entry
    t0 = time.perf_counter()
    outs = {s: os.path.join(BUILD_DIR, f"libvpt_{os.path.splitext(s)[0]}.so") for s in SOURCES}
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")]
    stale = [s for s, out in outs.items()
             if not os.path.exists(out)
             or os.path.getmtime(out) < max(os.path.getmtime(f) for f in [os.path.join(CSRC_DIR, s), *headers])]
    if stale:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        procs = {s: subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", f"{outs[s]}.{tag}", os.path.join(CSRC_DIR, s)],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s in stale}
        failed = []
        for s, proc in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{s} ({proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for s in stale:
            os.replace(f"{outs[s]}.{tag}", outs[s])
    entry = {}
    for s, signatures in SOURCES.items():
        lib = ctypes.CDLL(outs[s])
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            entry[name] = fn
    build_seconds = time.perf_counter() - t0
    _entry = entry
    return entry


def ptr(t: torch.Tensor, dtype: torch.dtype) -> int:
    """The device pointer of a contiguous CUDA tensor of `dtype`."""
    if not t.is_cuda or not t.is_contiguous() or t.dtype != dtype:
        raise ValueError(f"kernel argument must be a contiguous CUDA {dtype} tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    return t.data_ptr()


def launch(name: str, counter: str, *args) -> None:
    """Call one C entry point on the current stream; raise on a launch error
    (the wrappers check the layouts the kernels take before they call)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = library()[name](*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[counter] += 1
