"""The three pairs every case of tests/pil_format_cases.py is held to: the JAX
package's glTF texture decode (`gltf._load_image`, from memory and from a
file), `load_png` and `load_hdr` (under each of its format's extensions)
against the port's; equal arrays (dtype, shape, bytes), or a ValueError from
the port where the JAX package raises.  Used by tests/test_torch_tga_pcx.py,
test_torch_dds.py, test_torch_netpbm_qoi_sgi.py and test_torch_ico_psd.py.
"""

from __future__ import annotations

import base64
import os
import warnings

import numpy as np

from vpt_tpu.io import image as jimage
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import envmap as tenvmap
from vpt_tpu_torch.scene import gltf as tgltf


def outcome(fn):
    """(value, None) or (None, the exception) of fn()."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(), None
    except Exception as e:  # noqa: BLE001  (PIL, imageio and OpenCV raise many kinds)
        return None, e


def _docs(data: bytes, file_name: str) -> tuple:
    memory = {"images": [{"uri": "data:application/octet-stream;base64," + base64.b64encode(data).decode(),
                          "name": "wall"}]}
    return memory, {"images": [{"uri": file_name}]}


def paths(data: bytes, directory: str, exts) -> dict:
    """The file written once under each extension: ext -> path."""
    out = {}
    for ext in exts:
        out[ext] = os.path.join(directory, f"img{ext}")
        with open(out[ext], "wb") as f:
            f.write(data)
    return out


def pairs(data: bytes, directory: str, exts) -> dict:
    """key -> (the JAX package's call, the port's call) for one file."""
    files = paths(data, directory, exts)
    first = files[exts[0]]
    memory, by_file = _docs(data, os.path.basename(first))
    out = {"texture": (lambda: jgltf._load_image(memory, [], directory, 0),
                       lambda: tgltf._load_image(memory, [], directory, 0)),
           "texture-file": (lambda: jgltf._load_image(by_file, [], directory, 0),
                            lambda: tgltf._load_image(by_file, [], directory, 0)),
           "load_png": (lambda: jimage.load_png(first), lambda: timage.load_png(first))}
    for ext, path in files.items():
        out["load_hdr" + ext] = (lambda p=path: jenvmap.load_hdr(p), lambda p=path: tenvmap.load_hdr(p))
    return out


def compare(data: bytes, directory: str, exts) -> dict:
    """Every pair of one file: key -> None where both agree, else a line
    that says how they differ.  Also returns, under "_jax", which keys the
    JAX package decoded."""
    out, decoded = {}, []
    for key, (jax, port) in pairs(data, directory, exts).items():
        want, want_err = outcome(jax)
        got, got_err = outcome(port)
        if want_err is not None:
            out[key] = None if isinstance(got_err, ValueError) else \
                f"{key}: the JAX package raises {type(want_err).__name__}: {want_err}; the port gives " + \
                (f"{type(got_err).__name__}: {got_err}" if got_err is not None else f"{got.dtype} {got.shape}")
            continue
        decoded.append(key)
        if got_err is not None:
            out[key] = f"{key}: the port raises {type(got_err).__name__}: {got_err}; the JAX package gives " \
                       f"{want.dtype} {want.shape}"
        elif got.dtype != want.dtype or got.shape != want.shape:
            out[key] = f"{key}: port {got.dtype} {got.shape}, JAX {want.dtype} {want.shape}"
        elif not np.array_equal(got, want, equal_nan=got.dtype.kind == "f"):
            bad = np.argwhere(got != want)
            out[key] = f"{key}: {len(bad)} values differ, first at {bad[0].tolist()}: port " \
                       f"{got[tuple(bad[0])]}, JAX {want[tuple(bad[0])]}"
        else:
            out[key] = None
    out["_jax"] = decoded
    return out


def failures(data: bytes, directory: str, exts) -> list:
    """The pairs of one file that differ."""
    return [v for k, v in compare(data, directory, exts).items() if k != "_jax" and v]
