"""Write tests/torch_opencv/: the files of tests/opencv_cases.py and
manifest.json, the JAX package's `load_hdr` of each under `.exr` (imageio
hands an `.exr` file to OpenCV before any other installed plugin): the
sha256 of its float32 array and its shape, or null where it raises.

Files whose name holds "port-refuses" are the OpenCV data the port does not
read (AVIF) or cannot (a PAM of 2 or 4 channels, whose rows OpenCV leaves
half unwritten, so the JAX package's array is whatever memory held): their
entry records the port's refusal instead of a sha256.  Files named
"sweep-*" are corrupt copies tests/opencv_sweep.py found, kept as they
were (tests/opencv_cases.py reads them back).

Needs PIL, OpenCV (cv2), imageio and the JAX package.  Run from the
repository root:

    JAX_PLATFORMS=cpu python tests/make_torch_opencv.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import opencv_cases  # noqa: E402

OUT = os.path.join(HERE, "torch_opencv")


def digest(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()


def jax_load(data: bytes, name: str):
    """The JAX package's load_hdr of the bytes under `name`: the array, or
    None where it raises."""
    from vpt_tpu.scene import envmap

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, name)
        with open(path, "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                return envmap.load_hdr(path)
            except Exception:  # noqa: BLE001  (imageio and OpenCV raise many kinds)
                return None


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    manifest = {}
    for name, build in opencv_cases.CASES.items():
        data = build()
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        if "port-refuses" in name:
            manifest[name] = {"port_refuses": True}
            continue
        img = jax_load(data, "sky.exr")
        manifest[name] = None if img is None else {"sha256": digest(img), "shape": list(img.shape)}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(manifest)} files, {sum(v is None for v in manifest.values())} refused")


if __name__ == "__main__":
    main()
