"""Write the fixtures of PIL's rarer plugins, tests/torch_pil_rare/, and
their manifest (needs PIL, imageio, OpenCV and the JAX package):

    JAX_PLATFORMS=cpu python tests/make_torch_pil_rare.py

Every case of tests/pil_rare_cases.py under 40 KB is written as
NAME + its format's first extension.  manifest.json holds for each file
[shape, dtype, sha256 of the array's bytes] of the JAX package's four
decodes: its glTF texture decode of the bytes ("rgba", PIL's
`convert("RGBA")` / 255) and of the file by its path ("rgba_file"),
`load_png` of the file ("load_png", PIL's own mode array / 255) and
`envmap.load_hdr` of the file under its extension ("load_hdr", imageio);
null where the JAX package refuses the file that way.  It holds the same
for the files of `pil_rare_writers.generated()` (the PhotoCD cases, the
2048x2048 timing textures and the 4096x2048 FITS sky), which are made from
seeds and not committed.  chip_smoke.py phase 17 holds the port's decoders
to the manifest on a machine without PIL; tests/test_torch_pil_rare.py
does here.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import sys
import tempfile
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import gltf_scenes  # noqa: E402
import pil_rare_cases  # noqa: E402
import pil_rare_writers  # noqa: E402
from vpt_tpu.io import image as jimage  # noqa: E402
from vpt_tpu.scene import envmap, gltf  # noqa: E402

LIMIT = 40_000  # bytes: larger cases are tested from their seed and not committed


def entry(fn):
    """[shape, dtype, sha256] of fn()'s array, or None where it raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            arr = fn()
    except Exception:  # noqa: BLE001  (PIL, imageio and OpenCV raise many kinds; the port must refuse the file)
        return None
    return [list(arr.shape), str(arr.dtype), hashlib.sha256(arr.tobytes()).hexdigest()]


def decodes(data: bytes, path: str) -> dict:
    folder, name = os.path.split(path)
    memory = {"images": [{"uri": "data:application/octet-stream;base64," + base64.b64encode(data).decode()}]}
    by_file = {"images": [{"uri": name}]}
    return {"rgba": entry(lambda: gltf._load_image(memory, [], folder, 0)),
            "rgba_file": entry(lambda: gltf._load_image(by_file, [], folder, 0)),
            "load_png": entry(lambda: jimage.load_png(path)), "load_hdr": entry(lambda: envmap.load_hdr(path))}


def fixtures() -> dict:
    """file name -> bytes of every committed fixture."""
    out = {}
    for name, (ext, _) in pil_rare_cases.CASES.items():
        data = pil_rare_cases.case_bytes(name)
        if len(data) <= LIMIT and not name.startswith("pcd"):
            out[name + ext] = data
    return out


def main() -> None:
    folder = gltf_scenes.PIL_RARE_DIR
    os.makedirs(folder, exist_ok=True)
    for old in os.listdir(folder):
        os.remove(os.path.join(folder, old))
    manifest = {}
    for fname, data in fixtures().items():
        path = os.path.join(folder, fname)
        with open(path, "wb") as f:
            f.write(data)
        manifest[fname] = decodes(data, path)
    with tempfile.TemporaryDirectory() as tmp:
        for fname, data in pil_rare_writers.generated().items():
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                f.write(data)
            manifest[fname] = decodes(data, path)
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(folder, n)) for n in os.listdir(folder))
    print(f"{len(manifest)} entries in {folder}: {size} bytes")


if __name__ == "__main__":
    main()
