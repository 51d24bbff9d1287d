"""Write the TGA, DDS, Netpbm / PFM, QOI, SGI, PCX, ICO / CUR and PSD
fixtures of tests/torch_pil_formats/ and their manifest (needs PIL, imageio,
OpenCV and the JAX package):

    JAX_PLATFORMS=cpu python tests/make_torch_pil_formats.py

Every file that `gltf_scenes.PIL_FORMAT_FIXTURES` names is the case of its
name in tests/pil_format_cases.py (PIL or tests/pil_format_writers.py wrote
it, from a seed of its name).  manifest.json holds for each file [shape,
dtype, sha256 of the array's bytes] of the JAX package's two decodes: its
glTF texture decode of the bytes (`gltf._load_image`, PIL's
`convert("RGBA")` / 255) under "rgba", and `envmap.load_hdr` of the file
under its own extension (imageio) under "load_hdr"; null where the JAX
package refuses the file that way.  It holds the same for the three
2048x2048 textures of `gltf_scenes.PIL_FORMAT_TIMING`, which
`pil_format_writers.timing_textures` makes and which are not committed
(PIL decodes the QOI one in Python: the run takes about a minute).
`chip_smoke.py` phase 17 holds the port's decoders to the manifest on a
machine without PIL; tests/test_torch_pil_fixtures.py does here.
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
import pil_format_cases  # noqa: E402
import pil_format_writers  # noqa: E402
from vpt_tpu.scene import envmap, gltf  # noqa: E402


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
    doc = {"images": [{"uri": "data:application/octet-stream;base64," + base64.b64encode(data).decode()}]}
    return {"rgba": entry(lambda: gltf._load_image(doc, [], HERE, 0)), "load_hdr": entry(lambda: envmap.load_hdr(path))}


def main() -> None:
    folder = gltf_scenes.PIL_FORMAT_DIR
    os.makedirs(folder, exist_ok=True)
    manifest = {}
    for fname in gltf_scenes.PIL_FORMAT_FIXTURES:
        name, ext = os.path.splitext(fname)
        assert pil_format_cases.CASES[name][0] == ext, fname
        data = pil_format_cases.case_bytes(name)
        path = os.path.join(folder, fname)
        with open(path, "wb") as f:
            f.write(data)
        manifest[fname] = decodes(data, path)
    timing = pil_format_writers.timing_textures()
    assert sorted(timing) == sorted(gltf_scenes.PIL_FORMAT_TIMING)
    with tempfile.TemporaryDirectory() as tmp:
        for fname, data in timing.items():
            path = os.path.join(tmp, fname)
            with open(path, "wb") as f:
                f.write(data)
            manifest[fname] = decodes(data, path)
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(folder, n)) for n in os.listdir(folder))
    print(f"{len(manifest)} entries and {len(gltf_scenes.PIL_FORMAT_FIXTURES)} fixtures in {folder}: {size} bytes")


if __name__ == "__main__":
    main()
