"""Write the TIFF, GIF, BMP and JPEG fixtures of tests/torch_formats/ and
their manifest (needs PIL, imageio and the JAX package):

    python tests/make_torch_formats.py

Every file that `gltf_scenes.FORMAT_FIXTURES` names is the case of its name
in tests/format_cases.py (PIL, imageio's bundled tifffile or
tests/format_writers.py wrote it, from a seed of its name).  manifest.json
holds for each file [shape, dtype, sha256 of the array's bytes] of the JAX
package's two decodes: its glTF texture decode (`gltf._load_image`, PIL's
`convert("RGBA")` / 255) under "rgba", and `envmap.load_hdr` (imageio)
under "load_hdr"; null where the JAX package refuses the file that way
(PIL opens no float RGB TIFF), where the port must raise.  No decoded
image is stored.  `chip_smoke.py` phase 17a
holds the port's decoders to the manifest on a machine without PIL;
tests/test_torch_image_formats.py does here.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import sys
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import format_cases  # noqa: E402
import gltf_scenes  # noqa: E402
from vpt_tpu.scene import envmap, gltf  # noqa: E402


def entry(fn):
    """[shape, dtype, sha256] of fn()'s array, or None where it raises."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            arr = fn()
    except Exception:  # noqa: BLE001  (PIL and imageio raise many kinds; the port must refuse the file)
        return None
    return [list(arr.shape), str(arr.dtype), hashlib.sha256(arr.tobytes()).hexdigest()]


def main() -> None:
    os.makedirs(gltf_scenes.FORMAT_DIR, exist_ok=True)
    manifest = {}
    for fname in gltf_scenes.FORMAT_FIXTURES:
        name, ext = os.path.splitext(fname)
        assert format_cases.CASES[name][0] == ext, fname
        data = format_cases.case_bytes(name)
        path = os.path.join(gltf_scenes.FORMAT_DIR, fname)
        with open(path, "wb") as f:
            f.write(data)
        doc = {"images": [{"uri": "data:application/octet-stream;base64," + base64.b64encode(data).decode()}]}
        manifest[fname] = {"rgba": entry(lambda: gltf._load_image(doc, [], HERE, 0)),
                           "load_hdr": entry(lambda: envmap.load_hdr(path))}
    with open(os.path.join(gltf_scenes.FORMAT_DIR, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(gltf_scenes.FORMAT_DIR, n)) for n in os.listdir(gltf_scenes.FORMAT_DIR))
    print(f"{len(manifest)} fixtures and their manifest in {gltf_scenes.FORMAT_DIR}: {size} bytes")


if __name__ == "__main__":
    main()
