"""Write the AVIF fixtures of tests/torch_avif/ and their manifest (needs
PIL with AVIF, imageio and the JAX package):

    JAX_PLATFORMS=cpu python tests/make_torch_avif.py

Every case of tests/avif_cases.py is written under its name.  manifest.json
holds for each file [shape, dtype, sha256 of the array's bytes] of the JAX
package's four decodes, as tests/make_torch_pil_rare.py writes them: the
glTF texture decode of the bytes ("rgba") and of the file by its path
("rgba_file"), `load_png` ("load_png") and `envmap.load_hdr` ("load_hdr");
null where the JAX package refuses the file that way.  A case of
`avif_cases.REFUSED` is checked to be one the JAX package reads.
tests/test_torch_avif.py holds the port to the manifest and to the JAX
package here; chip_smoke.py phase 17 holds it to the manifest on a machine
without PIL.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import avif_cases  # noqa: E402
import gltf_scenes  # noqa: E402
from make_torch_pil_rare import decodes  # noqa: E402


def main() -> None:
    folder = gltf_scenes.AVIF_DIR
    os.makedirs(folder, exist_ok=True)
    for old in os.listdir(folder):
        os.remove(os.path.join(folder, old))
    manifest = {}
    for name, build in avif_cases.CASES.items():
        data = build()
        path = os.path.join(folder, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest[name] = decodes(data, path)
        if name in avif_cases.REFUSED:
            assert all(v is not None for v in manifest[name].values()), (name, "the JAX package refuses it")
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(folder, n)) for n in os.listdir(folder))
    print(f"{len(manifest)} files, {size} bytes")


if __name__ == "__main__":
    main()
