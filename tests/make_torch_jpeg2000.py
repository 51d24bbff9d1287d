"""Write the JPEG 2000 fixtures of tests/torch_jpeg2000/ and their manifest
(needs PIL, OpenCV, imageio and the JAX package):

    JAX_PLATFORMS=cpu python tests/make_torch_jpeg2000.py

Every case of tests/jpeg2000_cases.py is written as NAME + its extension;
beside them the two timing textures of `gltf_scenes.JPEG2000_TIMING` (a
2048x2048 9/7 JP2 at a rate, a 1024x1024 5/3 lossless JP2 of 256x256
tiles, each under 500 KB) and `gltf_scenes.JPEG2000_SKY`, a 1024x512 sky,
PIL's writer all three.  manifest.json holds for each file [shape, dtype,
sha256 of the array's bytes] of the JAX package's glTF texture decode
("rgba") and `envmap.load_hdr` under its own extension ("load_hdr"), null
where the JAX package refuses it.  pil_seconds.json holds PIL's decode
seconds here of each timing texture (`Image.open(...).convert("RGBA")`,
median of 5), the yardstick chip_smoke.py phase 17b prints beside the
port's.
"""

from __future__ import annotations

import io
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import gltf_scenes  # noqa: E402
import jpeg2000_cases  # noqa: E402
from make_torch_pil_formats import decodes  # noqa: E402
from PIL import Image  # noqa: E402

from vpt_tpu_torch.scene.envmap import default_sky  # noqa: E402


def _texture(n: int, seed: int, noise: float = 2.0) -> np.ndarray:
    """An n x n RGB texture: bands and rings, a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n] / n
    r = 128 + 100 * np.sin(14 * x + 3 * np.sin(9 * y))
    g = 128 + 100 * np.cos(11 * np.hypot(x - 0.4, y - 0.6) * 6)
    b = 255 * ((x * 7 + y * 5) % 1.0)
    img = np.stack([r, g, b], -1) + rng.normal(0, noise, (n, n, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _blocks(n: int) -> np.ndarray:
    """An n x n RGB texture for a lossless file: ramps over 32x32 blocks of
    flat colour (a tiled floor)."""
    y, x = np.mgrid[0:n, 0:n]
    cell = ((x // 32) * 37 + (y // 32) * 91)[..., None] * np.array([1, 3, 7])
    return ((cell + (x // 4 + y // 8)[..., None]) % 256).astype(np.uint8)


def extras() -> dict:
    """The timing textures and the sky: name -> bytes."""
    out = {"timing-2048-97-rate.jp2": jpeg2000_cases.pil_j2k(_texture(2048, 1), irreversible=True,
                                                             quality_layers=[40]),
           "timing-1024-53-tiles.jp2": jpeg2000_cases.pil_j2k(_blocks(1024), tile_size=(256, 256))}
    sky = np.clip(default_sky(size=(512, 1024)) * 150.0, 0, 255).astype(np.uint8)
    out[gltf_scenes.JPEG2000_SKY] = jpeg2000_cases.pil_j2k(sky, irreversible=True, quality_layers=[20])
    return out


def main() -> None:
    folder = gltf_scenes.JPEG2000_DIR
    os.makedirs(folder, exist_ok=True)
    files = {name + ext: jpeg2000_cases.case_bytes(name) for name, (ext, _) in jpeg2000_cases.CASES.items()}
    files.update(extras())
    manifest = {}
    for fname, data in files.items():
        path = os.path.join(folder, fname)
        with open(path, "wb") as f:
            f.write(data)
        manifest[fname] = decodes(data, path)
    with open(os.path.join(folder, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    seconds = {}
    for fname in gltf_scenes.JPEG2000_TIMING:
        assert len(files[fname]) <= 500_000, (fname, len(files[fname]))
        every = []
        for _ in range(5):
            t0 = time.perf_counter()
            np.asarray(Image.open(io.BytesIO(files[fname])).convert("RGBA"))
            every.append(time.perf_counter() - t0)
        seconds[fname] = {"pil_s": statistics.median(every), "all_s": every, "bytes": len(files[fname])}
    seconds["host"] = {"cpus": os.cpu_count(), "machine": platform.machine(), "python": platform.python_version()}
    with open(os.path.join(folder, "pil_seconds.json"), "w") as f:
        json.dump(seconds, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(folder, n)) for n in os.listdir(folder))
    print(f"{len(files)} files and their manifest in {folder} ({size} bytes); PIL's seconds: "
          f"{ {k: round(v['pil_s'], 4) for k, v in seconds.items() if 'pil_s' in v} }")


if __name__ == "__main__":
    main()
