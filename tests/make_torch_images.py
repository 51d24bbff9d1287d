"""Write the image decoder fixtures of tests/torch_images/ (PIL and numpy):

    python tests/make_torch_images.py

Every file that `gltf_scenes.IMAGE_FIXTURES` names, from seed 0: JPEGs that
PIL encodes (4:4:4, 4:2:2 and 4:2:0 at quality 50 and 95, gray, optimised
Huffman tables, restart markers, progressive 4:2:0 and gray) and PNGs that
`gltf_scenes.encode_png` writes, since PIL cannot (16-bit RGB, RGBA, gray
and gray+alpha, Adam7 at 8 and 16 bits, 1-, 2- and 4-bit gray; all five
row filters).  Beside each, NAME.ref.png is PIL's decode of it,
`convert("RGBA")`, written by the port's `save_png` (8-bit RGBA, filter
0).  The 1,024 x 1,024 4:2:0 JPEG that `chip_smoke.py` times,
`gltf_scenes.TIMING_JPEG`, has the sha256 of that decode's bytes in
TIMING_JPEG.sha256 instead (its reference would not fit the folder's
300 KB).  `chip_smoke.py` holds the port's decoders to these files on a
machine without PIL.
"""

from __future__ import annotations

import hashlib
import io
import os
import sys

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import gltf_scenes  # noqa: E402
from vpt_tpu_torch.io.image import save_png  # noqa: E402

FILTERS = (0, 1, 2, 3, 4, 4, 3, 1)


def photo(rng, h: int, w: int, noise: float = 8.0) -> np.ndarray:
    """An (h, w, 3) uint8 image with smooth colour fields, an edge and noise."""
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([np.sin(9 * x + 3 * y), np.cos(7 * x * y + 2), np.sin(20 * (x - y) ** 2)], axis=-1) * 110 + 128
    img[(x - 0.5) ** 2 + (y - 0.4) ** 2 < 0.05] *= 0.4
    img += rng.normal(0.0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg(img: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="JPEG", **kw)
    return out.getvalue()


def deep(rng, h: int, w: int, c: int) -> np.ndarray:
    """(h, w, c) uint16 samples: a ramp over the whole range plus noise."""
    ramp = np.linspace(0, 65535, h * w * c).reshape(h, w, c)
    return np.clip(ramp + rng.normal(0.0, 900.0, ramp.shape), 0, 65535).astype(np.uint16)


def fixtures(rng) -> dict:
    a, b = photo(rng, 29, 37), photo(rng, 48, 64)
    gray_a = a.mean(axis=-1).astype(np.uint8)
    return {
        "jpeg_444_q50.jpg": jpeg(a, quality=50, subsampling=0),
        "jpeg_444_q95.jpg": jpeg(b, quality=95, subsampling=0),
        "jpeg_422_q50.jpg": jpeg(b, quality=50, subsampling=1),
        "jpeg_422_q95.jpg": jpeg(a, quality=95, subsampling=1),
        "jpeg_420_q50.jpg": jpeg(a, quality=50, subsampling=2),
        "jpeg_420_q95.jpg": jpeg(b, quality=95, subsampling=2),
        "jpeg_gray.jpg": jpeg(gray_a, quality=85),
        "jpeg_optimize.jpg": jpeg(b, quality=75, optimize=True),
        "jpeg_restart.jpg": jpeg(a, quality=75, restart_marker_blocks=2),
        "jpeg_progressive_420.jpg": jpeg(b, quality=80, subsampling=2, progressive=True),
        "jpeg_progressive_gray.jpg": jpeg(gray_a, quality=80, progressive=True),
        "png16_rgb.png": gltf_scenes.encode_png(deep(rng, 29, 37, 3), 16, filters=FILTERS),
        "png16_rgba.png": gltf_scenes.encode_png(deep(rng, 29, 37, 4), 16, filters=FILTERS),
        "png16_gray.png": gltf_scenes.encode_png(deep(rng, 29, 37, 1) // 97, 16, filters=FILTERS),
        "png16_gray_alpha.png": gltf_scenes.encode_png(deep(rng, 29, 37, 2), 16, filters=FILTERS),
        "png_adam7_rgb8.png": gltf_scenes.encode_png(a, 8, filters=FILTERS, interlace=True),
        "png_adam7_rgba16.png": gltf_scenes.encode_png(deep(rng, 29, 37, 4), 16, filters=FILTERS, interlace=True),
        "png_gray1.png": gltf_scenes.encode_png(rng.integers(0, 2, (29, 37)), 1, filters=FILTERS),
        "png_gray2.png": gltf_scenes.encode_png(rng.integers(0, 4, (29, 37)), 2, filters=FILTERS),
        "png_gray4.png": gltf_scenes.encode_png(rng.integers(0, 16, (29, 37)), 4, filters=FILTERS,
                                                interlace=True),
    }


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def main() -> None:
    rng = np.random.default_rng(0)
    files = fixtures(rng)
    assert tuple(files) == gltf_scenes.IMAGE_FIXTURES, "the fixture list in gltf_scenes.py differs"
    os.makedirs(gltf_scenes.IMAGE_DIR, exist_ok=True)
    for name, data in files.items():
        with open(os.path.join(gltf_scenes.IMAGE_DIR, name), "wb") as f:
            f.write(data)
        save_png(os.path.join(gltf_scenes.IMAGE_DIR, name + ".ref.png"), pil_rgba(data))
    big = jpeg(photo(rng, 1024, 1024, noise=3.0), quality=85, subsampling=2)
    with open(os.path.join(gltf_scenes.IMAGE_DIR, gltf_scenes.TIMING_JPEG), "wb") as f:
        f.write(big)
    with open(os.path.join(gltf_scenes.IMAGE_DIR, gltf_scenes.TIMING_JPEG + ".sha256"), "w") as f:
        f.write(hashlib.sha256(pil_rgba(big).tobytes()).hexdigest() + "\n")
    total = sum(os.path.getsize(os.path.join(gltf_scenes.IMAGE_DIR, n)) for n in os.listdir(gltf_scenes.IMAGE_DIR))
    print(f"{len(files) + 1} fixtures in {gltf_scenes.IMAGE_DIR}: {total} bytes, the timing JPEG {len(big)} bytes")


if __name__ == "__main__":
    main()
