"""Write the WebP fixtures of tests/torch_webp/ and their manifest (needs
gcc, libwebp's encoder headers and library, PIL, imageio and the JAX
package):

    python tests/make_torch_webp.py

The files cover the encoder settings PIL's `save` does not expose: the
simple and the normal loop filter at each sharpness, 2, 4 and 8 token
partitions, 1-4 segments, a filter level of 0 and of 63, the ALPH chunk's
compression (raw or lossless) under each of libwebp's filter choices
(none, fast, best); nine cases of tests/webp_cases.py (ALPH chunks under
each of the four filters, raw and lossless, and an animation's first frame
at an offset), so the card's machine, which has no PIL, decodes them too;
and the two 2048x2048 textures that chip_smoke.py phase 17b times (lossy
with ALPH, lossless).  They are encoded by a one-off
C helper built here with gcc against libwebp's `WebPConfig` / `WebPEncode`
(the helper and its build stay in a temporary directory).  Every file's
name is in `gltf_scenes.WEBP_FIXTURES`.

manifest.json holds for each file [shape, dtype, sha256 of the array's
bytes] of the JAX package's decodes, as tests/make_torch_formats.py writes
its: the glTF texture decode (`gltf._load_image`) under "rgba" and
`envmap.load_hdr` under "load_hdr", null where it refuses the file.  No
decoded image is stored.  tests/test_torch_webp.py holds the port to the
manifest and to the JAX package here; chip_smoke.py phase 17 holds it to
the manifest on a machine without PIL.
"""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import gltf_scenes  # noqa: E402
from make_torch_formats import entry  # noqa: E402

HELPER = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>

/* helper IN.rgba WIDTH HEIGHT OUT.webp [key=value ...]: IN holds WIDTH x
   HEIGHT RGBA bytes; the keys set WebPConfig fields (and "alpha": 0 imports
   the pixels as RGB). */
int main(int argc, char **argv) {
    int w = atoi(argv[2]), h = atoi(argv[3]), use_alpha = 1;
    uint8_t *rgba = malloc((size_t)w * h * 4);
    FILE *f = fopen(argv[1], "rb");
    if (!f || fread(rgba, 1, (size_t)w * h * 4, f) != (size_t)w * h * 4) return 2;
    fclose(f);
    WebPConfig c;
    if (!WebPConfigInit(&c)) return 3;
    for (int i = 5; i < argc; i++) {
        char key[64];
        double v;
        if (sscanf(argv[i], "%63[^=]=%lf", key, &v) != 2) return 4;
#define SET(name) else if (!strcmp(key, #name)) c.name = (int)v;
        if (!strcmp(key, "quality")) c.quality = (float)v;
        else if (!strcmp(key, "alpha")) use_alpha = (int)v;
        SET(lossless) SET(method) SET(filter_type) SET(filter_strength) SET(filter_sharpness) SET(autofilter)
        SET(partitions) SET(segments) SET(sns_strength) SET(alpha_compression) SET(alpha_filtering)
        SET(alpha_quality) SET(exact) SET(use_sharp_yuv) SET(preprocessing)
        else return 5;
    }
    if (!WebPValidateConfig(&c)) return 6;
    WebPPicture pic;
    if (!WebPPictureInit(&pic)) return 7;
    pic.width = w;
    pic.height = h;
    pic.use_argb = c.lossless;
    if (!(use_alpha ? WebPPictureImportRGBA(&pic, rgba, w * 4) : WebPPictureImportRGBX(&pic, rgba, w * 4))) return 8;
    WebPMemoryWriter out;
    WebPMemoryWriterInit(&out);
    pic.writer = WebPMemoryWrite;
    pic.custom_ptr = &out;
    if (!WebPEncode(&c, &pic)) return 9;
    f = fopen(argv[4], "wb");
    fwrite(out.mem, 1, out.size, f);
    fclose(f);
    return 0;
}
"""


def small(seed: int, h: int = 48, w: int = 64) -> np.ndarray:
    """(h, w, 4) uint8: colour ramps, edges for the loop filter, noise, and a
    soft-edged alpha disc."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    rgb = np.stack([128 + 90 * np.sin(x / (5 + k) + y / (7 + 2 * k) + k) for k in range(3)], axis=-1)
    rgb += 60 * (((x // 8 + y // 8) % 2) - 0.5)[..., None]
    rgb += rng.normal(0, 8, rgb.shape)
    alpha = np.clip(300 - 9 * np.hypot(x - w / 2, y - h / 2), 0, 255) + rng.normal(0, 4, (h, w))
    return np.clip(np.concatenate([rgb, alpha[..., None]], axis=-1), 0, 255).astype(np.uint8)


def bricks(n: int = 2048, seed: int = 0) -> np.ndarray:
    """(n, n, 4) uint8: a brick wall texture (tinted bricks, mortar, slow
    shading, colours in steps of 4) with a radial alpha ramp."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n].astype(np.float32)
    bh, bw = 64, 128
    row = (y // bh).astype(int)
    shift = (row % 2) * bw / 2
    col = ((x + shift) // bw).astype(int)
    tint = rng.uniform(0.75, 1.0, (n // bh + 2, n // bw + 3, 3))
    rgb = np.array([170, 90, 60], np.float32) * tint[row, col]
    rgb[((y % bh) < 5) | (((x + shift) % bw) < 5)] = [200, 195, 185]
    rgb *= (0.85 + 0.15 * np.sin(x / 300.0) * np.cos(y / 410.0))[..., None]
    rgb = np.clip(rgb, 0, 255).astype(np.int32) // 4 * 4
    alpha = np.clip(255 * (1.3 - np.hypot(x - n / 2, y - n / 2) / (n / 2)), 0, 255)
    return np.concatenate([rgb, alpha[..., None].astype(np.int32)], axis=-1).astype(np.uint8)


LOSSY = dict(quality=75, method=4)
FIXTURES = {
    "vp8-filter-simple-sharpness-0.webp": (0, dict(LOSSY, filter_type=0, filter_strength=60, alpha=0)),
    "vp8-filter-simple-sharpness-4.webp": (1, dict(LOSSY, filter_type=0, filter_strength=60, filter_sharpness=4)),
    "vp8-filter-simple-sharpness-7.webp": (2, dict(LOSSY, filter_type=0, filter_strength=80, filter_sharpness=7,
                                                   alpha=0)),
    **{f"vp8-filter-normal-sharpness-{s}.webp": (10 + s, dict(LOSSY, filter_type=1, filter_strength=70,
                                                               filter_sharpness=s, alpha=s % 2))
       for s in range(1, 8)},
    "vp8-filter-off.webp": (20, dict(LOSSY, filter_strength=0, alpha=0)),
    "vp8-filter-strongest-q0.webp": (21, dict(quality=0, method=4, filter_strength=100, sns_strength=100)),
    "vp8-filter-auto.webp": (22, dict(LOSSY, autofilter=1, alpha=0)),
    # (libwebp's encoder writes one token partition at methods 3-6)
    **{f"vp8-partitions-{1 << p}.webp": (30 + p, dict(quality=75, method=p - 1, partitions=p, alpha=p % 2))
       for p in (1, 2, 3)},
    **{f"vp8-segments-{s}.webp": (40 + s, dict(LOSSY, segments=s, sns_strength=90, alpha=0)) for s in (1, 2, 3, 4)},
    "vp8-sharp-yuv-m6.webp": (50, dict(quality=90, method=6, use_sharp_yuv=1)),
    **{f"vp8-alph-{'lossless' if c else 'raw'}-filter-{name}.webp":
       (60 + 3 * c + f, dict(LOSSY, alpha_compression=c, alpha_filtering=f, alpha_quality=100))
       for c in (0, 1) for f, name in enumerate(("none", "fast", "best"))},
    "vp8-alph-quantised-q30.webp": (70, dict(LOSSY, alpha_quality=30, alpha_filtering=2, preprocessing=2)),
    "vp8l-m0-q0.webp": (80, dict(lossless=1, method=0, quality=0)),
    "vp8l-m6-q100-exact.webp": (81, dict(lossless=1, method=6, quality=100, exact=1)),
}
# Cases of tests/webp_cases.py (its RIFF writer's ALPH chunks under each
# filter, an animation's first frame at an offset), for the card's machine.
CASES = tuple(f"alph-{c}-filter-{f}" for c in ("raw", "lossless") for f in range(4)) + \
    ("animation-first-frame-lossy-alpha-12x9-at-6-4",)
TIMING = {
    "timing-2048-lossy-alpha.webp": dict(quality=40, method=4, alpha_quality=50),
    "timing-2048-lossless.webp": dict(lossless=1, method=6, quality=100),
}


def encode(helper: str, tmp: str, img: np.ndarray, settings: dict, out: str) -> None:
    raw = os.path.join(tmp, "in.rgba")
    img.tofile(raw)
    args = [f"{k}={v}" for k, v in settings.items()]
    subprocess.run([helper, raw, str(img.shape[1]), str(img.shape[0]), out, *args], check=True)


def main() -> None:
    from vpt_tpu.scene import envmap, gltf

    import webp_cases

    assert sorted(gltf_scenes.WEBP_FIXTURES) == sorted([*FIXTURES, *(f"{c}.webp" for c in CASES), *TIMING])
    os.makedirs(gltf_scenes.WEBP_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        src, helper = os.path.join(tmp, "helper.c"), os.path.join(tmp, "helper")
        with open(src, "w") as f:
            f.write(HELPER)
        subprocess.run(["gcc", "-O2", src, "-o", helper, "-lwebp"], check=True)
        for name, (seed, settings) in FIXTURES.items():
            img = small(seed, 150, 40) if "partitions" in name else small(seed)  # a partition per macroblock row
            encode(helper, tmp, img, settings, os.path.join(gltf_scenes.WEBP_DIR, name))
        for name in CASES:
            with open(os.path.join(gltf_scenes.WEBP_DIR, f"{name}.webp"), "wb") as f:
                f.write(webp_cases.case_bytes(name))
        wall = bricks()
        for name, settings in TIMING.items():
            encode(helper, tmp, wall, settings, os.path.join(gltf_scenes.WEBP_DIR, name))
    manifest = {}
    for name in gltf_scenes.WEBP_FIXTURES:
        path = os.path.join(gltf_scenes.WEBP_DIR, name)
        with open(path, "rb") as f:
            data = f.read()
        doc = {"images": [{"uri": "data:image/webp;base64," + base64.b64encode(data).decode()}]}
        manifest[name] = {"rgba": entry(lambda: gltf._load_image(doc, [], HERE, 0)),
                          "load_hdr": entry(lambda: envmap.load_hdr(path))}
    with open(os.path.join(gltf_scenes.WEBP_DIR, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(gltf_scenes.WEBP_DIR, n)) for n in os.listdir(gltf_scenes.WEBP_DIR))
    print(f"{len(manifest)} fixtures and their manifest in {gltf_scenes.WEBP_DIR}: {size} bytes")


if __name__ == "__main__":
    main()
