"""The AVIF files the port is held to (tests/torch_avif/, written by
tests/make_torch_avif.py; this module is jax-free, and needs PIL only to
make the files).

Each case is PIL 12.1's `save(format="AVIF", ...)` (libavif 1.3.0 with
libaom 3.12.1) of a seeded image: `quality=100`, which is coded-lossless
AV1, under every subsampling (4:0:0 from an RGB image), RGB and RGBA with
alpha premultiplied or not, full and limited range, aom speeds 0, 4, 6 and
10, explicit tile rows and columns and autotiling, sizes from 1x1 to
1024x1024, smooth, noisy and flat-graphic content (which reaches CfL,
filter intra and, with screen content tools on and intra block copy off,
palette), an ICC profile, EXIF with an orientation (PIL writes it as
`irot` / `imir`; libavif leaves the pixels unturned), XMP, and a 2-frame
`avis` sequence with and without alpha; and the files the port refuses by
name where PIL reads them: lossy AV1 (quality 99 and PIL's default 75),
intra block copy (aom's pick for flat graphics at speed 6), and a
matrix-coefficients value the port does not convert (a `colr` box edited
to FCC).  `REFUSED` maps each refused case to the words its refusal holds.

`TIMING` are the two 1024x1024 textures chip_smoke.py phase 17 times
(lossless 4:2:0 RGB and RGBA), `SKY` the 1024x512 environment map it
renders with (`default_sky`, tone-mapped to 8 bits).
"""

from __future__ import annotations

import io

import numpy as np

TIMING = ("timing-1024-soft-420.avif", "timing-1024-ramp-rgba.avif")
SKY = "sky-1024x512.avif"
REFUSED = {"lossy-q99-420.avif": "not coded-lossless", "lossy-q75-default.avif": "not coded-lossless",
           "intrabc-flat-speed6.avif": "allow_intrabc", "matrix-fcc-444.avif": "matrix coefficients 4"}


def field(kind: str, h: int, w: int, ch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "noise":
        return rng.integers(0, 256, (h, w, ch), np.uint8)
    if kind == "smooth":
        phase = rng.random(ch) * 6.0
        out = np.stack([(np.sin(x / 7.0 + phase[c]) + np.cos(y / 5.0 - phase[c])) * 60 + 128 for c in range(ch)], -1)
        return np.clip(out, 0, 255).astype(np.uint8)
    if kind == "flat":
        palette = rng.integers(0, 256, (5, ch))
        return palette[(np.add.outer(np.arange(h) // 6, np.arange(w) // 9)) % 5].astype(np.uint8)
    if kind == "soft":
        out = np.stack([128 + 100 * np.sin(x / 97.0), 128 + 100 * np.cos(y / 61.0), 128 + 80 * np.sin((x + y) / 150.0)],
                       -1)[..., :ch]
        return np.clip(out, 0, 255).astype(np.uint8)
    if kind == "ramp":
        out = np.stack([(x // 4) % 256, (y // 4) % 256, ((x + y) // 8) % 256, 255 - (x // 4 + y // 4) % 256], -1)
        return out[..., :ch].astype(np.uint8)
    raise ValueError(kind)


def pil_avif(arr: np.ndarray, **kw) -> bytes:
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(arr, "RGBA" if arr.shape[-1] == 4 else "RGB").save(out, format="AVIF", **{"quality": 100, **kw})
    return out.getvalue()


def _exif6() -> bytes:
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = 6
    return exif.tobytes()


def _sequence(ch: int) -> bytes:
    from PIL import Image

    frames = [Image.fromarray(field("noise", 24, 30, ch, 40 + k), "RGBA" if ch == 4 else "RGB") for k in range(2)]
    out = io.BytesIO()
    frames[0].save(out, format="AVIF", save_all=True, append_images=frames[1:], quality=100)
    return out.getvalue()


def _matrix(data: bytes, mc: int) -> bytes:
    """The file with its colr box's matrix coefficients edited."""
    at = data.find(b"nclx") + 8
    return data[:at] + mc.to_bytes(2, "big") + data[at + 2 :]


def _sky() -> np.ndarray:
    from vpt_tpu_torch.scene.envmap import default_sky

    sky = default_sky(size=(512, 1024))
    return np.clip(np.rint(255.0 * sky / (1.0 + sky)), 0, 255).astype(np.uint8)


CASES = {
    # subsampling, content and mode
    "sub-420-smooth-65x33.avif": lambda: pil_avif(field("smooth", 33, 65, 3, 1)),
    "sub-422-noise-13x7.avif": lambda: pil_avif(field("noise", 7, 13, 3, 2), subsampling="4:2:2"),
    "sub-444-flat-65x33.avif": lambda: pil_avif(field("flat", 33, 65, 3, 3), subsampling="4:4:4"),
    "sub-400-smooth-65x33.avif": lambda: pil_avif(field("smooth", 33, 65, 3, 4), subsampling="4:0:0"),
    "sub-400-rgba-noise-13x7.avif": lambda: pil_avif(field("noise", 7, 13, 4, 5), subsampling="4:0:0"),
    "rgba-420-noise-13x7.avif": lambda: pil_avif(field("noise", 7, 13, 4, 6)),
    "rgba-422-smooth-65x33.avif": lambda: pil_avif(field("smooth", 33, 65, 4, 7), subsampling="4:2:2"),
    "rgba-444-premultiplied-smooth-65x33.avif": lambda: pil_avif(field("smooth", 33, 65, 4, 8), subsampling="4:4:4",
                                                                 alpha_premultiplied=True),
    "rgba-420-premultiplied-noise-33x17.avif": lambda: pil_avif(field("noise", 17, 33, 4, 9),
                                                                alpha_premultiplied=True),
    # range
    "range-limited-420-smooth-65x33.avif": lambda: pil_avif(field("smooth", 33, 65, 3, 10), range="limited"),
    "range-limited-444-rgba-noise-13x7.avif": lambda: pil_avif(field("noise", 7, 13, 4, 11), subsampling="4:4:4",
                                                               range="limited"),
    "range-limited-400-noise-13x7.avif": lambda: pil_avif(field("noise", 7, 13, 3, 12), subsampling="4:0:0",
                                                          range="limited"),
    # aom speeds
    "speed-0-noise-13x7.avif": lambda: pil_avif(field("noise", 7, 13, 3, 13), speed=0),
    "speed-0-smooth-33x17.avif": lambda: pil_avif(field("smooth", 17, 33, 3, 14), speed=0),
    "speed-4-smooth-65x33.avif": lambda: pil_avif(field("smooth", 33, 65, 3, 15), speed=4),
    "speed-6-noise-65x33.avif": lambda: pil_avif(field("noise", 33, 65, 3, 16), speed=6),
    "speed-10-smooth-65x33.avif": lambda: pil_avif(field("smooth", 33, 65, 3, 17), speed=10),
    "speed-10-flat-130x200.avif": lambda: pil_avif(field("flat", 130, 200, 3, 18), speed=10),
    # tiles
    "tiles-2x2-smooth-192x256.avif": lambda: pil_avif(field("smooth", 192, 256, 3, 19), tile_rows=1, tile_cols=1,
                                                      speed=8),
    "tiles-1x4-smooth-64x512.avif": lambda: pil_avif(field("smooth", 64, 512, 3, 20), tile_cols=2, speed=8),
    "autotiling-soft-rgba-300x900.avif": lambda: pil_avif(field("soft", 300, 900, 4, 21), autotiling=True, speed=9),
    # sizes
    "size-1x1.avif": lambda: pil_avif(field("noise", 1, 1, 3, 22)),
    "size-1x1-rgba.avif": lambda: pil_avif(field("noise", 1, 1, 4, 23)),
    "size-2x3-444.avif": lambda: pil_avif(field("noise", 3, 2, 3, 24), subsampling="4:4:4"),
    "size-13x7-smooth.avif": lambda: pil_avif(field("smooth", 7, 13, 3, 25)),
    "size-65x33-flat-422.avif": lambda: pil_avif(field("flat", 33, 65, 3, 26), subsampling="4:2:2"),
    # screen content: palette with intra block copy off
    "palette-flat-130x200.avif": lambda: pil_avif(field("flat", 130, 200, 3, 27), speed=6,
                                                  advanced={"enable-intrabc": "0"}),
    "palette-flat-444-rgba-96x96.avif": lambda: pil_avif(field("flat", 96, 96, 4, 28), speed=6, subsampling="4:4:4",
                                                         advanced={"enable-intrabc": "0"}),
    # metadata and sequences
    "icc-profile.avif": lambda: pil_avif(field("smooth", 17, 21, 3, 29), icc_profile=b"\0" * 200),
    "exif-orientation-6.avif": lambda: pil_avif(field("smooth", 21, 17, 3, 30), exif=_exif6()),
    "xmp.avif": lambda: pil_avif(field("noise", 9, 11, 3, 31), xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"),
    "avis-2-frames.avif": lambda: _sequence(3),
    "avis-2-frames-rgba.avif": lambda: _sequence(4),
    # the timing textures and the sky of chip_smoke.py phase 17
    TIMING[0]: lambda: pil_avif(field("soft", 1024, 1024, 3, 0), speed=10),
    TIMING[1]: lambda: pil_avif(field("ramp", 1024, 1024, 4, 0), speed=10),
    SKY: lambda: pil_avif(_sky(), speed=8),
    # refused by name
    "lossy-q99-420.avif": lambda: pil_avif(field("smooth", 33, 65, 3, 32), quality=99),
    "lossy-q75-default.avif": lambda: pil_avif(field("smooth", 33, 65, 3, 33), quality=75),
    "intrabc-flat-speed6.avif": lambda: pil_avif(field("flat", 130, 200, 3, 3), speed=6),
    "matrix-fcc-444.avif": lambda: _matrix(pil_avif(field("noise", 7, 13, 3, 34), subsampling="4:4:4"), 4),
}
