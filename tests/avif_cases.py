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
`avis` sequence with and without alpha.

The `lossy-` cases are lossy AV1 (`quality` below 100): PIL's default 75
and quality 30 to 99, so that every coefficient-CDF set (qctx 0-3) is
reached; the default aom speed, speeds 5-10, and speeds 0 and 4 where
every plane's loop restoration type is none (speed 0 with 128x128
superblocks); every subsampling; RGBA with lossy alpha, premultiplied or
not; limited range; sizes from 1x1 to 200x300 (64x64 and 64x32
transforms), identity and 1D transform types, the reduced transform set
(`reduced-tx-type-set`), palette; per-plane delta q
(`enable-chroma-deltaq`), loop-filter sharpness, tiles, and delta q with
delta lf (`deltaq-mode` 3, `delta-lf-mode` 1).

Refused by name where PIL reads them: intra block copy (aom's pick for
flat graphics at speed 6), a matrix-coefficients value the port does not
convert (a `colr` box edited to FCC), loop restoration (aom at speed 4),
CDEF (`enable-cdef`), quantizer matrices (`enable-qm`),
and an `ispe` edited to another size than the frame's (libavif scales the
frame to it).  `REFUSED` maps each refused case to the words its refusal
holds.

`TIMING` are the three 1024x1024 textures chip_smoke.py phase 17 times
(lossless 4:2:0 RGB and RGBA, and PIL's default lossy 4:2:0), `SKY` the
1024x512 environment map it renders with (`default_sky`, tone-mapped to 8
bits).
"""

from __future__ import annotations

import io

import numpy as np

TIMING = ("timing-1024-soft-420.avif", "timing-1024-ramp-rgba.avif", "timing-1024-lossy-420.avif")
SKY = "sky-1024x512.avif"
REFUSED = {"intrabc-flat-speed6.avif": "allow_intrabc", "matrix-fcc-444.avif": "matrix coefficients 4",
           "refused-restoration-speed4.avif": "loop restoration", "refused-cdef.avif": "CDEF, a nonzero strength",
           "refused-qm.avif": "using_qmatrix", "refused-ispe-scaled.avif": "libavif scales the frame"}


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


def _ispe(data: bytes, w: int, h: int) -> bytes:
    """The file with its (first) ispe box edited to w x h."""
    at = data.find(b"ispe") + 8
    return data[:at] + w.to_bytes(4, "big") + h.to_bytes(4, "big") + data[at + 8 :]


def lossy(kind: str, h: int, w: int, ch: int, seed: int, quality: int, **kw) -> bytes:
    return pil_avif(field(kind, h, w, ch, seed), quality=quality, **kw)


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
    TIMING[2]: lambda: lossy("soft", 1024, 1024, 3, 1, 75),
    # lossy: quality and qctx (30, 40 -> 3; 75 -> 2; 90 -> 1; 99 -> 0)
    "lossy-q99-420.avif": lambda: lossy("smooth", 33, 65, 3, 32, 99),
    "lossy-q75-default.avif": lambda: lossy("smooth", 33, 65, 3, 33, 75),
    "lossy-q30-soft-256.avif": lambda: lossy("soft", 256, 256, 3, 35, 30),
    "lossy-q90-noise-96-speed5.avif": lambda: lossy("noise", 96, 96, 3, 36, 90, speed=5),
    # transform sizes and types: 64x64 / 64x32, rectangles, identity, 1D
    "lossy-q40-smooth-200x300-speed5.avif": lambda: lossy("smooth", 200, 300, 3, 3, 40, speed=5),
    "lossy-q40-noise-128-speed5.avif": lambda: lossy("noise", 128, 128, 3, 3, 40, speed=5),
    "lossy-q98-noise-64-speed7.avif": lambda: lossy("noise", 64, 64, 3, 3, 98, speed=7),
    "lossy-q95-noise-64-reduced-tx-set.avif": lambda: lossy("noise", 64, 64, 3, 3, 95, speed=6,
                                                            advanced={"reduced-tx-type-set": "1"}),
    "lossy-q75-palette-flat-96x96.avif": lambda: lossy("flat", 96, 96, 3, 3, 75, speed=6,
                                                       advanced={"enable-intrabc": "0"}),
    # aom speeds: 0 and 4 where no plane restores, 6, 8, 10
    "lossy-q90-noise-128-speed0-sb128.avif": lambda: lossy("noise", 128, 128, 3, 3, 90, speed=0),
    "lossy-q95-noise-64-speed4.avif": lambda: lossy("noise", 64, 64, 3, 3, 95, speed=4),
    "lossy-q60-smooth-65x33-speed6.avif": lambda: lossy("smooth", 33, 65, 3, 37, 60, speed=6),
    "lossy-q60-smooth-128-speed8.avif": lambda: lossy("smooth", 128, 128, 3, 38, 60, speed=8),
    "lossy-q60-smooth-128-speed10.avif": lambda: lossy("smooth", 128, 128, 3, 3, 60, speed=10),
    # subsampling, alpha, range, sizes
    "lossy-q75-422-smooth-65x33.avif": lambda: lossy("smooth", 33, 65, 3, 39, 75, subsampling="4:2:2"),
    "lossy-q75-444-noise-33x17.avif": lambda: lossy("noise", 17, 33, 3, 40, 75, subsampling="4:4:4"),
    "lossy-q75-400-smooth-65x33.avif": lambda: lossy("smooth", 33, 65, 3, 41, 75, subsampling="4:0:0"),
    "lossy-q75-rgba-420-smooth-65x33.avif": lambda: lossy("smooth", 33, 65, 4, 42, 75),
    "lossy-q60-rgba-premultiplied-noise-33x17.avif": lambda: lossy("noise", 17, 33, 4, 43, 60,
                                                                   alpha_premultiplied=True),
    "lossy-q75-limited-420-smooth-65x33.avif": lambda: lossy("smooth", 33, 65, 3, 44, 75, range="limited"),
    "lossy-q75-size-1x1.avif": lambda: lossy("noise", 1, 1, 3, 45, 75),
    "lossy-q50-size-2x3-444.avif": lambda: lossy("noise", 3, 2, 3, 46, 50, subsampling="4:4:4"),
    "lossy-q75-size-13x7.avif": lambda: lossy("smooth", 7, 13, 3, 47, 75),
    # per-plane delta q, sharpness, tiles, delta q and delta lf
    "lossy-q60-chroma-deltaq-96x128.avif": lambda: lossy("smooth", 96, 128, 3, 7, 60,
                                                         advanced={"enable-chroma-deltaq": "1"}),
    "lossy-q60-sharpness-7-96x128.avif": lambda: lossy("smooth", 96, 128, 3, 7, 60, advanced={"sharpness": "7"}),
    "lossy-q60-tiles-2x2-192x256.avif": lambda: lossy("smooth", 192, 256, 3, 7, 60, tile_rows=1, tile_cols=1, speed=8),
    "lossy-q50-deltaq-deltalf-noise-256.avif": lambda: lossy("noise", 256, 256, 3, 9, 50,
                                                             advanced={"deltaq-mode": "3", "delta-lf-mode": "1"}),
    # refused by name
    "intrabc-flat-speed6.avif": lambda: pil_avif(field("flat", 130, 200, 3, 3), speed=6),
    "matrix-fcc-444.avif": lambda: _matrix(pil_avif(field("noise", 7, 13, 3, 34), subsampling="4:4:4"), 4),
    "refused-restoration-speed4.avif": lambda: lossy("smooth", 128, 128, 3, 9, 75, speed=4),
    "refused-cdef.avif": lambda: lossy("smooth", 256, 256, 3, 9, 40, speed=6, advanced={"enable-cdef": "1"}),
    "refused-qm.avif": lambda: lossy("smooth", 96, 128, 3, 7, 60, advanced={"enable-qm": "1"}),
    "refused-ispe-scaled.avif": lambda: _ispe(pil_avif(field("noise", 7, 13, 3, 48), subsampling="4:4:4"), 14, 7),
}
