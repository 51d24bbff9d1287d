"""Random AVIF files against PIL: the port's AVIF decoding
(vpt_tpu_torch/io/avif.py) against PIL 12.1's `np.asarray(Image.open(f))`
on files PIL writes itself under random settings (subsampling 4:2:0 /
4:2:2 / 4:4:4 / 4:0:0, full or limited range, RGB or RGBA with alpha
premultiplied or not, explicit tiles or autotiling, sizes 1-160, noisy,
smooth, soft or flat-graphic content, and, for some flat files, screen
content tools with intra block copy off, which reaches palette): lossless
(`quality=100`, aom speed 0-10), or with `--lossy` quality 0-99 at the
default aom speed or 5-10.  Not part of tier-1 (it takes minutes):

    python tests/avif_sweep.py [--lossy] [FILES] [SEED] [OUT_DIR]
    python tests/avif_sweep.py --triples
    python tests/avif_sweep.py --corrupt [FILES] [SEED] [lossy]

Each file is "equal" (the same array), "refused" (the port refuses it by
name: intra block copy, which aom picks for some flat graphics) or
"differ"; with OUT_DIR each differing file is written there as
SEED-K.avif, to become a fixture of tests/torch_avif/ once repaired.  The
last line is a JSON object of the counts.

`--triples` holds the YUV -> RGB conversion to PIL's on the 4:4:4 data of a
4096x4096 image holding each of the 2^24 RGB triples once (full and limited
range): every YUV triple PIL's encoder makes of an RGB one reaches the
conversion.

`--corrupt` reports, for one-byte mutants of the valid fixtures of
tests/torch_avif/ (with `lossy`, of its lossy ones alone), how often the
port and PIL agree (both refuse, or equal arrays), where each refuses
alone, and where they differ; the port's route is PIL's (its AVIF plugin's
`_accept`, then the file), and a refusal by name of what the port does not
decode is counted apart ("port refuses by name").
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
import avif_cases  # noqa: E402
from vpt_tpu_torch.io import av1, avif  # noqa: E402


def random_file(rng, lossy: bool = False) -> tuple:
    """(the file's bytes, its settings) of one random lossless (or lossy) AVIF."""
    h, w = (int(v) for v in rng.integers(1, 161, 2))
    ch = int(rng.choice([3, 4]))
    kind = str(rng.choice(["noise", "smooth", "flat", "soft"]))
    kw = {"subsampling": str(rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])),
          "range": str(rng.choice(["full", "limited"])), "speed": int(rng.integers(0, 11)) if h * w < 4000
          else int(rng.integers(4, 11)), "alpha_premultiplied": bool(rng.integers(0, 2))}
    if lossy:
        kw["quality"] = int(rng.integers(0, 100))
        speed = int(rng.choice([-1, 5, 6, 7, 8, 9, 10]))
        if speed < 0:
            del kw["speed"]
        else:
            kw["speed"] = speed
    tiles = int(rng.integers(0, 3))
    if tiles == 1:
        kw.update(tile_rows=int(rng.integers(0, 3)), tile_cols=int(rng.integers(0, 3)), autotiling=False)
    elif tiles == 2:
        kw["autotiling"] = True
    if kind == "flat" and rng.integers(0, 2):
        kw["advanced"] = {"enable-intrabc": "0"}
    arr = avif_cases.field(kind, h, w, ch, int(rng.integers(0, 1 << 30)))
    return avif_cases.pil_avif(arr, **kw), {"size": [h, w], "channels": ch, "content": kind, **kw}


def sweep(n: int, seed: int, out_dir: str = None, lossy: bool = False) -> dict:
    from PIL import Image

    rng = np.random.default_rng(seed)
    counts = {"equal": 0, "refused": 0, "differ": 0}
    for k in range(n):
        data, settings = random_file(rng, lossy)
        want = np.asarray(Image.open(io.BytesIO(data)))
        try:
            got, _ = avif.read_pil(data, f"{seed}-{k}")
        except av1.Refused as e:
            counts["refused"] += 1
            if "allow_intrabc" not in str(e):
                print(f"{seed}-{k}: refused {e} {settings}")
            continue
        except Exception as e:  # noqa: BLE001  (any other failure is a difference)
            got = None
            print(f"{seed}-{k}: raised {e!r} {settings}")
        key = "equal" if got is not None and got.shape == want.shape and np.array_equal(got, want) else "differ"
        counts[key] += 1
        if key == "differ":
            print(f"{seed}-{k}: differs {settings}")
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(out_dir, f"{seed}-{k}.avif"), "wb") as f:
                    f.write(data)
    return counts


def triples() -> dict:
    """The 2^24 RGB triples as a 4096x4096 4:4:4 image, both ranges: the
    port's array against PIL's."""
    from PIL import Image

    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    out = {}
    for rng in ("full", "limited"):
        t0 = time.perf_counter()
        data = avif_cases.pil_avif(rgb, subsampling="4:4:4", range=rng, speed=10)
        want = np.asarray(Image.open(io.BytesIO(data)))
        got, _ = avif.read_pil(data, rng)
        out[rng] = {"bytes": len(data), "pixels_differing": int((got != want).any(-1).sum()),
                    "seconds": round(time.perf_counter() - t0, 1)}
    return out


def corrupt(n: int, seed: int, lossy: bool = False) -> dict:
    import warnings

    import gltf_scenes
    from PIL import Image

    from vpt_tpu_torch.io import probe

    rng = np.random.default_rng(seed)
    names = [f for f in gltf_scenes.avif_fixtures() if f not in avif_cases.REFUSED and f not in avif_cases.TIMING
             and (not lossy or f.startswith("lossy-"))]
    counts = {}
    for k in range(n):
        with open(os.path.join(gltf_scenes.AVIF_DIR, names[k % len(names)]), "rb") as f:
            data = bytearray(f.read())
        at = int(rng.integers(0, len(data)))
        where = "mdat" if at > data.find(b"mdat") else "boxes"
        data[at] = int(rng.integers(0, 256))
        named = False
        try:
            if not probe.ACCEPT["AVIF"](bytes(data)):
                raise ValueError("PIL's AVIF plugin does not accept it")
            got, _ = avif.read_pil(bytes(data), "mutant")
        except av1.Refused:
            got, named = None, True
        except ValueError as e:
            got, named = None, "Known, kept" in str(e)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = np.asarray(Image.open(io.BytesIO(bytes(data))))
        except Exception:  # noqa: BLE001  (PIL raises many kinds)
            want = None
        if got is None or want is None:
            key = "both refuse" if got is None and want is None else "PIL refuses" if want is None else \
                "port refuses by name" if named else "port refuses"
        else:
            key = "equal" if got.shape == want.shape and np.array_equal(got, want) else "differ"
        counts[f"{where}: {key}"] = counts.get(f"{where}: {key}", 0) + 1
    return counts


def main() -> None:
    if sys.argv[1:2] == ["--corrupt"]:
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 2000
        seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
        lossy = sys.argv[4:5] == ["lossy"]
        print(json.dumps({"corrupt": corrupt(n, seed, lossy), "files": n, "seed": seed, "lossy": lossy}))
        return
    if sys.argv[1:2] == ["--triples"]:
        print(json.dumps({"triples": triples()}))
        return
    args = sys.argv[1:]
    lossy = args[:1] == ["--lossy"]
    args = args[1:] if lossy else args
    n = int(args[0]) if len(args) > 0 else 500
    seed = int(args[1]) if len(args) > 1 else 0
    out_dir = args[2] if len(args) > 2 else None
    t0 = time.perf_counter()
    counts = sweep(n, seed, out_dir, lossy)
    print(json.dumps({"seed": seed, "files": n, "lossy": lossy, "counts": counts,
                      "seconds": round(time.perf_counter() - t0, 1)}))


if __name__ == "__main__":
    main()
