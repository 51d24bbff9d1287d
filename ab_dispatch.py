"""Captured s/dispatch of two trees of vpt_tpu_torch on one card, in turns.

    python3 ab_dispatch.py OTHER_ROOT [THIS_ROOT] [--baked]

OTHER_ROOT is the root of another checkout (e.g. a parent commit unpacked
with `git archive <commit> vpt_tpu_torch | tar -x -C .scratch/parent`; a
commit older than the port's own csrc/bvh_builder.cpp and csrc/lz4_block.c
needs `vpt_tpu/accel/cpp vpt_tpu/scene/cpp` too); THIS_ROOT defaults to
this checkout.  Each turn is a fresh process that builds its tree's
kernels and renders the stream, media and atmosphere paths of
chip_smoke.py (colonnade 512x512, 4 spp per dispatch, chip_smoke.py's
GRAPH_SEED): 2 warm-up dispatches, then 5 timed ones, each ending in a
device sync.  The energy-compensation fits are the constant fit, or with
--baked the 4,096-sample tables the default Renderer bakes (phase 4's
configuration), baked by the first turn into THIS_ROOT/.cache and read
from there by every turn, so both trees shade with the same tables.  The
turns run other, this, this, other; each prints one JSON line (its root,
per path the seconds, their median, the segments, the media loop steps,
the image's sum and the sha256 of its float32 bytes), and the card's name
and power limit come first.  Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

TIMED, WARM = 5, 2


def turn(root: str, cache: str | None) -> dict:
    """One process's measurements of the tree at `root`, with the baked
    tables of `cache` (None: the constant fit)."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from vpt_tpu_torch import Renderer, RenderFlags
    from vpt_tpu_torch.accel import kernels
    from vpt_tpu_torch.api import render_step
    from vpt_tpu_torch.render.lookup import get_lookup_tables
    from vpt_tpu_torch.scene.procedural import colonnade
    from vpt_tpu_torch.scene.types import Volume
    from vpt_tpu_torch.scene.vdb import procedural_cloud

    if not kernels.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {kernels.__file__}, not the tree at {root}")
    kernels.library()
    dev = torch.device("cuda")
    tables = None if cache is None else get_lookup_tables(cache_dir=cache, device=dev)

    def renderer(max_depth: int) -> Renderer:
        return Renderer(colonnade(), width=512, height=512,
                        flags=RenderFlags(max_depth=max_depth, max_medium_events=8), samples_per_frame=4,
                        lookup_tables=tables, device=dev)

    media = renderer(4)
    media.add_volume(Volume(corner_min=(-6, 3, -4), corner_max=(6, 9, 4), density=8.0, anisotropy=0.3,
                            density_grid=procedural_cloud((128, 128, 128), coverage=0.6)))
    media.add_volume(Volume(corner_min=(-17, 0, -7), corner_max=(17, 1.5, 7), density=0.05, color=(0.9, 0.9, 0.9)))
    atmo = renderer(8)
    atmo.set_enable_atmosphere(True)
    atmo.set_planet_position((0.0, -6360e3, 0.0))
    atmo.set_sky_altitude(30.0)
    out = {"root": root, "tables": "constant fit" if cache is None else "baked, 4096 samples"}
    for name, r in (("stream", renderer(8)), ("media", media), ("atmosphere", atmo)):
        zeros = torch.zeros((512, 512, 3), device=dev)
        times = []
        for i in range(WARM + TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, segs, stats = render_step(r.scene_data, r.meta, r.flags, r.params, 2654435761, (512, 512), zeros,
                                           0, 4)
            segs = int(segs)
            torch.cuda.synchronize()
            if i >= WARM:
                times.append(time.perf_counter() - t0)
        out[name] = {"s": times, "median_s": statistics.median(times), "segments": segs, "steps": stats.steps,
                     "img_sum": float(img.double().sum()),
                     "img_sha256": hashlib.sha256(img.float().contiguous().cpu().numpy().tobytes()).hexdigest()}
    return out


def main() -> int:
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--turn":
        print(json.dumps(turn(sys.argv[2], sys.argv[3] if len(sys.argv) == 4 else None)), flush=True)
        return 0
    args = [a for a in sys.argv[1:] if a != "--baked"]
    if len(args) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    other, this = args[0], args[1] if len(args) == 2 else os.path.dirname(os.path.abspath(__file__))
    cache = [os.path.join(os.path.abspath(this), ".cache")] if "--baked" in sys.argv[1:] else []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for root in (other, this, this, other):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root, *cache], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
