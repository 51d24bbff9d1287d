"""Benchmark: path segments/s of the port on one CUDA card.

    python -m vpt_tpu_torch bench

The measurement of the JAX package's root `bench.py`, on the card: the
colonnade (~334K triangles) at 512x512, depth 8, `max_medium_events` 8,
4 spp per dispatch; one warm-up dispatch, then at least 8 kept timed
dispatches, each timed on the host clock around a dispatch that ends in a
device sync.  A dispatch whose rate is over 3x or under 1/3 of the running
median is discarded and re-run (at most 24 in all), and once 4 are kept
the early ones are screened against the median the same way.  `value` is
the median rate of the kept dispatches.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"};
`detail.device` is the card's name and power limit as `nvidia-smi` reports
them.  It refuses to run with any VPT_* variable set (envguard), and on a
machine without a CUDA device it fails: it never falls back to the CPU.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.core.camera import perspective
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.envguard import require_clean_env
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene.build import compile_scene
from vpt_tpu_torch.scene.procedural import colonnade

BASELINE_SEGMENTS_PER_SEC = 200e6  # BASELINE.json's north star, segments/s per chip
N_TARGET = 8
MAX_TOTAL = 24
WIDTH = HEIGHT = 512
SPP_PER_DISPATCH = 4


def card_description(index: int = 0) -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def screen(kept: list, rate: float) -> bool:
    """Whether a dispatch at `rate` is kept: always while fewer than 3 are
    kept, else within 3x of their median rate."""
    if len(kept) < 3:
        return True
    med = float(np.median([k[0] for k in kept]))
    return med / 3.0 <= rate <= 3.0 * med


def prune(kept: list) -> list:
    """The kept dispatches within 3x of their median rate (once 4 are kept),
    so that an outlier among the first 3, before the screen arms, goes."""
    if len(kept) < 4:
        return kept
    med = float(np.median([k[0] for k in kept]))
    return [k for k in kept if med / 3.0 <= k[0] <= 3.0 * med]


def summarize(kept: list, discarded: int, n_tris: int, device: str) -> dict:
    """The JSON line from the kept (rate, segments, seconds) dispatches."""
    rates = [k[0] for k in kept]
    value = float(np.median(rates))
    median_dt = float(np.median([k[2] for k in kept]))
    spread = max(rates) / max(min(rates), 1e-9)
    return {
        "metric": "path_segments_per_sec_per_chip",
        "value": value,
        "unit": "segments/s",
        "vs_baseline": value / BASELINE_SEGMENTS_PER_SEC,
        "detail": {
            "scene": "colonnade",
            "median_segments_per_sec": value,
            "max_segments_per_sec": max(rates),
            "min_segments_per_sec": min(rates),
            "spread": round(spread, 2),
            "n_tris": n_tris,
            "resolution": [WIDTH, HEIGHT],
            "spp_per_dispatch": SPP_PER_DISPATCH,
            "dispatches": len(kept),
            "discarded": discarded,
            "elapsed_s": round(sum(k[2] for k in kept), 3),
            "total_segments": sum(k[1] for k in kept),
            "median_dispatch_s": round(median_dt, 4),
            "time_to_1024spp_s": round(-(-1024 // SPP_PER_DISPATCH) * median_dt, 1),
            "device": device,
        },
    }


def main(device="cuda") -> dict:
    """Run the measurement on `device` (a CUDA device), print the JSON line
    and return it."""
    require_clean_env()
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the benchmark measures a CUDA device, not {dev}")
    described = card_description(dev.index or 0)

    data, meta, aux = compile_scene(colonnade(), dev)  # the constant fits, as the JAX bench compiles it
    proj = perspective(np.radians(aux["camera_fov_deg"]), WIDTH / HEIGHT)
    params = default_params(dev, np.linalg.inv(aux["camera_view"]), np.linalg.inv(proj))
    flags = RenderFlags(max_depth=8, max_medium_events=8)

    def dispatch(seed, accum, frame):
        out, segs, _ = render_step(data, meta, flags, params, seed, (WIDTH, HEIGHT), accum, frame, SPP_PER_DISPATCH)
        return out, float(segs)  # float() waits for the dispatch

    out, _ = dispatch(1, torch.zeros((HEIGHT, WIDTH, 3), device=dev), 0)  # warm-up
    kept, discarded, i = [], 0, 0
    while len(kept) < N_TARGET and i < MAX_TOTAL:
        t0 = time.perf_counter()
        out, segs = dispatch(2 + i, out, 1 + i)
        dt = time.perf_counter() - t0
        i += 1
        rate = segs / dt
        if not screen(kept, rate):
            discarded += 1
            print(f"discarding outlier dispatch: {rate / 1e6:.2f} M segs/s", flush=True)
            continue
        kept.append((rate, segs, dt))
        pruned = prune(kept)
        if len(pruned) != len(kept):
            discarded += len(kept) - len(pruned)
            print(f"retro-discarding {len(kept) - len(pruned)} early outlier(s)", flush=True)
            kept = pruned
    line = summarize(kept, discarded, meta.n_tris, described)
    if line["detail"]["spread"] > 3.0:
        print(f"WARNING: dispatch rate spread {line['detail']['spread']:.1f}x > 3x: noisy run", flush=True)
    print(json.dumps(line), flush=True)
    return line
