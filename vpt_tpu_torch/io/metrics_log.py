"""Per-dispatch metrics log as JSON lines (port of vpt_tpu/io/metrics_log.py).

Every progressive dispatch of a `Renderer(metrics_log=path)` appends one
record, so a long render leaves a machine-readable trace of throughput and
convergence:

    r = Renderer(scene, metrics_log="render_log.jsonl")

A record holds ts, event ("dispatch", or any tag passed to `write`), frame,
seed, spp, wall_s, segments, segs_per_s, samples_accumulated, resolution
and scene, with the JAX package's keys and rounding.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional


class RenderLog:
    """Append-only JSON-lines writer; `null()` counts records and writes none."""

    def __init__(self, fh: Optional[IO[str]], path: Optional[str] = None):
        self._fh = fh
        self.path = path
        self.records = 0
        self._t_open = time.time()

    @classmethod
    def open(cls, path: str) -> "RenderLog":
        return cls(open(path, "a", buffering=1), path)

    @classmethod
    def null(cls) -> "RenderLog":
        return cls(None)

    def write(self, event: str, **fields) -> dict:
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        self.records += 1
        return rec

    def dispatch(self, *, frame, seed, spp, wall_s, segments, samples_accumulated, resolution, scene) -> dict:
        return self.write(
            "dispatch",
            frame=int(frame),
            seed=int(seed),
            spp=int(spp),
            wall_s=round(float(wall_s), 4),
            segments=float(segments),
            segs_per_s=round(float(segments) / max(float(wall_s), 1e-9), 1),
            samples_accumulated=int(samples_accumulated),
            resolution=list(resolution),
            scene=str(scene),
        )

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
