"""A sweep of quick_bench over layouts, one subprocess per configuration,
because the knobs bind at import (the port's counterpart of
scripts/sweep_bench.py).

    python -m vpt_tpu_torch.tools.sweep_bench [size] [spp] [--scene colonnade] [--device cuda|cpu]
                                              [--configs k64,k128,...]

CONFIGS differ from the JAX script's: its list sets VPT_SUPER_ROWS, which
nothing in vpt_tpu/ reads any more.  This one sweeps the knobs the port
reads: K = VPT_CLUSTER_SIZE in {64, 128, 256} on the stream path, and on
the packet path (VPT_TRACE=packet) VPT_PACKET_SIZE in {256, 512, 1024}
with VPT_SORT_KEY in {fs, fe}.  `--configs` runs the named subset, in
order.  Each configuration's last lines are echoed, then a summary: one
RESULT line per configuration (FAILED where it found none) and, last, the
device line of the first configuration that printed one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = [
    ("k64", {"VPT_CLUSTER_SIZE": "64"}),
    ("k128", {"VPT_CLUSTER_SIZE": "128"}),
    ("k256", {"VPT_CLUSTER_SIZE": "256"}),
] + [
    (f"packet{p}-{key}", {"VPT_TRACE": "packet", "VPT_PACKET_SIZE": str(p), "VPT_SORT_KEY": key})
    for p in (256, 512, 1024) for key in ("fs", "fe")
]


def sweep(size: str, spp: str, scene: str, device: str, labels=None, timeout: float = 2700, out=print) -> list:
    """Run quick_bench once per configuration (all, or those named in
    `labels`): [(label, RESULT line or "FAILED", the device line or None)]."""
    configs = dict(CONFIGS)
    chosen = labels or [label for label, _ in CONFIGS]
    unknown = [label for label in chosen if label not in configs]
    if unknown:
        raise ValueError(f"unknown configurations {unknown}; known: {[label for label, _ in CONFIGS]}")
    results = []
    for label in chosen:
        env = dict(os.environ)
        env.update(configs[label])
        out(f"=== {label}: {configs[label]} ===")
        proc = subprocess.run(
            [sys.executable, "-m", "vpt_tpu_torch.tools.quick_bench", size, spp, scene, "--device", device],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=timeout,
        )
        lines = proc.stdout.strip().splitlines()
        for line in lines[-5:]:
            out(f"    {line}")
        res = [line for line in lines if line.startswith("RESULT")]
        ok = proc.returncode == 0 and res
        results.append((label, res[-1] if ok else "FAILED", lines[-1] if ok else None))
        if proc.returncode != 0:
            out(proc.stderr[-1500:])
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("size", nargs="?", default="512")
    parser.add_argument("spp", nargs="?", default="4")
    parser.add_argument("--scene", default="colonnade")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback from one to the other")
    parser.add_argument("--configs", default=None, help="comma-separated labels of CONFIGS to run (default: all)")
    args = parser.parse_args(argv)
    labels = args.configs.split(",") if args.configs else None
    results = sweep(args.size, args.spp, args.scene, args.device, labels, out=lambda s: print(s, flush=True))
    print("\n=== sweep summary ===")
    for label, res, _ in results:
        print(f"{label:20s} {res}")
    print(next((dev for _, _, dev in results if dev), "no configuration named its device"), flush=True)
    return 0 if all(res != "FAILED" for _, res, _ in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
