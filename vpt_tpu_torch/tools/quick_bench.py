"""One layout's timing: a compile and first dispatch, then a few timed
dispatches on a named scene (the port's counterpart of
scripts/quick_bench.py).

    [VPT_* knobs] python -m vpt_tpu_torch.tools.quick_bench [size] [spp] [scene] [--device cuda|cpu]

Defaults: colonnade, 512x512, 4 spp per dispatch, max_depth 8,
max_medium_events 8, the constant energy-compensation fit (as the JAX
script compiles its scene), on the card.  The layout knobs bind at import
(VPT_CLUSTER_SIZE, VPT_GROUP_SIZE, VPT_PACKET_SIZE, VPT_SORT_KEY,
VPT_SORT_RAYS, VPT_TRACE), so a sweep runs this module once per layout
(`sweep_bench`).  Prints the layout, the compile-and-first-dispatch
seconds, each timed dispatch's seconds and M segs/s, one line

    RESULT <K>/<sort key>/<packet>/<trace>: median <x> M segs/s

(the sort key reads "unsorted" under VPT_SORT_RAYS=0), and as its last
line the device: the card's name and power limit from nvidia-smi.  Wall
times are the host's clock around dispatches that end in a device wait;
with --device cpu they are CPU times, for tests.
"""

from __future__ import annotations

import argparse
import statistics
import time

from vpt_tpu_torch.accel import cluster
from vpt_tpu_torch.render import integrator
from vpt_tpu_torch.tools.common import FLAGS, bench_scene, device_line, dispatch

TIMED = 3  # dispatches timed after the first


def layout_label() -> str:
    """<K>/<sort key>/<packet>/<trace> of the knobs as they stand."""
    key = cluster._SORT_KEY if integrator._SORT_RAYS else "unsorted"
    return f"{cluster.CLUSTER_SIZE}/{key}/{cluster.PACKET_SIZE}/{integrator.TRACE_MODE}"


def run(size: int = 512, spp: int = 4, scene: str = "colonnade", device="cuda", out=print) -> dict:
    """Compile `scene`, dispatch once, then TIMED times at new seeds;
    returns the rates (M segs/s), their median and the layout label."""
    t0 = time.perf_counter()
    data, meta, params = bench_scene(scene, device)
    acc, _ = dispatch(data, meta, FLAGS, params, 1, size, spp)
    cl = data.clusters
    out(f"layout: K={cluster.CLUSTER_SIZE} groups of {cluster.GROUP_SIZE} packets of {cluster.PACKET_SIZE} "
        f"sort key {cluster._SORT_KEY} sorted {integrator._SORT_RAYS} trace {integrator.TRACE_MODE}; "
        f"{meta.n_tris} triangles, {cl.count.shape[0]} clusters, {cl.group_min.shape[0]} groups")
    out(f"compile+first: {time.perf_counter() - t0:.1f}s  clusters={cl.count.shape[0]}")
    rates = []
    for i in range(TIMED):
        t0 = time.perf_counter()
        acc, segs = dispatch(data, meta, FLAGS, params, 2 + i, size, spp, acc)
        dt = time.perf_counter() - t0
        rates.append(segs / dt / 1e6)
        out(f"dispatch {i}: {dt:.3f}s  {segs} segments  {rates[-1]:.3f} M segs/s")
    label = layout_label()
    median = statistics.median(rates)
    out(f"RESULT {label}: median {median:.3f} M segs/s")
    return {"label": label, "rates": rates, "median": median, "size": size, "spp": spp, "scene": scene}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("size", nargs="?", type=int, default=512)
    parser.add_argument("spp", nargs="?", type=int, default=4)
    parser.add_argument("scene", nargs="?", default="colonnade")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback from one to the other")
    args = parser.parse_args(argv)
    run(args.size, args.spp, args.scene, args.device, out=lambda s: print(s, flush=True))
    print(device_line(args.device), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
