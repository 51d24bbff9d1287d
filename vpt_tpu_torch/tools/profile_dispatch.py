"""Profile one render dispatch and print where its device time goes (the
port's counterpart of scripts/profile_dispatch.py).

    python -m vpt_tpu_torch.tools.profile_dispatch [size] [spp] [scene] [--device cuda|cpu]

Defaults: colonnade, 256x256, 2 spp per dispatch, max_depth 8,
max_medium_events 8 (the JAX script's), on the card.  Prints the segments
per dispatch, the wall of one dispatch and its M segs/s, the device time
per lane (a lane is one CUDA stream) and each lane's top 30 ops by summed
device time with their counts, as the JAX script does; then the summed
device ms of the graphs' replays beside the device ms of one unprofiled
launch of the same step at the same seed (one CUDA event pair around it,
taken before and after the profiled run) and their ratio.  The launch also
holds the idle time between its graph nodes, which the kernels' sum does
not: on an H100 80GB HBM3 the same step's launch read 341-419 ms, within
and between processes, at a constant 342-346 ms of kernels (PERF.md §7).

On a CUDA device a dispatch is one launch of its step's dispatch graph
(render/graphs.py), and CUPTI does not see every kernel that runs inside the
graph's WHILE nodes (PERF.md §7).  So the profiled dispatch drives the
step's own captured torch graphs from the host: `graphs.run_plain` over the
dispatch graph's nodes, each torch graph replayed as it is and each loop
condition read by the host (`loop.cond`).  The kernels, buffers and results
are the launch's; the loop condition kernel alone does not run.  The first
line printed says so.  The tool checks that the profiled run and the launch
trace the same segments, and prints the profile's device events beside the
device work the graphs' replays ran: the kernel, memcpy and memset nodes of
each torch graph times its replays (graphs.device_nodes).  The profile also
holds the host's condition reads, a few events per loop condition.  With
--device cpu the dispatch runs eagerly and the profile is of CPU ops (their
self times; the lane is the host), for the tests; there is no launch to
compare with.
"""

from __future__ import annotations

import argparse
import collections
import re
import time

import torch

from vpt_tpu_torch.api import tiled_pixels
from vpt_tpu_torch.render import graphs, integrator
from vpt_tpu_torch.tools.common import FLAGS, bench_scene, device_line, dispatch

TOP = 30
# The csrc kernels by the names the profiler gives them.
CSRC_KERNELS = {
    "ray_keys": r"ray_keys_kernel<",
    "supertile_tables": r"supertile_tables_kernel<",
    "stream": r"trace_kernel<false",
    "occlude": r"trace_kernel<true",
    "visit": r"visit_kernel<",
    "loop_cond": r"vpt_loop_cond_kernel",
}
HOST_DRIVEN = ("profiled dispatch: the step's captured torch graphs replayed from the host (graphs.run_plain; "
               "CUPTI does not see every kernel inside the dispatch graph's WHILE nodes), the loop conditions read "
               "by the host, so the loop condition kernel does not run")
EAGER_CPU = "profiled dispatch: eager on the CPU, CPU ops (self times); no dispatch graph, no launch to compare"


def csrc_kernel(name: str):
    """The csrc kernel an op name is, or None."""
    return next((k for k, pat in CSRC_KERNELS.items() if re.search(pat, name)), None)


def _events(prof, cuda: bool):
    """(lane, name, ms) of each device event (CUDA) or CPU op (self time)."""
    if cuda:
        return [(f"cuda:{e.device_index} stream {e.thread}", e.name, e.time_range.elapsed_us() / 1e3)
                for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [("host", e.name, e.self_cpu_time_total / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU]


def launch_ms(step) -> float:
    """Device ms of one launch of the step's dispatch graph, by one CUDA
    event pair around it (the tallies zeroed first, as LoopGraph.run does)."""
    graph = step.graph
    graph.iters.fill_(0)
    graph.counts.zero_()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graphs.launch(graph)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def replayed_nodes(step) -> int:
    """The device work the last run of the step's dispatch graph replayed:
    its segment graphs' kernel, memcpy and memset nodes once per wavefront
    iteration, each media loop's step graph's once per step (the tallies
    the run's conditions kept)."""
    tallies = step.graph.counts.tolist()
    per_iteration = sum(graphs.device_nodes(g) for g, _ in step.segments)
    return tallies[0][1] * per_iteration + sum(
        t[1] * graphs.device_nodes(site.graph) for t, site in zip(tallies[1:], step.sites))


def host_driven(step) -> None:
    """The step's dispatch graph run from the host: graphs.run_plain over its
    nodes with the real torch graphs, from zeroed tallies."""
    graph = step.graph
    graph.iters.fill_(0)
    graph.counts.zero_()
    graphs.run_plain(graph.nodes, {})
    torch.cuda.synchronize()


def profile_step(scene_data, meta, flags, params, size: int, spp: int, seed: int = 3, top: int = TOP,
                 out=print) -> dict:
    """Profile the dispatch of (scene, flags, params) at `seed`, size x size,
    spp samples, after a first dispatch (which captures, on the card) and a
    timed one.  Returns the numbers it prints."""
    from torch.profiler import ProfilerActivity, profile

    dev = params.view_inverse.device
    cuda = dev.type == "cuda"
    out(HOST_DRIVEN if cuda else EAGER_CPU)
    acc, segs = dispatch(scene_data, meta, flags, params, 1, size, spp)
    out(f"segments per dispatch: {segs}")
    t0 = time.perf_counter()
    acc, segs = dispatch(scene_data, meta, flags, params, 2, size, spp, acc)
    wall = time.perf_counter() - t0
    out(f"wall: {wall * 1e3:.1f} ms  ({segs / wall / 1e6:.3f} M segs/s)")
    res = {"segments": segs, "wall_s": wall, "segments_per_s": segs / wall}
    if cuda:
        pxy, pidx, _, _ = tiled_pixels(size, size, dev)

        def load():  # the dispatch's step, loaded at `seed` and started, as render_step loads it
            step = integrator.dispatch_step(scene_data, meta, flags, params, pxy, pidx, (size, size), seed, spp)
            if step.graph is None:
                raise RuntimeError("the step holds no dispatch graph: profile_dispatch profiles captured steps "
                                   "(graphs.CAPTURE is False?)")
            return step

        step = load()
        res["launch_before_ms"] = launch_ms(step)
        launched = int(step.carry["segments"])
        host_driven(load())  # the first replay of each torch graph instantiates it
        step = load()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            host_driven(step)
        profiled = int(step.carry["segments"])
        if profiled != launched:
            raise RuntimeError(f"the host-driven dispatch traced {profiled} segments, the launch {launched}")
        res["replayed_nodes"] = replayed_nodes(step)
        res["launch_ms"] = launch_ms(load())
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            dispatch(scene_data, meta, flags, params, seed, size, spp)
    events = _events(prof, cuda)
    if not events:
        raise RuntimeError("the profile holds no device events")
    lanes = collections.defaultdict(float)
    ops = collections.defaultdict(lambda: [0.0, 0])
    for lane, name, ms in events:
        lanes[lane] += ms
        ops[(lane, name)][0] += ms
        ops[(lane, name)][1] += 1
    out("\nlanes:")
    for lane, ms in sorted(lanes.items(), key=lambda kv: -kv[1]):
        out(f"  {lane}: {ms:.1f} ms")
    tops = {}
    for lane in sorted(lanes, key=lambda k: -lanes[k]):
        agg = sorted(((name, v) for (ln, name), v in ops.items() if ln == lane), key=lambda kv: -kv[1][0])[:top]
        tops[lane] = [(name, ms, n) for name, (ms, n) in agg]
        out(f"\ntop ops in '{lane}' ({lanes[lane]:.1f} ms total):")
        for name, (ms, n) in agg:
            out(f"  {ms:9.2f} ms  x{n:<5d} {name[:110]}")
    total = sum(lanes.values())
    share = collections.defaultdict(lambda: [0.0, 0])
    for _, name, ms in events:
        k = csrc_kernel(name)
        if k:
            share[k][0] += ms
            share[k][1] += 1
    res.update(device_ms=total, events=len(events), lanes=dict(lanes), top=tops,
               csrc={k: {"ms": share[k][0], "count": share[k][1], "share": share[k][0] / total}
                     for k in CSRC_KERNELS})
    out("\ncsrc kernels: " + ", ".join(f"{k} {v['ms']:.2f} ms x{v['count']} ({100 * v['share']:.2f}%)"
                                      for k, v in res["csrc"].items()))
    if cuda:
        res["ratio"] = total / res["launch_ms"]
        out(f"device events in the profile {len(events)}; kernel, memcpy and memset nodes the graphs' replays ran "
            f"{res['replayed_nodes']} ({len(events) / res['replayed_nodes'] - 1:+.2%}; the profile also holds the "
            "host's condition reads)")
        out(f"profile device ms {total:.2f}; WHILE launch device ms {res['launch_ms']:.2f} (one CUDA event pair, "
            f"same step, seed {seed}, after the profiled run; {res['launch_before_ms']:.2f} before it); "
            f"ratio {res['ratio']:.4f}")
    else:
        out(f"profile CPU ms {total:.2f}; WHILE launch device ms: not measured (CPU)")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("size", nargs="?", type=int, default=256)
    parser.add_argument("spp", nargs="?", type=int, default=2)
    parser.add_argument("scene", nargs="?", default="colonnade")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback from one to the other")
    args = parser.parse_args(argv)
    data, meta, params = bench_scene(args.scene, args.device)
    profile_step(data, meta, FLAGS, params, args.size, args.spp, out=lambda s: print(s, flush=True))
    print(device_line(args.device), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
