"""Toy dispatch graphs of render/graphs.py: WHILE loops over seeded live
schedules, for holding the loop condition (csrc/graph_loop.cu
vpt_loop_cond_kernel, its plain version render/loop.py:cond) to
`lax.while_loop`'s iteration count.  Imports no JAX: `chip_smoke.py` builds
the same toys on the card, the CPU tests run them through
`graphs.run_plain` with a Tape per graph.

A lane j of a loop dies at its step death[j]: the loop's live mask after
step k is death > k, so `lax.while_loop` with cond (i < cap) & any(live)
runs min(cap, max(death)) steps (0 where no lane is alive at entry).  The
nested toy runs an inner loop inside each outer step k (the outer
counter at k + 1 inside its body, as the condition counts a step before
the body runs) over the lanes with death_in > k + 1 + i after inner step
i."""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.render import graphs, loop

# (lanes, cap, how the deaths are drawn): cap 0, every lane dead at entry,
# lanes alive at the cap, and random schedules.
SCHEDULES = {
    "cap0": (64, 0, "random"),
    "all_dead": (64, 7, "dead"),
    "alive_at_cap": (64, 5, "long"),
    "random_a": (1000, 40, "random"),
    "random_b": (17, 12, "random"),
    "one_lane": (1, 9, "random"),
    "wavefront": (262_144, 72, "random"),
}


def deaths(name: str, seed: int = 0) -> tuple:
    """(death steps (lanes,) int64, cap) of schedule `name`."""
    n, cap, kind = SCHEDULES[name]
    rng = np.random.default_rng(seed)
    if kind == "dead":
        d = np.zeros(n, np.int64)
    elif kind == "long":
        d = rng.integers(cap + 1, 3 * cap + 2, n)
    else:
        d = np.where(rng.random(n) < 0.3, 0, rng.integers(0, max(cap, 1) + 6, n))
    return d.astype(np.int64), cap


def expected(death: np.ndarray, cap: int) -> int:
    """lax.while_loop's step count of the single toy."""
    i = 0
    while i < cap and (death > i).any():
        i += 1
    return i


def expected_nested(death_out: np.ndarray, cap_out: int, death_in: np.ndarray, cap_in: int) -> tuple:
    """(outer steps, inner loops entered, inner steps) of the nested toy."""
    k, inner = 0, 0
    while k < cap_out and (death_out > k).any():
        k += 1
        i = 0
        while i < cap_in and (death_in > k + i).any():
            i += 1
        inner += i
    return k, k, inner


def _graph(recorder, fn):
    recorder.begin()
    fn()
    return recorder.end()[0]


def single(death: torch.Tensor, cap: int, recorder) -> tuple:
    """The single toy's nodes and (live, steps, counts): a graph sets
    live = death > 0, the Cond upstream of the WHILE node starts the loop
    and its body is a graph (live = death > steps) and the Cond."""
    dev = death.device
    live = torch.zeros(death.shape, dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    init = _graph(recorder, lambda: live.copy_(death > 0))
    body = _graph(recorder, lambda: live.copy_(death > steps))
    nodes = [init, graphs.Cond(live, steps, cap, 0, True, counts),
             graphs.While(0, [body, graphs.Cond(live, steps, cap, 0, False, counts)])]
    return nodes, (live, steps, counts)


def nested(death_out: torch.Tensor, cap_out: int, death_in: torch.Tensor, cap_in: int, recorder) -> tuple:
    """The nested toy's nodes and its tallies (counts_out, counts_in)."""
    dev = death_out.device
    live_out = torch.zeros(death_out.shape, dtype=torch.bool, device=dev)
    live_in = torch.zeros(death_in.shape, dtype=torch.bool, device=dev)
    k, i = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
    c_out, c_in = (torch.zeros((2,), dtype=torch.int64, device=dev) for _ in range(2))
    init_out = _graph(recorder, lambda: live_out.copy_(death_out > 0))
    init_in = _graph(recorder, lambda: live_in.copy_(death_in > k))
    body_in = _graph(recorder, lambda: live_in.copy_(death_in > k + i))
    body_out = _graph(recorder, lambda: live_out.copy_(death_out > k))
    inner = graphs.While(1, [body_in, graphs.Cond(live_in, i, cap_in, 1, False, c_in)])
    nodes = [init_out, graphs.Cond(live_out, k, cap_out, 0, True, c_out),
             graphs.While(0, [init_in, graphs.Cond(live_in, i, cap_in, 1, True, c_in), inner, body_out,
                              graphs.Cond(live_out, k, cap_out, 0, False, c_out)])]
    return nodes, (c_out, c_in)


def plain_count(death: torch.Tensor, cap: int) -> int:
    """The single toy's step count through loop.cond on `death`'s device,
    the host reading the condition before each step."""
    steps = torch.zeros((), dtype=torch.int64, device=death.device)
    live = death > 0
    while loop.cond(live, steps, cap):
        steps += 1
        live = death > steps
    return int(steps)
