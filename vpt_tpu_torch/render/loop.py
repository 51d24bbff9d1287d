"""Bounded stochastic loops over the wavefront: the port of the media
modules' `lax.while_loop(cond, body, carry)` with
cond = (i < max_steps) & any(carry["live"]).

The step count decides the random streams: every step advances the RNG of
every lane, dead lanes included, so a lane's state after the loop depends
on how long the slowest lane ran.  `while_live` runs exactly the JAX
package's count of steps.

`while_live` is the one place where a loop runs.  Eagerly (a CPU device,
or graphs.CAPTURE False), the host cannot see `any(live)` without a
synchronisation, so it reads it once per CHUNK steps (`drive`): inside a
chunk each step's update is kept only where any(live) held at the step's
start, which makes the steps past the loop's end change nothing.  While
render/graphs.py captures an iteration of the wavefront loop
(`recording`), it hands the loop to the capture as a loop site instead:
the capture closes the graph it was recording, captures one plain step of
the loop as a graph of its own and opens the next, and the dispatch graph
runs that step in a WHILE node whose condition is `cond`, evaluated on the
device (csrc/graph_loop.cu) as `lax.while_loop` evaluates it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

CHUNK = 8  # steps issued between two host reads of the loop's flag


@dataclasses.dataclass
class LoopStats:
    """What the loops of one caller ran: loop calls, steps (as
    `lax.while_loop` counts its iterations), host synchronisations inside
    the loops (`syncs`) and host reads after a dispatch graph's launch
    (`launch_reads`, render/graphs.py)."""

    loops: int = 0
    steps: int = 0
    syncs: int = 0
    launch_reads: int = 0


_capture = threading.local()  # .site while this thread captures an iteration


@contextlib.contextmanager
def recording(site):
    """Inside the block, `while_live` on this thread hands each loop to
    `site(body, carry, max_steps)` and returns what it returns."""
    outer = getattr(_capture, "site", None)
    _capture.site = site
    try:
        yield
    finally:
        _capture.site = outer


def cond(live: torch.Tensor, steps: torch.Tensor, cap: int) -> bool:
    """`lax.while_loop`'s condition of a loop: any(live) & (steps < cap).
    The plain version of csrc/graph_loop.cu vpt_loop_cond_kernel, which
    sets a WHILE node's condition to it on the device."""
    return bool(live.any()) and int(steps) < cap


def flag(carry: dict, steps: torch.Tensor) -> torch.Tensor:
    """[any(live), steps run] as one int64 tensor: what the host reads
    between two chunks."""
    return torch.stack([carry["live"].any().to(torch.int64), steps])


def gated_steps(body, carry: dict, steps: torch.Tensor, n: int):
    """n steps of the loop, each kept only where any(live) held at its
    start: (carry, steps run)."""
    for _ in range(n):
        go = carry["live"].any()
        new = body(carry)
        carry = {k: torch.where(go, new[k], v) for k, v in carry.items()}
        steps = steps + go.to(torch.int64)
    return carry, steps


def drive(read, run_chunk, max_steps: int, stats: LoopStats) -> None:
    """The host's side of one loop: read the flag (`read()`, a `flag`
    tensor), and while a lane is live and fewer than max_steps were issued,
    run another chunk (`run_chunk(n)`, n steps).  Counts the loop, its steps
    and its host reads into `stats`."""
    stats.loops += 1
    issued = 0
    while issued < max_steps:
        stats.syncs += 1
        any_live, n_run = read().tolist()
        if not any_live:
            stats.steps += n_run
            return
        n = min(CHUNK, max_steps - issued)
        run_chunk(n)
        issued += n
    # The cap: the last chunk's lanes may still have died inside it.
    stats.syncs += 1
    stats.steps += int(read()[1])


def while_live(body, carry: dict, max_steps: int, stats: Optional[LoopStats] = None) -> dict:
    """carry = body(carry) while any(carry["live"]), at most max_steps times.
    Every value of `carry` is a tensor; `body` returns the same keys.  The
    loop's counts go to `stats` (to none when None)."""
    site = getattr(_capture, "site", None)
    if site is not None:
        return site(body, carry, max_steps)
    run = {"carry": carry, "steps": torch.zeros((), dtype=torch.int64, device=carry["live"].device)}

    def chunk(n):
        run["carry"], run["steps"] = gated_steps(body, run["carry"], run["steps"], n)

    drive(lambda: flag(run["carry"], run["steps"]), chunk, max_steps, LoopStats() if stats is None else stats)
    return run["carry"]
