"""Bounded stochastic loops over the wavefront: the port of the media
modules' `lax.while_loop(cond, body, carry)` with
cond = (i < max_steps) & any(carry["live"]).

The step count decides the random streams: every step advances the RNG of
every lane, dead lanes included, so a lane's state after the loop depends
on how long the slowest lane ran.  `while_live` runs exactly the JAX
package's count of steps.  The host cannot see `any(live)` without a
synchronisation, so it reads it once per CHUNK steps: inside a chunk each
step's update is kept only where any(live) held at the step's start, which
makes the steps past the loop's end change nothing.
"""

from __future__ import annotations

import dataclasses

import torch

CHUNK = 8  # steps issued between two host reads of the loop's flag


@dataclasses.dataclass
class LoopStats:
    """What the loops of one caller ran: loop calls, steps (as
    `lax.while_loop` counts its iterations) and host synchronisations."""

    loops: int = 0
    steps: int = 0
    syncs: int = 0


def while_live(body, carry: dict, max_steps: int, stats: LoopStats) -> dict:
    """carry = body(carry) while any(carry["live"]), at most max_steps times.
    Every value of `carry` is a tensor; `body` returns the same keys."""
    stats.loops += 1
    steps = torch.zeros((), dtype=torch.int64, device=carry["live"].device)
    issued = 0
    while issued < max_steps:
        stats.syncs += 1
        any_live, n_run = torch.stack([carry["live"].any().to(torch.int64), steps]).tolist()
        if not any_live:
            stats.steps += n_run
            return carry
        for _ in range(min(CHUNK, max_steps - issued)):
            go = carry["live"].any()
            new = body(carry)
            carry = {k: torch.where(go, new[k], v) for k, v in carry.items()}
            steps = steps + go.to(torch.int64)
            issued += 1
    # The cap: the last chunk's lanes may still have died inside it.
    stats.syncs += 1
    stats.steps += int(steps)
    return carry
