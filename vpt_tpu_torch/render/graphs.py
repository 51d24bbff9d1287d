"""Captured dispatch steps: the port's counterpart of the JAX package's
compiled dispatch.

The JAX package builds one XLA program per configuration
(`vpt_tpu/api.py:71-111`, `_render_step` with `_STEP_CACHE`; the sharded
step's `functools.lru_cache`, `vpt_tpu/dist/mesh.py:58`) and passes the
per-dispatch values (`params`, `frame_seed`, `accum`, `frame_count`) to it
as arguments, so a camera move or a new seed compiles nothing.  Here a
`Step` holds one configuration of the wavefront loop
(render/integrator.py):

* `inputs`: device buffers of the per-dispatch values (the render
  parameters, the frame seed, the sample offset, the pixel arrays) that
  `load` copies each dispatch's values into, as JAX passes arguments;
* the carry: the loop's state, which each iteration reads and replaces;
* on a CUDA device, a `torch.cuda.CUDAGraph` of one iteration.  Its first
  use runs one real iteration eagerly on a side stream (the kernels load,
  cuBLAS and the sorts warm up), then captures the iteration once, writing
  its result back into the carry's static buffers; every later iteration
  is one `replay()`.  The host still reads `alive.any()` between replays,
  so the iteration count, the host syncs and the results equal an eager
  run's, bit for bit.

Steps are cached per key (`cached`), at most `STEPS_CAP` of them, first in
first out, each holding strong references to what its key's ids name, as
`_STEP_CACHE` does.  A failed capture or replay raises: nothing retries
eagerly.  On a CPU device, with `CAPTURE` False, and for a loop with media
(whose loops read a host flag inside an iteration) the iteration runs
eagerly through the same buffers.

A replay runs no Python, so the kernel wrappers' launch counts
(accel/kernels.LAUNCHES) cannot move in it: `capture` takes back what the
wrappers counted while the iteration was captured and `replay` adds it per
replay.  Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from vpt_tpu_torch.accel import kernels

CAPTURE = True  # False runs every iteration eagerly on the card too (for A/B runs and tests)
STEPS_CAP = 8
_STEPS: dict = {}


def leaf_ids(tree) -> tuple:
    """The ids of the leaves of a (nested) NamedTuple, in order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(i for x in tree for i in leaf_ids(x))
    return (id(tree),)


def buffer(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A step's own device buffer of `dtype`, holding `value` (a tensor or a
    number)."""
    return torch.as_tensor(value, dtype=dtype, device=device).clone()


def assign(buf: torch.Tensor, value) -> None:
    """Write `value` into `buf` on the device: a tensor is copied, a number
    filled in (no host-to-device copy)."""
    if torch.is_tensor(value):
        buf.copy_(value)
    else:
        buf.fill_(float(value) if buf.is_floating_point() else int(value))


def capturable(device) -> bool:
    return CAPTURE and torch.device(device).type == "cuda"


def cached(key, make) -> "Step":
    """The step of `key`, made by `make()` on a miss; the oldest of
    STEPS_CAP entries goes first."""
    step = _STEPS.get(key)
    if step is None:
        if len(_STEPS) >= STEPS_CAP:
            _STEPS.pop(next(iter(_STEPS)))
        step = _STEPS[key] = make()
    return step


def clear() -> None:
    """Drop every cached step and its graph."""
    _STEPS.clear()


def steps() -> list:
    """The cached steps, oldest first."""
    return list(_STEPS.values())


def _record(fn) -> torch.cuda.CUDAGraph:
    """Capture fn's work on the current device into a new graph.  The
    thread-local mode refuses a synchronising call from this thread only, so
    another thread's CUDA calls (a process group's watchdog) go on."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    return graph


def capture(fn):
    """(graph, launches): fn captured into a graph, and the kernel launches
    the graph holds by kernel.  fn's Python runs once; what the wrappers
    counted in it is taken back, since capturing launches nothing."""
    before = dict(kernels.LAUNCHES)
    try:
        graph = _record(fn)
    finally:
        launches = {k: kernels.LAUNCHES[k] - n for k, n in before.items()}
        kernels.LAUNCHES.update(before)
    return graph, launches


def replay(graph, launches: dict) -> None:
    graph.replay()
    for k, n in launches.items():
        kernels.LAUNCHES[k] += n


def write(static: dict, out: dict) -> None:
    """static[k] <- out[k] on the device for every key.  An output that is
    (a view of) another static buffer is cloned first, so no copy reads a
    buffer that an earlier copy overwrote."""
    held = {v.untyped_storage().data_ptr() for v in static.values()}
    out = {k: v.clone() if v is not static[k] and v.untyped_storage().data_ptr() in held else v
           for k, v in out.items()}
    for k, v in out.items():
        if v is not static[k]:
            static[k].copy_(v)


class Step:
    """One configuration of the loop: `body(carry, inputs, stats) -> carry`,
    its input buffers and, once captured, its graph.  `owner` holds what
    the cache key's ids name."""

    def __init__(self, body, inputs: dict, owner=None):
        self.body = body
        self.inputs = inputs
        self.owner = owner
        self.carry = None
        self.graph = None
        self.launches = {}  # kernel -> launches per replay
        self.capture_seconds = None
        self.pool_bytes = None  # memory_reserved taken by the capture (the graph's pool)
        self.captures = 0
        self.replays = 0
        self._static = None
        self._capture = False

    def load(self, **values) -> None:
        """Copy this dispatch's values into the input buffers (a tuple of
        values into a tuple of buffers)."""
        for name, value in values.items():
            buf = self.inputs[name]
            for b, v in zip(buf, value) if isinstance(buf, tuple) else ((buf, value),):
                assign(b, v)

    def start(self, carry: dict, capture: bool) -> None:
        """Begin a dispatch at `carry`; with `capture`, its iterations run
        as replays of the captured graph (captured at the first one)."""
        self._capture = capture
        if capture and self._static is not None:
            write(self._static, carry)
            self.carry = self._static
        else:
            self.carry = carry

    def advance(self, stats) -> None:
        """One iteration of the loop."""
        if not self._capture:
            self.carry = self.body(self.carry, self.inputs, stats)
        elif self.graph is None:
            self._warm_and_capture(stats)
        else:
            replay(self.graph, self.launches)
            self.replays += 1

    def _warm_and_capture(self, stats) -> None:
        dev = self.carry["alive"].device
        with _side_stream(dev):
            carry = self.body(self.carry, self.inputs, stats)  # the dispatch's real iteration
        self._static = {k: v.clone() for k, v in carry.items()}
        self.carry = self._static
        del carry
        reserved = _settle(dev)
        t0 = time.perf_counter()
        self.graph, self.launches = capture(lambda: write(self._static, self.body(self._static, self.inputs, None)))
        self.pool_bytes = _settle(dev) - reserved
        self.capture_seconds = time.perf_counter() - t0
        self.captures += 1


@contextlib.contextmanager
def _side_stream(device):
    """Run the block on a side stream of a CUDA device, ordered after and
    before the current stream's work (the warm-up that capturing wants)."""
    if device.type != "cuda":
        yield
        return
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


def _settle(device) -> int:
    """Wait for the device, free the allocator's unused blocks and return
    the bytes it still reserves (0 off CUDA)."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)
