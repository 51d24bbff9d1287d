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
* on a CUDA device, its iteration as CUDA graphs.  The first use runs
  one real iteration eagerly on a side stream (the kernels load, cuBLAS
  and the sorts warm up; the media loops read their host flags), then
  captures the iteration once, writing its result back into the carry's
  static buffers; every later iteration is replayed.  Without media the
  iteration is one graph.  Each media loop it meets (render/loop.py) is a
  loop site: the capture closes the graph of the segment before it,
  captures one CHUNK of the loop's steps as a graph of its own and opens
  the next segment, so an iteration with k sites is k + 1 segment graphs
  and k chunk graphs, all in one memory pool (`Recorder`), replayed
  segment 0, chunks of site 0, segment 1, ..., the last segment.  Between
  the chunk replays the host reads the loop's flag as the eager loop
  does, and between iterations it reads `alive.any()`, so the iteration
  count, the media loop steps, the host syncs and the results equal an
  eager run's, bit for bit.

Why one pool and one capture pass, not a body split into functions: the
body runs once in Python while it is captured, so every tensor that a
later graph reads (a loop body's closure, a local the next segment reads)
is still referenced when that graph is captured and keeps its block, and
every block freed in the pass is reused only by graphs that replay after
it; the body and the media modules stay one function each, and the
eager loop and the captured one share `loop.drive`.

Steps are cached per key (`cached`), at most `STEPS_CAP` of them, first in
first out, each holding strong references to what its key's ids name, as
`_STEP_CACHE` does.  A failed capture or replay raises: nothing retries
eagerly.  On a CPU device and with `CAPTURE` False the iteration runs
eagerly through the same buffers.

A replay runs no Python, so the kernel wrappers' launch counts
(accel/kernels.LAUNCHES) cannot move in it: `Recorder.end` takes back what
the wrappers counted while a graph was captured and `replay` adds it per
replay, a chunk graph's at each chunk.  Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import torch

from vpt_tpu_torch.accel import kernels
from vpt_tpu_torch.render import loop

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


class Recorder:
    """Captures work into CUDA graphs that share one memory pool, one graph
    at a time, in the order in which they will replay: a tensor that one
    graph writes and a later one reads keeps its block, and a block freed
    inside the sequence is reused only by graphs that replay after its last
    reader.  `end` returns the graph and the kernel launches it holds: what
    the wrappers counted while it was captured is taken back, since
    capturing launches nothing.  The thread-local error mode refuses a
    synchronising call from this thread only, so another thread's CUDA
    calls (a process group's watchdog) go on."""

    def __init__(self):
        self.pool = None
        self._open = None  # (what _begin_graph returned,) while a capture is open
        self._before = None

    def begin(self) -> None:
        self._before = dict(kernels.LAUNCHES)
        self._open = (self._begin_graph(),)

    def end(self):
        """(graph, launches by kernel) of the capture begun last."""
        (opened,), self._open = self._open, None
        try:
            graph = self._end_graph(opened)
        finally:
            launches = {k: kernels.LAUNCHES[k] - n for k, n in self._before.items()}
            kernels.LAUNCHES.update(self._before)
        return graph, launches

    def abort(self) -> None:
        """End a capture left open by an error; the error it raises is the
        first one's consequence, so it is dropped."""
        if self._open is not None:
            with contextlib.suppress(Exception):
                self.end()

    def _begin_graph(self):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        ctx = torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local")
        ctx.__enter__()
        return graph, ctx

    def _end_graph(self, opened):
        graph, ctx = opened
        ctx.__exit__(None, None, None)
        return graph


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


@dataclasses.dataclass
class Site:
    """A media loop inside a captured iteration: the graph of one CHUNK of
    its steps and the kernel launches it holds, its carry, step counter and
    flag (buffers of the step's pool that the segment before the site
    fills), its cap and, for the check against the eager iteration, the
    function of its body."""

    graph: object
    launches: dict
    carry: dict
    steps: torch.Tensor
    flag: torch.Tensor
    max_steps: int
    body: str

    def run(self, stats: loop.LoopStats) -> None:
        """The loop's host side: chunk replays while a lane is live."""
        loop.drive(lambda: self.flag, lambda n: replay(self.graph, self.launches), self.max_steps, stats)


class Step:
    """One configuration of the loop: `body(carry, inputs, stats) -> carry`,
    its input buffers and, once captured, its iteration as graphs: the
    segments of the body between its media loops, and a `Site` per loop,
    replayed segment 0, site 0, segment 1, ..., the last segment.  `owner`
    holds what the cache key's ids name."""

    def __init__(self, body, inputs: dict, owner=None):
        self.body = body
        self.inputs = inputs
        self.owner = owner
        self.carry = None
        self.segments = []  # (graph, launches) per segment: one more than the sites
        self.sites = []
        self.capture_seconds = None
        self.pool_bytes = None  # memory_reserved taken by the capture (the graphs' pool)
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
        as replays of the captured graphs (captured at the first one)."""
        self._capture = capture
        if capture and self._static is not None:
            write(self._static, carry)
            self.carry = self._static
        else:
            self.carry = carry

    def advance(self, stats: loop.LoopStats) -> None:
        """One iteration of the loop."""
        if not self._capture:
            self.carry = self.body(self.carry, self.inputs, stats)
        elif not self.segments:
            self._warm_and_capture(stats)
        else:
            for (graph, launches), site in zip(self.segments, self.sites + [None]):
                replay(graph, launches)
                if site is not None:
                    site.run(stats)
            self.replays += 1

    def _warm_and_capture(self, stats: loop.LoopStats) -> None:
        dev = self.carry["alive"].device
        loops = stats.loops
        with _side_stream(dev):
            carry = self.body(self.carry, self.inputs, stats)  # the dispatch's real iteration
        loops = stats.loops - loops
        self._static = {k: v.clone() for k, v in carry.items()}
        self.carry = self._static
        del carry
        reserved = _settle(dev)
        t0 = time.perf_counter()
        rec, segments, sites = Recorder(), [], []

        def site(body, carry, max_steps):
            """A loop met while capturing: the segment before it ends with
            the loop's carry, step counter and flag in buffers of the pool;
            one chunk of the loop is a graph of its own; the next segment
            begins and reads the loop's carry."""
            if max_steps % loop.CHUNK:
                raise ValueError(f"a captured loop's cap {max_steps} is not a multiple of CHUNK = {loop.CHUNK}")
            static = {k: v.clone() for k, v in carry.items()}
            steps = torch.zeros((), dtype=torch.int64, device=dev)
            flag = loop.flag(static, steps)
            segments.append(rec.end())
            rec.begin()
            out, run = loop.gated_steps(body, static, steps, loop.CHUNK)
            write(static, out)
            steps.copy_(run)
            flag.copy_(loop.flag(static, steps))
            graph, launches = rec.end()
            sites.append(Site(graph, launches, static, steps, flag, max_steps, body.__qualname__))
            rec.begin()
            return static

        try:
            with loop.recording(site):
                rec.begin()
                write(self._static, self.body(self._static, self.inputs, None))
                segments.append(rec.end())
        except BaseException:
            rec.abort()
            raise
        if len(sites) != loops:
            raise RuntimeError(f"the captured iteration met {len(sites)} media loops, the eager one {loops}")
        self.segments, self.sites = segments, sites
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
