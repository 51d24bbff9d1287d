"""Captured dispatch steps: the port's counterpart of the JAX package's
compiled dispatch.

The JAX package builds one XLA program per configuration
(`vpt_tpu/api.py:71-111`, `_render_step` with `_STEP_CACHE`; the sharded
step's `functools.lru_cache`, `vpt_tpu/dist/mesh.py:58`) and passes the
per-dispatch values (`params`, `frame_seed`, `accum`, `frame_count`) to it
as arguments, so a camera move or a new seed compiles nothing; its loops
are `lax.while_loop`s on the device.  Here a `Step` holds one
configuration of the wavefront loop (render/integrator.py):

* `inputs`: device buffers of the per-dispatch values (the render
  parameters, the frame seed, the sample offset, the pixel arrays) that
  `load` copies each dispatch's values into, as JAX passes arguments;
* the carry: the loop's state, which each iteration reads and replaces;
* on a CUDA device, the whole loop as one instantiated CUDA graph
  (`LoopGraph`).  The first use runs one real iteration eagerly on a
  side stream (the kernels load, cuBLAS and the sorts warm up; the media
  loops read their host flags), then captures the iteration once, writing
  its result back into the carry's static buffers.  Each media loop it
  meets (render/loop.py) is a loop site: the capture closes the graph of
  the segment before it, captures ONE step of the loop as a graph of its
  own and opens the next segment, so an iteration with k sites is k + 1
  segment graphs and k step graphs, all in one memory pool (`Recorder`).
  They are assembled into

      cond(wavefront) WHILE(wavefront) { segment 0, cond(site 0),
          WHILE(site 0) { step 0, cond(site 0) }, segment 1, ...,
          the last segment, cond(wavefront) }

  where each cond is the hand-written kernel of csrc/graph_loop.cu that
  sets its WHILE node's condition, any(live) & (steps < cap), as
  `lax.while_loop` evaluates it: before the first body and after each.  A
  dispatch is one launch of that graph, and the host reads nothing until
  it ends; then it reads the loops' device tallies once (iterations, media
  loops entered, media steps), from which the kernel launch counts and
  `LoopStats` follow.  The iteration count, the media loop steps and the
  results equal an eager run's, bit for bit.

Why one pool and one capture pass, not a body split into functions: the
body runs once in Python while it is captured, so every tensor that a
later graph reads (a loop body's closure, a local the next segment reads)
is still referenced when that graph is captured and keeps its block, and
every block freed in the pass is reused only by graphs that run after it;
the body and the media modules stay one function each.

Steps are cached per key (`cached`), at most `STEPS_CAP` of them, first in
first out, as `_STEP_CACHE` does.  A step holds its owner's tensors (the
scene whose ids the key names) only by weak references: when one of them
is collected (its Renderer is gone, or a setter replaced the scene), the
step leaves the cache and its graphs and pool go with it, so no later
object can take its key's ids.  A failed capture, assembly or launch
raises: nothing retries on the host.  On a CPU device and with `CAPTURE`
False every iteration runs eagerly through the same buffers, the host
reading `any(alive)` before each; on a CPU tensor the dispatch graph runs
as its plain version (`run_plain`, the tests' stand-in for graphs).

A graph runs no Python, so the kernel wrappers' launch counts
(accel/kernels.LAUNCHES) cannot move in it: `Recorder.end` takes back what
the wrappers counted while a graph was captured, and after a launch the
device tallies say how often each graph ran.  Nothing here runs at import
time.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import time
import weakref

import torch

from vpt_tpu_torch.accel import kernels
from vpt_tpu_torch.render import loop

CAPTURE = True  # False runs every iteration eagerly on the card too (for A/B runs and tests)
STEPS_CAP = 8
MIN_CUDA = 12040  # child-graph and kernel nodes inside conditional bodies
_STEPS: dict = {}
_versions_checked = False


def leaves(tree) -> tuple:
    """The leaves of a (nested) NamedTuple, in order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(leaf for x in tree for leaf in leaves(x))
    return (tree,)


def leaf_ids(tree) -> tuple:
    """The ids of the leaves of a (nested) NamedTuple, in order."""
    return tuple(id(leaf) for leaf in leaves(tree))


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


def cached(key, make, owner) -> "Step":
    """The step of `key`, made by `make()` on a miss; the oldest of
    STEPS_CAP entries goes first.  The step leaves the cache when a leaf of
    `owner` (the tensors whose ids the key names) is collected."""
    step = _STEPS.get(key)
    if step is None:
        if len(_STEPS) >= STEPS_CAP:
            _STEPS.pop(next(iter(_STEPS)))
        step = _STEPS[key] = make()
        held = weakref.ref(step)

        def drop(_, key=key):
            if key in _STEPS and _STEPS[key] is held():
                del _STEPS[key]

        step.watch = [weakref.ref(leaf, drop) for leaf in leaves(owner)]
    return step


def clear() -> None:
    """Drop every cached step and its graph."""
    _STEPS.clear()


def steps() -> list:
    """The cached steps, oldest first."""
    return list(_STEPS.values())


def add_launches(launches: dict, times: int) -> None:
    """Count `times` runs of a graph holding `launches` kernel launches."""
    for k, n in launches.items():
        kernels.LAUNCHES[k] += n * times


class Recorder:
    """Captures work into CUDA graphs that share one memory pool, one graph
    at a time, in the order in which they will run: a tensor that one graph
    writes and a later one reads keeps its block, and a block freed inside
    the sequence is reused only by graphs that run after its last reader.
    The graphs are kept (`keep_graph`), not instantiated: the dispatch
    graph holds them as child graphs.  `end` returns the graph and the
    kernel launches it holds: what the wrappers counted while it was
    captured is taken back, since capturing launches nothing.  The
    thread-local error mode refuses a synchronising call from this thread
    only, so another thread's CUDA calls (a process group's watchdog) go
    on."""

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
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError as e:
            raise RuntimeError(f"torch {torch.__version__}: torch.cuda.CUDAGraph takes no keep_graph, which the "
                               "dispatch graph needs") from e
        ctx = torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local")
        ctx.__enter__()
        return graph, ctx

    def _end_graph(self, opened):
        graph, ctx = opened
        ctx.__exit__(None, None, None)
        return graph


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
    """A media loop inside a captured iteration: the graph of one step of
    its body and the kernel launches it holds, its carry (buffers of the
    step's pool that the segment before the site fills), its cap and, for
    the check against the eager iteration, the function of its body."""

    graph: object
    launches: dict
    carry: dict
    max_steps: int
    body: str


# The nodes of a dispatch graph, in the order they run.  A node is a
# captured graph (run once), a `Cond` or a `While`.

@dataclasses.dataclass
class Cond:
    """The loop condition (csrc/graph_loop.cu vpt_loop_cond_kernel): with
    `reset`, steps <- 0 and counts[0] += 1 (the loop is entered); then
    go = any(live) & (steps < cap); where go, steps += 1 and counts[1] += 1;
    the condition of WHILE node `handle` <- go."""

    live: torch.Tensor
    steps: torch.Tensor
    cap: int
    handle: int
    reset: bool
    counts: torch.Tensor


@dataclasses.dataclass
class While:
    """body runs while the condition of `handle` holds, which the Cond just
    upstream sets first and the body's last Cond after each run."""

    handle: int
    body: list


def plan(segments: list, sites: list, alive: torch.Tensor, iters: torch.Tensor, cap: int,
         site_steps: torch.Tensor, counts: torch.Tensor) -> list:
    """The dispatch graph's nodes: the wavefront loop (handle 0, tallies in
    counts[0]) over the segments, with the WHILE node of site j (handle
    j + 1, step counter site_steps[j], tallies in counts[j + 1]) between
    segments j and j + 1."""
    body = []
    for j, (segment, site) in enumerate(zip(segments, sites)):
        live, h = site.carry["live"], j + 1
        body += [segment, Cond(live, site_steps[j], site.max_steps, h, True, counts[h]),
                 While(h, [site.graph, Cond(live, site_steps[j], site.max_steps, h, False, counts[h])])]
    wavefront = Cond(alive, iters, cap, 0, False, counts[0])
    return [wavefront, While(0, body + [segments[-1], wavefront])]


def run_plain(nodes: list, handles: dict) -> None:
    """The dispatch graph's plain version: each Cond through loop.cond, each
    graph (a stand-in with `replay`, as the CPU tests capture) run once."""
    for node in nodes:
        if isinstance(node, Cond):
            if node.reset:
                node.steps.zero_()
                node.counts[0] += 1
            go = loop.cond(node.live, node.steps, node.cap)
            if go:
                node.steps += 1
                node.counts[1] += 1
            handles[node.handle] = go
        elif isinstance(node, While):
            while handles[node.handle]:
                run_plain(node.body, handles)
        else:
            node.replay()


def _call(name: str, *args) -> None:
    err = kernels.library()[name](*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")


def check_versions() -> None:
    """Raise unless the CUDA driver and runtime are MIN_CUDA or later."""
    global _versions_checked
    if _versions_checked:
        return
    cuda_driver, runtime = ctypes.c_int(), ctypes.c_int()
    _call("vpt_graph_versions", ctypes.addressof(cuda_driver), ctypes.addressof(runtime))
    if min(cuda_driver.value, runtime.value) < MIN_CUDA:
        raise RuntimeError(f"the dispatch graph's WHILE nodes need CUDA {MIN_CUDA // 1000}.{MIN_CUDA % 1000 // 10} "
                           f"or later: CUDA driver {cuda_driver.value}, runtime {runtime.value}")
    _versions_checked = True


# cudaGraphNodeType values, for the error a torch graph's node raises.
NODE_TYPES = {3: "host", 6: "wait event", 7: "event record", 8: "external semaphore signal",
              9: "external semaphore wait", 10: "memory alloc", 11: "memory free", 12: "batch memory op"}


def assemble(nodes: list):
    """Build the dispatch graph of `nodes` with csrc/graph_loop.cu and
    instantiate it: (graph, exec) handles.  Each torch graph is walked
    first; a node type that a conditional body may not hold raises,
    naming it.  A WHILE node's handle is made in the graph of its first
    Cond, the one upstream of it."""
    check_versions()
    graph = ctypes.c_void_p()
    _call("vpt_graph_create", ctypes.addressof(graph))
    handles = {}
    try:
        _build(graph, nodes, handles)
        exe = ctypes.c_void_p()
        _call("vpt_graph_instantiate", graph, ctypes.addressof(exe))
    except BaseException:
        kernels.library()["vpt_graph_destroy"](graph, None)
        raise
    return graph.value, exe.value


def _build(graph, nodes: list, handles: dict) -> None:
    dep = None
    for node in nodes:
        out = ctypes.c_void_p()
        if isinstance(node, Cond):
            if node.handle not in handles:
                h = ctypes.c_ulonglong()
                _call("vpt_graph_handle", graph, ctypes.addressof(h))
                handles[node.handle] = h.value
            live = kernels.ptr(node.live, torch.bool)
            if live % 16:
                raise ValueError("a loop's live mask must be 16-byte aligned")
            _call("vpt_graph_add_cond", graph, dep, live, node.live.numel(), kernels.ptr(node.steps, torch.int64),
                  node.cap, handles[node.handle], int(node.reset), kernels.ptr(node.counts, torch.int64),
                  ctypes.addressof(out))
        elif isinstance(node, While):
            body = ctypes.c_void_p()
            _call("vpt_graph_add_while", graph, dep, handles[node.handle], ctypes.addressof(body),
                  ctypes.addressof(out))
            _build(body, node.body, handles)
        else:
            raw = node.raw_cuda_graph()
            bad = ctypes.c_int()
            _call("vpt_graph_bad_node", raw, ctypes.addressof(bad))
            if bad.value >= 0:
                raise RuntimeError(f"a captured graph holds a {NODE_TYPES.get(bad.value, 'type %d' % bad.value)} "
                                   "node, which a conditional body may not hold")
            _call("vpt_graph_add_child", graph, dep, raw, ctypes.addressof(out))
        dep = out


def device_nodes(graph) -> int:
    """The kernel, memcpy and memset nodes of a captured torch graph: the
    device events one replay of it runs."""
    counts = (ctypes.c_longlong * 3)()
    _call("vpt_graph_count_nodes", graph.raw_cuda_graph(), ctypes.addressof(counts))
    return sum(counts)


def _destroy(graph, exe) -> None:
    with contextlib.suppress(Exception):
        kernels.library()["vpt_graph_destroy"](graph, exe)


class DispatchGraph:
    """`nodes` as one graph: on a CUDA device assembled and instantiated,
    keeping `held` (the graphs whose clones it runs) as long as it lives;
    on the CPU run as `run_plain`.  `launch` runs it once."""

    def __init__(self, nodes: list, device, held=()):
        self.nodes = nodes
        self.held = list(held)
        self.cuda = torch.device(device).type == "cuda"
        self.exec = None
        if self.cuda:
            graph, self.exec = assemble(nodes)
            weakref.finalize(self, _destroy, graph, self.exec)


def launch(graph: DispatchGraph) -> None:
    """One run of a dispatch graph on the current stream (its plain version
    off CUDA)."""
    if graph.cuda:
        _call("vpt_graph_launch", graph.exec, torch.cuda.current_stream().cuda_stream)
    else:
        run_plain(graph.nodes, {})


class LoopGraph(DispatchGraph):
    """A step's loop (`plan`) over its captured graphs, which it keeps with
    their pool and static carry.  `iters` is the wavefront loop's counter
    (the host sets it to the iterations already run), `site_steps` the
    media loops' and `counts` the loops' tallies, [entered, steps] per loop,
    the wavefront first."""

    def __init__(self, step: "Step", cap: int):
        alive = step.carry["alive"]
        dev = alive.device
        self.segment_launches = [launches for _, launches in step.segments]
        self.site_launches = [s.launches for s in step.sites]
        self.iters = torch.zeros((), dtype=torch.int64, device=dev)
        self.site_steps = torch.zeros((len(step.sites),), dtype=torch.int64, device=dev)
        self.counts = torch.zeros((len(step.sites) + 1, 2), dtype=torch.int64, device=dev)
        segments = [g for g, _ in step.segments]
        super().__init__(plan(segments, step.sites, alive, self.iters, cap, self.site_steps, self.counts), dev,
                         held=segments + [s.graph for s in step.sites])

    def run(self, done: int, stats: loop.LoopStats) -> None:
        """Run the loop on from `done` iterations: one launch, then one host
        read of the tallies, which count the kernels' launches and the media
        loops into `stats`."""
        self.iters.fill_(done)
        self.counts.zero_()
        launch(self)
        tallies = self.counts.tolist()  # the dispatch's one host read, after the launch
        stats.launch_reads += 1
        iters = tallies[0][1]
        entered, steps = [t[0] for t in tallies[1:]], [t[1] for t in tallies[1:]]
        for launches in self.segment_launches:
            add_launches(launches, iters)
        for launches, n in zip(self.site_launches, steps):
            add_launches(launches, n)
        if self.cuda:
            kernels.LAUNCHES["loop_cond"] += 1 + iters + sum(entered) + sum(steps)
        stats.loops += sum(entered)
        stats.steps += sum(steps)


class Step:
    """One configuration of the loop: `body(scene, carry, inputs, stats) ->
    carry`, its input buffers and, once captured, the segments of the body
    between its media loops, a `Site` per loop and the dispatch graph over
    them.  `watch` holds weak references to the owner's tensors
    (`cached`)."""

    def __init__(self, body, inputs: dict):
        self.body = body
        self.inputs = inputs
        self.carry = None
        self.segments = []  # (graph, launches) per segment: one more than the sites
        self.sites = []
        self.graph = None  # the LoopGraph
        self.capture_seconds = None
        self.pool_bytes = None  # memory_reserved taken by the capture (the graphs' pool)
        self.captures = 0
        self.replays = 0  # launches of the dispatch graph
        self.watch = []
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
        """Begin a dispatch at `carry`; with `capture`, its loop runs as the
        dispatch graph (captured at the first dispatch)."""
        self._capture = capture
        if capture and self._static is not None:
            write(self._static, carry)
            self.carry = self._static
        else:
            self.carry = carry

    def run(self, scene, max_iters: int, stats: loop.LoopStats) -> dict:
        """The dispatch's loop: carry = body(carry) while any(alive), at most
        max_iters times.  Returns the final carry."""
        if self._capture and self.graph is not None:
            self.graph.run(0, stats)
            self.replays += 1
            return self.carry
        for i in range(max_iters):
            stats.syncs += 1
            if not bool(self.carry["alive"].any()):
                break
            if self._capture:  # the first dispatch: one eager iteration, the capture, the graph for the rest
                self._warm_and_capture(scene, stats, max_iters)
                self.graph.run(1, stats)
                self.replays += 1
                break
            self.carry = self.body(scene, self.carry, self.inputs, stats)
        return self.carry

    def _warm_and_capture(self, scene, stats: loop.LoopStats, max_iters: int) -> None:
        dev = self.carry["alive"].device
        loops = stats.loops
        with _side_stream(dev):
            carry = self.body(scene, self.carry, self.inputs, stats)  # the dispatch's real iteration
        loops = stats.loops - loops
        self._static = {k: v.clone() for k, v in carry.items()}
        self.carry = self._static
        del carry
        reserved = _settle(dev)
        t0 = time.perf_counter()
        rec, segments, sites = Recorder(), [], []

        def site(body, carry, max_steps):
            """A loop met while capturing: the segment before it ends with
            the loop's carry in buffers of the pool; one step of the loop is
            a graph of its own; the next segment begins and reads the
            loop's carry."""
            static = {k: v.clone() for k, v in carry.items()}
            segments.append(rec.end())
            rec.begin()
            write(static, body(static))
            graph, launches = rec.end()
            sites.append(Site(graph, launches, static, max_steps, body.__qualname__))
            rec.begin()
            return static

        try:
            with loop.recording(site):
                rec.begin()
                write(self._static, self.body(scene, self._static, self.inputs, None))
                segments.append(rec.end())
        except BaseException:
            rec.abort()
            raise
        if len(sites) != loops:
            raise RuntimeError(f"the captured iteration met {len(sites)} media loops, the eager one {loops}")
        self.segments, self.sites = segments, sites
        self.graph = LoopGraph(self, max_iters)
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
