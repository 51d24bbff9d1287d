"""The captured dispatch step (vpt_tpu_torch/render/graphs.py) on the CPU.

* The loop body is free of host synchronisation: one iteration of the
  reduced colonnade of test_torch_render.py in the stream and the packet
  mode, under a guard that makes every synchronising call (Tensor.__bool__,
  __int__, __float__, __index__, .item, .tolist, nonzero, argwhere,
  masked_select, unique, boolean-mask indexing) raise on a tensor with
  elements; the guard is lifted inside the kernels' *_plain versions only,
  which never run on the card.
* One step, many dispatches: the step is built once and serves two
  dispatches with another camera, sky rotation, frame seed, frame count and
  sample offset; each agrees with the JAX package on the same inputs
  (test_torch_render.py's bar: PSNR > 40 dB on [0, 10], 99% of pixels
  within rtol 1e-3 / atol 1e-4, segments within 1%) and equals, bit for bit,
  a step built fresh for it.
* The same two dispatches through the capture path, with a tape in place
  of each CUDA graph (the CPU has no graphs; `Tape`): the captured Python
  runs once, and a replay runs the recorded aten ops again on the same
  tensors, the dispatch graph's WHILE nodes replaying their body tapes
  while the plain condition holds (`graphs.run_plain`): bitwise the eager
  dispatches, one capture, every dispatch one run of the dispatch
  graph.  A media configuration captures too.
* The cache: a new scene, resolution, flags, sample count or trace mode
  adds an entry, new parameters do not, and a ninth entry evicts the first.
* Launch accounting, with a stub graph: capturing counts nothing, and the
  launches counted while capturing are added once per run of the graph
  (the dispatch graph's tallies); a failed capture restores the counts
  and raises.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_render import SEED, _assert_images_agree
from vpt_tpu.api import _render_step
from vpt_tpu.core import tiling as jtiling
from vpt_tpu.core.camera import look_at as jlook_at
from vpt_tpu.core.camera import perspective
from vpt_tpu.render import integrator as jintegrator
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.render.params import default_params as jparams
from vpt_tpu.scene.build import compile_scene
from vpt_tpu.scene.procedural import colonnade, cornell_box
from vpt_tpu_torch.accel import envelope, kernels, occlude, stream, visit
from vpt_tpu_torch.api import render_step, tiled_pixels
from vpt_tpu_torch.core.tiling import scatter_to_image
from vpt_tpu_torch.render import graphs, integrator
from vpt_tpu_torch.render.loop import LoopStats
from vpt_tpu_torch.render.params import RenderFlags, default_params, scalar
from vpt_tpu_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

W = H = 16
FLAGS = dict(max_depth=3, max_medium_events=8)
PLAIN = [(envelope, "ray_keys_plain"), (envelope, "supertile_tables_plain"), (stream, "stream_trace_plain"),
         (occlude, "occlude_trace_plain"), (visit, "visit_trace_plain")]
SYNCING_METHODS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "nonzero")
SYNCING_FUNCTIONS = ("nonzero", "argwhere", "masked_select", "unique")


class HostSync(AssertionError):
    """A synchronising call in the loop body."""


@contextlib.contextmanager
def sync_guard():
    """Every synchronising call on a tensor with elements raises HostSync,
    except inside the kernels' plain versions."""
    plain_depth = [0]

    def armed(x):
        return plain_depth[0] == 0 and torch.is_tensor(x) and x.numel() > 0

    def method(name, orig):
        def guarded(self, *args, **kwargs):
            if armed(self):
                raise HostSync(f"Tensor.{name} on a tensor of shape {tuple(self.shape)}")
            return orig(self, *args, **kwargs)
        return guarded

    def function(name, orig):
        def guarded(x, *args, **kwargs):
            if armed(x):
                raise HostSync(f"torch.{name} on a tensor of shape {tuple(x.shape)}")
            return orig(x, *args, **kwargs)
        return guarded

    def has_mask(index):
        index = index if isinstance(index, tuple) else (index,)
        return any(torch.is_tensor(i) and i.dtype == torch.bool and i.numel() > 0 for i in index)

    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def getitem(self, index):
        if plain_depth[0] == 0 and has_mask(index):
            raise HostSync("boolean-mask indexing")
        return get(self, index)

    def setitem(self, index, value):
        if plain_depth[0] == 0 and has_mask(index):
            raise HostSync("boolean-mask assignment")
        return put(self, index, value)

    def lifted(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            plain_depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                plain_depth[0] -= 1
        return run

    with contextlib.ExitStack() as stack:
        for name in SYNCING_METHODS:
            stack.enter_context(mock.patch.object(torch.Tensor, name, method(name, getattr(torch.Tensor, name))))
        for name in SYNCING_FUNCTIONS:
            stack.enter_context(mock.patch.object(torch, name, function(name, getattr(torch, name))))
        stack.enter_context(mock.patch.object(torch.Tensor, "__getitem__", getitem))
        stack.enter_context(mock.patch.object(torch.Tensor, "__setitem__", setitem))
        for module, name in PLAIN:
            stack.enter_context(mock.patch.object(module, name, lifted(getattr(module, name))))
        yield


class Tape(TorchDispatchMode):
    """A CUDA graph's stand-in on the CPU.  While it is entered, every aten op
    is recorded with its arguments and its outputs and run, but for the ops
    that write a tensor (in place or `out=`), which capturing does not run;
    `replay` runs all ops again in order on the same tensor objects and
    writes each fresh result into the recorded output (a view or an
    in-place result already is it).  So the Python that made the ops runs
    once, a Python number read at capture stays what it was, and a replay
    reads and writes the same tensors, as a graph's replay reads and writes
    the same addresses.  A plain kernel version (data-dependent shapes
    inside) is recorded as one call (`taped`)."""

    current = None

    def __init__(self):
        super().__init__()
        self.nodes = []
        self.paused = False

    def __enter__(self):
        Tape.current = self
        return super().__enter__()

    def __exit__(self, *exc):
        Tape.current = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        if func._schema.is_mutable:  # capturing writes nothing: the op's tensor comes back as it was
            out = _written(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        self.nodes.append((func, args, kwargs, out))
        return out

    def call(self, fn, args, kwargs):
        self.paused = True
        try:
            out = fn(*args, **kwargs)
        finally:
            self.paused = False
        self.nodes.append((fn, args, kwargs, out))
        return out

    def replay(self):
        for fn, args, kwargs, out in self.nodes:
            _store(out, fn(*args, **kwargs))


def _written(func, args, kwargs):
    """The argument that an in-place or out= op writes and returns."""
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is not None and arg.alias_info.is_write:
            return kwargs[arg.name] if arg.name in kwargs else args[i]
    raise NotImplementedError(f"{func} writes no argument of its own")


def _store(recorded, fresh):
    if torch.is_tensor(recorded):
        if recorded.untyped_storage().data_ptr() != fresh.untyped_storage().data_ptr():
            recorded.copy_(fresh)
    elif isinstance(recorded, (tuple, list)):
        for r, f in zip(recorded, fresh):
            _store(r, f)


class TapeRecorder(graphs.Recorder):
    """graphs.Recorder with a Tape for each graph; with `guard`, each graph's
    capture runs under sync_guard."""

    guard = False

    def _begin_graph(self):
        stack = contextlib.ExitStack()
        if self.guard:
            stack.enter_context(sync_guard())
        tape = stack.enter_context(Tape())
        return tape, stack

    def _end_graph(self, opened):
        tape, stack = opened
        stack.close()
        return tape


@contextlib.contextmanager
def taped(guard: bool = False):
    """The capture path on the CPU: every device capturable (unless
    graphs.CAPTURE is False), each graph a Tape, each plain kernel version
    one call on the tape."""

    def opaque(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            tape = Tape.current
            return fn(*args, **kwargs) if tape is None else tape.call(fn, args, kwargs)
        return run

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(graphs, "capturable", lambda device: graphs.CAPTURE))
        stack.enter_context(mock.patch.object(graphs, "Recorder", TapeRecorder))
        stack.enter_context(mock.patch.object(TapeRecorder, "guard", guard))
        for module, name in PLAIN:
            stack.enter_context(mock.patch.object(module, name, opaque(getattr(module, name))))
        yield


@contextlib.contextmanager
def kept_steps():
    """The steps that integrator.dispatch_step returns inside the block, in
    order, each kept alive (a step leaves the cache with its scene)."""
    made, dispatch_step = [], integrator.dispatch_step

    def keep(*args, **kwargs):
        made.append(dispatch_step(*args, **kwargs))
        return made[-1]

    with mock.patch.object(integrator, "dispatch_step", keep):
        yield made


@pytest.fixture(autouse=True)
def fresh_cache():
    graphs.clear()
    yield
    graphs.clear()


@pytest.fixture(scope="module")
def scene():
    """The reduced colonnade, compiled by the JAX package and converted."""
    data, meta, aux = compile_scene(colonnade(n_columns=2, column_res=(24, 8)))
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    return data, meta, aux, tdata, tmeta


def _cameras(aux, eye_shift=0.0):
    view = aux["camera_view"] if eye_shift == 0.0 else jlook_at((eye_shift, 4.0, 18.0), (0.0, 3.0, 0.0), (0, 1, 0))
    return np.linalg.inv(view), np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H))


# Two dispatches: another camera, sky rotation, frame seed, frame count and sample offset.
DISPATCHES = [dict(eye_shift=0.0, azimuth=0.0, altitude=0.0, seed=SEED, frame_count=0, offset=0),
              dict(eye_shift=3.0, azimuth=40.0, altitude=12.0, seed=77, frame_count=1, offset=3)]


def _params(aux, d):
    view_inv, proj_inv = _cameras(aux, d["eye_shift"])
    tp = default_params(view_inv, proj_inv, device="cpu")._replace(sky_rotation_azimuth=scalar(d["azimuth"], "cpu"),
                                                            sky_rotation_altitude=scalar(d["altitude"], "cpu"))
    jp = jparams(view_inv, proj_inv)._replace(sky_rotation_azimuth=jnp.float32(d["azimuth"]),
                                              sky_rotation_altitude=jnp.float32(d["altitude"]))
    return tp, jp


def _port_dispatch(tdata, tmeta, tp, d, accum, n_samples=2):
    """render_step with a sample offset: render_samples, the scatter to the
    image and the EWMA, as render_step composes them."""
    pxy, pidx, sct, padded = tiled_pixels(W, H, "cpu")
    rad, segs, stats = integrator.render_samples(tdata, tmeta, RenderFlags(**FLAGS), tp, pxy, pidx, (W, H), d["seed"],
                                                 n_samples, sample_offset=d["offset"])
    img = integrator.accumulate_ewma(accum, scatter_to_image(rad, sct, padded, W, H), d["frame_count"])
    return img, int(segs), stats


def _jax_dispatch(data, meta, jp, d, accum, n_samples=2):
    """The same through the JAX package: its _render_step for offset 0,
    else its render_samples with the offset and _render_step's scatter and
    EWMA."""
    flags = JFlags(**FLAGS)
    if d["offset"] == 0:
        out, segs = _render_step(data, meta, flags, jp, jnp.uint32(d["seed"]), (W, H), accum,
                                 jnp.int32(d["frame_count"]), n_samples)
        return np.asarray(out), float(segs)
    pxy, pidx, sct, padded = jtiling.tiled_pixel_order(W, H)
    rad, segs = jax.jit(functools.partial(jintegrator.render_samples, meta=meta, flags=flags, resolution=(W, H),
                                          n_samples=n_samples))(
        data, params=jp, pixel_xy=jnp.asarray(pxy), pixel_index=jnp.asarray(pidx), frame_seed=jnp.uint32(d["seed"]),
        sample_offset=jnp.uint32(d["offset"]))
    out = jintegrator.accumulate_ewma(accum, jtiling.scatter_to_image(rad, jnp.asarray(sct), padded, W, H),
                                      jnp.int32(d["frame_count"]))
    return np.asarray(out), float(segs)


def _two_dispatches(scene):
    """The two dispatches through one step: [(image, segments)], the step."""
    _, _, aux, tdata, tmeta = scene
    accum, out = torch.zeros((H, W, 3)), []
    for d in DISPATCHES:
        tp, _ = _params(aux, d)
        img, segs, _ = _port_dispatch(tdata, tmeta, tp, d, accum)
        out.append((img, segs))
        accum = img
    assert len(graphs.steps()) == 1
    return out, graphs.steps()[0]


# ----------------------------------------------------------------- the guard


@pytest.mark.parametrize("call", [
    lambda: bool(torch.ones(3).any()), lambda: int(torch.ones(())), lambda: float(torch.ones(())),
    lambda: torch.ones(1).item(), lambda: torch.ones(2).tolist(),
    lambda: torch.nonzero(torch.ones(2)), lambda: torch.ones(2).nonzero(), lambda: torch.ones(3)[torch.ones(3) > 0],
    lambda: torch.ones(3).__setitem__(torch.ones(3) > 0, 0.0), lambda: torch.unique(torch.ones(3)),
    lambda: range(torch.tensor(3)),
], ids=["bool", "int", "float", "item", "tolist", "torch.nonzero", "Tensor.nonzero", "mask-get", "mask-set",
        "unique", "index"])
def test_the_guard_catches_each_sync(call):
    with sync_guard(), pytest.raises(HostSync):
        call()


def test_the_guard_is_lifted_inside_the_plain_versions():
    def syncing_plain(*args):
        return bool(torch.ones(3).any())

    with mock.patch.object(stream, "stream_trace_plain", syncing_plain), sync_guard():
        assert stream.stream_trace_plain() is True
        assert torch.zeros(0).tolist() == []  # no elements: nothing to wait for
        with pytest.raises(HostSync):
            syncing_plain()


# -------------------------------------------------------------- the body


@pytest.mark.parametrize("mode", ["stream", "packet"])
def test_body_is_sync_free(scene, mode):
    _, _, aux, tdata, tmeta = scene
    tp, _ = _params(aux, DISPATCHES[0])
    pxy, pidx, _, _ = tiled_pixels(W, H, "cpu")
    with mock.patch.object(integrator, "TRACE_MODE", mode):
        step = integrator.dispatch_step(tdata, tmeta, RenderFlags(**FLAGS), tp, pxy, pidx, (W, H), SEED, 2)
        start = dict(step.carry)
        with sync_guard():
            out = step.body(tdata, step.carry, step.inputs, LoopStats())
    assert set(out) == set(start) and set(integrator.CARRY) <= set(out)  # segments: every lane and its shadow rays
    assert int(out["segments"]) > W * H and not torch.equal(out["origin"], start["origin"])
    for k in ("pre_state", "pre_origin", "pre_direction"):
        assert out[k] is start[k]


def test_media_is_captured_on_a_capturable_device(cornell):
    """dispatch_step captures a configuration with volumes or the
    atmosphere as it captures one without (graphs.CAPTURE False keeps it
    eager): one segment more than its loop sites."""
    tdata, tmeta, aux = cornell
    tp = default_params(*_cameras(aux), device="cpu")
    pxy, pidx, _, _ = tiled_pixels(8, 8, "cpu")
    flags = RenderFlags(max_depth=1, max_medium_events=1, enable_atmosphere=True)
    with taped():
        integrator.path_trace_sample(tdata, tmeta, flags, tp, pxy, pidx, (8, 8), 5)
        with mock.patch.object(graphs, "CAPTURE", False):
            eager = integrator.dispatch_step(tdata, tmeta, flags, tp, pxy, pidx, (8, 8), 5)
    step = graphs.steps()[0]
    assert step.captures == 1 and len(step.sites) > 0 and len(step.segments) == len(step.sites) + 1
    assert eager is step and not step._capture


# ------------------------------------------------- one step, many dispatches


@pytest.fixture(scope="module")
def two_dispatches(scene):
    graphs.clear()
    out, step = _two_dispatches(scene)
    graphs.clear()
    return out, step


@pytest.fixture(scope="module")
def jax_dispatches(scene):
    """The two dispatches through the JAX package, the second accumulating
    onto the first."""
    data, meta, aux, _, _ = scene
    accum, out = jnp.zeros((H, W, 3), jnp.float32), []
    for d in DISPATCHES:
        img, segs = _jax_dispatch(data, meta, _params(aux, d)[1], d, accum)
        out.append((img, segs))
        accum = jnp.asarray(img)
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_one_step_matches_jax_on_each_dispatch(two_dispatches, jax_dispatches, i):
    (got, segs), (want, want_segs) = two_dispatches[0][i], jax_dispatches[i]
    _assert_images_agree(got.numpy(), want)
    assert abs(segs - want_segs) <= 0.01 * want_segs


def test_one_step_equals_a_fresh_step(scene, two_dispatches):
    _, _, aux, tdata, tmeta = scene
    (first, _), (second, second_segs) = two_dispatches[0]
    graphs.clear()
    d = DISPATCHES[1]
    img, segs, _ = _port_dispatch(tdata, tmeta, _params(aux, d)[0], d, first)
    assert torch.equal(img, second) and segs == second_segs
    assert not torch.equal(first, second)


def test_captured_buffers_equal_eager_dispatches(scene, two_dispatches):
    """The capture path on the CPU, each graph a Tape."""
    with taped():
        out, step = _two_dispatches(scene)
    for (got, segs), (want, want_segs) in zip(out, two_dispatches[0]):
        assert torch.equal(got, want) and segs == want_segs
    assert step.captures == 1 and step.replays > 0 and len(step.segments) == 1 and not step.sites


# ----------------------------------------------------------------- the cache


@pytest.fixture(scope="module")
def cornell():
    data, meta, aux = compile_scene(cornell_box())
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    return tdata, tmeta, aux


def _step(cornell, size=8, flags=RenderFlags(max_depth=2), n_samples=1, tp=None, data=None):
    tdata, tmeta, aux = cornell
    pxy, pidx, _, _ = tiled_pixels(size, size, "cpu")
    tp = default_params(*_cameras(aux), device="cpu") if tp is None else tp
    return integrator.dispatch_step(tdata if data is None else data, tmeta, flags, tp, pxy, pidx, (size, size), 5,
                                    n_samples)


def test_new_params_seed_or_offset_reuse_the_step(cornell):
    tdata, tmeta, aux = cornell
    step = _step(cornell)
    tp = default_params(*_cameras(aux, 2.0), device="cpu")._replace(environment_intensity=scalar(3.0, "cpu"))
    again = _step(cornell, tp=tp)
    pxy, pidx, _, _ = tiled_pixels(8, 8, "cpu")
    third = integrator.dispatch_step(tdata, tmeta, RenderFlags(max_depth=2), tp, pxy, pidx, (8, 8), 99, 1,
                                     sample_offset=7)
    assert step is again is third and len(graphs.steps()) == 1
    assert torch.equal(step.inputs["params"].view_inverse, tp.view_inverse)
    assert float(step.inputs["params"].environment_intensity) == 3.0
    assert int(step.inputs["frame_seed"]) == 99 and int(step.inputs["sample_offset"]) == 7


@pytest.mark.parametrize("change", ["scene", "resolution", "flags", "samples_per_launch", "n_samples", "trace_mode"])
def test_a_new_configuration_adds_an_entry(cornell, change):
    tdata, _, _ = cornell
    first = _step(cornell)
    kw = {"scene": dict(data=tdata._replace(tri_p0=tdata.tri_p0.clone())), "resolution": dict(size=16),
          "flags": dict(flags=RenderFlags(max_depth=3)),
          "samples_per_launch": dict(flags=RenderFlags(max_depth=2, samples_per_launch=2)),
          "n_samples": dict(n_samples=2)}.get(change, {})
    with mock.patch.object(integrator, "TRACE_MODE", "packet" if change == "trace_mode" else integrator.TRACE_MODE):
        second = _step(cornell, **kw)
    assert second is not first and len(graphs.steps()) == 2


def test_the_ninth_entry_evicts_the_first(cornell):
    made = [_step(cornell, n_samples=k) for k in range(1, graphs.STEPS_CAP + 2)]
    held = graphs.steps()
    assert len(held) == graphs.STEPS_CAP and made[0] not in held and held == made[1:]
    assert _step(cornell, n_samples=1) is not made[0]


# --------------------------------------------------------- launch accounting


class StubGraph:
    pass


class StubRecorder(graphs.Recorder):
    def _begin_graph(self):
        return None

    def _end_graph(self, opened):
        return StubGraph()


def test_capture_takes_back_the_counts_and_replays_add_them():
    def iteration():  # what the wrappers count while an iteration is captured
        kernels.LAUNCHES["ray_keys"] += 2
        kernels.LAUNCHES["stream"] += 1

    kernels.reset_launches()
    kernels.LAUNCHES["occlude"] = 5
    rec = StubRecorder()
    rec.begin()
    iteration()
    graph, launches = rec.end()
    assert isinstance(graph, StubGraph)
    zero = dict.fromkeys(kernels.LAUNCHES, 0)  # the trace kernels, loop_cond and the probe kernels
    assert kernels.LAUNCHES == {**zero, "occlude": 5}
    assert launches == {**zero, "ray_keys": 2, "stream": 1}
    graphs.add_launches(launches, 3)  # the graph ran 3 times (the dispatch graph's tally)
    assert kernels.LAUNCHES == {**zero, "ray_keys": 6, "stream": 3, "occlude": 5}
    kernels.reset_launches()


def test_a_failed_capture_restores_the_counts_and_raises():
    class Failing(StubRecorder):
        def _end_graph(self, opened):
            raise RuntimeError("operation not permitted when stream is capturing")

    kernels.reset_launches()
    rec = Failing()
    rec.begin()
    kernels.LAUNCHES["visit"] = 4
    with pytest.raises(RuntimeError, match="capturing"):
        rec.end()
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    rec.begin()
    kernels.LAUNCHES["visit"] = 4
    rec.abort()  # an error's open capture: ended, its error dropped, the counts restored
    assert all(v == 0 for v in kernels.LAUNCHES.values()) and rec._open is None


def test_write_clones_outputs_that_alias_another_buffer():
    static = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor([3.0, 4.0])}
    graphs.write(static, {"a": static["b"], "b": static["a"] * 10})  # a swap through the buffers
    assert static["a"].tolist() == [3.0, 4.0] and static["b"].tolist() == [10.0, 20.0]
    same = static["a"]
    graphs.write(static, {"a": same, "b": static["b"][[1, 0]]})
    assert static["a"] is same and static["b"].tolist() == [20.0, 10.0]
