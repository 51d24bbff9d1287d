"""The dispatch graph of render/graphs.py on the CPU: its WHILE nodes, its
condition, the captured dispatches that run it, and the step cache's
lifetime.

* The loop condition (render/loop.py:cond, the plain version of
  csrc/graph_loop.cu vpt_loop_cond_kernel) run as WHILE nodes by
  `graphs.run_plain`, each graph a Tape (test_torch_graphs.py), gives the
  iteration count, final live mask and tallies of `jax.lax.while_loop`
  with cond (i < cap) & any(live) on seeded live schedules (tests/
  while_toys.py: cap 0, every lane dead at entry, lanes alive at the cap,
  random ones, a 512x512 wavefront), host-driven through `loop.cond` as
  well; nested WHILE nodes count their loops and steps as nested
  `while_loop`s do.
* `graphs.plan`: the wavefront WHILE node over the segments, a nested
  WHILE node per loop site between them, each WHILE node's condition set
  just upstream of it and at the end of its body.
* The stream and packet dispatches of the reduced colonnade, two of them
  through one captured step (the first captures, the second only runs the
  dispatch graph), equal eager ones bit for bit with equal segments, media
  loops and steps; the captured dispatch reads nothing inside its loop
  once the graph is built and reads the graph's tallies once after it.
  (The media configurations are in test_torch_media_graphs.py.)
* The step cache holds its owners weakly: a step leaves the cache when its
  Renderer is collected or a setter replaces the Renderer's scene, and a
  scene that lives on keeps its step.
"""

import dataclasses
import gc
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import while_toys
from test_torch_graphs import DISPATCHES, FLAGS, H, W, TapeRecorder, _params, kept_steps, taped
from test_torch_graphs import scene  # noqa: F401  (the reduced colonnade fixture)
from vpt_tpu.scene.procedural import cornell_box
from vpt_tpu_torch import Renderer, RenderFlags
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.render import graphs, integrator, loop
from vpt_tpu_torch.scene.types import Material, Volume

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_cache():
    graphs.clear()
    yield
    graphs.clear()


def _jax_while(death: np.ndarray, cap: int):
    """(steps, final live) of lax.while_loop with cond (i < cap) & any(live)."""
    d = jnp.asarray(death)

    def cond(c):
        return (c[0] < cap) & jnp.any(c[1])

    def body(c):
        return c[0] + 1, d > c[0] + 1

    i, live = jax.lax.while_loop(cond, body, (jnp.int32(0), d > 0))
    return int(i), np.asarray(live)


# ------------------------------------------------------------ the condition


@pytest.mark.parametrize("name", list(while_toys.SCHEDULES))
def test_while_node_counts_as_lax_while_loop(name):
    death, cap = while_toys.deaths(name)
    want, want_live = _jax_while(death, cap)
    assert want == while_toys.expected(death, cap)
    nodes, (live, steps, counts) = while_toys.single(torch.as_tensor(death), cap, TapeRecorder())
    for _ in range(2):  # a second run starts over: the upstream Cond resets the counter
        graphs.run_plain(nodes, {})
        assert int(steps) == want and counts.tolist() == [1, want]
        assert np.array_equal(live.numpy(), want_live)
        counts.zero_()
    assert while_toys.plain_count(torch.as_tensor(death), cap) == want


@pytest.mark.parametrize("seed", range(6))
def test_nested_while_nodes_count_loops_and_steps(seed):
    rng = np.random.default_rng(100 + seed)
    d_out = rng.integers(0, 9, 32).astype(np.int64)
    d_in = rng.integers(0, 14, 48).astype(np.int64)
    cap_out, cap_in = int(rng.integers(0, 9)), int(rng.integers(0, 8))
    nodes, (c_out, c_in) = while_toys.nested(torch.as_tensor(d_out), cap_out, torch.as_tensor(d_in), cap_in,
                                              TapeRecorder())
    graphs.run_plain(nodes, {})
    k, entered, inner = while_toys.expected_nested(d_out, cap_out, d_in, cap_in)
    assert c_out.tolist() == [1, k] and c_in.tolist() == [entered, inner]


@pytest.mark.parametrize("live,steps,cap,want", [
    ([True, False], 0, 1, True), ([False, False], 0, 5, False), ([True], 3, 3, False), ([True], 0, 0, False),
    ([False, True, False], 2, 3, True),
])
def test_cond_is_any_live_below_the_cap(live, steps, cap, want):
    assert loop.cond(torch.tensor(live), torch.tensor(steps), cap) is want


def test_plan_sets_each_condition_upstream_and_at_the_end_of_each_body():
    segments = [f"segment{j}" for j in range(3)]
    sites = [graphs.Site(f"step{j}", {}, {"live": torch.zeros(4, dtype=torch.bool)}, 8 * (j + 1), "body")
             for j in range(2)]
    alive, iters = torch.zeros(4, dtype=torch.bool), torch.zeros((), dtype=torch.int64)
    site_steps, counts = torch.zeros(2, dtype=torch.int64), torch.zeros((3, 2), dtype=torch.int64)
    first, wave = graphs.plan(segments, sites, alive, iters, 72, site_steps, counts)
    assert isinstance(first, graphs.Cond) and first.live is alive and first.steps is iters and first.cap == 72
    assert not first.reset and first.handle == wave.handle == 0 and isinstance(wave, graphs.While)
    body = wave.body
    assert body[0] == "segment0" and body[3] == "segment1" and body[6] == "segment2" and len(body) == 8
    for j, at in enumerate((1, 4)):
        cond, site = body[at], body[at + 1]
        assert cond.reset and cond.handle == site.handle == j + 1 and cond.cap == 8 * (j + 1)
        assert cond.live is sites[j].carry["live"] and cond.counts.data_ptr() == counts[j + 1].data_ptr()
        assert site.body[0] == f"step{j}" and not site.body[1].reset and site.body[1].handle == j + 1
    assert body[-1] is first  # the wavefront's condition after each body


# ------------------------------------------------- captured against eager


def _dispatches(scene, capture: bool):
    """Two render_step dispatches of the reduced colonnade (FLAGS, 2 spp):
    [(image, segments, (loops, steps, syncs, launch_reads))]."""
    _, _, aux, tdata, tmeta = scene
    accum, out = torch.zeros((H, W, 3)), []
    with mock.patch.object(graphs, "CAPTURE", capture):
        for i, d in enumerate(DISPATCHES):
            tp, _ = _params(aux, d)
            accum, segs, stats = render_step(tdata, tmeta, RenderFlags(**FLAGS), tp, d["seed"], (W, H), accum, i, 2)
            out.append((accum.clone(), int(segs), dataclasses.astuple(stats)))
    return out


@pytest.mark.parametrize("mode", ["stream", "packet"])
def test_captured_dispatches_equal_eager_ones(scene, mode):  # noqa: F811
    with mock.patch.object(integrator, "TRACE_MODE", mode):
        eager = _dispatches(scene, False)
        graphs.clear()
        with taped(guard=True), kept_steps() as made:
            captured = _dispatches(scene, True)
    for (a, sa, la), (b, sb, lb) in zip(eager, captured):
        assert torch.equal(a, b) and sa == sb and la[:2] == lb[:2] == (0, 0)
        assert la[3] == 0 and lb[3] == 1
    assert eager[0][2][2] > 2 and captured[0][2][2] == 1 and captured[1][2][2] == 0  # reads inside the loop
    assert not torch.equal(eager[0][0], eager[1][0])
    step = made[0]
    assert all(s is step for s in made) and step.captures == 1 and step.replays == 2 and not step.sites
    assert isinstance(step.graph.nodes[1], graphs.While) and len(step.graph.nodes[1].body) == 2


# ------------------------------------------------------------- the cache


def _renderer():
    return Renderer(cornell_box(), width=8, height=8, flags=RenderFlags(max_depth=2), samples_per_frame=1,
                    lookup_tables=None, device="cpu")


def test_a_step_goes_with_its_renderer():
    r = _renderer()
    r.path_trace()
    assert len(graphs.steps()) == 1
    keep = _renderer()
    keep.path_trace()
    assert len(graphs.steps()) == 2
    del r
    gc.collect()
    (step,) = graphs.steps()
    keep.path_trace()
    assert graphs.steps() == [step]  # a scene that lives keeps its step


@pytest.mark.parametrize("setter", ["set_material", "set_env_map", "add_volume"])
def test_a_step_goes_when_a_setter_replaces_the_scene(setter):
    r = _renderer()
    r.path_trace()
    (first,) = graphs.steps()
    if setter == "set_material":
        r.set_material(0, Material(base_color=(0.2, 0.7, 0.3)))
    elif setter == "set_env_map":
        r.set_env_map(np.full((8, 16, 3), 0.5, np.float32))
    else:
        r.add_volume(Volume(corner_min=(-1, -1, -1), corner_max=(1, 1, 1), density=0.1))
    assert first not in graphs.steps()
    r.path_trace()
    (second,) = graphs.steps()
    assert second is not first
