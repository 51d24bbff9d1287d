"""The media and atmosphere loops in the captured dispatch step
(vpt_tpu_torch/render/graphs.py) on the CPU, each CUDA graph a Tape
(test_torch_graphs.py): the captured Python runs once, and a replay runs
the recorded aten ops again on the same tensors.

For each configuration of the reduced colonnade (77,148 triangles, four
emissive lamps, the sky) at 16x16, 1 spp, depth 2:
* one heterogeneous volume (the single-volume march and transmittance),
* a cloud and a haze (the merged march and transmittance), also in the
  packet trace mode,
* the atmosphere (the gallery's day setup),
* the cloud, the haze and the atmosphere together,
two dispatches (another camera, seed and frame count the second time)
through one captured step, its loop run as the dispatch graph's plain
version (WHILE nodes over the tapes), equal two eager dispatches bit for
bit, with equal segments and media LoopStats loops and steps; the
captured dispatch reads nothing inside its loop once the graph is built
(the first dispatch runs its first iteration eagerly before capturing)
and reads the graph's tallies once after it; the step is captured once,
every segment and loop step of the capture runs under sync_guard, and
its loop sites come in the order of integrator.body's
media calls (`_sites`: 5 for a cloud and a haze, 7 for the atmosphere,
16 for both).  A one-rank gloo render_sharded of the cloud and the haze,
captured, equals the eager render_samples over the same pixels bit for
bit.  One captured dispatch of the atmosphere agrees with the JAX package
by test_torch_media_render.py's bar."""

import dataclasses
import os
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_graphs import kept_steps, taped
from tests.test_torch_media_render import _render_both
from vpt_tpu.scene.build import compile_scene as jcompile_scene
from vpt_tpu.scene.procedural import colonnade as jcolonnade
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.core.camera import look_at, perspective
from vpt_tpu_torch.dist import mesh
from vpt_tpu_torch.io.metrics import psnr
from vpt_tpu_torch.render import graphs, integrator
from vpt_tpu_torch.render.params import RenderFlags, default_params, scalar, vec3
from vpt_tpu_torch.scene.build import build_volume_table, compile_scene
from vpt_tpu_torch.scene.procedural import colonnade
from vpt_tpu_torch.scene.types import Volume, tree_to_device
from vpt_tpu_torch.scene.vdb import procedural_cloud

torch.set_num_threads(1)

W = H = 16
FLAGS = dict(max_depth=2, max_medium_events=4)
CLOUD = dict(corner_min=(-6.0, 3.0, -4.0), corner_max=(6.0, 9.0, 4.0), density=8.0, anisotropy=0.3,
             density_grid=procedural_cloud((16, 16, 16), coverage=0.6, seed=0))
HAZE = dict(corner_min=(-17.0, 0.0, -7.0), corner_max=(17.0, 1.5, 7.0), density=0.05, color=(0.9, 0.9, 0.9))
PLANET = (0.0, -6360e3, 0.0)
CASES = {  # volumes, atmosphere, trace mode
    "one_cloud": ([CLOUD], False, "stream"),
    "cloud_and_haze": ([CLOUD, HAZE], False, "stream"),
    "cloud_and_haze_packet": ([CLOUD, HAZE], False, "packet"),
    "atmosphere": ([], True, "stream"),
    "volumes_and_atmosphere": ([CLOUD, HAZE], True, "stream"),
}


def _sites(n_volumes: int, atmo: bool) -> list:
    """The loop sites of one iteration in integrator.body's order, with
    the sky and mesh NEE on (colonnade has a sky and lamps): the scatter
    distance through the volumes and through the atmosphere, then the
    shadow-ray transmittance (`nee_transmittance`: the volumes' march, and
    towards the sky one atmosphere loop per colour channel) of the surface's
    sky and lamp samples, of a volume scatter's, and of an atmosphere
    scatter's sun sample."""
    if n_volumes > 1:
        scatter, march = "scatter_distance_merged", "volumes_transmittance_merged"
    else:
        scatter, march = "scatter_distance_in_volume", "volumes_transmittance"

    def nee(to_sky):
        return ([march] if n_volumes else []) + (["transmittance"] * 3 if to_sky and atmo else [])

    sites = ([scatter] if n_volumes else []) + (["sample_scatter_distance"] if atmo else [])
    sites += nee(True) + nee(False)  # surface: sky, lamp
    if n_volumes:
        sites += nee(True) + nee(False)  # volume scatter: sky, lamp
    if atmo:
        sites += nee(True)  # atmosphere scatter: the sun
    return [f"{name}.<locals>.body" for name in sites]


@pytest.fixture(scope="module")
def scene():
    return compile_scene(colonnade(n_columns=2, column_res=(24, 8)), device="cpu")


@pytest.fixture(autouse=True)
def fresh_cache():
    graphs.clear()
    yield
    graphs.clear()


def _configuration(scene, case: str):
    """(scene data, meta, flags, aux) of `case`."""
    data, meta, aux = scene
    vols, atmo, _ = CASES[case]
    data = data._replace(volumes=tree_to_device(build_volume_table([Volume(**v) for v in vols]), "cpu"))
    meta = dataclasses.replace(meta, n_volumes=len(vols),
                               n_het_volumes=sum(v.get("density_grid") is not None for v in vols))
    return data, meta, RenderFlags(enable_atmosphere=atmo, **FLAGS), aux


def _dispatches(scene, case: str):
    """Two render_step dispatches of `case`: ([(image, segments, LoopStats
    as a tuple)], meta, the step), the step taken while its scene lives."""
    data, meta, flags, aux = _configuration(scene, case)
    atmo = flags.enable_atmosphere
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H))
    views = [np.linalg.inv(aux["camera_view"]), np.linalg.inv(look_at((3.0, 4.0, 18.0), (0.0, 3.0, 0.0), (0, 1, 0)))]
    accum, out = torch.zeros((H, W, 3)), []
    for i, (view_inv, seed) in enumerate(zip(views, (2654435761, 77))):
        params = default_params(view_inv, proj_inv, device="cpu")
        if atmo:
            params = params._replace(planet_position=vec3(PLANET, "cpu"), sky_rotation_altitude=scalar(30.0, "cpu"))
        accum, segs, stats = render_step(data, meta, flags, params, seed, (W, H), accum, i, 1)
        out.append((accum.clone(), int(segs), dataclasses.astuple(stats)))
    return out, meta, graphs.steps()[0]


@pytest.mark.parametrize("case", list(CASES))
def test_captured_media_dispatches_equal_eager_ones(scene, case):
    vols, atmo, mode = CASES[case]
    with mock.patch.object(integrator, "TRACE_MODE", mode):
        eager, meta, step = _dispatches(scene, case)
        assert not step.segments  # the CPU runs eagerly
        graphs.clear()
        with taped(guard=True):
            captured, _, step = _dispatches(scene, case)
    assert meta.n_volumes == len(vols) and not meta.use_brute_force
    for (a, sa, la), (b, sb, lb) in zip(eager, captured):
        assert torch.equal(a, b) and sa == sb and la[:2] == lb[:2], (sa, sb, la, lb)  # loops, steps
        assert la[3] == 0 and lb[3] == 1  # reads after a launch: the tallies, once
    assert captured[1][2][2] == 0 and 0 < captured[0][2][2] < eager[0][2][2]  # reads inside the loop
    assert not torch.equal(eager[0][0], eager[1][0])
    assert step.captures == 1 and step.replays > 0
    assert [site.body for site in step.sites] == _sites(len(vols), atmo)
    assert len(step.segments) == len(step.sites) + 1
    loops, steps, syncs, _ = eager[0][2]
    assert loops > len(step.sites) and steps > 0 and syncs > loops


def test_captured_one_rank_sharded_media_render_equals_render_samples(scene):
    data, meta, flags, aux = _configuration(scene, "cloud_and_haze")
    params = default_params(np.linalg.inv(aux["camera_view"]),
                            np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H)), device="cpu")
    pxy, pidx = (torch.as_tensor(a) for a in mesh.pixel_grid(W, H))
    want, want_segs, _ = integrator.render_samples(data, meta, flags, params, pxy, pidx, (W, H), 99, 2)
    graphs.clear()
    with tempfile.TemporaryDirectory() as tmp, taped():
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", world_size=1, rank=0)
        try:
            img, segs = mesh.render_sharded(data, meta, flags, params, (W, H), 99, 2, mesh.make_mesh(device_type="cpu"))
        finally:
            dist.destroy_process_group()
    (step,) = graphs.steps()
    assert step.captures == 1 and step.replays > 0 and len(step.sites) == 5
    assert torch.equal(img, want.reshape(H, W, 3)) and int(segs) == int(want_segs)


@pytest.fixture(scope="module")
def jax_scene():
    return jcompile_scene(jcolonnade(n_columns=2, column_res=(24, 8)))


def test_captured_atmosphere_dispatch_matches_jax(jax_scene):
    """test_torch_media_render.py's atmosphere case, its port dispatch
    captured."""
    with taped(), kept_steps() as made:
        want, want_segs, got, segs, stats, _ = _render_both(jax_scene, "atmosphere")
    (step,) = made
    assert step.captures == 1 and step.replays > 0 and len(step.sites) == 7
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(segs - want_segs) <= 0.01 * want_segs
