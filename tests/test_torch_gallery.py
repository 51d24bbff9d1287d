"""vpt_tpu_torch.gallery against scripts/gallery.py, on the CPU.

The JAX script is loaded by path with its `render` replaced by a recorder
and its output directory by a temporary one, and its `main()` runs: that
records every job (name, scene, flags, setup, samples, size) without
rendering.  The port's job list must equal the recording exactly: names
and order, flags, samples and size, and the scenes field by field (meshes'
arrays, instances and transforms, materials, textures, volumes with their
grids, camera).  Then each job's setup is applied to a JAX `Renderer` and a
port `Renderer` at 16x16 with `lookup_tables=None`, and the render
parameters, flags, post-processing settings and volume tables must be
equal.

The surface-only jobs render through both packages at 16x16, 1 spp, depth
3, at test_torch_render.py's bar: PSNR > 40 dB on the images clipped to
[0, 10] and at least 99% of pixels within rtol 1e-3 / atol 1e-4.
cornell_smoke and atmosphere_sunset render as test_torch_media_render.py
renders its media cases (the JAX loops op by op; the heterogeneous volume
on JAX's loop schedule), at the same bar.  cornell_bloom's saved PNG is
held to JAX's, both from the same HDR image.  colonnade is not rendered
here: test_torch_render.py renders it at reduced size."""

import contextlib
import dataclasses
import importlib.util
import io
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_media_render import _jax_render_step, jax_schedule
from test_torch_trace import use_native_jax_bvh
from vpt_tpu.api import Renderer as JRenderer
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu_torch import gallery
from vpt_tpu_torch.api import Renderer, render_step
from vpt_tpu_torch.io.image import load_png
from vpt_tpu_torch.io.metrics import psnr

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "gallery.py")
W = H = 16
SEED = 2654435761  # the first frame seed Renderer.path_trace draws
RENDER_DEPTH = 3
JOBS = {job.name: job for job in gallery.jobs()}
SURFACE_JOBS = ["cornell_box", "cornell_glass_gold", "cornell_dof", "sphere_garden"]
MEDIA_JOBS = {"cornell_smoke": True, "atmosphere_sunset": False}  # name: on JAX's loop schedule
STATE_JOBS = [name for name in JOBS if name != "colonnade"]


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """scripts/gallery.py's jobs, recorded by running its main() with its
    render replaced: {name: dict of render's arguments}, and what it
    printed."""
    spec = importlib.util.spec_from_file_location("jax_gallery", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    env = {k: v for k, v in os.environ.items() if k not in ("GALLERY_SIZE", "GALLERY_SPP")}
    with mock.patch.dict(os.environ, env, clear=True):
        spec.loader.exec_module(script)
    calls = {}

    def record(name, scene, flags=None, setup=None, spp=script.SPP, size=script.SIZE):
        # The JAX script's render applies this default (scripts/gallery.py:27).
        calls[name] = dict(scene=scene, flags=flags or JFlags(max_depth=8, max_medium_events=4), setup=setup,
                           spp=spp, size=size)

    script.render = record
    script.OUT = str(tmp_path_factory.mktemp("jax_gallery"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        script.main()
    assert os.listdir(script.OUT) == []
    return calls, out.getvalue()


def _equal(a, b, path="") -> None:
    """Field-by-field equality of two host scene values from the two
    packages: dataclasses by their fields, arrays by dtype, shape and value."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        fa, fb = dataclasses.fields(a), dataclasses.fields(b)
        assert [f.name for f in fa] == [f.name for f in fb], path
        for f in fa:
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


_pairs = {}


def _pair(recorded, name):
    """(JAX Renderer, port Renderer) of job `name` at 16x16, 1 spp,
    lookup_tables=None, each with its package's setup applied."""
    if name not in _pairs:
        calls, _ = recorded
        want, job = calls[name], JOBS[name]
        use_native_jax_bvh()  # both sides' BVHs from the same C++ builder
        jr = JRenderer(want["scene"], width=W, height=H, flags=want["flags"], samples_per_frame=1, max_samples=1,
                       lookup_tables=None)
        tr = Renderer(job.scene(), width=W, height=H, flags=job.flags, samples_per_frame=1, max_samples=1,
                      lookup_tables=None, device="cpu")
        if want["setup"]:
            want["setup"](jr)
        if job.setup:
            job.setup(tr)
        _pairs[name] = jr, tr
    return _pairs[name]


def test_jobs_in_the_script_order(recorded):
    calls, printed = recorded
    names = [n for n in calls if n != "viking_room"]
    assert names == list(JOBS)
    assert "viking_room" in calls or "viking_room skipped:" in printed


@pytest.mark.parametrize("name", list(JOBS))
def test_job_equals_the_script(recorded, name):
    want, job = recorded[0][name], JOBS[name]
    assert dataclasses.asdict(job.flags) == dataclasses.asdict(want["flags"])
    assert job.spp == want["spp"] and gallery.SIZE == want["size"]
    assert (job.setup is None) == (want["setup"] is None)
    _equal(job.scene(), want["scene"], name)


@pytest.mark.parametrize("name", STATE_JOBS)
def test_setup_gives_the_renderer_state_of_the_script(recorded, name):
    jr, tr = _pair(recorded, name)
    assert dataclasses.asdict(tr.flags) == dataclasses.asdict(jr.flags)
    assert dataclasses.asdict(tr.post) == dataclasses.asdict(jr.post)
    assert tr.params._fields == jr.params._fields
    for field, a, b in zip(tr.params._fields, tr.params, jr.params):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)
    _equal(tr.volumes, list(jr.volumes), name)
    assert (tr.meta.n_volumes, tr.meta.n_het_volumes) == (jr.meta.n_volumes, jr.meta.n_het_volumes)
    tv, jv = tr.scene_data.volumes, jr.scene_data.volumes
    assert tv._fields == jv._fields
    for field, a, b in zip(tv._fields, tv, jv):
        a = a.numpy()
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype), err_msg=field)


def _assert_images_agree(got, want):
    assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.mean() > 0
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"


@pytest.mark.parametrize("name", SURFACE_JOBS)
def test_surface_job_renders_as_the_script(recorded, name):
    jr, tr = _pair(recorded, name)
    for r in (jr, tr):
        r.set_max_depth(RENDER_DEPTH)
        r.path_trace()
    assert tr.meta.n_volumes == 0 and not tr.flags.enable_atmosphere
    assert tr.meta.use_brute_force == (name != "sphere_garden")
    _assert_images_agree(tr.hdr_image(), np.asarray(jr.hdr_image()))
    assert abs(tr.segments_traced - jr.segments_traced) <= 0.01 * jr.segments_traced


@pytest.mark.parametrize("name", list(MEDIA_JOBS))
def test_media_job_renders_as_the_script(recorded, name):
    jr, tr = _pair(recorded, name)
    jflags = dataclasses.replace(jr.flags, max_depth=RENDER_DEPTH)
    tflags = dataclasses.replace(tr.flags, max_depth=RENDER_DEPTH)
    want, want_segs, counts = _jax_render_step(jr.scene_data, jr.meta, jflags, jr.params, jnp.uint32(SEED), (W, H),
                                               jnp.zeros((H, W, 3), jnp.float32), jnp.int32(0), 1)
    forced = MEDIA_JOBS[name]
    with jax_schedule(counts) if forced else contextlib.nullcontext() as natural:
        got, segs, stats = render_step(tr.scene_data, tr.meta, tflags, tr.params, SEED, (W, H), torch.zeros((H, W, 3)),
                                       0, 1)
    if forced:
        assert tr.meta.n_het_volumes == 1
        assert all(abs(a - b) <= 2 for a, b in zip(natural, counts)), (natural, counts)
    else:
        assert tflags.enable_atmosphere and stats.steps == sum(counts) and stats.loops == len(counts)
    _assert_images_agree(got.numpy(), np.asarray(want))
    assert abs(int(segs) - float(want_segs)) <= 0.01 * float(want_segs)


def test_bloom_saves_the_script_image(recorded, tmp_path):
    jr, tr = _pair(recorded, "cornell_bloom")
    assert tr.post.enable_bloom
    hdr = np.random.default_rng(0).gamma(0.6, 1.5, (H, W, 3)).astype(np.float32)
    tr._accum = torch.as_tensor(hdr)
    jr._accum = jnp.asarray(hdr)
    bloomed = tr.output_image()
    np.testing.assert_allclose(bloomed, np.asarray(jr.output_image()), rtol=0.0, atol=1e-5)
    got = load_png(tr.save(str(tmp_path / "port.png")))
    want = load_png(jr.save(str(tmp_path / "jax.png")))
    assert got.shape == want.shape == (H, W, 3)
    assert np.abs(got - want).max() <= 1 / 255 + 1e-6
    tr.post.enable_bloom = False
    assert np.abs(bloomed - tr.output_image()).mean() > 1e-3  # the setup's bloom shows


def test_main_renders_every_job_and_skips_the_absent_asset(tmp_path, capsys):
    rendered = []

    def record(job, size, spp, device="cuda", out=None):
        rendered.append((job.name, size, spp, device, out))

    env = {k: v for k, v in os.environ.items() if k not in ("GALLERY_SIZE", "GALLERY_SPP")}
    with mock.patch.object(gallery, "render", record), mock.patch.dict(os.environ, {**env, "GALLERY_SPP": "8"},
                                                                       clear=True):
        assert gallery.main([str(tmp_path / "out"), "--device", "cpu"]) == 0
    out = str(tmp_path / "out")
    assert os.path.isdir(out)
    want = [(job.name, gallery.SIZE, job.spp, "cpu", out) for job in gallery.jobs(8)]
    if os.path.exists(gallery.VIKING_ROOM):
        want.append(("viking_room", gallery.SIZE, 8, "cpu", out))
    else:
        assert "viking_room skipped:" in capsys.readouterr().out
    assert rendered == want
    root = os.path.dirname(os.path.dirname(SCRIPT))
    assert os.path.normpath(gallery.OUT) == os.path.join(root, "Gallery", "torch")
