"""The textured colonnade and the furnace scene: the port's procedural
scenes equal the JAX package's arrays (meshes, materials, textures), a
32x32 dispatch of the small textured colonnade through the port's
render_step agrees with vpt_tpu.api._render_step on the same compiled
scene (test_torch_render.py's bar: PSNR > 40 dB on [0, 10], 99% of pixels
within rtol 1e-3 / atol 1e-4), and the furnace render on the CPU keeps
its mean error under 0.05."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import SEED
from vpt_tpu.api import _render_step
from vpt_tpu.core.camera import perspective
from vpt_tpu.io.metrics import psnr
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.render.params import default_params as jparams
from vpt_tpu.scene import procedural as jproc
from vpt_tpu.scene.build import compile_scene
from vpt_tpu_torch.api import Renderer, render_step
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene import procedural as tproc
from vpt_tpu_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

W = H = 32
SMALL = dict(n_columns=2, column_res=(12, 8))


def assert_scenes_equal(got, want):
    """Host scenes equal field by field, arrays by value and dtype."""
    assert got.name == want.name and len(got.textures) == len(want.textures)
    for a, b in zip(got.meshes, want.meshes):
        for f in ("positions", "normals", "uvs", "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for a, b in zip(got.instances, want.instances):
        assert (a.mesh, a.material, a.name) == (b.mesh, b.material, b.name)
        np.testing.assert_array_equal(a.transform, b.transform)
    assert [dataclasses.asdict(m) for m in got.materials] == [dataclasses.asdict(m) for m in want.materials]
    for a, b in zip(got.textures, want.textures):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(got.env_map, want.env_map)
    np.testing.assert_array_equal(got.camera_view, want.camera_view)


@pytest.mark.parametrize("name,kwargs", [("colonnade_textured", SMALL), ("furnace_sphere", {}),
                                         ("furnace_sphere", {"albedo": 0.5, "sky": 2.0})])
def test_scene_equals_jax(name, kwargs):
    got, want = getattr(tproc, name)(**kwargs), getattr(jproc, name)(**kwargs)
    assert_scenes_equal(got, want)


def test_textured_colonnade_carries_its_maps():
    s = tproc.colonnade_textured(**SMALL)
    assert len(s.textures) == 9 and s.name == "colonnade_textured"
    mats = {m.name: m for m in s.materials}
    assert (mats["stone"].base_color_texture, mats["stone"].normal_texture) == (3, 4)
    assert (mats["floor"].base_color_texture, mats["floor"].normal_texture) == (5, 6)
    assert mats["drape-red"].normal_texture == mats["drape-green"].normal_texture == 8
    assert sum(t.shape[0] * t.shape[1] for t in s.textures[3:]) == 4 * 1024**2 + 2 * 512**2
    assert tproc.colonnade(**SMALL).textures[3:] == [] and tproc.colonnade(**SMALL).name == "colonnade"


def test_textured_render_matches_jax():
    scene = jproc.colonnade_textured(**SMALL)
    data, meta, aux = compile_scene(scene)
    assert meta.has_textures and not meta.use_brute_force
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H))
    flags = dict(max_depth=3, max_medium_events=8)
    want, want_segs = _render_step(data, meta, JFlags(**flags), jparams(view_inv, proj_inv), jnp.uint32(SEED),
                                   (W, H), jnp.zeros((H, W, 3), jnp.float32), jnp.int32(0), 1)
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    got, segs, _ = render_step(tdata, tmeta, RenderFlags(**flags), default_params("cpu", view_inv, proj_inv), SEED,
                               (W, H), torch.zeros((H, W, 3)), 0, 1)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.mean() > 0
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(int(segs) - float(want_segs)) <= 0.01 * float(want_segs)


def test_textures_change_the_render():
    """The maps reach the shading: the textured and the plain colonnade
    differ on the same seeds."""
    flags = RenderFlags(max_depth=2, max_medium_events=0)
    imgs = []
    for scene in (tproc.colonnade(**SMALL), tproc.colonnade_textured(**SMALL)):
        r = Renderer(scene, 16, 16, flags, lookup_tables=None, device="cpu")
        r.path_trace()
        imgs.append(r.hdr_image())
    assert r.meta.has_textures and not np.allclose(imgs[0], imgs[1])


def test_furnace_render_on_the_cpu():
    r = Renderer(tproc.furnace_sphere(), 16, 16,
                 RenderFlags(max_depth=32, furnace_test_mode=True, enable_mesh_mis=False,
                             use_energy_compensation=False),
                 samples_per_frame=8, max_samples=16, lookup_tables=None, device="cpu")
    assert r.meta.use_brute_force and r.meta.n_tris == 960
    img = r.render()
    assert float(np.abs(img - 1.0).mean()) < 0.05
