"""The port's sharded render against the JAX package's: vpt_tpu.dist.mesh on
the virtual CPU devices of tests/conftest.py, vpt_tpu_torch.dist.mesh on
gloo rank groups on the CPU, the same compiled scene for both (the JAX
scene's leaves through scene_from_numpy, handed to the ranks as numpy).

Cornell 16^2 without boxes, depth 3.  The RNG streams are identical, but
float32 transcendentals differ by ulps between XLA:CPU and ATen, as in
tests/test_torch_render.py, hence its bar: PSNR > 40 dB on the image
clipped to [0, 10], at least 99% of pixels within rtol 1e-3 / atol 1e-4,
and equal segment counts.  Each JAX mesh is compiled once (module-scoped
fixtures)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.core.camera import perspective
from vpt_tpu.dist import mesh as jmesh
from vpt_tpu.io.metrics import psnr
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.render.params import default_params as jparams
from vpt_tpu.scene.build import compile_scene
from vpt_tpu.scene.procedural import cornell_box
from vpt_tpu_torch.dist import dryrun
from vpt_tpu_torch.dist import mesh as tmesh
from vpt_tpu_torch.render.params import RenderFlags
from vpt_tpu_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

SIZE = 16
# (kind, (tile, spp), resolution, frame seed, n_samples[, tile_rows])
CASES = {
    "sharded (2, 2) 16x16 4 spp": ("sharded", (2, 2), (SIZE, SIZE), 99, 4),
    "sharded (4, 1) 15x13 1 spp": ("sharded", (4, 1), (15, 13), 7, 1),
    "tiled (2, 1) 16x16 2 spp, 2 bands": ("tiled", (2, 1), (SIZE, SIZE), 1234, 2, 2),
}


@pytest.fixture(scope="module")
def scene():
    data, meta, aux = compile_scene(cornell_box(with_boxes=False))
    cameras = (np.linalg.inv(aux["camera_view"]), np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0)))
    return data, meta, cameras


@pytest.fixture(scope="module")
def jax_renders(scene):
    data, meta, cameras = scene
    flags, params = JFlags(max_depth=3, max_medium_events=2), jparams(*cameras)
    out = {}
    for name, (kind, (tile, spp), resolution, seed, n_samples, *rest) in CASES.items():
        m = jmesh.make_mesh(jax.devices()[: tile * spp], tile=tile, spp=spp)
        if kind == "sharded":
            img, segs = jmesh.render_sharded(data, meta, flags, params, resolution, seed, n_samples=n_samples, mesh=m)
        else:
            img, segs = jmesh.render_tiled_final_frame(data, meta, flags, params, resolution, n_samples, m,
                                                       tile_rows=rest[0], frame_seed=seed)
        out[name] = (np.asarray(img), float(segs))
    return out


@pytest.fixture(scope="module")
def port_renders(scene):
    data, meta, cameras = scene
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    host, flags = dryrun.host_tree(tdata), RenderFlags(max_depth=3, max_medium_events=2)
    out = {}
    for n_ranks in (4, 2):
        names = [n for n, c in CASES.items() if c[1][0] * c[1][1] == n_ranks]
        ranks = dryrun.run_ranks(n_ranks, dryrun.render_jobs, host, tmeta, flags, cameras,
                                 [CASES[n] for n in names], "cpu", device="cpu")
        assert all(foreign == [] for _, foreign in ranks)
        out.update(zip(names, ranks[0][0]))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_port_agrees_with_jax(jax_renders, port_renders, case):
    want, want_segs = jax_renders[case]
    got, segs = port_renders[case]
    assert got.shape == want.shape and np.isfinite(got).all() and got.mean() > 0
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert segs == want_segs


@pytest.mark.parametrize("width, height, n_tile", [(16, 16, 4), (15, 13, 4), (15, 13, 8), (15, 13, 5)])
def test_pixel_arrays_equal_jax(width, height, n_tile):
    jxy, jidx = jmesh.pixel_grid(width, height)
    txy, tidx = tmesh.pixel_grid(width, height)
    assert np.array_equal(jxy, txy) and np.array_equal(jidx.astype(np.int64), tidx)
    jpad = jmesh._pad_pixels(jxy, jidx, n_tile, width * height)
    tpad = tmesh._pad_pixels(txy, tidx, n_tile, width * height)
    assert np.array_equal(jpad[0], tpad[0]) and np.array_equal(jpad[1].astype(np.int64), tpad[1])
    assert jpad[2] == tpad[2]
