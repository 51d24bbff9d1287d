"""render_samples with a sample offset, against the JAX package's: up to 8
samples both precompute every sample's primary rays, above 8 both reseed a
lane at regeneration with (new sample + offset) and make its rays anew.
Cornell 16^2 without boxes, depth 3, the same compiled scene for both; the
bar of tests/test_torch_render.py (PSNR > 40 dB on the image clipped to
[0, 10], at least 99% of pixels within rtol 1e-3 / atol 1e-4) and equal
segment counts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.core.camera import perspective
from vpt_tpu.dist.mesh import pixel_grid
from vpt_tpu.io.metrics import psnr
from vpt_tpu.render import integrator as jintegrator
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.render.params import default_params as jparams
from vpt_tpu.scene.build import compile_scene
from vpt_tpu.scene.procedural import cornell_box
from vpt_tpu_torch.render import integrator
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

SIZE = 16
SEED = 99


@pytest.fixture(scope="module")
def scene():
    data, meta, aux = compile_scene(cornell_box(with_boxes=False))
    cameras = (np.linalg.inv(aux["camera_view"]), np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0)))
    return data, meta, cameras


@pytest.mark.parametrize("n_samples, sample_offset", [(10, 3), (4, 3)])
def test_render_samples_with_offset_matches_jax(scene, n_samples, sample_offset):
    data, meta, cameras = scene
    pxy, pidx = pixel_grid(SIZE, SIZE)
    step = jax.jit(functools.partial(jintegrator.render_samples, meta=meta,
                                     flags=JFlags(max_depth=3, max_medium_events=2), resolution=(SIZE, SIZE),
                                     n_samples=n_samples))
    want, want_segs = step(data, params=jparams(*cameras), pixel_xy=jnp.asarray(pxy), pixel_index=jnp.asarray(pidx),
                           frame_seed=jnp.uint32(SEED), sample_offset=jnp.uint32(sample_offset))
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    got, segs, _ = integrator.render_samples(
        tdata, tmeta, RenderFlags(max_depth=3, max_medium_events=2), default_params(*cameras, device="cpu"),
        torch.as_tensor(pxy), torch.as_tensor(pidx.astype(np.int64)), (SIZE, SIZE), SEED, n_samples,
        sample_offset=sample_offset)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == (SIZE * SIZE, 3) and np.isfinite(got).all() and got.mean() > 0
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert int(segs) == float(want_segs)


def test_reseeding_keeps_no_per_sample_ray_sets(scene, monkeypatch):
    """Above 8 samples the loop makes primary rays only for sample 0 up front
    and then once per iteration, never one set per sample."""
    data, meta, cameras = scene
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    calls = []
    real = integrator.generate_primary_rays
    monkeypatch.setattr(integrator, "generate_primary_rays", lambda *a: calls.append(1) or real(*a))
    pxy, pidx = pixel_grid(4, 4)
    flags = RenderFlags(max_depth=3, max_medium_events=2)
    _, _, stats = integrator.render_samples(tdata, tmeta, flags, default_params(*cameras, device="cpu"),
                                            torch.as_tensor(pxy), torch.as_tensor(pidx.astype(np.int64)), (4, 4),
                                            SEED, 12)
    assert stats.syncs < 12 * 5  # the loop ended before its cap, on its last alive check
    assert len(calls) == stats.syncs  # one set up front, one per iteration that ran
