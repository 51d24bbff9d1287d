"""The ported slice as a whole: one dispatch of the reduced colonnade (77,148
triangles, 25 instances, glass, brass and four emissive lamps) through
vpt_tpu.api._render_step on the CPU, jitted as Renderer.path_trace runs it,
against vpt_tpu_torch.api.render_step on the same converted scene, in the
port's stream trace mode and in its packet trace mode.  (On the CPU the JAX
package traces through `intersect_clusters`' XLA visit loop in either mode.)

The RNG streams are identical, but float32 transcendentals differ by ulps
between XLA:CPU and ATen, which can flip a rare Russian-roulette or lobe
decision: hence PSNR > 40 dB on the image clipped to [0, 10] (the bar
test_golden.py sets for two intersection backends) and at least 99% of
pixels within rtol 1e-3 / atol 1e-4."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.api import _render_step
from vpt_tpu.core.camera import perspective
from vpt_tpu.io.metrics import psnr
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.render.params import default_params as jparams
from vpt_tpu.scene.build import compile_scene
from vpt_tpu.scene.procedural import colonnade, cornell_box
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.render import integrator
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

W = H = 16
SEED = 2654435761  # the first frame seed Renderer.path_trace draws


def _render_both(scene, trace_mode="stream"):
    data, meta, aux = compile_scene(scene)
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H))
    want, want_segs = _render_step(
        data, meta, JFlags(max_depth=3, max_medium_events=8), jparams(view_inv, proj_inv),
        jnp.uint32(SEED), (W, H), jnp.zeros((H, W, 3), jnp.float32), jnp.int32(0), 1,
    )
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    args = (tdata, tmeta, RenderFlags(max_depth=3, max_medium_events=8),
            default_params(view_inv, proj_inv, device="cpu"), SEED, (W, H), torch.zeros((H, W, 3)), 0, 1)
    got, segs, stats = render_step(*args)
    packet = None
    if not meta.use_brute_force:
        # Packet mode must not reach the stream path's trace or occlusion.
        with mock.patch.object(integrator, "TRACE_MODE", "packet"), \
                mock.patch.object(integrator, "intersect_stream", side_effect=AssertionError("stream trace")), \
                mock.patch.object(integrator, "occlude_stream", side_effect=AssertionError("stream occlude")):
            packet = render_step(*args)
        packet = (packet[0].numpy(), int(packet[1]), packet[2].syncs)
    assert stats.loops == stats.steps == 0  # no volume, no atmosphere
    return np.asarray(want), float(want_segs), got.numpy(), int(segs), stats.syncs, meta, packet


def _assert_images_agree(got, want):
    assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.mean() > 0
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"


@pytest.fixture(scope="module")
def renders():
    return _render_both(colonnade(n_columns=2, column_res=(24, 8)))


def test_scene_covers_the_main_path(renders):
    *_, meta, _ = renders
    assert not meta.use_brute_force and meta.n_instances == 25 and meta.n_emissive == 4
    assert meta.n_tris == 77148


def test_render_matches_jax(renders):
    want, _, got, _, _, _, _ = renders
    _assert_images_agree(got, want)


def test_packet_mode_render_matches_jax(renders):
    want, want_segs, _, _, _, _, (got, segs, syncs) = renders
    _assert_images_agree(got, want)
    assert abs(segs - want_segs) <= 0.01 * want_segs
    assert 1 <= syncs <= 3 + 8


def test_brute_force_scene_render_matches_jax():
    """The Cornell box has 36 triangles: both sides trace by brute force."""
    want, _, got, _, _, meta, _ = _render_both(cornell_box())
    assert meta.use_brute_force
    _assert_images_agree(got, want)


def test_segments_and_syncs(renders):
    _, want_segs, _, segs, syncs, _, _ = renders
    assert abs(segs - want_segs) <= 0.01 * want_segs
    # One alive check per loop iteration: at most max_depth + max_medium_events.
    assert 1 <= syncs <= 3 + 8
