"""The media branch of the ported integrator as a whole: one dispatch of
the reduced colonnade (77,148 triangles, 25 instances, glass, brass, four
emissive lamps) at 16x16, 1 spp, through vpt_tpu.api._render_step's
function on the CPU against vpt_tpu_torch.api.render_step on the same
converted scene, with `lookup_tables=None` (the constant fit) on both
sides:

1. one homogeneous volume (the single-volume functions);
2. two volumes, one a 24^3 cloud (the merged march, delta tracking and
   ratio-tracked NEE);
3. the atmosphere day setup (planet surface at y = 0, sun 30 degrees up),
   whose floor hits meet the below-planet kill.

The bar is test_torch_render.py's: PSNR > 40 dB on the image clipped to
[0, 10], at least 99% of pixels within rtol 1e-3 / atol 1e-4, and the
segment count within 1%.

Every media loop advances every lane's RNG on every step, so one loop
whose step count differs from JAX's gives every lane other draws from
then on, and an unrelated image.  XLA's compiled arithmetic (FMAs,
reciprocal multiplies; test_torch_volumes.py) moves lanes by ulps, so the
JAX integrator runs op by op (its `lax.while_loop`s as Python loops,
`jax_eager_loops`); only its trace and occlusion, which draw no random
numbers, stay jitted.

Op by op is not enough for a heterogeneous volume.  A lane that leaves
the cloud through its last 32^3 block lands, in exact arithmetic, on the
box exit itself, so whether it has exited is decided by rounding: a lane
whose ray differs from JAX's by an ulp (camera products, transcendentals)
exits a step earlier or later about half the time, and when it is the
loop's last live lane, the loop's count moves.  The JAX package is no
steadier: its jitted render of case 2 against its op-by-op render of the
same function reads ~32 dB with ~58% of pixels close.  So case 2 runs the
port's media loops for JAX's step counts, loop by loop (`jax_schedule`),
and holds the image to the same bar; each loop's own end in the port
must lie within two steps of JAX's.  Cases 1 and 3 run unforced."""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_volumes import jax_eager_loops
from vpt_tpu.accel.traverse import T_MAX, T_MIN
from vpt_tpu.api import _render_step_impl
from vpt_tpu.render import integrator as jint
from vpt_tpu.core.camera import perspective
from vpt_tpu.io.metrics import psnr
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.render.params import default_params as jparams
from vpt_tpu.scene.build import build_volume_table, compile_scene
from vpt_tpu.scene.procedural import colonnade
from vpt_tpu.scene.types import Volume
from vpt_tpu.scene.vdb import procedural_cloud
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.render import atmosphere, volumes
from vpt_tpu_torch.render.params import RenderFlags, default_params, scalar, vec3
from vpt_tpu_torch.scene.convert import scene_from_numpy

torch.set_num_threads(1)

W = H = 16
SEED = 2654435761  # the first frame seed Renderer.path_trace draws
FLAGS = dict(max_depth=3, max_medium_events=8)
HAZE = dict(corner_min=(-17.0, 0.0, -7.0), corner_max=(17.0, 1.5, 7.0), density=0.05, color=(0.9, 0.9, 0.9))
CLOUD = dict(corner_min=(-6.0, 3.0, -4.0), corner_max=(6.0, 9.0, 4.0), density=8.0, anisotropy=0.3)
PLANET = (0.0, -6360e3, 0.0)

FORCED = {"one_volume": False, "two_volumes": True, "atmosphere": False}
CASES = {
    "one_volume": [dict(HAZE, density=0.2)],
    "two_volumes": [dict(CLOUD, density_grid=procedural_cloud((24, 24, 24), coverage=0.6, seed=0)), HAZE],
    "atmosphere": [],
}


_jit_trace = jax.jit(jint.trace, static_argnames=("meta", "any_hit", "sort_rays"))
_jit_occlude = jax.jit(jint.occlude, static_argnames=("meta",))


def _trace(scene, meta, origin, direction, active, t_min=T_MIN, t_max=T_MAX, any_hit=False, sort_rays=True,
           anyhit_mask=None):
    return _jit_trace(scene, meta=meta, origin=origin, direction=direction, active=active, t_min=t_min, t_max=t_max,
                      any_hit=any_hit, sort_rays=sort_rays, anyhit_mask=anyhit_mask)


def _occlude(scene, meta, origin, direction, active, t_min=T_MIN, t_max=T_MAX, exclude_tri=None):
    return _jit_occlude(scene, meta=meta, origin=origin, direction=direction, active=active, t_min=t_min,
                        t_max=t_max, exclude_tri=exclude_tri)


def _jax_render_step(*args):
    """vpt_tpu.api._render_step's function, op by op but for the trace:
    (image, segments, each media loop's step count)."""
    with jax_eager_loops() as counts, mock.patch.object(jint, "trace", _trace), \
            mock.patch.object(jint, "occlude", _occlude):
        out, segs = _render_step_impl(*args)
    return out, segs, counts


@contextlib.contextmanager
def jax_schedule(counts):
    """Run the port's media loops for the given step counts, in order, and
    collect where each would have ended on its own (the first step with no
    live lane, or its count if lanes were still live)."""
    queue, natural = list(counts), []

    def forced(body, carry, max_steps, stats):
        n = queue.pop(0)
        assert n <= max_steps
        end = None
        for i in range(n):
            if end is None and not bool(carry["live"].any()):
                end = i
            carry = body(carry)
        natural.append(n if end is None else end)
        return carry

    with mock.patch.object(volumes, "while_live", forced), mock.patch.object(atmosphere, "while_live", forced):
        yield natural
    assert not queue, f"{len(queue)} JAX loops the port did not run"


@pytest.fixture(scope="module")
def scene():
    return compile_scene(colonnade(n_columns=2, column_res=(24, 8)))


def _render_both(scene, case):
    data, meta, aux = scene
    vols = [Volume(**v) for v in CASES[case]]
    if vols:
        data = data._replace(volumes=build_volume_table(vols))
        meta = dataclasses.replace(meta, n_volumes=len(vols),
                                   n_het_volumes=sum(v.density_grid is not None for v in vols))
    atmo = case == "atmosphere"
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H))
    jp = jparams(view_inv, proj_inv)
    tp = default_params(view_inv, proj_inv, device="cpu")
    if atmo:
        jp = jp._replace(planet_position=jnp.asarray(PLANET, jnp.float32), sky_rotation_altitude=jnp.float32(30.0))
        tp = tp._replace(planet_position=vec3(PLANET, "cpu"), sky_rotation_altitude=scalar(30.0, "cpu"))
    want, want_segs, counts = _jax_render_step(
        data, meta, JFlags(enable_atmosphere=atmo, **FLAGS), jp, jnp.uint32(SEED), (W, H),
        jnp.zeros((H, W, 3), jnp.float32), jnp.int32(0), 1,
    )
    tdata, tmeta = scene_from_numpy(jax.tree.map(np.asarray, data), meta, "cpu")
    forced = FORCED[case]
    with jax_schedule(counts) if forced else contextlib.nullcontext() as natural:
        got, segs, stats = render_step(tdata, tmeta, RenderFlags(enable_atmosphere=atmo, **FLAGS), tp, SEED,
                                       (W, H), torch.zeros((H, W, 3)), 0, 1)
    if forced:
        assert all(abs(a - b) <= 2 for a, b in zip(natural, counts)), (natural, counts)
    if not forced:
        assert stats.steps == sum(counts) and stats.loops == len(counts), (stats, counts)
    return np.asarray(want), float(want_segs), got.numpy(), int(segs), stats, tmeta


@pytest.mark.parametrize("case", list(CASES))
def test_media_render_matches_jax(scene, case):
    want, want_segs, got, segs, stats, meta = _render_both(scene, case)
    assert meta.n_volumes == len(CASES[case]) and not meta.use_brute_force
    assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.mean() > 0
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    assert close.mean() >= 0.99, f"{(~close).sum()} of {close.size} pixels differ"
    assert abs(segs - want_segs) <= 0.01 * want_segs
    if case == "atmosphere":
        assert stats.loops > 3 * FLAGS["max_depth"] and stats.syncs > stats.loops
