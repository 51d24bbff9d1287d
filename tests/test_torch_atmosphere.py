"""vpt_tpu_torch's atmosphere and sun disk against vpt_tpu's: heights and
densities at planet scale, the planet and atmosphere sphere tests,
ratio-tracked transmittance and null-collision scatter sampling on 4,096
rays in each colour channel, and the sun-disk NEE sampler.

Inputs come from a numpy seed; the JAX functions run op by op, their
`lax.while_loop`s as Python loops (see test_torch_volumes.py for why).
The bars are test_torch_volumes.py's: integers equal, floats within
rtol 1e-5 / atol 1e-6 on all but 0.1% of lanes, iteration counts equal.
The rays start near the ground of the day setup (planet centre at
(0, -6360 km, 0), so the ground is y = 0), some below it, where one
float32 ulp of |p - centre| is half a metre."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_volumes import N, _t, assert_agree, jax_eager_loops
from vpt_tpu.core import vecmath as jvec
from vpt_tpu.render import atmosphere as jatmo
from vpt_tpu.render import lights as jlights
from vpt_tpu.render.params import default_params as jparams
from vpt_tpu_torch.core import vecmath as tvec
from vpt_tpu_torch.render import atmosphere as tatmo
from vpt_tpu_torch.render import lights as tlights
from vpt_tpu_torch.render import loop
from vpt_tpu_torch.render.params import default_params, scalar, vec3

torch.set_num_threads(1)

SETUPS = {
    # The gallery's day setup under colonnade's sky.
    "day": dict(planet_position=(0.0, -6360e3, 0.0)),
    # Non-default multipliers, falloffs and a thinner atmosphere (the
    # default planet sits at +y: "up" is -y there).
    "custom": dict(planet_position=(0.0, 6360e3 + 1000.0, 0.0), atmosphere_height=60e3,
                   rayleigh_scattering_multiplier=(1.0, 2.0, 0.5), mie_scattering_multiplier=(3.0, 1.0, 1.0),
                   ozone_absorption_multiplier=(1.0, 1.0, 4.0), rayleigh_density_falloff=7000.0,
                   ozone_peak=25000.0),
}


def _params(setup):
    jp, tp = jparams(), default_params(device="cpu")
    for k, v in SETUPS[setup].items():
        jp = jp._replace(**{k: jnp.asarray(v, jnp.float32)})
        tp = tp._replace(**{k: vec3(v, "cpu") if isinstance(v, tuple) else scalar(v, "cpu")})
    return jp, tp


def _rays(setup, seed=3):
    r = np.random.default_rng(seed)
    up = 1.0 if setup == "day" else -1.0
    origin = np.stack([r.uniform(-20, 20, N), up * r.uniform(-2.0, 40.0, N), r.uniform(-10, 10, N)], -1)
    origin[: N // 16, 1] = up * r.uniform(0.0, 5000.0, N // 16)  # higher up
    d = r.normal(size=(N, 3))
    d[: N // 4, 1] = up * np.abs(d[: N // 4, 1]) * 0.05  # near the horizon
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    state = r.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    channel = r.integers(0, 3, N)
    active = r.random(N) < 0.9
    return origin.astype(np.float32), d.astype(np.float32), state, channel, active


@pytest.mark.parametrize("setup", list(SETUPS))
def test_heights_densities_and_spheres_match_jax(setup):
    jp, tp = _params(setup)
    o, d, *_ = _rays(setup)
    jh, th = jatmo.atmosphere_height(jp, jnp.asarray(o)), tatmo.atmosphere_height(tp, _t(o))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))  # half-metre ulps: bit for bit
    for fn in ("rayleigh_density", "mie_density", "ozone_density"):
        np.testing.assert_allclose(getattr(tatmo, fn)(tp, th).numpy(), np.asarray(getattr(jatmo, fn)(jp, jh)),
                                   rtol=1e-5, atol=1e-30, err_msg=fn)
    for radius in (jp.planet_radius, jp.planet_radius + jp.atmosphere_height):
        want = jvec.intersect_sphere(jnp.asarray(o), jnp.asarray(d), jp.planet_position, radius)
        got = tvec.intersect_sphere(_t(o), _t(d), tp.planet_position, torch.tensor(np.float32(radius)))
        assert_agree(*zip(got, want))


@pytest.mark.parametrize("setup", list(SETUPS))
def test_transmittance_matches_jax(setup):
    jp, tp = _params(setup)
    o, d, s, ch, a = _rays(setup)
    with jax_eager_loops() as counts:
        js, jtr = jatmo.transmittance(jnp.asarray(s), jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ch),
                                      jnp.asarray(a))
    stats = loop.LoopStats()
    ts, ttr = tatmo.transmittance(_t(s), tp, _t(o), _t(d), _t(ch), _t(a), stats)
    assert_agree((ts, js), (ttr, jtr))
    assert stats.steps == counts[0] > 5 and stats.loops == 1
    tr = np.asarray(jtr)  # ratio tracking with roulette: each lane 0 or 1
    assert 0.05 < (tr == 0.0).mean() < 0.95 and ((tr == 0.0) | (tr == 1.0)).all()


@pytest.mark.parametrize("setup", list(SETUPS))
def test_scatter_distance_matches_jax(setup):
    jp, tp = _params(setup)
    o, d, s, ch, a = _rays(setup, seed=4)
    with jax_eager_loops() as counts:
        jout = jatmo.sample_scatter_distance(jnp.asarray(s), jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ch),
                                             jnp.asarray(a))
    stats = loop.LoopStats()
    tout = tatmo.sample_scatter_distance(_t(s), tp, _t(o), _t(d), _t(ch), _t(a), stats)
    assert_agree(*zip(tout, jout))
    assert stats.steps == counts[0] > 5 and stats.loops == 1
    comp = np.asarray(jout[2])
    assert {-1, 0, 1}.issubset(set(comp.tolist()))  # misses, Rayleigh and Mie events


@pytest.mark.parametrize("az,al,intensity", [(0.0, 30.0, 1.0), (-135.0, 5.0, 2.5), (20.0, 89.95, 0.7)])
def test_sun_disk_matches_jax(az, al, intensity):
    s = np.random.default_rng(5).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    sun = np.array([1.0, 0.9, 0.7], np.float32)
    want = jlights.sample_sun_disk(jnp.asarray(s), jnp.asarray(sun), jnp.float32(intensity), jnp.float32(az),
                                   jnp.float32(al), (N,))
    got = tlights.sample_sun_disk(_t(s), _t(sun), scalar(intensity, "cpu"), scalar(az, "cpu"), scalar(al, "cpu"), (N,))
    assert_agree(*zip(got, want))
    axis = np.asarray(want[1]).mean(0)
    cos_max = np.cos(np.float32(tlights.SUN_THETA))
    assert (got[1].numpy() @ (axis / np.linalg.norm(axis)) >= cos_max - 1e-6).all()  # inside the cone
