"""The energy-compensation table bake and its fits against the JAX
package: the reflection table and both refraction tables at 8 samples per
texel from the JAX seeds, `fit_table`, the fits `compile_scene` carries,
the reference `.bin` loader, and the port's own cache files.

Every texel runs the JAX package's PCG stream; float32 transcendentals
differ by ulps between XLA:CPU and ATen, which can flip a rare sample's
Fresnel pick or validity test, so the tables are held to a mean absolute
difference of 1e-5 with at least 99.9% of texels within 1e-4."""

import os

import numpy as np
import pytest
import torch

from vpt_tpu.render import lookup as jlookup
from vpt_tpu.render import lookup_fit as jfit
from vpt_tpu.scene.build import compile_scene as jcompile
from vpt_tpu.scene.procedural import cornell_box as jcornell
from vpt_tpu_torch.api import Renderer
from vpt_tpu_torch.render import lookup, lookup_fit
from vpt_tpu_torch.render.params import RenderFlags
from vpt_tpu_torch.scene.build import compile_scene
from vpt_tpu_torch.scene.procedural import cornell_box

torch.set_num_threads(2)
SAMPLES = 8


@pytest.fixture(scope="module")
def baked():
    """{name: (port table, JAX table)} at SAMPLES samples per texel."""
    return {
        "reflect": (lookup.bake_reflection_table(SAMPLES, device="cpu"), jlookup.bake_reflection_table(SAMPLES)),
        "refract_out": (lookup.bake_refraction_table(True, SAMPLES, device="cpu"),
                        jlookup.bake_refraction_table(True, SAMPLES)),
        "refract_in": (lookup.bake_refraction_table(False, SAMPLES, device="cpu"),
                       jlookup.bake_refraction_table(False, SAMPLES)),
    }


@pytest.mark.parametrize("name", ["reflect", "refract_out", "refract_in"])
def test_bake_matches_jax(baked, name):
    got, want = baked[name]
    assert got.shape == want.shape == (lookup.REFLECT_SHAPE if name == "reflect" else lookup.REFRACT_SHAPE)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.mean() <= 1e-5, diff.mean()
    assert (diff <= 1e-4).mean() >= 0.999, f"{(diff > 1e-4).sum()} of {diff.size} texels differ"
    assert want.std() > 0.01  # a real table, not a constant


@pytest.mark.parametrize("name", ["reflect", "refract_out"])
def test_fit_table_matches_jax(baked, name):
    table = baked[name][1][:, ::2, ::2] if name == "refract_out" else baked[name][1]  # the JAX fit's cost is per texel
    got = lookup_fit.fit_table(table, lookup_fit.REFLECT_DEG)
    want = jfit.fit_table(table, jfit.REFLECT_DEG)
    assert got.shape == (7, 11, 13) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_compile_scene_fits_match_jax(baked):
    """Tables are fitted, fits (at most 16 layers) pass through; the
    refraction tables are cut to every fourth row and column here, which
    keeps them tables while the JAX package fits them in seconds."""
    tables = (baked["reflect"][1],) + tuple(baked[k][1][:, ::4, ::4] for k in ("refract_out", "refract_in"))
    jdata, _, _ = jcompile(jcornell(), lookup_tables=tables)
    data, _, _ = compile_scene(cornell_box(), lookup_tables=tables, device="cpu")
    for f in ("lookup_reflect", "lookup_refract_out", "lookup_refract_in"):
        np.testing.assert_allclose(getattr(data, f).numpy(), np.asarray(getattr(jdata, f)), rtol=0, atol=1e-6,
                                   err_msg=f)
    # Fits pass through as they are, and None is the constant fit.
    fits = tuple(getattr(data, f).numpy() for f in ("lookup_reflect", "lookup_refract_out", "lookup_refract_in"))
    again, _, _ = compile_scene(cornell_box(), lookup_tables=fits, device="cpu")
    np.testing.assert_array_equal(again.lookup_refract_in.numpy(), fits[2])
    const, _, _ = compile_scene(cornell_box(), device="cpu")
    np.testing.assert_array_equal(const.lookup_reflect.numpy(), lookup_fit.constant_fit(1.0))


def test_load_reference_tables(tmp_path):
    r = np.random.default_rng(0)
    shapes = {"ReflectionLookup.bin": lookup.REFLECT_SHAPE, "RefractionLookupHitFromOutside.bin": lookup.REFRACT_SHAPE,
              "RefractionLookupHitFromInside.bin": lookup.REFRACT_SHAPE}
    written = {}
    for name, shape in shapes.items():
        written[name] = r.random(shape).astype(np.float32)
        written[name].tofile(tmp_path / name)
    got = lookup.load_reference_tables(str(tmp_path))
    want = jlookup.load_reference_tables(str(tmp_path))
    for g, w, name in zip(got, want, shapes):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, written[name])
    np.zeros(10, np.float32).tofile(tmp_path / "ReflectionLookup.bin")
    with pytest.raises(ValueError):
        lookup.load_reference_tables(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        lookup.load_reference_tables(str(tmp_path / "absent"))


def test_cache_and_fits_use_the_port_names(tmp_path, baked):
    """get_lookup_tables bakes once into torch_lookup_*.npy and then loads;
    get_lookup_fits caches the fits beside them; JAX's names are never used."""
    cache = str(tmp_path)
    tables = lookup.get_lookup_tables(n_samples=2, cache_dir=cache, device="cpu")
    names = sorted(os.listdir(cache))
    assert names == [f"torch_lookup_{k}_2.npy" for k in ("reflect", "refract_in", "refract_out")]
    np.testing.assert_array_equal(tables[0], lookup.bake_reflection_table(2, device="cpu"))
    again = lookup.get_lookup_tables(n_samples=2, cache_dir=cache, device="cpu")
    for a, b in zip(tables, again):
        np.testing.assert_array_equal(a, b)
    fits = lookup_fit.get_lookup_fits(n_samples=2, cache_dir=cache, device="cpu")
    assert "torch_lookup_fits_2_12x10x6.npz" in os.listdir(cache)
    np.testing.assert_array_equal(fits[1], lookup_fit.fit_table(tables[1]))
    assert not any(n.startswith("lookup_") for n in os.listdir(cache))


def test_renderer_lookup_tables_argument(tmp_path, monkeypatch):
    """"auto" bakes on the Renderer's device (the cache directory is
    redirected here), "reference" loads the .bin tables, None is the
    constant fit, and anything else is refused."""
    baked_on = []

    def fake_tables(n_samples=4096, cache_dir=None, device="cpu"):
        baked_on.append(device)
        r = np.random.default_rng(1)
        return (r.random(lookup.REFLECT_SHAPE).astype(np.float32),
                r.random(lookup.REFRACT_SHAPE).astype(np.float32), r.random(lookup.REFRACT_SHAPE).astype(np.float32))

    import vpt_tpu_torch.api as api

    monkeypatch.setattr(api, "get_lookup_tables", fake_tables)
    kw = dict(width=4, height=4, flags=RenderFlags(max_depth=1, max_medium_events=1))
    auto = Renderer(cornell_box(), device="cpu", **kw)
    assert baked_on == [torch.device("cpu")]
    assert not np.array_equal(auto.scene_data.lookup_reflect.numpy(), lookup_fit.constant_fit(1.0))
    off = Renderer(cornell_box(), device="cpu", flags=RenderFlags(use_energy_compensation=False), width=4, height=4)
    assert len(baked_on) == 1  # no bake when the flags do not use the tables
    np.testing.assert_array_equal(off.scene_data.lookup_reflect.numpy(), lookup_fit.constant_fit(1.0))
    none = Renderer(cornell_box(), device="cpu", lookup_tables=None, **kw)
    np.testing.assert_array_equal(none.scene_data.lookup_refract_out.numpy(), lookup_fit.constant_fit(1.0))
    monkeypatch.setenv("VPT_REFERENCE_TABLES", str(tmp_path))
    r = np.random.default_rng(2)
    for name, shape in (("ReflectionLookup.bin", lookup.REFLECT_SHAPE),
                        ("RefractionLookupHitFromOutside.bin", lookup.REFRACT_SHAPE),
                        ("RefractionLookupHitFromInside.bin", lookup.REFRACT_SHAPE)):
        r.random(shape).astype(np.float32).tofile(tmp_path / name)
    ref = Renderer(cornell_box(), device="cpu", lookup_tables="reference", **kw)
    np.testing.assert_allclose(ref.scene_data.lookup_refract_in.numpy(),
                               lookup_fit.fit_table(lookup.load_reference_tables(str(tmp_path))[2]), atol=0)
    with pytest.raises(ValueError):
        Renderer(cornell_box(), device="cpu", lookup_tables="bogus", **kw)
