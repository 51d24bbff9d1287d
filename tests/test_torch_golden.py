"""The port against the golden images of tests/test_golden.py, on the CPU.

The four goldens whose scenes are in the repository are rendered through
the port's `Renderer` at the JAX tests' scene, size, flags, seed and bar
(tests/torch_goldens.py): SSIM on the images clipped to [0, 8] above 0.97
(glass, smoke) and 0.95 (sunset), plain SSIM above 0.98 (cornell).  The
goldens are only read: a missing one fails, and nothing is written under
tests/golden.

The cornell golden predates the JAX package's current code (its own render
reads ~0.99 against it), so cornell and glass are also held to the JAX
package's current render of the same configuration, at
test_torch_render.py's bar: PSNR > 40 dB on the images clipped to [0, 10]
and at least 99% of pixels within rtol 1e-3 / atol 1e-4, but for the share
of close pixels in the glass render (`CLOSE_SHARE`).  Brute force
against the clusters and the tonemapped PNG round trip follow the JAX
tests, the former at 16x16, 4 spp (JAX's 48x48, 16 spp runs on the card,
chip_smoke.py phase 13)."""

import os

import numpy as np
import pytest
import torch

from tests import torch_goldens
from tests.test_golden import _render_cornell
from vpt_tpu.api import Renderer as JRenderer
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.scene.procedural import cornell_box as jcornell_box
from vpt_tpu.scene.types import Material as JMaterial
from vpt_tpu_torch.io.image import load_png, save_png
from vpt_tpu_torch.io.metrics import psnr
from vpt_tpu_torch.post.tonemap import tonemap

torch.set_num_threads(1)

_images = {}


def _port_image(name: str) -> np.ndarray:
    if name not in _images:
        _images[name] = torch_goldens.render(torch_goldens.GOLDENS[name].renderer("cpu"))
    return _images[name]


def _jax_glass() -> np.ndarray:
    """tests/test_golden.py's glass render."""
    scene = jcornell_box()
    scene.materials.append(JMaterial(name="glass", base_color=(1, 1, 1), transmission=1.0, ior=1.5, roughness=0.02))
    scene.instances[-2].material = len(scene.materials) - 1
    r = JRenderer(scene, width=48, height=48, flags=JFlags(max_depth=8, max_medium_events=4), samples_per_frame=24,
                  max_samples=24, lookup_tables=None)
    r._seed_counter = 17
    r.path_trace()
    return np.asarray(r.hdr_image())


# The share of pixels within rtol 1e-3 / atol 1e-4 of JAX's render.  A glass
# hit picks reflection or refraction by its Fresnel weight against a random
# number, and a weight an ulp away flips a rare pick, which changes that
# pixel by up to ~0.8 at 24 spp: the JAX package's own jitted render of the
# glass configuration and its op-by-op render (under `jax.disable_jit()`)
# agree on 95.3% of pixels (PSNR 47.5 dB); the port and the jitted render on
# 94.7% (PSNR 49.8 dB) (tests/jax_glass_agreement.py).  The cornell render has no such pick (max abs
# difference 1.4e-6).
CLOSE_SHARE = {"cornell": 0.99, "glass": 0.94}
JAX_RENDERS = {"cornell": lambda: np.asarray(_render_cornell()), "glass": _jax_glass}


@pytest.mark.parametrize("name", list(torch_goldens.GOLDENS))
def test_port_render_matches_golden(name):
    img = _port_image(name)
    assert np.isfinite(img).all() and img.mean() > 0
    golden = torch_goldens.GOLDENS[name]
    s = torch_goldens.golden_ssim(golden, img)
    assert s > golden.bar, f"SSIM vs {golden.file}: {s:.5f}"


@pytest.mark.parametrize("name", list(JAX_RENDERS))
def test_port_render_matches_jax(name):
    got, want = _port_image(name), JAX_RENDERS[name]()
    assert got.shape == want.shape
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert close.mean() >= CLOSE_SHARE[name], f"{(~close).sum()} of {close.size} pixels differ"


def test_a_missing_golden_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(torch_goldens, "GOLDEN_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        torch_goldens.golden_ssim(torch_goldens.GOLDENS["sunset"], np.zeros((32, 32, 3), np.float32))
    assert os.listdir(tmp_path) == []


def test_brute_vs_cluster_paths_agree():
    brute, clustered = torch_goldens.brute_and_cluster(16, 4, "cpu")
    assert brute.meta.use_brute_force and not clustered.meta.use_brute_force
    imgs = [torch_goldens.render(r) for r in (brute, clustered)]
    assert np.isfinite(imgs[0]).all() and np.isfinite(imgs[1]).all()
    p = psnr(np.clip(imgs[0], 0, 10), np.clip(imgs[1], 0, 10), data_range=10.0)
    assert p > 40.0, f"brute vs cluster PSNR {p:.1f} dB"


def test_tonemapped_png_round_trip(tmp_path):
    img = torch_goldens.render(torch_goldens.cornell("cpu", spp=8))
    ldr = tonemap(torch.as_tensor(img)).numpy()
    path = str(tmp_path / "roundtrip.png")
    save_png(path, ldr)
    back = load_png(path)
    assert back.shape == ldr.shape
    assert np.abs(back - ldr).max() < 1 / 255 + 1e-3


def test_cornell_box_glass_gltf_golden():
    if not os.path.exists(torch_goldens.GLTF_GLASS):
        pytest.skip("the reference asset CornellBoxGlass.gltf (Assets/ of the reference repository) is not in this "
                    "repository; its golden cornell_glass_gltf_48_16spp.npy waits for it")
    golden = torch_goldens.GLTF_GOLDEN
    img = torch_goldens.render(golden.renderer("cpu"))
    assert np.isfinite(img).all() and img.max() > 0
    s = torch_goldens.golden_ssim(golden, img)
    assert s > golden.bar, f"SSIM vs {golden.file}: {s:.5f}"
