"""The golden-image configurations of tests/test_golden.py for the port:
the same scenes, sizes, flags, seeds and SSIM bars, built with the port
alone (no JAX), so that tests/test_torch_golden.py holds the port to
tests/golden on the CPU and chip_smoke.py on the card.

The goldens are only read here: a missing golden raises."""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np

from vpt_tpu_torch import Renderer, RenderFlags
from vpt_tpu_torch.core.camera import look_at
from vpt_tpu_torch.io.metrics import ssim
from vpt_tpu_torch.scene.gltf import load_gltf
from vpt_tpu_torch.scene.procedural import cornell_box, make_quad, sphere_garden
from vpt_tpu_torch.scene.types import Instance, Material, Scene, Volume
from vpt_tpu_torch.scene.vdb import procedural_cloud

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# The reference's glTF assets, where the reference repository keeps them;
# they are not part of this repository.
GLTF_GLASS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "Assets",
                          "CornellBoxGlass.gltf")


def _renderer(scene, size, flags, spp, seed, device) -> Renderer:
    """A one-dispatch Renderer of `spp` samples with the constant fit and
    its seed stream at `seed`, as the JAX package's golden tests make it."""
    r = Renderer(scene, width=size, height=size, flags=flags, samples_per_frame=spp, max_samples=spp,
                 lookup_tables=None, device=device)
    r._seed_counter = seed
    return r


def cornell(device, spp: int = 32) -> Renderer:
    return _renderer(cornell_box(), 64, RenderFlags(max_depth=6, max_medium_events=2), spp, 41, device)


def glass(device) -> Renderer:
    """Cornell with a glass tall box (refraction, TIR, caustics)."""
    scene = cornell_box()
    scene.materials.append(Material(name="glass", base_color=(1, 1, 1), transmission=1.0, ior=1.5, roughness=0.02))
    scene.instances[-2].material = len(scene.materials) - 1  # tall box
    return _renderer(scene, 48, RenderFlags(max_depth=8, max_medium_events=4), 24, 17, device)


def smoke(device) -> Renderer:
    """The empty Cornell box with a 24^3 procedural cloud in `scene.volumes`,
    as the JAX package's test sets it.  compile_scene reads no
    `scene.volumes` in either package (volumes enter a render only through
    `Renderer.add_volume`), so this golden is the empty box at its seeds."""
    scene = cornell_box(with_boxes=False)
    scene.volumes = [Volume(density=6.0, density_grid=procedural_cloud((24, 24, 24), coverage=0.55, seed=4),
                            corner_min=(-0.7, -0.9, -0.7), corner_max=(0.7, 0.5, 0.7), anisotropy=0.3)]
    return _renderer(scene, 40, RenderFlags(max_depth=5, max_medium_events=6), 16, 23, device)


def sunset(device) -> Renderer:
    """The path-traced sky with the sun at the horizon over a ground quad."""
    ground = make_quad((-50, -0.2, 50), (50, -0.2, 50), (50, -0.2, -50), (-50, -0.2, -50))
    scene = Scene(meshes=[ground], instances=[Instance(mesh=0, material=0, transform=np.eye(4, dtype=np.float32))],
                  materials=[Material(base_color=(0.4, 0.35, 0.3))], textures=[],
                  camera_view=look_at((0.0, 1.0, 0.0), (0.0, 4.0, -20.0), (0.0, 1.0, 0.0)), camera_aspect=1.0,
                  name="sunset")
    r = _renderer(scene, 32, RenderFlags(max_depth=5, max_medium_events=3, enable_atmosphere=True,
                                         enable_mesh_mis=False), 16, 31, device)
    r.set_sky_altitude(-2.0)  # sun at the horizon
    return r


def gltf_glass(device) -> Renderer:
    """The reference's own dielectric scene, loaded by the glTF importer."""
    return _renderer(load_gltf(GLTF_GLASS), 48, RenderFlags(max_depth=8, max_medium_events=4), 16, 29, device)


class Golden(NamedTuple):
    file: str
    renderer: Callable  # device -> Renderer, seed stream set
    bar: float  # SSIM must exceed it
    clipped: bool  # SSIM on the images clipped to [0, 8] (else plain SSIM)


GOLDENS = {
    "cornell": Golden("cornell_64_32spp.npy", cornell, 0.98, False),
    "glass": Golden("glass_cornell_48_24spp.npy", glass, 0.97, True),
    "smoke": Golden("smoke_cornell_40_16spp.npy", smoke, 0.97, True),
    "sunset": Golden("sunset_32_16spp.npy", sunset, 0.95, True),
}
GLTF_GOLDEN = Golden("cornell_glass_gltf_48_16spp.npy", gltf_glass, 0.97, True)


def render(r: Renderer) -> np.ndarray:
    r.path_trace()
    return r.hdr_image()


def golden_ssim(g: Golden, img: np.ndarray) -> float:
    """SSIM of `img` against golden `g`, as the JAX package's test takes
    it; raises FileNotFoundError if the golden is missing."""
    golden = np.load(os.path.join(GOLDEN_DIR, g.file))
    if g.clipped:
        return ssim(np.clip(img, 0, 8), np.clip(golden, 0, 8))
    return ssim(img, golden)


def brute_and_cluster(size: int, spp: int, device) -> tuple:
    """sphere_garden(grid=3) traced by brute force and through the clusters,
    the same estimator and seeds: two Renderers, not yet rendered."""
    scene = sphere_garden(grid=3)
    out = []
    for brute in (True, False):
        r = _renderer(scene, size, RenderFlags(max_depth=4, max_medium_events=2), spp, 7, device)
        r.meta = dataclasses.replace(r.meta, use_brute_force=brute)
        out.append(r)
    return tuple(out)
