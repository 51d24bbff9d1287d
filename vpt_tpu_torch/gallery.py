"""The showcase gallery (port of scripts/gallery.py): nine procedural scenes
that together reach every feature path of the renderer (glass and metal,
the cluster trace, depth of field, a heterogeneous volume, bloom, the
instanced colonnade, the path-traced atmosphere), rendered to PNGs.

    python -m vpt_tpu_torch.gallery [out] [--device cuda]

`out` defaults to Gallery/torch/ in the repository, beside the JAX
package's TPU renders in Gallery/, which it never overwrites.  Every image is
GALLERY_SIZE^2 (default 320) at GALLERY_SPP samples per pixel (default
192; twice that for cornell_glass_gold), 8 per dispatch, on the card unless
`--device` names another device.  The jobs are data (`jobs`), so a caller
can read them without rendering; `render` renders one job.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np

from vpt_tpu_torch.api import Renderer
from vpt_tpu_torch.core.camera import look_at
from vpt_tpu_torch.render.params import RenderFlags
from vpt_tpu_torch.scene.gltf import load_gltf
from vpt_tpu_torch.scene.procedural import colonnade, cornell_box, make_quad, sphere_garden
from vpt_tpu_torch.scene.types import Instance, Material, Scene, Volume
from vpt_tpu_torch.scene.vdb import procedural_cloud

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "Gallery", "torch")
SIZE = 320  # GALLERY_SIZE
SPP = 192  # GALLERY_SPP
SAMPLES_PER_FRAME = 8
DEFAULT_FLAGS = RenderFlags(max_depth=8, max_medium_events=4)
# The reference's glTF scene, where the reference repository keeps it; it is
# not part of this repository, and the gallery skips it when it is absent.
VIKING_ROOM = os.path.join(ROOT, "Assets", "VikingRoom.gltf")


class Job(NamedTuple):
    """One gallery image: `scene()` builds its host scene, `setup(r)`, if
    any, edits the Renderer before the render."""

    name: str
    scene: Callable[[], Scene]
    flags: RenderFlags
    setup: Optional[Callable[[Renderer], None]]
    spp: int


def cornell_materials() -> Scene:
    """The Cornell box with a glass tall box and a gold short box."""
    scene = cornell_box()
    scene.materials.append(Material(name="glass", transmission=1.0, roughness=0.02, ior=1.5))
    scene.materials.append(Material(name="gold", base_color=(1.0, 0.77, 0.34), metallic=1.0, roughness=0.12))
    scene.instances[6].material = 4
    scene.instances[7].material = 5
    return scene


def atmosphere_scene() -> Scene:
    """A 4 km ground quad under the open sky, the camera 2 m up looking
    towards the horizon."""
    ground = make_quad((-2000, -0.2, 2000), (2000, -0.2, 2000), (2000, -0.2, -2000), (-2000, -0.2, -2000))
    return Scene(
        meshes=[ground],
        instances=[Instance(mesh=0, material=0, transform=np.eye(4, dtype=np.float32))],
        materials=[Material(base_color=(0.35, 0.32, 0.28))],
        textures=[],
        camera_view=look_at((0.0, 2.0, 0.0), (0.0, 60.0, -400.0), (0.0, 1.0, 0.0)),
        camera_aspect=1.0,
        name="atmosphere",
    )


def dof(r: Renderer) -> None:
    r.set_focus_distance(3.2)
    r.set_dof_strength(0.18)


def smoke(r: Renderer) -> None:
    r.add_volume(Volume(corner_min=(-0.6, -0.6, -0.6), corner_max=(0.6, 0.6, 0.6), density=14.0,
                        color=(0.3, 0.32, 0.36), density_grid=procedural_cloud((48, 48, 48), coverage=0.6)))


def glow(r: Renderer) -> None:
    r.post.enable_bloom = True
    r.post.bloom_threshold = 1.2
    r.post.bloom_strength = 0.6


# The reference's default planet position (PathTracer.h:222) puts the planet
# centre 6360 km above the origin, so a positive sun altitude is below its
# horizon and the sky renders black.  The gallery moves the planet below the
# scene: surface at y ~ 0, zenith +y.
def day(r: Renderer) -> None:
    r.set_planet_position((0.0, -6360e3, 0.0))
    r.set_sky_altitude(30.0)


def sunset(r: Renderer) -> None:
    r.set_planet_position((0.0, -6360e3, 0.0))
    r.set_sky_altitude(2.0)


def jobs(spp: int = SPP) -> list:
    """The gallery's jobs in render order, `spp` samples per pixel each
    (twice that for the glass and gold box)."""
    atmo = RenderFlags(max_depth=6, max_medium_events=6, enable_atmosphere=True, enable_mesh_mis=False)
    return [
        Job("cornell_box", cornell_box, DEFAULT_FLAGS, None, spp),
        Job("cornell_glass_gold", cornell_materials, DEFAULT_FLAGS, None, spp * 2),
        Job("sphere_garden", sphere_garden, DEFAULT_FLAGS, None, spp),
        Job("cornell_dof", cornell_materials, DEFAULT_FLAGS, dof, spp),
        Job("cornell_smoke", lambda: cornell_box(with_boxes=False), DEFAULT_FLAGS, smoke, spp),
        Job("cornell_bloom", lambda: cornell_box(light_emission=(40, 30, 12)), DEFAULT_FLAGS, glow, spp),
        Job("colonnade", colonnade, RenderFlags(max_depth=8, max_medium_events=2), None, spp),
        Job("atmosphere_day", atmosphere_scene, atmo, day, spp),
        Job("atmosphere_sunset", atmosphere_scene, atmo, sunset, spp),
    ]


def render(job: Job, size: int, spp: int, device="cuda", out: Optional[str] = None) -> Renderer:
    """Render `job` at size x size to `spp` samples per pixel on `device`
    (the Renderer's defaults otherwise, the baked energy-compensation tables
    included); with `out`, write out/<name>.png.  Returns the Renderer."""
    t0 = time.time()
    r = Renderer(job.scene(), width=size, height=size, flags=job.flags, samples_per_frame=SAMPLES_PER_FRAME,
                 max_samples=spp, device=device)
    if job.setup:
        job.setup(r)
    r.render()
    if out is not None:
        path = r.save(os.path.join(out, f"{job.name}.png"))
        print(f"{job.name}: {time.time() - t0:.0f}s, {r.samples_accumulated} spp -> {path}", flush=True)
    return r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vpt_tpu_torch.gallery", description=__doc__.split("\n")[0])
    p.add_argument("out", nargs="?", default=OUT, help="output directory (default Gallery/torch/)")
    p.add_argument("--device", default="cuda", help="torch device to render on (default cuda)")
    args = p.parse_args(argv)
    size = int(os.environ.get("GALLERY_SIZE", SIZE))
    spp = int(os.environ.get("GALLERY_SPP", SPP))
    os.makedirs(args.out, exist_ok=True)
    for job in jobs(spp):
        render(job, size, job.spp, args.device, args.out)
    try:
        viking = load_gltf(VIKING_ROOM)
    except OSError as e:  # the reference asset is not in the repository
        print("viking_room skipped:", e, flush=True)
    else:
        render(Job("viking_room", lambda: viking, RenderFlags(max_depth=6, max_medium_events=2), None, spp), size,
               spp, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
