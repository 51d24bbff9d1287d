"""`render_step` and `Renderer` (port of vpt_tpu/api.py).

`render_step` is one progressive dispatch: n_samples new paths per pixel in
8x8-tiled ray order, scattered back to a row-major image and EWMA'd into
the accumulation buffer.  `Renderer` keeps the accumulation state of one
compiled scene on one device, mirroring the reference's PathTracer host
object: progressive accumulation, typed setters that each restart it
(the atmosphere's and the phase function's included), volumes,
post-processing (bloom, tonemap), PNG / HDR export, checkpoints and the
per-dispatch metrics log.  Its energy-compensation tables are baked on its
device by default (`lookup_tables="auto"`), as the JAX package's are.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from vpt_tpu_torch.core.camera import FlyCamera, look_at, perspective
from vpt_tpu_torch.core.tiling import scatter_to_image, tiled_pixel_order
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.io.image import export_filename, save_hdr, save_png
from vpt_tpu_torch.io.metrics_log import RenderLog
from vpt_tpu_torch.post.bloom import bloom as bloom_pass
from vpt_tpu_torch.post.tonemap import tonemap as tonemap_pass
from vpt_tpu_torch.render import integrator
from vpt_tpu_torch.render.lookup import get_lookup_tables, load_reference_tables
from vpt_tpu_torch.render.params import PHASE_FUNCTIONS, RenderFlags, default_params, scalar, vec3
from vpt_tpu_torch.scene.build import build_material_attr, build_volume_table, compile_scene
from vpt_tpu_torch.scene.envmap import load_hdr, prepare_environment
from vpt_tpu_torch.scene.types import Material, Scene, Volume, tree_to_device
from vpt_tpu_torch.scene.vdb import load_grid


@dataclasses.dataclass
class PostSettings:
    """PostProcessor knobs (PostProcessor.h:36-50 defaults)."""

    exposure: float = 1.0
    gamma: float = 2.2
    bloom_threshold: float = 1.5
    bloom_strength: float = 0.5
    bloom_falloff: float = 0.5
    bloom_mip_levels: int = 10
    tonemap_mode: str = "aces"
    enable_bloom: bool = False


@functools.lru_cache(maxsize=8)
def tiled_pixels(width: int, height: int, device: torch.device):
    """(pixel_xy, pixel_index, scatter, padded) of `tiled_pixel_order` on
    `device`, made once per size: the JAX package closes its step over
    these arrays, so the port keeps them beside its steps (render/graphs.py)
    instead of copying them to the device on every dispatch."""
    pxy, pidx, sct, padded = tiled_pixel_order(width, height)
    return (torch.as_tensor(pxy, device=device), torch.as_tensor(pidx.astype(np.int64), device=device),
            torch.as_tensor(sct, device=device), padded)


def render_step(scene_data, meta, flags, params, frame_seed: int, resolution, accum, frame_count: int,
                n_samples: int):
    """One dispatch: (new accumulation (H, W, 3), segments traced as an int64
    device scalar, LoopStats of the media loops with the dispatch's host
    reads).  On a CUDA device the loop is one launch of the configuration's
    dispatch graph (render/graphs.py)."""
    width, height = resolution
    pxy, pidx, sct, padded = tiled_pixels(width, height, accum.device)
    radiance, segments, stats = integrator.render_samples(
        scene_data, meta, flags, params, pxy, pidx, resolution, frame_seed, n_samples,
    )
    new = scatter_to_image(radiance, sct, padded, width, height)
    return integrator.accumulate_ewma(accum, new, frame_count), segments, stats


class Renderer:
    """Progressive path tracer over one compiled scene on `device`."""

    def __init__(self, scene: Scene, width=None, height=None, flags: RenderFlags = RenderFlags(),
                 samples_per_frame: int = 1, max_samples: int = 5000, lookup_tables="auto", metrics_log=None, *,
                 device="cuda"):
        """The JAX package's parameters in its order, then the keyword-only
        `device`.  `lookup_tables`: "auto" bakes the energy-compensation
        tables on `device` (or loads the cached bake) when the flags use
        them, "reference" loads the reference's committed tables, None uses
        the constant fit; three tables or fits may also be passed.
        `metrics_log`: a path to append one JSON record per dispatch to, or
        a `RenderLog`; None logs nothing."""
        self._scene_host = scene
        self.device = resolve_device(device)
        if isinstance(lookup_tables, str):
            if lookup_tables == "auto":
                lookup_tables = get_lookup_tables(device=self.device) if flags.use_energy_compensation else None
            elif lookup_tables == "reference":
                lookup_tables = load_reference_tables()
            else:
                raise ValueError('lookup_tables must be "auto", "reference", None or three tables, '
                                 f"not {lookup_tables!r}")
        self.scene_data, self.meta, aux = compile_scene(scene, lookup_tables, device=self.device)
        self.volumes = []  # host Volume list; add_volume and friends rebuild the table
        self.flags = flags
        self.post = PostSettings()
        # Output sized 1080 * aspect x 1080 like the reference (PathTracer.cpp:507-512).
        height = 1080 if height is None else height
        width = int(round(height * aux["camera_aspect"])) if width is None else width
        self.width, self.height = width, height
        view = aux["camera_view"]
        if view is None:
            view = look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        proj = perspective(np.radians(aux["camera_fov_deg"]), width / height)
        self.params = default_params(np.linalg.inv(view), np.linalg.inv(proj), device=self.device)
        self.camera = FlyCamera.from_matrices(view, proj)
        self.samples_per_frame = samples_per_frame
        self.max_samples = max_samples
        self._accum = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        self.frame_count = 0
        self.samples_accumulated = 0
        self._seed_counter = 0
        self.render_seconds = 0.0
        self.segments_traced = 0.0
        self.last_host_syncs = 0  # host reads of the last dispatch: inside its loops, and after its graph's launch
        self.last_media_steps = 0  # volume and atmosphere loop steps of the last dispatch
        self.metrics = (RenderLog.open(metrics_log) if isinstance(metrics_log, str)
                        else (metrics_log or RenderLog.null()))

    # ------------------------------------------------------------------ core

    def reset_path_tracing(self) -> None:
        """ResetPathTracing (PathTracer.h:183): the next dispatch starts a
        new accumulation."""
        self.frame_count = 0
        self.samples_accumulated = 0
        self.render_seconds = 0.0
        self.segments_traced = 0.0

    reset_accumulation = reset_path_tracing

    def path_trace(self) -> bool:
        """One progressive dispatch; True once max_samples are accumulated."""
        if self.samples_accumulated >= self.max_samples:
            return True
        t0 = time.perf_counter()
        self._seed_counter += 1
        seed = (self._seed_counter * 2654435761) & 0xFFFFFFFF
        accum = self._accum if self.frame_count > 0 else torch.zeros_like(self._accum)
        self._accum, segments, stats = render_step(
            self.scene_data, self.meta, self.flags, self.params, seed, (self.width, self.height),
            accum, self.frame_count, self.samples_per_frame,
        )
        self.last_host_syncs, self.last_media_steps = stats.syncs + stats.launch_reads, stats.steps
        segments = float(segments)  # waits for the dispatch to finish
        dt = time.perf_counter() - t0
        self.segments_traced += segments
        self.render_seconds += dt
        self.frame_count += 1
        self.samples_accumulated += self.samples_per_frame
        self.metrics.dispatch(
            frame=self.frame_count, seed=seed, spp=self.samples_per_frame, wall_s=dt, segments=segments,
            samples_accumulated=self.samples_accumulated, resolution=(self.width, self.height),
            scene=self.meta.name,
        )
        return self.samples_accumulated >= self.max_samples

    def render(self, total_samples: Optional[int] = None, verbose: bool = False) -> np.ndarray:
        """Accumulate until max_samples; returns the HDR image."""
        if total_samples is not None:
            self.max_samples = total_samples
        while not self.path_trace():
            if verbose and self.frame_count % 16 == 0:
                eta = self.render_seconds * (self.max_samples - self.samples_accumulated) / max(
                    self.samples_accumulated, 1)
                print(f"[vpt] {self.samples_accumulated}/{self.max_samples} spp, "
                      f"{self.render_seconds:.1f}s elapsed, ETA {eta:.1f}s")
        return self.hdr_image()

    # ---------------------------------------------------------------- output

    def hdr_image(self) -> np.ndarray:
        return self._accum.cpu().numpy()

    def output_image(self) -> np.ndarray:
        """Post-processed LDR image (PostProcessor::PostProcess equivalent)."""
        img = self._accum
        bl = None
        if self.post.enable_bloom:
            bl = bloom_pass(img, threshold=self.post.bloom_threshold, strength=self.post.bloom_strength,
                            falloff_range=self.post.bloom_falloff, mip_levels=self.post.bloom_mip_levels)
        out = tonemap_pass(img, bloom=bl, exposure=self.post.exposure, gamma=self.post.gamma,
                           mode=self.post.tonemap_mode)
        return out.cpu().numpy()

    def save(self, path: str, embed_stats: bool = False) -> str:
        """Write the tonemapped PNG (or, for `.npy`, the HDR buffer); with
        `embed_stats` the name carries spp and seconds.  Returns the path."""
        if embed_stats:
            base = path[:-4] if path.endswith(".png") else path
            path = export_filename(base, self.samples_accumulated, self.render_seconds)
        if path.endswith(".npy"):
            save_hdr(path, self.hdr_image())
        else:
            save_png(path, self.output_image())
        return path

    # ------------------------------------------------------------ checkpoint

    def save_checkpoint(self, path: str) -> None:
        """Accumulation buffer and counters: the full resumable state."""
        np.savez(path, accum=self.hdr_image(), frame_count=self.frame_count,
                 samples_accumulated=self.samples_accumulated, seed_counter=self._seed_counter,
                 render_seconds=self.render_seconds)

    def load_checkpoint(self, path: str) -> None:
        d = np.load(path if path.endswith(".npz") else path + ".npz")
        self._accum = torch.as_tensor(d["accum"], device=self.device)
        self.frame_count = int(d["frame_count"])
        self.samples_accumulated = int(d["samples_accumulated"])
        self._seed_counter = int(d["seed_counter"])
        self.render_seconds = float(d["render_seconds"])

    # --------------------------------------------------------------- setters
    # Every setter resets accumulation, like the reference's Set* methods.

    def _param(self, **kw) -> None:
        """New parameter values (a number becomes a 0-d float32 tensor on
        the device); the cached steps copy them in at the next dispatch."""
        kw = {k: v if torch.is_tensor(v) else scalar(v, self.device) for k, v in kw.items()}
        self.params = self.params._replace(**kw)
        self.reset_path_tracing()

    def _flag(self, **kw) -> None:
        self.flags = dataclasses.replace(self.flags, **kw)
        self.reset_path_tracing()

    def set_camera(self, view=None, proj=None) -> None:
        kw = {}
        if view is not None:
            kw["view_inverse"] = np.linalg.inv(np.asarray(view, np.float32))
        if proj is not None:
            kw["proj_inverse"] = np.linalg.inv(np.asarray(proj, np.float32))
        self._param(**{k: torch.as_tensor(v.astype(np.float32), device=self.device) for k, v in kw.items()})

    def sync_fly_camera(self) -> None:
        self.set_camera(view=self.camera.view_matrix(), proj=self.camera.proj_matrix())

    def set_max_depth(self, d: int) -> None:
        self._flag(max_depth=int(d))

    def set_max_samples(self, s: int) -> None:
        self.max_samples = int(s)

    def set_samples_per_frame(self, s: int) -> None:
        self.samples_per_frame = int(s)
        self.reset_path_tracing()

    def set_max_luminance(self, v: float) -> None:
        self._param(max_luminance=float(v))

    def set_focus_distance(self, v: float) -> None:
        self._param(focus_distance=float(v))

    def set_dof_strength(self, v: float) -> None:
        self._param(dof_strength=float(v))

    def set_sky_azimuth(self, deg: float) -> None:
        self._param(sky_rotation_azimuth=float(deg))

    def set_sky_altitude(self, deg: float) -> None:
        self._param(sky_rotation_altitude=float(deg))

    def set_sky_intensity(self, v: float) -> None:
        self._param(environment_intensity=float(v))

    def set_emissive_pdf_bias(self, v: float) -> None:
        self._param(emissive_pdf_bias=float(v))

    def set_sky_mis(self, on: bool) -> None:
        self._flag(enable_sky_mis=bool(on))

    def set_mesh_mis(self, on: bool) -> None:
        self._flag(enable_mesh_mis=bool(on))

    def set_env_map_shown_directly(self, on: bool) -> None:
        self._flag(show_env_map_directly=bool(on))

    def set_use_only_geometry_normals(self, on: bool) -> None:
        self._flag(use_only_geometry_normals=bool(on))

    def set_use_energy_compensation(self, on: bool) -> None:
        self._flag(use_energy_compensation=bool(on))

    def set_furnace_test_mode(self, on: bool) -> None:
        self._flag(furnace_test_mode=bool(on))

    def set_sun_color(self, rgb) -> None:
        self._param(sun_color=vec3(rgb, self.device))

    def set_enable_atmosphere(self, on: bool) -> None:
        self._flag(enable_atmosphere=bool(on))

    def set_phase_function(self, name: str) -> None:
        if name not in PHASE_FUNCTIONS:
            raise ValueError(f"phase function must be one of {PHASE_FUNCTIONS}, not {name!r}")
        self._flag(phase_function=name)

    # Atmosphere parameters (PathTracer.h:168-179): the scalars rounded to
    # float32 by _param, the (3,) vectors made on the device once per call.
    def set_planet_position(self, pos) -> None:
        self._param(planet_position=vec3(pos, self.device))

    def set_planet_radius(self, r: float) -> None:
        self._param(planet_radius=float(r))

    def set_atmosphere_height(self, h: float) -> None:
        self._param(atmosphere_height=float(h))

    def set_rayleigh_scattering_multiplier(self, m) -> None:
        self._param(rayleigh_scattering_multiplier=vec3(m, self.device))

    def set_mie_scattering_multiplier(self, m) -> None:
        self._param(mie_scattering_multiplier=vec3(m, self.device))

    def set_ozone_absorption_multiplier(self, m) -> None:
        self._param(ozone_absorption_multiplier=vec3(m, self.device))

    def set_rayleigh_density_falloff(self, v: float) -> None:
        self._param(rayleigh_density_falloff=float(v))

    def set_mie_density_falloff(self, v: float) -> None:
        self._param(mie_density_falloff=float(v))

    def set_ozone_density_falloff(self, v: float) -> None:
        self._param(ozone_density_falloff=float(v))

    def set_ozone_peak(self, v: float) -> None:
        self._param(ozone_peak=float(v))

    def set_env_map(self, env) -> None:
        """SetEnvMapFilepath (PathTracer.cpp:1137-1332): a `.npy`, `.hdr`,
        PNG or JPEG path (`load_hdr`) or an (H, W, 3) array; rebuilds the
        alias map."""
        if isinstance(env, str):
            env = load_hdr(env)
        env = np.asarray(env, np.float32)
        self._scene_host.env_map = env
        self.scene_data = self.scene_data._replace(env=tree_to_device(prepare_environment(env), self.device))
        self.reset_path_tracing()

    @property
    def total_vertex_count(self) -> int:
        return int(sum(m.positions.shape[0] for m in self._scene_host.meshes))

    @property
    def total_index_count(self) -> int:
        return int(sum(m.indices.shape[0] for m in self._scene_host.meshes))

    def set_material(self, index: int, material: Material) -> None:
        """SetMaterial (PathTracer.cpp:1010-): replace one material."""
        self._scene_host.materials[index] = material
        attr = build_material_attr(self._scene_host.materials)
        self.scene_data = self.scene_data._replace(material_attr=torch.as_tensor(attr, device=self.device))
        self.reset_path_tracing()

    def get_material(self, index: int) -> Material:
        return self._scene_host.materials[index]

    @property
    def materials(self):
        return self._scene_host.materials

    def resize_image(self, width: int, height: int) -> None:
        """A new output size; the projection follows the new aspect ratio."""
        self.width, self.height = width, height
        self._accum = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        self.camera.aspect = width / height
        self.set_camera(proj=self.camera.proj_matrix())

    # --------------------------------------------------------------- volumes
    # AddVolume / SetVolume / RemoveVolume (PathTracer.cpp:1334-).  The only
    # way volumes enter a render, as in the JAX package.

    def _rebuild_volumes(self) -> None:
        self.scene_data = self.scene_data._replace(
            volumes=tree_to_device(build_volume_table(self.volumes), self.device))
        n_het = sum(1 for v in self.volumes if v.density_grid is not None)
        self.meta = dataclasses.replace(self.meta, n_volumes=len(self.volumes), n_het_volumes=n_het)
        self.reset_path_tracing()

    def add_volume(self, volume: Volume) -> None:
        self.volumes.append(volume)
        self._rebuild_volumes()

    def set_volume(self, index: int, volume: Volume) -> None:
        self.volumes[index] = volume
        self._rebuild_volumes()

    def remove_volume(self, index: int) -> None:
        self.volumes.pop(index)
        self._rebuild_volumes()

    def add_density_data_to_volume(self, index: int, grid, temperature=None) -> None:
        """AddDensityDataToVolume (PathTracer.cpp:1347-1516): a dense
        (D, H, W) density grid, or a `.npy` / `.npz` path, and optionally a
        temperature grid the same way."""
        self.volumes[index].density_grid = load_grid(grid) if isinstance(grid, str) else grid
        if temperature is not None:
            self.volumes[index].temperature_grid = (
                load_grid(temperature) if isinstance(temperature, str) else temperature)
        self._rebuild_volumes()

    def remove_density_data_from_volume(self, index: int) -> None:
        self.volumes[index].density_grid = None
        self.volumes[index].temperature_grid = None
        self._rebuild_volumes()
