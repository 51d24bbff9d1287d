"""`render_step` and a minimal `Renderer` (port of vpt_tpu/api.py).

`render_step` is one progressive dispatch: n_samples new paths per pixel in
8x8-tiled ray order, scattered back to a row-major image and EWMA'd into
the accumulation buffer.  `Renderer` keeps the accumulation state of one
compiled scene on one device.  PNG export, the setters, checkpoints and
post-processing are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vpt_tpu_torch.core.camera import look_at, perspective
from vpt_tpu_torch.core.tiling import scatter_to_image, tiled_pixel_order
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.render import integrator
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene.build import compile_scene


def render_step(scene_data, meta, flags, params, frame_seed: int, resolution, accum, frame_count: int,
                n_samples: int):
    """One dispatch: (new accumulation (H, W, 3), segments traced as an int64
    device scalar, host synchronisations made)."""
    width, height = resolution
    dev = accum.device
    pxy, pidx, sct, padded = tiled_pixel_order(width, height)
    radiance, segments, syncs = integrator.render_samples(
        scene_data, meta, flags, params, torch.as_tensor(pxy, device=dev),
        torch.as_tensor(pidx.astype(np.int64), device=dev), resolution, frame_seed, n_samples,
    )
    new = scatter_to_image(radiance, torch.as_tensor(sct, device=dev), padded, width, height)
    return integrator.accumulate_ewma(accum, new, frame_count), segments, syncs


class Renderer:
    """Progressive path tracer over one compiled scene on `device`."""

    def __init__(self, scene, device, width=None, height=None, flags: RenderFlags = RenderFlags(),
                 samples_per_frame: int = 1, max_samples: int = 5000):
        self.device = resolve_device(device)
        self.scene_data, self.meta, aux = compile_scene(scene, self.device)
        self.flags = flags
        height = 1080 if height is None else height
        width = int(round(height * aux["camera_aspect"])) if width is None else width
        self.width, self.height = width, height
        view = aux["camera_view"]
        if view is None:
            view = look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        proj = perspective(np.radians(aux["camera_fov_deg"]), width / height)
        self.params = default_params(self.device, np.linalg.inv(view), np.linalg.inv(proj))
        self.samples_per_frame = samples_per_frame
        self.max_samples = max_samples
        self._accum = torch.zeros((height, width, 3), dtype=torch.float32, device=self.device)
        self.frame_count = 0
        self.samples_accumulated = 0
        self._seed_counter = 0
        self.render_seconds = 0.0
        self.segments_traced = 0
        self.last_host_syncs = 0

    def path_trace(self) -> bool:
        """One progressive dispatch; True once max_samples are accumulated."""
        if self.samples_accumulated >= self.max_samples:
            return True
        t0 = time.perf_counter()
        self._seed_counter += 1
        seed = (self._seed_counter * 2654435761) & 0xFFFFFFFF
        accum = self._accum if self.frame_count > 0 else torch.zeros_like(self._accum)
        self._accum, segments, self.last_host_syncs = render_step(
            self.scene_data, self.meta, self.flags, self.params, seed, (self.width, self.height),
            accum, self.frame_count, self.samples_per_frame,
        )
        self.segments_traced += int(segments)  # waits for the dispatch to finish
        self.render_seconds += time.perf_counter() - t0
        self.frame_count += 1
        self.samples_accumulated += self.samples_per_frame
        return self.samples_accumulated >= self.max_samples

    def render(self, total_samples=None) -> np.ndarray:
        """Accumulate until max_samples; returns the HDR image."""
        if total_samples is not None:
            self.max_samples = total_samples
        while not self.path_trace():
            pass
        return self.hdr_image()

    def hdr_image(self) -> np.ndarray:
        return self._accum.cpu().numpy()
