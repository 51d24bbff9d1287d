"""What the dispatch tools share: the JAX scripts' configuration of a named
procedural scene, one dispatch, and the line that names the device."""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.bench import card_description
from vpt_tpu_torch.core.camera import perspective
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene import procedural
from vpt_tpu_torch.scene.build import compile_scene

FLAGS = RenderFlags(max_depth=8, max_medium_events=8)  # the JAX scripts' flags


def bench_scene(scene_name: str, device):
    """(scene data, meta, params) of a named procedural scene compiled as the
    JAX scripts compile it (the constant energy-compensation fit), with its
    camera at a square aspect."""
    dev = resolve_device(device)
    data, meta, aux = compile_scene(getattr(procedural, scene_name)(), device=dev)
    proj = perspective(np.radians(aux["camera_fov_deg"]), 1.0)
    return data, meta, default_params(np.linalg.inv(aux["camera_view"]), np.linalg.inv(proj), device=dev)


def dispatch(scene_data, meta, flags, params, seed: int, size: int, spp: int, accum=None):
    """One render_step at `seed` of size x size pixels, spp samples each,
    waited for: (accumulation, segments as an int)."""
    if accum is None:
        accum = torch.zeros((size, size, 3), device=params.view_inverse.device)
    out, segs, _ = render_step(scene_data, meta, flags, params, seed, (size, size), accum, 0, spp)
    return out, int(segs)  # the host read waits for the dispatch


def device_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them, or the CPU named as such."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return card_description(dev.index or 0)
    return "cpu (no card: times are the host's)"
