"""Render parameters (port of vpt_tpu/render/params.py).

`RenderFlags` are the reference's compile-time switches; `RenderParams`
its uniform buffer.  The camera matrices are tensors on the render device;
the scalars are Python floats.  The atmosphere block waits for the
atmosphere port.  Defaults match PathTracer.h:197-233.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RenderFlags:
    enable_sky_mis: bool = True
    enable_mesh_mis: bool = True
    show_env_map_directly: bool = True
    use_only_geometry_normals: bool = False
    use_energy_compensation: bool = True
    furnace_test_mode: bool = False
    enable_atmosphere: bool = False  # not ported yet: rendering raises
    max_depth: int = 200
    max_medium_events: int = 32  # extra iteration slack for in-medium walks


class RenderParams(NamedTuple):
    view_inverse: torch.Tensor  # (4, 4)
    proj_inverse: torch.Tensor  # (4, 4)
    max_luminance: float = 500.0  # firefly clamp
    focus_distance: float = 1.0
    dof_strength: float = 0.0
    sky_rotation_azimuth: float = 0.0  # degrees
    sky_rotation_altitude: float = 0.0  # degrees
    environment_intensity: float = 1.0
    emissive_pdf_bias: float = 0.0


def default_params(device, view_inverse=None, proj_inverse=None) -> RenderParams:
    def mat(m):
        m = np.eye(4, dtype=np.float32) if m is None else np.asarray(m, np.float32)
        return torch.as_tensor(m, device=device)

    return RenderParams(view_inverse=mat(view_inverse), proj_inverse=mat(proj_inverse))
