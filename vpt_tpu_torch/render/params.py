"""Render parameters (port of vpt_tpu/render/params.py).

`RenderFlags` are the reference's compile-time switches; `RenderParams`
its uniform buffer.  The camera matrices and the (3,) colour and position
fields are tensors on the render device, made once; the scalars are Python
floats (the atmosphere's rounded to float32 as the JAX package stores
them).  Defaults match PathTracer.h:197-233.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

PHASE_FUNCTIONS = ("hg", "draine", "hg_draine")


@dataclasses.dataclass(frozen=True)
class RenderFlags:
    enable_sky_mis: bool = True
    enable_mesh_mis: bool = True
    show_env_map_directly: bool = True
    use_only_geometry_normals: bool = False
    use_energy_compensation: bool = True
    furnace_test_mode: bool = False
    enable_atmosphere: bool = False
    phase_function: str = "hg"  # "hg" | "draine" | "hg_draine"
    max_depth: int = 200
    max_medium_events: int = 32  # extra iteration slack for in-medium walks


class RenderParams(NamedTuple):
    view_inverse: torch.Tensor  # (4, 4)
    proj_inverse: torch.Tensor  # (4, 4)
    sun_color: torch.Tensor  # (3,)
    # Atmosphere block (Bindings.slang:27-37); meters.
    planet_position: torch.Tensor  # (3,)
    rayleigh_scattering_multiplier: torch.Tensor  # (3,)
    mie_scattering_multiplier: torch.Tensor  # (3,)
    ozone_absorption_multiplier: torch.Tensor  # (3,)
    max_luminance: float = 500.0  # firefly clamp
    focus_distance: float = 1.0
    dof_strength: float = 0.0
    sky_rotation_azimuth: float = 0.0  # degrees
    sky_rotation_altitude: float = 0.0  # degrees
    environment_intensity: float = 1.0
    emissive_pdf_bias: float = 0.0
    planet_radius: float = 6360e3
    atmosphere_height: float = 100e3
    rayleigh_density_falloff: float = 8000.0
    mie_density_falloff: float = 1200.0
    ozone_density_falloff: float = 5000.0
    ozone_peak: float = 22000.0


def f32(v) -> float:
    """A scalar parameter rounded to float32, as a Python float."""
    return float(np.float32(v))


def vec3(v, device) -> torch.Tensor:
    """A (3,) float32 parameter on `device` (one host-to-device copy)."""
    return torch.as_tensor(np.asarray(v, np.float32).reshape(3), device=device)


def default_params(device, view_inverse=None, proj_inverse=None) -> RenderParams:
    def mat(m):
        m = np.eye(4, dtype=np.float32) if m is None else np.asarray(m, np.float32)
        return torch.as_tensor(m, device=device)

    return RenderParams(
        view_inverse=mat(view_inverse),
        proj_inverse=mat(proj_inverse),
        sun_color=vec3((1.0, 0.956, 0.88), device),
        planet_position=vec3((0.0, 6360e3 + 1000.0, 0.0), device),
        rayleigh_scattering_multiplier=vec3((1.0, 1.0, 1.0), device),
        mie_scattering_multiplier=vec3((1.0, 1.0, 1.0), device),
        ozone_absorption_multiplier=vec3((1.0, 1.0, 1.0), device),
    )
