"""Render parameters (port of vpt_tpu/render/params.py).

`RenderFlags` are the reference's compile-time switches; `RenderParams`
its uniform buffer, in the JAX package's field order.  Every field is a
float32 tensor on the render device, as the JAX package holds each as a
float32 array: the matrices (4, 4), the colour and position fields (3,),
the scalars 0-d.  A dispatch copies them into its captured step's own
buffers (render/graphs.py), so a new camera, sky or intensity changes what
the step computes without capturing it again.  Defaults match
PathTracer.h:197-233.
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
    samples_per_launch: int = 1
    max_medium_events: int = 32  # extra iteration slack for in-medium walks


class RenderParams(NamedTuple):
    view_inverse: torch.Tensor  # (4, 4)
    proj_inverse: torch.Tensor  # (4, 4)
    max_luminance: torch.Tensor  # firefly clamp, default 500
    focus_distance: torch.Tensor
    dof_strength: torch.Tensor
    sky_rotation_azimuth: torch.Tensor  # degrees
    sky_rotation_altitude: torch.Tensor  # degrees
    environment_intensity: torch.Tensor
    emissive_pdf_bias: torch.Tensor
    sun_color: torch.Tensor  # (3,)
    # Atmosphere block (Bindings.slang:27-37); meters.
    planet_position: torch.Tensor  # (3,)
    planet_radius: torch.Tensor
    atmosphere_height: torch.Tensor
    rayleigh_scattering_multiplier: torch.Tensor  # (3,)
    mie_scattering_multiplier: torch.Tensor  # (3,)
    ozone_absorption_multiplier: torch.Tensor  # (3,)
    rayleigh_density_falloff: torch.Tensor
    mie_density_falloff: torch.Tensor
    ozone_density_falloff: torch.Tensor
    ozone_peak: torch.Tensor


def scalar(v, device) -> torch.Tensor:
    """A 0-d float32 parameter on `device`, rounded as np.float32 rounds."""
    return torch.as_tensor(np.float32(v), device=device)


def vec3(v, device) -> torch.Tensor:
    """A (3,) float32 parameter on `device` (one host-to-device copy)."""
    return torch.as_tensor(np.asarray(v, np.float32).reshape(3), device=device)


def default_params(view_inverse=None, proj_inverse=None, *, device="cuda") -> RenderParams:
    """The JAX package's defaults on `device` (the card unless the caller
    asks for the CPU); the matrices default to the identity."""
    def mat(m):
        m = np.eye(4, dtype=np.float32) if m is None else np.asarray(m, np.float32)
        return torch.as_tensor(m, device=device)

    return RenderParams(
        view_inverse=mat(view_inverse),
        proj_inverse=mat(proj_inverse),
        max_luminance=scalar(500.0, device),
        focus_distance=scalar(1.0, device),
        dof_strength=scalar(0.0, device),
        sky_rotation_azimuth=scalar(0.0, device),
        sky_rotation_altitude=scalar(0.0, device),
        environment_intensity=scalar(1.0, device),
        emissive_pdf_bias=scalar(0.0, device),
        sun_color=vec3((1.0, 0.956, 0.88), device),
        planet_position=vec3((0.0, 6360e3 + 1000.0, 0.0), device),
        planet_radius=scalar(6360e3, device),
        atmosphere_height=scalar(100e3, device),
        rayleigh_scattering_multiplier=vec3((1.0, 1.0, 1.0), device),
        mie_scattering_multiplier=vec3((1.0, 1.0, 1.0), device),
        ozone_absorption_multiplier=vec3((1.0, 1.0, 1.0), device),
        rayleigh_density_falloff=scalar(8000.0, device),
        mie_density_falloff=scalar(1200.0, device),
        ozone_density_falloff=scalar(5000.0, device),
        ozone_peak=scalar(22000.0, device),
    )
