"""Energy-compensation lookup-table bake (port of vpt_tpu/render/lookup.py;
Turquin 2019, LookupReflect.slang / LookupRefract.slang).

* reflection table (32, 64, 64): directional albedo E(V.z, roughness,
  anisotropy) of the GGX reflection lobe;
* refraction tables (32, 128, 128) x 2: directional albedo of the full
  dielectric reflect + refract over (sqrt-encoded V.z, roughness, IOR in
  [1, 2]), for hits from outside (eta = 1 / ior) and from inside.

Every texel runs its own PCG stream seeded as the JAX package seeds it, and
the estimators are the JAX package's, so a bake on any device reproduces
its tables to float32 rounding.  The sample loop runs on the device the
caller names.  Baked tables are cached as `.npy` files under the
git-ignored `.cache/` at the repository root, named `torch_lookup_*`.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import normalize, reflect, refract
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.render import sampling
from vpt_tpu_torch.render.bsdf import dielectric_fresnel, ggx_d_anisotropic, ggx_smith_g1

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".cache")

REFLECT_SHAPE = (32, 64, 64)  # (anisotropy layer, roughness row, V.z col)
REFRACT_SHAPE = (32, 128, 128)  # (ior layer, roughness row, sqrt(V.z) col)



def _view_vector(state, view_cos):
    state, u_phi = rng.next_float(state)
    xy = torch.sqrt(torch.clamp(1.0 - view_cos * view_cos, min=0.0))
    phi = u_phi * 2.0 * math.pi
    return state, normalize(torch.stack([xy * torch.cos(phi), xy * torch.sin(phi), view_cos], dim=-1))


def _reflection_estimate(state, view_cos, ax, ay):
    """One sample of the GGX reflection directional albedo."""
    state, v = _view_vector(state, view_cos)
    state, h = sampling.sample_ggx_vndf(state, v, ax, ay)
    l = normalize(reflect(-v, h))
    # EvaluateReflection with F = 1 (Material.slang:331-351)
    d = ggx_d_anisotropic(h, ax, ay)
    gv = ggx_smith_g1(v, ax, ay)
    gl = ggx_smith_g1(l, ax, ay)
    vdoth = (v * h).sum(dim=-1)
    vz = torch.clamp(v[..., 2], min=1e-8)
    pdf = (gv * torch.clamp(vdoth, min=0.0) * d / vz) / torch.clamp(4.0 * vdoth, min=1e-20)
    brdf = d * gv * gl / (4.0 * vz)
    val = brdf / torch.clamp(pdf, min=1e-20)
    ok = (l[..., 2] > 0.0) & (pdf > 0.0) & torch.isfinite(val)
    return state, torch.where(ok, val, 0.0)


def _refraction_estimate(state, view_cos, roughness, eta):
    state, v = _view_vector(state, view_cos)
    ax = ay = roughness
    state, h = sampling.sample_ggx_vndf(state, v, ax, ay)
    vdoth = (v * h).sum(dim=-1)
    f = dielectric_fresnel(torch.abs(vdoth), eta)
    state, u_f = rng.next_float(state)

    # Reflection branch (F = 1 evaluation)
    l_r = normalize(reflect(-v, h))
    d = ggx_d_anisotropic(h, ax, ay)
    gv = ggx_smith_g1(v, ax, ay)
    vz = torch.clamp(v[..., 2], min=1e-8)
    gl_r = ggx_smith_g1(l_r, ax, ay)
    pdf_r = (gv * torch.clamp(vdoth, min=0.0) * d / vz) / torch.clamp(4.0 * vdoth, min=1e-20)
    brdf_r = d * gv * gl_r / (4.0 * vz)
    val_r = brdf_r / torch.clamp(pdf_r, min=1e-20)
    ok_r = (l_r[..., 2] > 0.0) & (pdf_r > 0.0) & torch.isfinite(val_r)

    # Refraction branch (EvaluateRefraction with F = 1)
    l_t = normalize(refract(-v, h, eta))
    ldoth = (l_t * h).sum(dim=-1)
    gl_t = ggx_smith_g1(l_t, ax, ay)
    denom = ldoth + eta * vdoth
    denom2 = torch.clamp(denom * denom, min=1e-20)
    eta2 = eta * eta
    jac = eta2 * torch.abs(ldoth) / denom2
    pdf_t = (gv * torch.abs(vdoth) * d / vz) * jac
    bsdf_t = (d * gv * gl_t * eta2 / denom2) * (torch.abs(vdoth) * torch.abs(ldoth) / vz)
    val_t = bsdf_t / torch.clamp(pdf_t, min=1e-20)
    ok_t = (l_t[..., 2] < 0.0) & (pdf_t > 0.0) & torch.isfinite(val_t)

    val = torch.where(u_f < f, torch.where(ok_r, val_r, 0.0), torch.where(ok_t, val_t, 0.0))
    return state, val


def _grid(shape, device):
    nl, nr, nv = shape
    f32 = torch.float32
    return (torch.arange(nl, dtype=f32, device=device)[:, None, None],
            torch.arange(nr, dtype=f32, device=device)[None, :, None],
            torch.arange(nv, dtype=f32, device=device)[None, None, :])


def _bake(estimate, inputs, shape, n_samples: int, seed: int) -> np.ndarray:
    """Average n_samples draws of `estimate` per texel; texel i's stream
    starts at pcg_hash(i + seed)."""
    inputs = [x.expand(shape).reshape(-1) for x in inputs]
    state = rng.pcg_hash(torch.arange(int(np.prod(shape)), dtype=torch.int64, device=inputs[0].device) + seed)
    acc = torch.zeros_like(inputs[0])
    for _ in range(n_samples):
        state, val = estimate(state, *inputs)
        acc = acc + val
    return (acc / n_samples).reshape(shape).cpu().numpy()


def bake_reflection_table(n_samples: int = 4096, seed: int = 7, device="cuda") -> np.ndarray:
    layer, row, col = _grid(REFLECT_SHAPE, resolve_device(device))
    nl, nr, nv = REFLECT_SHAPE
    view_cos = torch.clamp(col / nv, 0.05, 0.999)
    roughness = torch.clamp(row / nr, 0.0001, 1.0)
    aspect = torch.sqrt(1.0 - torch.sqrt(layer / nl) * 0.9)
    ax = torch.clamp(roughness / aspect, min=1e-4)
    ay = torch.clamp(roughness * aspect, min=1e-4)
    return _bake(_reflection_estimate, (view_cos, ax, ay), REFLECT_SHAPE, n_samples, seed)


def bake_refraction_table(above_surface: bool, n_samples: int = 4096, seed: int = 13, device="cuda") -> np.ndarray:
    layer, row, col = _grid(REFRACT_SHAPE, resolve_device(device))
    nl, nr, nv = REFRACT_SHAPE
    view_cos = torch.clamp((col / (nv - 1.0)) ** 2, 0.01, 0.9999)
    roughness = torch.clamp(row / (nr - 1.0), 0.01, 1.0)
    ior = 1.0 + torch.clamp(layer / (nl - 1.0), 0.0001, 1.0)
    eta = (1.0 / ior) if above_surface else ior
    return _bake(_refraction_estimate, (view_cos, roughness, eta), REFRACT_SHAPE, n_samples, seed)


def load_reference_tables(table_dir: str | None = None):
    """The reference's committed ground-truth tables (10M samples per texel,
    PathTracer.cpp:199-201) from `table_dir`, or else from the directory
    the environment variable VPT_REFERENCE_TABLES names (the reference's
    Assets/LookupTables): raw float32 [layer][row][col], returned as
    (reflect, refract_out, refract_in), "out" being hits from outside
    (eta = 1 / ior).  Raises FileNotFoundError if the files are absent."""
    table_dir = table_dir or os.environ.get("VPT_REFERENCE_TABLES")
    if table_dir is None:
        raise FileNotFoundError("pass table_dir or set VPT_REFERENCE_TABLES to the reference's LookupTables directory")

    def read(name, shape):
        a = np.fromfile(os.path.join(table_dir, name), dtype=np.float32)
        if a.size != np.prod(shape):
            raise ValueError(f"{name}: expected {np.prod(shape)} f32, got {a.size}")
        return a.reshape(shape)

    return (
        read("ReflectionLookup.bin", REFLECT_SHAPE),
        read("RefractionLookupHitFromOutside.bin", REFRACT_SHAPE),
        read("RefractionLookupHitFromInside.bin", REFRACT_SHAPE),
    )


def get_lookup_tables(n_samples: int = 4096, cache_dir: str | None = None, device="cuda"):
    """Bake on `device` (or load the cached bake): (reflect, refract_out, refract_in)."""
    cache_dir = cache_dir or CACHE_DIR
    paths = [os.path.join(cache_dir, f"torch_lookup_{k}_{n_samples}.npy")
             for k in ("reflect", "refract_out", "refract_in")]
    if all(os.path.exists(p) for p in paths):
        return tuple(np.load(p) for p in paths)
    tables = (
        bake_reflection_table(n_samples, device=device),
        bake_refraction_table(above_surface=True, n_samples=n_samples, device=device),
        bake_refraction_table(above_surface=False, n_samples=n_samples, device=device),
    )
    os.makedirs(cache_dir, exist_ok=True)
    for p, t in zip(paths, tables):
        np.save(p, t)
    return tables
