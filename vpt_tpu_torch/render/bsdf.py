"""Energy-conserving five-lobe BSDF (port of vpt_tpu/render/bsdf.py):
metallic, diffuse, specular dielectric, glass reflect and glass refract,
selected with the reference's normalised probabilities and evaluated as a
one-sample MIS estimator over all lobes, in tangent space (+Z = normal)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import dot, normalize, reflect, refract, unit_axis
from vpt_tpu_torch.render import sampling
from vpt_tpu_torch.render.lookup_fit import eval_fit, layer_coord
from vpt_tpu_torch.render.surface import sample_texture

# Lobe ids (BSDFComponent, Material.slang:20-27): sample_bsdf's `component`.
METALLIC, DIFFUSE, SPECULAR_DIELECTRIC, GLASS_REFLECT, GLASS_REFRACT = range(5)


class MaterialProps(NamedTuple):
    base_color: torch.Tensor  # (N, 3)
    emissive_color: torch.Tensor  # (N, 3)
    specular_color: torch.Tensor  # (N, 3)
    medium_color: torch.Tensor  # (N, 3)
    metallic: torch.Tensor  # (N,)
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    anisotropy: torch.Tensor
    anisotropy_rotation: torch.Tensor
    medium_density: torch.Tensor
    medium_anisotropy: torch.Tensor
    eta: torch.Tensor  # relative IOR by hit side
    ax: torch.Tensor
    ay: torch.Tensor


def make_material(scene, mat_row, uv, hit_from_inside, furnace_test_mode: bool, has_textures: bool = True):
    """Per-ray material from the packed (N, MAT_ATTR_COLS) rows, textures applied."""
    base = mat_row[:, 0:3]
    emissive = mat_row[:, 3:6]
    specular = mat_row[:, 6:9]
    medium_color = mat_row[:, 9:12]
    metal = mat_row[:, 15]
    rough = mat_row[:, 16]
    if has_textures:
        def tex(col):
            return sample_texture(scene.textures, scene.texture_dims, mat_row[:, col].to(torch.int64), uv)

        base = base * torch.pow(torch.clamp(tex(23)[:, :3], min=0.0), 2.2)
        rough = rough * tex(25)[:, 0]
        metal = metal * tex(26)[:, 0]
        emissive = emissive * tex(27)[:, :3]
    ior = torch.clamp(mat_row[:, 17], min=1.000001)
    aniso = mat_row[:, 19]
    aspect = torch.sqrt(1.0 - torch.sqrt(torch.clamp(aniso, min=0.0)) * 0.9)
    if furnace_test_mode:
        base = torch.ones_like(base)
        emissive = torch.zeros_like(emissive)
        specular = torch.ones_like(specular)
        medium_color = torch.ones_like(medium_color)
    return MaterialProps(
        base_color=base,
        emissive_color=emissive,
        specular_color=specular,
        medium_color=medium_color,
        metallic=metal,
        roughness=rough,
        ior=ior,
        transmission=mat_row[:, 18],
        anisotropy=aniso,
        anisotropy_rotation=mat_row[:, 20],
        medium_density=mat_row[:, 21],
        medium_anisotropy=mat_row[:, 22],
        eta=torch.where(hit_from_inside, ior, 1.0 / ior),
        ax=torch.clamp(rough / aspect, min=1e-5),
        ay=torch.clamp(rough * aspect, min=1e-5),
    )


def lobe_probabilities(props: MaterialProps):
    p_metal = props.metallic
    p_diel = (1.0 - props.metallic) * (1.0 - props.transmission)
    p_glass = (1.0 - props.metallic) * props.transmission
    total = torch.clamp(p_metal + p_diel + p_glass, min=1e-20)
    return p_metal / total, p_diel / total, p_glass / total


def schlick_fresnel(vdoth):
    m = torch.clamp(1.0 - vdoth, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _nonzero(x):
    return torch.where(torch.abs(x) < 1e-20, 1e-20, x)


def dielectric_fresnel(vdoth, eta):
    """Exact dielectric Fresnel with total internal reflection."""
    cos_i = vdoth
    sin_t_sq = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t_sq, min=0.0))
    rs = (eta * cos_t - cos_i) / _nonzero(eta * cos_t + cos_i)
    rp = (eta * cos_i - cos_t) / _nonzero(eta * cos_i + cos_t)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin_t_sq > 1.0, 1.0, f)


def ggx_d_anisotropic(h, ax, ay):
    hx2 = h[..., 0] ** 2
    hy2 = h[..., 1] ** 2
    hz2 = h[..., 2] ** 2
    denom = math.pi * ax * ay * (hx2 / (ax * ax) + hy2 / (ay * ay) + hz2) ** 2
    return 1.0 / torch.clamp(denom, min=1e-20)


def ggx_smith_lambda(v, ax, ay):
    vx2 = v[..., 0] ** 2
    vy2 = v[..., 1] ** 2
    vz2 = v[..., 2] ** 2
    return (-1.0 + torch.sqrt(1.0 + (ax * ax * vx2 + ay * ay * vy2) / torch.clamp(vz2, min=1e-20))) / 2.0


def ggx_smith_g1(v, ax, ay):
    return 1.0 / (1.0 + ggx_smith_lambda(v, ax, ay))


def energy_comp_terms(props: MaterialProps, scene, vz, use_energy_compensation: bool):
    """Turquin energy terms (E_reflect, E_glass) from the Chebyshev fits;
    computed once per bounce and shared by the three BSDF evaluations."""
    if not use_energy_compensation:
        one = torch.ones_like(vz)
        return one, one
    layer_g = layer_coord((torch.clamp(props.ior, 1.0001, 2.0) - 1.0) * 32.0, 32)
    u_g = torch.sqrt(torch.clamp(vz, min=0.0))
    comp_in = eval_fit(scene.lookup_refract_in, u_g, props.roughness, layer_g)
    comp_out = eval_fit(scene.lookup_refract_out, u_g, props.roughness, layer_g)
    glass_comp = torch.clamp(torch.where(props.eta > 1.0, comp_in, comp_out), 0.0, 1.0)
    layer_r = layer_coord(props.anisotropy * 32.0, 32)
    refl_e = torch.clamp(eval_fit(scene.lookup_reflect, vz, props.roughness, layer_r), 1e-4, 1.0)
    return refl_e, glass_comp


def evaluate_reflection(v, l, f_color, ax, ay):
    """Microfacet reflection: (brdf (N, 3), pdf (N,))."""
    h = normalize(v + l)
    vdoth = dot(v, h)
    d = ggx_d_anisotropic(h, ax, ay)
    gv = ggx_smith_g1(v, ax, ay)
    gl = ggx_smith_g1(l, ax, ay)
    vz = torch.clamp(v[..., 2], min=1e-8)
    pdf = (gv * torch.clamp(vdoth, min=0.0) * d / vz) / torch.clamp(4.0 * vdoth, min=1e-20)
    brdf = (d * gv * gl / (4.0 * vz))[..., None] * f_color
    bad = l[..., 2] <= 1e-5
    return torch.where(bad[..., None], 0.0, brdf), torch.where(bad, 0.0, pdf)


def evaluate_refraction(v, l, f_color, eta, ax, ay):
    """Microfacet refraction with the eta^2 Jacobian."""
    h = normalize(eta[..., None] * v + l)
    h = torch.where((h[..., 2] < 0.0)[..., None], -h, h)
    vdoth = dot(v, h)
    ldoth = dot(l, h)
    d = ggx_d_anisotropic(h, ax, ay)
    gv = ggx_smith_g1(v, ax, ay)
    gl = ggx_smith_g1(l, ax, ay)
    denom = ldoth + eta * vdoth
    denom2 = torch.clamp(denom * denom, min=1e-20)
    eta2 = eta * eta
    jac = (eta2 * torch.abs(ldoth)) / denom2
    vz = torch.clamp(torch.abs(v[..., 2]), min=1e-8)
    pdf = (gv * torch.abs(vdoth) * d / vz) * jac
    bsdf_s = (d * gv * gl * eta2 / denom2) * (torch.abs(vdoth) * torch.abs(ldoth) / vz)
    bad = l[..., 2] >= 1e-5
    return torch.where(bad[..., None], 0.0, bsdf_s[..., None] * f_color), torch.where(bad, 0.0, pdf)


def evaluate_bsdf(props: MaterialProps, scene, v, l, use_energy_compensation: bool, comp=None):
    """One-sample-MIS evaluation over all lobes: (bxdf (N, 3), pdf (N,)).
    `comp` is the (refl_e, glass_comp) pair from energy_comp_terms, which
    depends only on (v, material), so a bounce's evaluations share one; with
    None it is computed here from `scene`'s fits."""
    p_metal, p_diel, p_glass = lobe_probabilities(props)
    refracted = l[..., 2] < 0.0
    h_refl = normalize(v + l)
    h_refr = normalize(props.eta[..., None] * v + l)
    h_refr = torch.where((h_refr[..., 2] < 0.0)[..., None], -h_refr, h_refr)
    h = torch.where(refracted[..., None], h_refr, h_refl)
    vdoth = dot(v, h)
    ldoth = dot(l, h)
    valid_refraction = ((vdoth > 0.0) & (ldoth < 0.0)) | ((vdoth < 0.0) & (ldoth > 0.0))
    f_diel = dielectric_fresnel(torch.abs(vdoth), props.eta)
    if comp is None:
        comp = energy_comp_terms(props, scene, v[..., 2], use_energy_compensation)
    refl_e, glass_comp = comp
    not_refr = (~refracted)[..., None]

    bxdf = torch.zeros_like(v)
    pdf = torch.zeros_like(f_diel)

    # Metallic
    f_metal = props.base_color + (props.specular_color - props.base_color) * schlick_fresnel(dot(v, h_refl))[..., None]
    m_brdf, m_pdf = evaluate_reflection(v, l, f_metal, props.ax, props.ay)
    if use_energy_compensation:
        m_brdf = (1.0 + props.base_color * ((1.0 - refl_e) / refl_e)[..., None]) * m_brdf
    bxdf = bxdf + torch.where(not_refr, m_brdf * p_metal[..., None], 0.0)
    pdf = pdf + torch.where(~refracted, m_pdf * p_metal, 0.0)

    # Diffuse
    lz = l[..., 2]
    d_pdf = torch.where(lz > 0.0, lz / math.pi, 0.0)
    d_brdf = props.base_color * (lz / math.pi)[..., None]
    w_d = p_diel * (1.0 - f_diel)
    bxdf = bxdf + torch.where(not_refr, d_brdf * w_d[..., None], 0.0)
    pdf = pdf + torch.where(~refracted, d_pdf * w_d, 0.0)

    # Specular dielectric
    s_brdf, s_pdf = evaluate_reflection(v, l, props.specular_color, props.ax, props.ay)
    if use_energy_compensation:
        s_brdf = s_brdf / refl_e[..., None]
    w_s = p_diel * f_diel
    bxdf = bxdf + torch.where(not_refr, s_brdf * w_s[..., None], 0.0)
    pdf = pdf + torch.where(~refracted, s_pdf * w_s, 0.0)

    # Glass reflect
    comp_ok = (glass_comp > 0.01)[..., None]
    comp_div = torch.clamp(glass_comp, min=1e-4)[..., None]
    g_brdf, g_pdf = evaluate_reflection(v, l, props.specular_color, props.ax, props.ay)
    g_brdf = torch.where(comp_ok, g_brdf / comp_div, g_brdf)
    w_gr = p_glass * f_diel
    bxdf = bxdf + torch.where(not_refr, g_brdf * w_gr[..., None], 0.0)
    pdf = pdf + torch.where(~refracted, g_pdf * w_gr, 0.0)

    # Glass refract
    r_bsdf, r_pdf = evaluate_refraction(v, l, props.base_color, props.eta, props.ax, props.ay)
    r_bsdf = torch.where(comp_ok, r_bsdf / comp_div, r_bsdf)
    w_gt = p_glass * (1.0 - f_diel)
    ok_refr = refracted & valid_refraction
    bxdf = bxdf + torch.where(ok_refr[..., None], r_bsdf * w_gt[..., None], 0.0)
    pdf = pdf + torch.where(ok_refr, r_pdf * w_gt, 0.0)
    return bxdf, pdf


def sample_bsdf(state, props: MaterialProps, scene, v, h, use_energy_compensation: bool, comp=None):
    """Lobe selection, direction sampling and full evaluation from the
    pre-sampled VNDF half-vector `h`: (state, l, bxdf, pdf, component), the
    last the picked lobe's id (int32)."""
    p_metal, p_diel, _ = lobe_probabilities(props)
    f_diel = dielectric_fresnel(dot(v, h), props.eta)
    state, x1 = rng.next_float(state)
    state, x2 = rng.next_float(state)
    # The cosine draw is consumed on every lane to keep the RNG chain aligned.
    state, l_diffuse = sampling.sample_cosine_hemisphere(state, unit_axis(2, v).expand(v.shape))
    l_reflect = normalize(reflect(-v, h))
    l_refract = normalize(refract(-v, h, props.eta))

    pick_metal = x1 < p_metal
    pick_diel = (~pick_metal) & (x1 < p_metal + p_diel)
    pick_glass = (~pick_metal) & (~pick_diel)
    reflect_branch = x2 < f_diel
    component = torch.where(
        pick_metal, METALLIC,
        torch.where(pick_diel, torch.where(reflect_branch, SPECULAR_DIELECTRIC, DIFFUSE),
                    torch.where(reflect_branch, GLASS_REFLECT, GLASS_REFRACT))).to(torch.int32)
    use_reflect = pick_metal | (pick_diel & reflect_branch) | (pick_glass & reflect_branch)
    use_diffuse = pick_diel & ~reflect_branch
    l = torch.where(use_reflect[..., None], l_reflect, torch.where(use_diffuse[..., None], l_diffuse, l_refract))
    refracted = pick_glass & ~reflect_branch
    invalid = (~refracted & (l[..., 2] < 0.0)) | (refracted & (l[..., 2] >= 0.0))

    bxdf, pdf = evaluate_bsdf(props, scene, v, l, use_energy_compensation, comp)
    return state, l, torch.where(invalid[..., None], 0.0, bxdf), torch.where(invalid, 0.0, pdf), component
