"""The wavefront path integrator, surface branch (port of
vpt_tpu/render/integrator.py).

The whole pixel wavefront advances one path event per iteration: trace,
miss shading, the nested-dielectric walk, sky and emissive-triangle NEE
through one batched 2N shadow query, BSDF sampling with MIS, firefly clamp
and Russian roulette; a lane whose path ends starts its pixel's next sample
at once (path regeneration).  With volumes or the atmosphere each
iteration first samples a scatter distance through them; scatter events
shade like surfaces, with phase-function sampling, NEE transmittance and
the spectral channel split.  JAX's `lax.while_loop` becomes a host loop
bounded by n_samples * (max_depth + max_medium_events) iterations that
stops early once no lane is alive: that check reads one bool from the
device, one synchronisation per iteration; the media loops add theirs
(render/loop.py), and the total is returned.

Large scenes trace through the cluster tables in one of two modes, read
from `VPT_TRACE` once at import as in the JAX package: "stream" (default;
kernels 1-4) or "packet" (the packet trace through kernel 5); under
`VPT_REQUIRE_GOLDENS` a non-default value refuses the import
(envguard.guard_ablations).  Switch in
code with `mock.patch.object(integrator, "TRACE_MODE", "packet")`.
"""

from __future__ import annotations

import os

import torch

from vpt_tpu_torch.accel import traverse
from vpt_tpu_torch.accel.cluster import intersect_clusters
from vpt_tpu_torch.accel.occlude import occlude_stream
from vpt_tpu_torch.accel.stream import intersect_stream
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import generate_primary_rays
from vpt_tpu_torch.core.vecmath import dot, luminance, normalize, power_heuristic
from vpt_tpu_torch.envguard import guard_ablations
from vpt_tpu_torch.render import bsdf as bsdf_mod
from vpt_tpu_torch.render import atmosphere as atmo
from vpt_tpu_torch.render import lights, sampling, volumes
from vpt_tpu_torch.render import surface as surface_mod
from vpt_tpu_torch.render.loop import LoopStats
from vpt_tpu_torch.render.params import RenderFlags, RenderParams


guard_ablations()
TRACE_MODE = os.environ.get("VPT_TRACE", "stream")  # stream | packet


def trace(scene, meta, origin, direction, active, t_min=traverse.T_MIN, t_max=traverse.T_MAX):
    """Closest hit: brute force for small scenes, else the cluster stream
    trace, or the key-sorted packet trace in "packet" mode.  Inactive rays
    report a miss."""
    if meta.use_brute_force:
        n_real = meta.n_tris
        hit = traverse.intersect_brute(
            origin, direction, scene.tri_p0[:n_real], scene.tri_e1[:n_real], scene.tri_e2[:n_real],
            t_min, t_max,
        )
        return traverse.Hit(
            t=torch.where(active, hit.t, -1.0), tri=torch.where(active, hit.tri, -1), u=hit.u, v=hit.v,
        )
    if TRACE_MODE == "packet":
        return intersect_clusters(origin, direction, scene.clusters, t_min, t_max, active=active, sort_rays=True)
    return intersect_stream(origin, direction, scene.clusters, t_min, t_max, active=active)


def occlude(scene, meta, origin, direction, active, t_min=traverse.T_MIN, t_max=traverse.T_MAX,
            exclude_tri=None):
    """Shadow query: blocked iff a triangle with virtual id != exclude_tri
    intersects in (t_min, t_max).  The stream mode runs the occlusion
    kernel; brute-force scenes and the packet mode make a closest-hit trace
    and compare ids."""
    if not meta.use_brute_force and TRACE_MODE != "packet":
        return occlude_stream(origin, direction, scene.clusters, t_min, t_max, active=active,
                              exclude_tri=exclude_tri)
    hit = trace(scene, meta, origin, direction, active, t_min=t_min, t_max=t_max)
    return (hit.t >= 0.0) & (hit.tri != exclude_tri)


def _sel(mask, a, b):
    """torch.where with a (N,) mask against (N,) or (N, 3) operands."""
    if torch.is_tensor(a) and a.ndim == 2 or torch.is_tensor(b) and b.ndim == 2:
        mask = mask[:, None]
    return torch.where(mask, a, b)


def path_trace_sample(scene, meta, flags: RenderFlags, params: RenderParams, pixel_xy, pixel_index,
                      resolution, sample_seed: int, n_samples: int = 1):
    """Trace n_samples paths per pixel with path regeneration.

    Returns ((N, 3) radiance summed over samples, segment count as an int64
    device scalar, LoopStats: the media loops run and their steps, and the
    host synchronisations of the whole call)."""
    n = pixel_xy.shape[0]
    dev = pixel_xy.device
    f32 = torch.float32
    eps_scale = float(meta.scene_scale)
    s_floor = 0.0346 * eps_scale
    t_min_s = traverse.T_MIN * eps_scale
    center = torch.tensor(meta.scene_center, dtype=f32, device=dev)
    use_mesh_nee = flags.enable_mesh_mis and meta.n_emissive > 0
    sky_half = bool(flags.enable_sky_mis)
    use_volumes = meta.n_volumes > 0
    use_atmo = bool(flags.enable_atmosphere)
    any_media = use_volumes or use_atmo
    vt = scene.volumes
    media = LoopStats()  # the media loops'; the main loop's syncs join at the end

    # Every sample's primary rays up front; regeneration selects from them.
    pre = []
    for s in range(n_samples):
        rs = rng.seed(pixel_index, s, sample_seed)
        pre.append(generate_primary_rays(
            params.view_inverse, params.proj_inverse, pixel_xy, resolution, rs,
            params.focus_distance, params.dof_strength,
        ))
    state, origin, direction = pre[0]
    throughput = torch.ones((n, 3), dtype=f32, device=dev)
    radiance = torch.zeros((n, 3), dtype=f32, device=dev)
    lane_acc = torch.zeros((n, 3), dtype=f32, device=dev)
    sample_idx = torch.zeros(n, dtype=torch.int64, device=dev)
    prev_pdf = torch.ones(n, dtype=f32, device=dev)
    depth = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    in_medium = torch.zeros(n, dtype=torch.bool, device=dev)
    med_color = torch.ones((n, 3), dtype=f32, device=dev)
    med_density = torch.zeros(n, dtype=f32, device=dev)
    med_aniso = torch.zeros(n, dtype=f32, device=dev)
    channel = torch.full((n,), -1, dtype=torch.int64, device=dev)  # spectral split (RTCommon.slang:26-29)
    vol_depth = torch.zeros(n, dtype=torch.int64, device=dev)  # volume scatter count
    segments = torch.zeros((), dtype=torch.int64, device=dev)
    zeros3 = torch.zeros((n, 3), dtype=f32, device=dev)

    def fold(path_rad, ch):
        """Channel mask and NaN/Inf rejection of a finished path (RayGen.slang:116-128)."""
        if use_atmo:
            mask = (torch.arange(3, device=dev)[None, :] == ch[:, None]).to(f32)
            path_rad = path_rad * torch.where((ch < 0)[:, None], 1.0, mask)
        return torch.where(torch.isfinite(path_rad).all(dim=-1, keepdim=True), path_rad, 0.0)

    max_iters = n_samples * (flags.max_depth + flags.max_medium_events)
    syncs = 0
    for _ in range(max_iters):
        syncs += 1
        if not bool(alive.any()):
            break
        was_alive = alive
        if use_atmo:
            # Below the planet surface: the path ends (RayGen.slang:76-84).
            alive = alive & ~(atmo.atmosphere_height(params, origin) < 0.0)
        hit = trace(scene, meta, origin, direction, alive, t_min=t_min_s)
        hit_found = hit.t >= 0.0

        # Volume and atmosphere scattering (ScatteredInVolume, RayGen.slang:162-263).
        scatter_t = torch.full((n,), -1.0, device=dev)
        scatter_vol = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if use_volumes:
            if meta.n_volumes > 1:
                # One entry-sorted march over all volumes shares the loop budget.
                state, scatter_t, scatter_vol = volumes.scatter_distance_merged(
                    state, vt, meta.n_volumes, origin, direction, vol_depth, alive, media)
            else:
                state, t_vi = volumes.scatter_distance_in_volume(state, vt, 0, origin, direction, vol_depth, alive,
                                                                 media)
                closer = t_vi >= 0.0
                scatter_vol = torch.where(closer, 0, scatter_vol)
                scatter_t = torch.where(closer, t_vi, scatter_t)
        if use_atmo:
            # Channel pick for unsplit rays, stratified over (pixel, sample):
            # uint32 arithmetic, so the sum wraps before the modulus.
            cand = ((pixel_index + sample_idx + sample_seed) & 0xFFFFFFFF) % 3
            channel_eff = torch.where(channel < 0, cand, channel)
            state, at_t, at_comp = atmo.sample_scatter_distance(state, params, origin, direction, channel_eff, alive,
                                                                media)
            closer = (at_t >= 0.0) & ((at_t < scatter_t) | (scatter_t < 0.0))
            scatter_vol = torch.where(closer, -2, scatter_vol)
            scatter_t = torch.where(closer, at_t, scatter_t)
            atmo_comp = torch.where(closer, at_comp, -1)
        if any_media:
            dist_geo = torch.where(hit_found, hit.t, -1.0)
            vol_scatter = alive & (scatter_t >= 0.0) & ((dist_geo < 0.0) | (scatter_t < dist_geo))
            atmo_scatter = vol_scatter & (scatter_vol == -2)
            media_scatter = vol_scatter & (scatter_vol >= 0)
            vol_pos = origin + direction * torch.clamp(scatter_t, min=0.0)[:, None]
            missed = alive & ~hit_found & ~vol_scatter
            surf_lanes = alive & hit_found & ~vol_scatter
        else:
            missed = alive & ~hit_found
            surf_lanes = alive & hit_found

        # Miss shading (Miss.slang:8-77); with the atmosphere it adds nothing.
        if use_atmo:
            emitted = zeros3
        else:
            env_rgba = lights.env_radiance(scene.env, direction, params.sky_rotation_azimuth,
                                           params.sky_rotation_altitude)
            env_rgb = env_rgba[:, :3] * params.environment_intensity
            if not flags.show_env_map_directly:
                env_rgb = _sel(depth == 0, 0.0, env_rgb)
            if flags.furnace_test_mode:
                env_rgb = torch.ones_like(env_rgb)
            if flags.enable_sky_mis:
                env_rgb = env_rgb * torch.where(depth > 0, power_heuristic(prev_pdf, env_rgba[:, 3]), 1.0)[:, None]
            emitted = _sel(missed, env_rgb, zeros3)

        # In-medium walk (ClosestHit.slang:80-116).
        geom_dist = torch.where(hit_found, hit.t, traverse.T_MAX)
        state, scat_d = sampling.sample_scatter_distance(state, torch.clamp(med_density, min=1e-20))
        walk_lanes = surf_lanes & in_medium
        med_scatter = walk_lanes & (med_aniso != 1.0) & (scat_d < geom_dist)
        state, med_dir = sampling.sample_henyey_greenstein(state, direction, med_aniso)
        beer = torch.exp(-(1.0 - med_color) * (med_density * geom_dist)[:, None])
        beer_lanes = walk_lanes & (med_aniso == 1.0)
        shade = surf_lanes & ~med_scatter

        # Surface and material (Surface.slang / Material.slang).
        safe_tri = torch.clamp(hit.tri.to(torch.int64), 0, scene.tri_p0.shape[0] - 1)
        surf = surface_mod.make_surface(scene, safe_tri, hit.u, hit.v, direction,
                                        flags.use_only_geometry_normals, meta.has_textures)
        props = bsdf_mod.make_material(scene, surf.mat_row, surf.uv, surf.hit_from_inside,
                                       flags.furnace_test_mode, meta.has_textures)
        surf = surface_mod.rotate_tangents(surf, props.anisotropy_rotation)
        is_light = (props.emissive_color > 0.0).any(dim=-1)
        v_tan = surface_mod.world_to_tangent(surf, -direction)
        ec_comp = bsdf_mod.energy_comp_terms(props, scene, v_tan[..., 2], flags.use_energy_compensation)

        # NEE sampling: sky (or the sun disk) and emissive mesh, one batched shadow query.
        if sky_half:
            if use_atmo:
                state, to_sky, sky_rgb, sky_pdf = lights.sample_sun_disk(
                    state, params.sun_color, params.environment_intensity, params.sky_rotation_azimuth,
                    params.sky_rotation_altitude, n)
            else:
                state, to_sky, sky_rgba = lights.importance_sample_env(
                    state, scene.env, params.sky_rotation_azimuth, params.sky_rotation_altitude)
                sky_rgb = sky_rgba[:, :3] * params.environment_intensity
                sky_pdf = sky_rgba[:, 3]
            # ClosestHit.slang:133 applies the intensity a second time.
            sky_rgb = sky_rgb * params.environment_intensity
        nee_pos = _sel(vol_scatter, vol_pos, surf.world_pos) if any_media else surf.world_pos
        if use_mesh_nee:
            state, to_light, light_rgb, light_pdf, light_tri, light_dist = lights.sample_emissive_triangle(
                state, scene, nee_pos, meta.n_emissive, meta.has_textures)
        else:
            light_pdf = torch.zeros(n, dtype=f32, device=dev)

        p_mag = torch.linalg.vector_norm(surf.world_pos - center, dim=-1) + s_floor
        parts = []
        if sky_half:
            sky_org = surf.world_pos + surf.normal * (5.8e-6 * p_mag)[:, None]
            if any_media:
                need_sky = shade | media_scatter | atmo_scatter
                sky_org = _sel(vol_scatter, vol_pos, sky_org)
            else:
                need_sky = shade
            parts.append((sky_org, to_sky, need_sky, torch.full((n,), traverse.T_MAX, dtype=f32, device=dev),
                          torch.full((n,), -1, dtype=torch.int32, device=dev)))
        if use_mesh_nee:
            light_eps = 5e-3 * (light_dist + s_floor)
            light_org = surf.world_pos + to_light * light_eps[:, None]
            if any_media:
                need_light = ((shade & ~is_light) | media_scatter) & (light_pdf > 0.0)
                light_org = _sel(vol_scatter, vol_pos, light_org)
            else:
                need_light = shade & ~is_light & (light_pdf > 0.0)
            parts.append((light_org, to_light, need_light, torch.clamp(light_dist - light_eps, min=t_min_s),
                          light_tri))
        if parts:
            shadow_active = torch.cat([p[2] for p in parts])
            shadow_blocked = occlude(
                scene, meta, torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]), shadow_active,
                t_min=t_min_s, t_max=torch.cat([p[3] for p in parts]), exclude_tri=torch.cat([p[4] for p in parts]),
            )
            segments = segments + shadow_active.sum()
        if sky_half:
            can_hit_sky = need_sky & ~shadow_blocked[:n]
        if use_mesh_nee:
            can_hit_light = need_light & ~shadow_blocked[n if sky_half else 0:]

        # BSDF sampling (ClosestHit.slang:191-238).
        state, h_tan = sampling.sample_ggx_vndf(state, v_tan, props.ax, props.ay)
        state, l_tan, bxdf_s, pdf_s = bsdf_mod.sample_bsdf(state, props, v_tan, h_tan,
                                                           flags.use_energy_compensation, ec_comp)
        was_refracted = l_tan[:, 2] < 0.0
        scatter_world = surface_mod.tangent_to_world(surf, l_tan)
        leak = ~was_refracted & (dot(scatter_world, surf.geom_normal) < 0.0)
        pdf_s = torch.where(leak, 0.0, pdf_s)
        bxdf_s = _sel(leak, 0.0, bxdf_s)

        # Medium enter / exit on refraction (ClosestHit.slang:227-238).
        entering = shade & was_refracted & ~surf.hit_from_inside
        exiting = shade & was_refracted & surf.hit_from_inside
        new_in_medium = torch.where(entering, True, torch.where(exiting, False, in_medium))
        new_med_color = _sel(entering, props.medium_color, med_color)
        new_med_density = torch.where(entering, props.medium_density, med_density)
        new_med_aniso = torch.where(entering, props.medium_anisotropy, med_aniso)

        def nee_transmittance(state, org, dirs, ray_depth, lanes, through_atmo: bool):
            """Shadow-ray transmittance through the volumes and, for the sky
            and sun, the atmosphere: per channel for unsplit rays, the
            tracked channel for split ones (ClosestHit.slang:335-350)."""
            tr = torch.ones((n, 3), dtype=f32, device=dev)
            if use_volumes:
                march = volumes.volumes_transmittance_merged if meta.n_volumes > 1 else volumes.volumes_transmittance
                state, tv = march(state, vt, meta.n_volumes, org, dirs, ray_depth, lanes, media)
                tr = tr * tv[:, None]
            if through_atmo and use_atmo:
                cols = []
                for ch in range(3):
                    run = lanes & ((channel < 0) | (channel == ch))
                    state, ta = atmo.transmittance(state, params, org, dirs, torch.where(channel < 0, ch, channel),
                                                   run, media)
                    cols.append(torch.where(run, tr[:, ch] * ta, tr[:, ch]))
                tr = torch.stack(cols, dim=-1)
            return state, tr

        # NEE evaluation (ClosestHit.slang:240-256, 326-372).
        if sky_half:
            sky_bxdf, sky_eval_pdf = bsdf_mod.evaluate_bsdf(
                props, v_tan, surface_mod.world_to_tangent(surf, to_sky), flags.use_energy_compensation, ec_comp)
            if any_media:
                state, sky_trans = nee_transmittance(state, sky_org, to_sky, torch.zeros_like(depth), can_hit_sky,
                                                     True)
                sky_bxdf = sky_bxdf * sky_trans
            sky_ok = can_hit_sky & shade & (sky_pdf > 0.0) & (sky_eval_pdf > 0.0)
            sky_contrib = (sky_bxdf * sky_rgb / torch.clamp(sky_pdf, min=1e-20)[:, None]
                           * power_heuristic(sky_pdf, sky_eval_pdf)[:, None])
            emitted = emitted + _sel(sky_ok, sky_contrib, 0.0)
        if use_mesh_nee:
            l_bxdf, l_eval_pdf = bsdf_mod.evaluate_bsdf(
                props, v_tan, surface_mod.world_to_tangent(surf, to_light), flags.use_energy_compensation, ec_comp)
            if any_media:
                state, l_trans = nee_transmittance(state, light_org, to_light, torch.zeros_like(depth), can_hit_light,
                                                   False)
                l_bxdf = l_bxdf * l_trans
            l_ok = can_hit_light & shade & (light_pdf > 0.0) & (l_eval_pdf > 0.0) & ~is_light
            l_contrib = (l_bxdf * light_rgb / torch.clamp(light_pdf, min=1e-20)[:, None]
                         * power_heuristic(light_pdf, l_eval_pdf)[:, None])
            emitted = emitted + _sel(l_ok, l_contrib, 0.0)

        # Volume scattering events (EvaluateVolumeScatteringEvent, RayGen.slang:265-380).
        if any_media:
            vol_dir = direction
            vol_bxdf = zeros3
            vol_pdf = torch.ones(n, dtype=f32, device=dev)
        if use_volumes:
            vidx = torch.clamp(scatter_vol, 0, max(meta.n_volumes - 1, 0))
            # Emission: the volume's colour plus temperature (RayGen.slang:268).
            state, temp_emit = volumes.temperature_emission(state, vt, vidx, vol_pos)
            emitted = emitted + _sel(media_scatter, vt.emissive_color[vidx] + temp_emit, 0.0)
            # The phase sample gives the new direction.
            state, sampled_dir = volumes.phase_sample(state, vt, vidx, direction, vol_depth, flags.phase_function)
            phase_new = volumes.phase_eval(vt, vidx, direction, sampled_dir, vol_depth, flags.phase_function)
            vol_color = vt.color[vidx]
            vol_dir = _sel(media_scatter, sampled_dir, vol_dir)
            vol_bxdf = _sel(media_scatter, vol_color * phase_new[:, None], vol_bxdf)
            vol_pdf = torch.where(media_scatter, phase_new, vol_pdf)
            if sky_half:
                # Sky MIS at the scatter point (RayGen.slang:319-352).
                phase_sky = volumes.phase_eval(vt, vidx, direction, to_sky, vol_depth, flags.phase_function)
                state, v_sky_tr = nee_transmittance(state, vol_pos, to_sky, vol_depth, can_hit_sky & media_scatter,
                                                    True)
                ok = media_scatter & can_hit_sky & (sky_pdf > 0.0) & (phase_sky > 0.0)
                contrib = (v_sky_tr * (vol_color * phase_sky[:, None]) * sky_rgb
                           / torch.clamp(sky_pdf, min=1e-20)[:, None] * power_heuristic(sky_pdf, phase_sky)[:, None])
                emitted = emitted + _sel(ok, contrib, 0.0)
            if use_mesh_nee:
                # Mesh MIS at the scatter point (RayGen.slang:355-372).
                phase_l = volumes.phase_eval(vt, vidx, direction, to_light, vol_depth, flags.phase_function)
                state, v_l_tr = nee_transmittance(state, vol_pos, to_light, vol_depth + 1,
                                                  can_hit_light & media_scatter, False)
                ok = media_scatter & can_hit_light & (light_pdf > 0.0) & (phase_l > 0.0)
                contrib = (v_l_tr * (vol_color * phase_l[:, None]) * light_rgb
                           / torch.clamp(light_pdf, min=1e-20)[:, None] * power_heuristic(light_pdf, phase_l)[:, None])
                emitted = emitted + _sel(ok, contrib, 0.0)

        # Atmosphere scattering events (EvaluateAtmosphereScatteringEvent, RayGen.slang:382-471).
        if use_atmo:
            channel = torch.where(atmo_scatter, channel_eff, channel)
            state, dir_ray = sampling.sample_rayleigh(state, direction)
            state, dir_mie = sampling.sample_henyey_greenstein(state, direction, 0.85)
            is_ray = atmo_comp == atmo.COMPONENT_RAYLEIGH
            is_mie = atmo_comp == atmo.COMPONENT_MIE
            a_dir = _sel(is_ray, dir_ray, _sel(is_mie, dir_mie, direction))
            ph_ray = sampling.phase_rayleigh(direction, a_dir)
            ph_mie = sampling.phase_henyey_greenstein(direction, a_dir, 0.85)
            mie_atten = atmo.coefficients(dev)[3]
            if sky_half:
                # MIS variant (RayGen.slang:425-452): the HG BxDF with
                # single-scatter albedo 1 - absorption / extinction.
                mie_bxdf = ph_mie[:, None] * (1.0 - mie_atten)[None, :]
            else:
                # Non-MIS variant (RayGen.slang:455-465): PhaseMie over the HG
                # pdf, times the reference's own attenuation factor.
                mie_bxdf = sampling.phase_mie_approx(direction, a_dir)[:, None] * mie_atten[None, :]
            a_bxdf = _sel(is_ray, ph_ray[:, None] * torch.ones((1, 3), device=dev), _sel(is_mie, mie_bxdf, zeros3))
            a_pdf = torch.where(is_ray, ph_ray, torch.where(is_mie, ph_mie, 1.0))
            vol_dir = _sel(atmo_scatter, a_dir, vol_dir)
            vol_bxdf = _sel(atmo_scatter, a_bxdf, vol_bxdf)
            vol_pdf = torch.where(atmo_scatter, a_pdf, vol_pdf)
            if sky_half:
                # Sun NEE at the scatter point, no MIS weight (RayGen.slang:404-452).
                ph_mie_sky = sampling.phase_henyey_greenstein(direction, to_sky, 0.85)
                ph_sky = torch.where(is_ray, sampling.phase_rayleigh(direction, to_sky),
                                     torch.where(is_mie, ph_mie_sky, 0.0))
                state, a_tr = nee_transmittance(state, vol_pos, to_sky, vol_depth, atmo_scatter & can_hit_sky, True)
                oka = atmo_scatter & can_hit_sky & (sky_pdf > 0.0)
                contrib = ph_sky[:, None] * a_tr * sky_rgb / torch.clamp(sky_pdf, min=1e-20)[:, None]
                emitted = emitted + _sel(oka, contrib, 0.0)

        # Emissive surface hit, direct or MIS-weighted (ClosestHit.slang:265-317).
        if flags.enable_mesh_mis:
            emitted = emitted + _sel(shade & (depth == 0) & is_light, props.emissive_color, 0.0)
            to_pos = surf.world_pos - origin
            dist_sq = dot(to_pos, to_pos)
            cos_t = torch.abs(dot(surf.normal, normalize(origin - surf.world_pos)))
            light_sampling_pdf = (
                (1.0 / float(max(meta.n_emissive, 1)))
                * (1.0 / torch.clamp(surf.em_tcount, min=1.0))
                * (1.0 / torch.clamp(surf.area, min=1e-20))
                * (dist_sq / torch.clamp(cos_t, min=1e-20))
            )
            light_sampling_pdf = torch.clamp(light_sampling_pdf, min=params.emissive_pdf_bias)
            mis_emit = props.emissive_color * power_heuristic(prev_pdf, light_sampling_pdf)[:, None]
            emitted = emitted + _sel(shade & (depth > 0) & is_light, mis_emit, 0.0)
        else:
            emitted = emitted + _sel(shade, props.emissive_color, 0.0)

        # Contribution and firefly clamp (RayGen.slang:92-102); a hit or
        # scatter event at depth 0 is not clamped.
        contribution = emitted * throughput
        scale = params.max_luminance / torch.clamp(luminance(contribution), min=params.max_luminance)
        no_clamp = (depth == 0) & ((surf_lanes | vol_scatter) if any_media else surf_lanes)
        contribution = _sel(no_clamp, contribution, contribution * scale[:, None])
        radiance = radiance + _sel(alive, contribution, 0.0)

        # Throughput update and event bookkeeping (RayGen.slang:103).
        invalid = shade & (pdf_s <= 0.0)
        factor = _sel(shade, bxdf_s / torch.clamp(pdf_s, min=1e-20)[:, None], torch.ones((n, 3), dtype=f32, device=dev))
        factor = _sel(beer_lanes, factor * beer, factor)
        factor = _sel(med_scatter, med_color, factor)
        if any_media:
            factor = _sel(vol_scatter, vol_bxdf / torch.clamp(vol_pdf, min=1e-20)[:, None], factor)
        throughput = throughput * _sel(alive, factor, 1.0)

        bounce_eps = (5.8e-4 * p_mag)[:, None]
        new_origin = _sel(
            shade, surf.world_pos + surf.normal * torch.where(was_refracted[:, None], -bounce_eps, bounce_eps), origin)
        new_origin = _sel(med_scatter, origin + direction * scat_d[:, None], new_origin)
        new_direction = _sel(shade, scatter_world, direction)
        new_direction = _sel(med_scatter, med_dir, new_direction)
        if any_media:
            new_origin = _sel(vol_scatter, vol_pos, new_origin)
            new_direction = _sel(vol_scatter, vol_dir, new_direction)
            prev_pdf = torch.where(shade, pdf_s, torch.where(med_scatter | vol_scatter,
                                                             torch.where(vol_scatter, vol_pdf, 1.0), prev_pdf))
            depth = depth + (shade | vol_scatter).to(torch.int64)
            vol_depth = vol_depth + media_scatter.to(torch.int64)
        else:
            prev_pdf = torch.where(shade, pdf_s, torch.where(med_scatter, 1.0, prev_pdf))
            depth = depth + shade.to(torch.int64)  # medium events do not age the path
        alive = alive & ~missed & ~invalid & (depth < flags.max_depth)

        # Russian roulette (RayGen.slang:105-113).
        p = torch.clamp(throughput.amax(dim=-1), max=1.0)
        state, u_rr = rng.next_float(state)
        alive = alive & ~(p < u_rr)
        throughput = _sel(alive, throughput / torch.clamp(p, min=1e-20)[:, None], throughput)
        segments = segments + was_alive.sum()

        # Path regeneration: fold finished paths, start the next sample.
        path_end = was_alive & ~alive
        lane_acc = lane_acc + _sel(path_end, fold(radiance, channel), 0.0)
        regen = path_end & (sample_idx + 1 < n_samples)
        sample_idx = torch.where(regen, sample_idx + 1, sample_idx)
        rs, o_new, d_new = pre[min(1, n_samples - 1)]
        for s in range(2, n_samples):
            pick = sample_idx == s
            rs = torch.where(pick, pre[s][0], rs)
            o_new = _sel(pick, pre[s][1], o_new)
            d_new = _sel(pick, pre[s][2], d_new)
        origin = _sel(regen, o_new, new_origin)
        direction = normalize(_sel(regen, d_new, new_direction))
        state = torch.where(regen, rs, state)
        alive = alive | regen
        radiance = _sel(path_end, 0.0, radiance)
        throughput = _sel(regen, 1.0, throughput)
        prev_pdf = torch.where(regen, 1.0, prev_pdf)
        depth = torch.where(regen, 0, depth)
        in_medium = new_in_medium & ~regen
        med_color = _sel(regen, 1.0, new_med_color)
        med_density = torch.where(regen, 0.0, new_med_density)
        med_aniso = torch.where(regen, 0.0, new_med_aniso)
        channel = torch.where(regen, -1, channel)
        vol_depth = torch.where(regen, 0, vol_depth)

    # Paths cut by the iteration cap fold with what they have.
    lane_acc = lane_acc + _sel(alive, fold(radiance, channel), 0.0)
    media.syncs += syncs
    return lane_acc, segments, media


def render_samples(scene, meta, flags, params, pixel_xy, pixel_index, resolution, frame_seed: int,
                   n_samples: int):
    """Mean of n_samples paths per pixel: ((N, 3), segments, LoopStats)."""
    acc, segs, stats = path_trace_sample(scene, meta, flags, params, pixel_xy, pixel_index, resolution,
                                         frame_seed, n_samples=n_samples)
    return acc / n_samples, segs, stats


def accumulate_ewma(prev_color, new_color, frame_count: int):
    """Progressive accumulation: lerp(prev, new, 1 / (n + 1))."""
    return prev_color + (new_color - prev_color) * (1.0 / (float(frame_count) + 1.0))
