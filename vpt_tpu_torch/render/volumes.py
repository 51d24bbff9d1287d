"""Participating media: homogeneous and heterogeneous AABB volumes (port of
vpt_tpu/render/volumes.py, Volume.slang).

Analytic exponential sampling for homogeneous volumes; delta tracking
(null collisions) restarted per 32^3 max-density block for heterogeneous
ones; ratio tracking with Russian roulette for transmittance; dense-brick
grid sampling with the reference's +-1 voxel jitter; blackbody / palette
temperature emission; the HG, Draine and HG+Draine phase functions.

The stochastic loops run through `loop.while_live`, which reproduces the
JAX package's iteration counts.  A volume index `vi` is a slice of one
volume (the single-volume functions) or an (N,) tensor of per-lane
volumes (the merged march): both broadcast the same way, and neither
indexes with a 0-dim tensor, which would read it back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.vecmath import blackbody_rgb, pow32
from vpt_tpu_torch.render import sampling
from vpt_tpu_torch.render.loop import LoopStats, while_live

BLOCK_DIM = 32  # MAX_DENSITY_GRID_DIM (Volume.slang:11)
MAX_DELTA_STEPS = 2048  # the reference uses 10000 (Volume.slang:298)
MAX_TRANSMITTANCE_STEPS = 512  # the reference: 1000 (Volume.slang:458)


def intersect_aabb(origin, direction, bmin, bmax):
    """Ray-AABB (Volume.slang:190-213): (near, far), both -1 when tmax < 0
    or tmin > tmax."""
    inv = 1.0 / torch.where(torch.abs(direction) > 1e-20, direction, 1e-20)
    t0 = (bmin - origin) * inv
    t1 = (bmax - origin) * inv
    tn = torch.minimum(t0, t1).amax(dim=-1)
    tf = torch.maximum(t0, t1).amin(dim=-1)
    miss = (tf < 0.0) | (tn > tf)
    return torch.where(miss, -1.0, tn), torch.where(miss, -1.0, tf)


def _grid_sample(state, grids, grid_idx, grid_max, sharpness, cmin, cmax, x):
    """Dense-brick fetch with +-1 voxel jitter (Volume.slang:69-117): the
    position normalised inside [cmin, cmax] with y flipped, the value
    / grid_max * sharpness clamped to [0, 1].  grids is (G, D, H, W)."""
    _, d, h, w = grids.shape
    npos = (x - cmin) / torch.clamp(cmax - cmin, min=1e-20)
    ix = (npos[..., 0] * w).to(torch.int64)
    iy = ((1.0 - npos[..., 1]) * h).to(torch.int64)
    iz = (npos[..., 2] * d).to(torch.int64)
    jitter = []
    for _ in range(3):
        state, j = rng.next_uint(state)
        jitter.append(j % 3 - 1)
    ix = torch.clamp(ix + jitter[0], 0, w - 1)
    iy = torch.clamp(iy + jitter[1], 0, h - 1)
    iz = torch.clamp(iz + jitter[2], 0, d - 1)
    val = grids[grid_idx, iz, iy, ix]
    return state, torch.clamp(val / torch.clamp(grid_max, min=1e-20) * sharpness, 0.0, 1.0)


def _effective_density(vol, vi, base, ray_depth):
    approx = vol.approx_cloud_scattering[vi] != 0
    fall = vol.approx_scattering_falloff[vi]
    return torch.where(approx, base * pow32(fall, ray_depth.to(torch.float32)), base)


def _effective_anisotropy(vol, vi, ray_depth):
    g = vol.anisotropy[vi]
    approx = vol.approx_cloud_scattering[vi] != 0
    dec = pow32(torch.abs(g), 1.0 + ray_depth.to(torch.float32)) * torch.sign(g)
    return torch.where(approx, dec, g)


def _grid_of(vol, vi):
    return torch.clamp(vol.density_grid_index[vi], min=0).to(torch.int64)


def density_at_point(state, vol, vi, x, ray_depth):
    """GetDensityAtPoint x GetEffectiveDensity."""
    if vol.density_grids.shape[0] == 0:
        base = vol.density[vi]
    else:
        state, gval = _grid_sample(state, vol.density_grids, _grid_of(vol, vi), vol.max_density[vi],
                                   vol.grid_sharpness[vi], vol.corner_min[vi], vol.corner_max[vi], x)
        base = torch.where(vol.density_grid_index[vi] >= 0, gval * vol.density[vi], vol.density[vi])
    return state, _effective_density(vol, vi, base, ray_depth)


class _Blocks:
    """The block-DDA geometry of the volumes `vi` (Volume.slang:291-356)."""

    def __init__(self, vol, vi):
        self.vol, self.vi = vol, vi
        self.cmin, self.cmax = vol.corner_min[vi], vol.corner_max[vi]
        ext = self.cmax - self.cmin
        self.ext = ext
        self.size = ext / BLOCK_DIM
        self.eps = 1e-4 * ext.amax(dim=-1)
        g = vol.max_density_blocks.shape[0]
        self.flat = vol.max_density_blocks.reshape(g, -1)
        self.grid = _grid_of(vol, vi)

    def step(self, state, origin, direction, near0, t, ray_depth):
        """One restart: the block containing near0 + t + eps, its majorant and
        a sampled free flight.  Returns (state, t_new, test lanes before the
        live mask, majorant)."""
        pos = origin + direction * (near0 + t + self.eps)[:, None]
        rel = (pos - self.cmin) / torch.clamp(self.ext, min=1e-20)
        idx = torch.clamp((rel * BLOCK_DIM).to(torch.int64), 0, BLOCK_DIM - 1)
        lin = idx[..., 0] + idx[..., 1] * BLOCK_DIM + idx[..., 2] * (BLOCK_DIM * BLOCK_DIM)
        bmin = self.cmin + self.size * idx.to(torch.float32)
        b_near, b_far = intersect_aabb(pos, direction, bmin, bmin + self.size)
        max_density = _effective_density(self.vol, self.vi, self.flat[self.grid, lin] * self.vol.density[self.vi],
                                         ray_depth)
        state, sampled = sampling.sample_scatter_distance(state, torch.clamp(max_density, min=1e-20))
        bad_block = b_far <= 0.0
        to_exit = b_far - torch.clamp(b_near, min=0.0)
        advance_block = ~bad_block & (sampled > to_exit)
        t_new = torch.where(bad_block, t + self.eps,
                            torch.where(advance_block, t + to_exit + self.eps, t + sampled))
        return state, t_new, ~bad_block & ~advance_block, max_density


def scatter_distance_in_volume(state, vol, vi: int, origin, direction, ray_depth, active, stats: Optional[LoopStats] = None):
    """DoesRayScatterInVolume for volume vi over the wavefront
    (Volume.slang:256-356): (state, t) with t = -1 for no scatter."""
    v = slice(vi, vi + 1)
    near, far = intersect_aabb(origin, direction, vol.corner_min[v], vol.corner_max[v])
    near0 = torch.clamp(near, min=0.0)
    ok = active & (far >= 0.0) & (far - near0 > 0.0)
    gi = vol.density_grid_index[v]

    # Homogeneous: analytic exponential distance.
    state, d_hom = sampling.sample_scatter_distance(state, torch.clamp(vol.density[v], min=1e-20))
    t_hom = torch.where(ok & (d_hom < far - near0), near0 + d_hom, -1.0)
    if vol.density_grids.shape[0] == 0:
        return state, torch.where(gi >= 0, -1.0, t_hom)

    # Heterogeneous: block-restarted delta tracking.
    blk = _Blocks(vol, v)

    def body(c):
        state, t_new, testable, max_density = blk.step(c["state"], origin, direction, near0, c["t"], ray_depth)
        exited = (near0 + t_new) > far
        test_lanes = c["live"] & testable & ~exited
        state, dens = density_at_point(state, vol, v, origin + direction * (near0 + t_new)[:, None], ray_depth)
        state, u = rng.next_float(state)
        real_hit = test_lanes & (dens / torch.clamp(max_density, min=1e-20) >= u)
        return dict(state=state, t=torch.where(c["live"], t_new, c["t"]),
                    result=torch.where(real_hit, near0 + t_new, c["result"]),
                    live=c["live"] & ~exited & ~real_hit)

    out = while_live(body, dict(state=state, t=torch.zeros_like(near0), result=torch.full_like(near0, -1.0),
                                live=ok & (gi >= 0)), MAX_DELTA_STEPS, stats)
    return out["state"], torch.where(gi >= 0, out["result"], t_hom)


def _lane_volume_tables(vol, origin, direction, n_volumes: int):
    """Per-lane entry-sorted volume order (RayGen.slang:164-190): (order,
    near, far, entry), each (N, V), misses last with entry = inf."""
    hits = [intersect_aabb(origin, direction, vol.corner_min[i : i + 1], vol.corner_max[i : i + 1])
            for i in range(n_volumes)]
    near = torch.stack([h[0] for h in hits], dim=1)
    far = torch.stack([h[1] for h in hits], dim=1)
    key = torch.where(far >= 0.0, torch.clamp(near, min=0.0), torch.inf)
    key_s, order = torch.sort(key, dim=1, stable=True)
    return order, near.gather(1, order), far.gather(1, order), key_s


def _at(table, slot):
    return table.gather(1, slot[:, None])[:, 0]


def scatter_distance_merged(state, vol, n_volumes: int, origin, direction, ray_depth, active, stats: Optional[LoopStats] = None):
    """One entry-sorted march over all volumes per ray (ScatteredInVolume,
    RayGen.slang:162-208): each lane delta-tracks its current volume and
    moves to the next when it exits, bounded by the nearest scatter found
    so far.  Returns (state, t, volume index) with t = -1 for no scatter."""
    n = origin.shape[0]
    if n_volumes == 0:
        return state, torch.full((n,), -1.0, device=origin.device), torch.full((n,), -1, device=origin.device)
    order, near_s, far_s, entry_s = _lane_volume_tables(vol, origin, direction, n_volumes)
    heterogeneous = vol.density_grids.shape[0] > 0

    def body(c):
        state = c["state"]
        slot = torch.clamp(c["slot"], max=n_volumes - 1)
        vi = _at(order, slot)
        near0 = torch.clamp(_at(near_s, slot), min=0.0)
        far = _at(far_s, slot)
        hom = vol.density_grid_index[vi] < 0

        # Homogeneous volumes: one analytic event, then advance.
        state, d_hom = sampling.sample_scatter_distance(state, torch.clamp(vol.density[vi], min=1e-20))
        hom_hit = c["fresh"] & hom & (d_hom < (far - near0))

        # Heterogeneous: one block-restarted delta-tracking step.
        t = c["t"]
        if heterogeneous:
            state, t_new, testable, max_density = _Blocks(vol, vi).step(state, origin, direction, near0, t, ray_depth)
            exited = (near0 + t_new) > far
            # Stop marching past a nearer scatter already found (maxDistance).
            bounded = (c["result"] >= 0.0) & ((near0 + t_new) > c["result"])
            test_lanes = c["live"] & ~hom & testable & ~exited & ~bounded
            state, dens = density_at_point(state, vol, vi, origin + direction * (near0 + t_new)[:, None], ray_depth)
            state, u = rng.next_float(state)
            real_hit = test_lanes & (dens / torch.clamp(max_density, min=1e-20) >= u)
            het_done = ~hom & (exited | bounded | real_hit)
        else:
            t_new = t
            real_hit = torch.zeros_like(hom)
            het_done = ~hom
            state, _ = rng.next_float(state)

        hit_t = torch.where(hom, near0 + d_hom, near0 + t_new)
        better = c["live"] & (hom_hit | real_hit) & ((hit_t < c["result"]) | (c["result"] < 0.0))
        result = torch.where(better, hit_t, c["result"])
        finished = c["live"] & (hom | het_done)
        slot2 = c["slot"] + finished.to(torch.int64)
        t2 = torch.where(finished, 0.0, torch.where(c["live"] & ~hom, t_new, t))
        next_entry = _at(entry_s, torch.clamp(slot2, max=n_volumes - 1))
        dead = (slot2 >= n_volumes) | ~torch.isfinite(next_entry) | ((result >= 0.0) & (next_entry > result) & finished)
        return dict(state=state, slot=torch.where(c["live"], slot2, c["slot"]), t=torch.where(c["live"], t2, c["t"]),
                    fresh=finished, result=result, result_vol=torch.where(better, vi, c["result_vol"]),
                    live=c["live"] & ~dead)

    zeros = torch.zeros(n, dtype=torch.int64, device=origin.device)
    init = dict(state=state, slot=zeros, t=torch.zeros(n, device=origin.device),
                fresh=torch.ones(n, dtype=torch.bool, device=origin.device),
                result=torch.full((n,), -1.0, device=origin.device), result_vol=zeros - 1,
                live=active & torch.isfinite(entry_s[:, 0]))
    out = while_live(body, init, MAX_DELTA_STEPS, stats)
    return out["state"], out["result"], out["result_vol"]


def volumes_transmittance(state, vol, n_volumes: int, origin, direction, ray_depth, active, stats: Optional[LoopStats] = None):
    """CalculateVolumesTransmittance, one volume after another
    (Volume.slang:419-517): (state, (N,) transmittance)."""
    trans = torch.ones(origin.shape[0], device=origin.device)
    for vi in range(n_volumes):
        v = slice(vi, vi + 1)
        near, far = intersect_aabb(origin, direction, vol.corner_min[v], vol.corner_max[v])
        near0 = torch.clamp(near, min=0.0)
        gi = vol.density_grid_index[v]
        # Homogeneous: analytic Beer.
        length = far - near0
        hom = torch.where((far >= 0.0) & (length > 0.0), torch.exp(-vol.density[v] * length), 1.0)
        if vol.density_grids.shape[0] == 0:
            trans = trans * torch.where(active, hom, 1.0)
            continue

        # Heterogeneous: ratio tracking with Russian roulette.
        blk = _Blocks(vol, v)
        live0 = active & (gi >= 0) & (far >= 0.0)

        def body(c, v=v, blk=blk, near0=near0, far=far):
            state, t_new, testable, max_density = blk.step(c["state"], origin, direction, near0, c["t"], ray_depth)
            exited = (near0 + t_new) > far
            test_lanes = c["live"] & testable & ~exited
            state, dens = density_at_point(state, vol, v, origin + direction * (near0 + t_new)[:, None], ray_depth)
            tr = torch.where(test_lanes, c["tr"] * (1.0 - dens / torch.clamp(max_density, min=1e-20)), c["tr"])
            # Roulette with p = tr (Volume.slang:506-513): absorbed lanes
            # drop to 0, surviving tested lanes carry tr / p = 1.
            state, u = rng.next_float(state)
            absorbed = test_lanes & (u > tr)
            tr = torch.where(absorbed, 0.0, torch.where(test_lanes, 1.0, tr))
            return dict(state=state, t=torch.where(c["live"], t_new, c["t"]), tr=tr,
                        live=c["live"] & ~exited & ~absorbed)

        out = while_live(body, dict(state=state, t=torch.zeros_like(near0), tr=torch.ones_like(near0), live=live0),
                         MAX_TRANSMITTANCE_STEPS, stats)
        state = out["state"]
        het = torch.where(live0, out["tr"], 1.0)
        trans = torch.clamp(trans * torch.where(gi >= 0, het, torch.where(active, hom, 1.0)), 0.0, 1.0)
    return state, torch.clamp(trans, 0.0, 1.0)


def volumes_transmittance_merged(state, vol, n_volumes: int, origin, direction, ray_depth, active,
                                 stats: Optional[LoopStats] = None):
    """Ratio-tracked transmittance across all volumes per ray in one loop
    (Volume.slang:419-517): each lane marches its entry-sorted volumes,
    homogeneous ones in a single analytic step.  (state, (N,) transmittance)."""
    n = origin.shape[0]
    if n_volumes == 0:
        return state, torch.ones(n, device=origin.device)
    order, near_s, far_s, entry_s = _lane_volume_tables(vol, origin, direction, n_volumes)
    heterogeneous = vol.density_grids.shape[0] > 0

    def body(c):
        state = c["state"]
        slot = torch.clamp(c["slot"], max=n_volumes - 1)
        vi = _at(order, slot)
        near0 = torch.clamp(_at(near_s, slot), min=0.0)
        far = _at(far_s, slot)
        hom = vol.density_grid_index[vi] < 0
        hom_tr = torch.exp(-vol.density[vi] * torch.clamp(far - near0, min=0.0))
        t = c["t"]
        absorbed = torch.zeros_like(hom)
        if heterogeneous:
            state, t_new, testable, max_density = _Blocks(vol, vi).step(state, origin, direction, near0, t, ray_depth)
            exited = (near0 + t_new) > far
            test_lanes = c["live"] & ~hom & testable & ~exited
            state, dens = density_at_point(state, vol, vi, origin + direction * (near0 + t_new)[:, None], ray_depth)
            tr = torch.where(test_lanes, c["tr"] * (1.0 - dens / torch.clamp(max_density, min=1e-20)), c["tr"])
            state, u = rng.next_float(state)
            absorbed = test_lanes & (u > tr)
            tr = torch.where(absorbed, 0.0, torch.where(test_lanes, 1.0, tr))
            het_done = ~hom & exited
        else:
            t_new = t
            tr = c["tr"]
            het_done = ~hom
            state, _ = rng.next_float(state)

        tr = torch.where(c["live"] & hom, tr * hom_tr, tr)
        finished = c["live"] & (hom | het_done)
        slot2 = c["slot"] + finished.to(torch.int64)
        t2 = torch.where(finished, 0.0, torch.where(c["live"] & ~hom, t_new, t))
        next_entry = _at(entry_s, torch.clamp(slot2, max=n_volumes - 1))
        dead = absorbed | (slot2 >= n_volumes) | (finished & ~torch.isfinite(next_entry))
        return dict(state=state, slot=torch.where(c["live"], slot2, c["slot"]), t=torch.where(c["live"], t2, c["t"]),
                    tr=torch.where(c["live"], torch.clamp(tr, 0.0, 1.0), c["tr"]), live=c["live"] & ~dead)

    init = dict(state=state, slot=torch.zeros(n, dtype=torch.int64, device=origin.device),
                t=torch.zeros(n, device=origin.device), tr=torch.ones(n, device=origin.device),
                live=active & torch.isfinite(entry_s[:, 0]))
    out = while_live(body, init, MAX_TRANSMITTANCE_STEPS, stats)
    return out["state"], torch.clamp(out["tr"], 0.0, 1.0)


def temperature_emission(state, vol, vi, x):
    """GetEmissionFromTemperatureAtPoint (Volume.slang:230-253)."""
    if vol.temperature_grids.shape[0] == 0:
        return state, torch.zeros(x.shape[:-1] + (3,), device=x.device)
    state, tnorm = _grid_sample(state, vol.temperature_grids, _grid_of(vol, vi), vol.max_density[vi] * 0 + 1.0,
                                vol.grid_sharpness[vi], vol.corner_min[vi], vol.corner_max[vi], x)
    kelvin = tnorm * (vol.kelvin_max[vi] - vol.kelvin_min[vi]) + vol.kelvin_min[vi]
    color = torch.where((vol.use_blackbody[vi] != 0)[..., None], blackbody_rgb(kelvin), vol.temperature_color[vi])
    intensity = pow32(tnorm, vol.temperature_gamma[vi]) * vol.temperature_scale[vi]
    out = intensity[..., None] * pow32(torch.clamp(color, min=0.0), vol.emissive_color_gamma[vi][..., None])
    return state, torch.where((vol.has_temperature[vi] != 0)[..., None], out, 0.0)


def phase_sample(state, vol, vi, incident, ray_depth, phase_function: str):
    """GetScatteringDirection (Volume.slang:358-375)."""
    if phase_function == "hg":
        return sampling.sample_henyey_greenstein(state, incident, _effective_anisotropy(vol, vi, ray_depth))
    if phase_function == "draine":
        return sampling.sample_draine(state, incident, _effective_anisotropy(vol, vi, ray_depth), vol.alpha[vi])
    return sampling.sample_hg_plus_draine(state, incident, vol.droplet_size[vi], ray_depth)


def phase_eval(vol, vi, v, l, ray_depth, phase_function: str):
    """EvaluatePhaseFunction (Volume.slang:377-407)."""
    if phase_function == "hg":
        return sampling.phase_henyey_greenstein(v, l, _effective_anisotropy(vol, vi, ray_depth))
    if phase_function == "draine":
        return sampling.phase_draine(v, l, _effective_anisotropy(vol, vi, ray_depth), vol.alpha[vi])
    g_hg, g_d, alpha_d, w_d = sampling.hg_plus_draine_params(vol.droplet_size[vi])
    hg = sampling.phase_henyey_greenstein(v, l, g_hg)
    dr = sampling.phase_draine(v, l, g_d, alpha_d)
    return hg + (dr - hg) * w_d  # lerp(HG, Draine, W_D) (Volume.slang:396-407)
