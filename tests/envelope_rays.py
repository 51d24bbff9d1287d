"""Adversarial envelope inputs for the port's tests, built with the port
alone (no JAX, so the card's tests can use them): the 32x32 primary rays of
cornell_box, sphere_garden and a reduced colonnade, one bounce from their
hits and the 2N shadow batch, with inactive rays whose origin is NaN,
origins on box faces, axis-parallel directions (the 1e-20 guard), rays
starting inside a box and inside two overlapping groups (an entry tie at
t_min), and rays aimed at such a pair from outside.  Where no two groups of
a scene overlap, the last group takes the box of the first group with a
volume (a flat box, such as a ground plane's, is entered by no ray that
starts on it), so every scene has exact entry ties between two groups."""

import functools

import numpy as np
import torch

from vpt_tpu_torch.accel import stream
from vpt_tpu_torch.accel.traverse import T_MAX
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import generate_primary_rays, perspective
from vpt_tpu_torch.core.tiling import tiled_pixel_order
from vpt_tpu_torch.render.params import default_params
from vpt_tpu_torch.scene.build import compile_scene
from vpt_tpu_torch.scene.procedural import colonnade, cornell_box, sphere_garden

SCENES = {
    "cornell_box": cornell_box,
    "sphere_garden": sphere_garden,
    "colonnade": functools.partial(colonnade, n_columns=2, column_res=(24, 8)),
}
SIZE = 32


@functools.lru_cache(maxsize=None)
def wavefronts(name):
    """(clusters, t_min, {kind: (origin, direction, t_max, active)}) on the
    CPU, kind in primary, bounce, shadow (a sky direction and a point in the
    scene); the module docstring lists the adversarial rays."""
    data, meta, aux = compile_scene(SCENES[name](), device="cpu")
    cl = data.clusters
    t_min = 1e-4 * meta.scene_scale
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0))
    params = default_params(view_inv, proj_inv, device="cpu")
    pxy, pidx, _, _ = tiled_pixel_order(SIZE, SIZE)
    state = rng.seed(torch.as_tensor(pidx.astype(np.int64)), 0, 12345)
    _, org, d = generate_primary_rays(params.view_inverse, params.proj_inverse, torch.as_tensor(pxy),
                                      (SIZE, SIZE), state, params.focus_distance, params.dof_strength)
    n = org.shape[0]
    hit = stream.intersect_stream(org, d, cl, t_min, T_MAX)
    found = hit.t >= 0
    pos = torch.where(found[:, None], org + hit.t[:, None] * d, torch.nan)  # inactive rays: NaN origins
    r = np.random.default_rng(7)

    def unit(k):
        v = r.normal(size=(k, 3))
        return torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), dtype=torch.float32)

    lo = cl.group_min.numpy().copy()
    hi = cl.group_max.numpy().copy()
    b_org, b_dir, b_act = pos.clone(), unit(n), found.clone()
    k = 0
    for axis in range(3):  # axis-parallel directions from hit points and from a group's face
        for sign in (1.0, -1.0):
            e = np.zeros(3, np.float32)
            e[axis] = sign
            b_dir[k] = torch.as_tensor(e)
            g = k % lo.shape[0]
            face = (lo[g] + hi[g]) / 2
            face[axis] = lo[g][axis] if sign > 0 else hi[g][axis]
            b_org[k + 6], b_dir[k + 6], b_act[k], b_act[k + 6] = torch.as_tensor(face), torch.as_tensor(e), True, True
            k += 1
    for j, g in enumerate(range(0, lo.shape[0], max(1, lo.shape[0] // 8))):  # inside a box
        b_org[12 + j], b_act[12 + j] = torch.as_tensor((lo[g] + hi[g]) / 2), True
    pairs = [(i, j) for i in range(lo.shape[0]) for j in range(i + 1, lo.shape[0])
             if (np.maximum(lo[i], lo[j]) < np.minimum(hi[i], hi[j])).all()]
    if not pairs:  # no two groups overlap: the last one takes the first solid one's box
        g = next(g for g in range(lo.shape[0] - 1) if (lo[g] < hi[g]).all())
        lo[-1], hi[-1] = lo[g], hi[g]
        cl = cl._replace(group_min=torch.as_tensor(lo), group_max=torch.as_tensor(hi))
        pairs = [(g, lo.shape[0] - 1)]
    for j, (g0, g1) in enumerate(pairs[:8]):  # inside two overlapping groups: an entry tie at t_min
        mid = (np.maximum(lo[g0], lo[g1]) + np.minimum(hi[g0], hi[g1])) / 2
        b_org[24 + j], b_act[24 + j] = torch.as_tensor(mid), True
        b_org[40 + j], b_act[40 + j] = torch.as_tensor(mid), False  # and inactive
        away = mid + np.float32(2.0) * np.array([0.3, 1.0, 0.2], np.float32)  # aimed at it from outside
        b_org[32 + j], b_dir[32 + j], b_act[32 + j] = (torch.as_tensor(away), torch.nn.functional.normalize(
            torch.as_tensor(mid - away), dim=0), True)
    b_act[48:52] = False
    b_org[48:52] = torch.nan
    center = torch.as_tensor((lo.min(axis=0) + hi.max(axis=0)) / 2)
    to_pt = center + torch.as_tensor(r.uniform(-1, 1, (n, 3)), dtype=torch.float32) * 0.5 * (
        torch.as_tensor(hi.max(axis=0) - lo.min(axis=0)))
    to_pt = to_pt - pos
    dist = torch.linalg.vector_norm(to_pt, dim=1)
    sky = torch.nn.functional.normalize(torch.tensor([[0.3, 1.0, 0.2]]), dim=1).expand(n, 3)
    shadow = (torch.cat([pos, pos]), torch.cat([sky, to_pt / dist[:, None]]),
              torch.cat([torch.full((n,), T_MAX), torch.clamp(dist, min=t_min)]), torch.cat([found, found]))
    return cl, t_min, {
        "primary": (org.contiguous(), d.contiguous(), T_MAX, torch.ones(n, dtype=torch.bool)),
        "bounce": (b_org, b_dir, T_MAX, b_act),
        "shadow": tuple(x.contiguous() for x in shadow),
    }


def dense_keys(ent, levels):
    """ray_keys from dense entries: the first and second (entry, id) minima."""
    gp = ent.shape[1]
    v0, g0 = torch.min(ent, dim=1)
    l0 = torch.where(torch.isfinite(v0), g0, gp)
    if levels == 1:
        return l0.to(torch.int32)
    v1, g1 = torch.min(ent.scatter(1, g0[:, None], torch.inf), dim=1)
    return (l0 * (gp + 1) + torch.where(torch.isfinite(v1), g1, gp)).to(torch.int32)
