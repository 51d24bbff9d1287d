"""Smoke run of vpt_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card, torch and CUDA versions;
  2. build the hand-written CUDA kernels (vpt_tpu_torch/csrc) with nvcc;
  3. every kernel against its plain torch version on the same inputs, at
     the main path's shapes: the colonnade scene, 512x512 tiled primary
     rays, one bounce of cosine-diffuse rays and the 2N shadow batch;
     envelope kernels exactly, the trace by the tie rule, occlusion as equal
     booleans; CUDA-event medians of both;
  4. the main path: Renderer on colonnade at 512x512, max_depth 8,
     max_medium_events 8, 4 spp per dispatch, one warm-up and three timed
     dispatches, with every kernel's launch count;
  5. a 128x128 1-spp render with the kernels against the same render with
     every plain version: PSNR > 40 dB.
The last two lines are the kernel table as JSON and {"ok": true, ...}.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch

from vpt_tpu_torch import Renderer, RenderFlags
from vpt_tpu_torch.accel import envelope, kernels, occlude, stream
from vpt_tpu_torch.accel.traverse import T_MAX, T_MIN
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import generate_primary_rays, perspective
from vpt_tpu_torch.core.tiling import tiled_pixel_order
from vpt_tpu_torch.render import lights, sampling, surface
from vpt_tpu_torch.render.params import default_params
from vpt_tpu_torch.scene.build import compile_scene
from vpt_tpu_torch.scene.procedural import colonnade

SRC_ENVELOPE = "vpt_tpu_torch/csrc/envelope.cu"
SRC_TRACE = "vpt_tpu_torch/csrc/trace.cu"
REPLACES = {
    "ray_keys": "vpt_tpu/accel/envelope.py:132",
    "supertile_tables": "vpt_tpu/accel/envelope.py:209",
    "stream": "vpt_tpu/accel/stream.py:490",
    "occlude": "vpt_tpu/accel/occlude.py:350",
}
PLAIN = {
    "ray_keys": (envelope, "ray_keys", envelope.ray_keys_plain),
    "supertile_tables": (envelope, "supertile_tables", envelope.supertile_tables_plain),
    "stream": (stream, "stream_trace", stream.stream_trace_plain),
    "occlude": (occlude, "occlude_trace", occlude.occlude_trace_plain),
}
W = H = 512


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of `reps` calls after one warm-up, by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def psnr(a: np.ndarray, b: np.ndarray, data_range: float) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(data_range**2 / mse)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, counting entries that are equal (the same infinity
    included) as 0."""
    return float(torch.where(a == b, 0.0, (a.double() - b.double()).abs()).max())


def plain_kernels() -> ExitStack:
    """Route every kernel wrapper of the render path to its plain version."""
    stack = ExitStack()
    for module, name, plain in PLAIN.values():
        stack.enter_context(mock.patch.object(module, name, plain))
    return stack


def main_path_inputs(data, meta, aux, dev):
    """Primary rays, one diffuse bounce and the 2N shadow batch at 512x512."""
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H))
    params = default_params(dev, view_inv, proj_inv)
    pxy, pidx, _, _ = tiled_pixel_order(W, H)
    state = rng.seed(torch.as_tensor(pidx.astype(np.int64), device=dev), 0, 12345)
    state, org, d = generate_primary_rays(params.view_inverse, params.proj_inverse,
                                          torch.as_tensor(pxy, device=dev), (W, H), state, 1.0, 0.0)
    t_min = T_MIN * meta.scene_scale
    hit = stream.intersect_stream(org, d, data.clusters, t_min, T_MAX)
    found = hit.t >= 0
    tri = torch.clamp(hit.tri.to(torch.int64), 0, data.tri_p0.shape[0] - 1)
    surf = surface.make_surface(data, tri, hit.u, hit.v, d, False, meta.has_textures)
    center = torch.tensor(meta.scene_center, device=dev)
    p_mag = torch.linalg.vector_norm(surf.world_pos - center, dim=-1) + 0.0346 * meta.scene_scale
    bounce_org = surf.world_pos + surf.geom_normal * (5.8e-4 * p_mag)[:, None]
    state, bounce_dir = sampling.sample_cosine_hemisphere(state, surf.geom_normal)
    state, to_sky, _ = lights.importance_sample_env(state, data.env, 0.0, 0.0)
    state, to_light, _, light_pdf, light_tri, light_dist = lights.sample_emissive_triangle(
        state, data, surf.world_pos, meta.n_emissive, meta.has_textures)
    light_eps = 5e-3 * (light_dist + 0.0346 * meta.scene_scale)
    n = org.shape[0]
    shadow = dict(
        origin=torch.cat([surf.world_pos + surf.normal * (5.8e-6 * p_mag)[:, None],
                          surf.world_pos + to_light * light_eps[:, None]]),
        direction=torch.cat([to_sky, to_light]),
        active=torch.cat([found, found & (light_pdf > 0)]),
        tmax=torch.cat([torch.full((n,), T_MAX, device=dev), torch.clamp(light_dist - light_eps, min=t_min)]),
        extri=torch.cat([torch.full((n,), -1, dtype=torch.int32, device=dev), light_tri]),
    )
    return t_min, (org, d, torch.ones_like(found)), (bounce_org, bounce_dir, found), shadow


def compare_envelope(cl, bands, t_min, levels, table):
    gmin, gmax = stream.pad_groups(cl)
    inv = stream.guarded_inverse(bands.direction)
    key_args = (bands.origin, inv, bands.tmax, gmin, gmax, t_min, levels)
    k_kernel = envelope.ray_keys(*key_args)
    k_plain = envelope.ray_keys_plain(*key_args)
    torch.cuda.synchronize()
    check(torch.equal(k_kernel, k_plain), f"ray_keys levels={levels} equals its plain version")
    tab_args = (bands.origin, inv, bands.tmax, gmin, gmax, t_min)
    s_kernel = envelope.supertile_tables(*tab_args)
    s_plain = envelope.supertile_tables_plain(*tab_args)
    torch.cuda.synchronize()
    check(torch.equal(s_kernel, s_plain), f"supertile_tables ({s_kernel.shape[0]} supertiles) equals its plain version")
    for name, err in (("ray_keys", max_abs_err(k_kernel, k_plain)),
                      ("supertile_tables", max_abs_err(s_kernel, s_plain))):
        table[name]["max_abs_err"] = max(table[name].get("max_abs_err", 0.0), err)
    return key_args, tab_args


def compare_stream(bands, cl, t_min, label):
    tk, trk, uk, vk = stream.stream_trace(bands, cl, t_min)
    tp, trp, up, vp = stream.stream_trace_plain(bands, cl, t_min)
    torch.cuda.synchronize()
    act = (bands.payload[0] & 1) > 0
    check(torch.allclose(tk, tp, rtol=1e-5, atol=1e-6), f"stream t ({label}) within rtol 1e-5 / atol 1e-6")
    same = trk == trp
    tie = (tk - tp).abs() <= 1e-5 + 1e-5 * tp.abs()
    check(bool((same | (tie & (trp >= 0))).all()), f"stream ids ({label}) equal except at t ties")
    check(torch.allclose(uk[same], up[same], rtol=1e-4, atol=1e-5)
          and torch.allclose(vk[same], vp[same], rtol=1e-4, atol=1e-5), f"stream u/v ({label})")
    hits = int(((trk >= 0) & act).sum())
    log(f"stream {label}: {int(act.sum())} active rays, {hits} hits, {int((~same).sum())} id ties")
    return max_abs_err(tk, tp)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} | {smi}")

    # 2. Build.
    kernels.library()
    log(f"kernel build: {kernels.build_seconds:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")

    # 3. Kernels against plain versions at the main path's shapes.
    t0 = time.perf_counter()
    data, meta, aux = compile_scene(colonnade(), dev)
    torch.cuda.synchronize()
    log(f"compile_scene(colonnade): {time.perf_counter() - t0:.1f} s, {meta.n_tris} triangles, "
        f"{data.clusters.count.shape[0]} clusters, {data.clusters.group_min.shape[0]} groups, "
        f"{meta.n_instances} instances")
    cl = data.clusters
    table = {k: {"name": k, "route": "cuda", "source": SRC_ENVELOPE if k in ("ray_keys", "supertile_tables")
                 else SRC_TRACE, "replaces": REPLACES[k]} for k in REPLACES}
    t_min, primary, bounce, shadow = main_path_inputs(data, meta, aux, dev)
    b_primary = stream.trace_bands(*primary[:2], cl, t_min, T_MAX, primary[2], torch.zeros_like(primary[2]))
    b_bounce = stream.trace_bands(*bounce[:2], cl, t_min, T_MAX, bounce[2], torch.zeros_like(bounce[2]))
    b_shadow = occlude.shadow_bands(shadow["origin"], shadow["direction"], cl, t_min, shadow["tmax"],
                                    shadow["active"], shadow["extri"])
    key_args, tab_args = compare_envelope(cl, b_bounce, t_min, 2, table)
    compare_envelope(cl, b_shadow, t_min, 1, table)
    table["stream"]["max_abs_err"] = max(compare_stream(b_primary, cl, t_min, "primary"),
                                         compare_stream(b_bounce, cl, t_min, "bounce"))
    ok = occlude.occlude_trace(b_shadow, cl, t_min)
    op = occlude.occlude_trace_plain(b_shadow, cl, t_min)
    torch.cuda.synchronize()
    check(torch.equal(ok, op), "occlude equals its plain version")
    table["occlude"]["max_abs_err"] = max_abs_err(ok, op)
    log(f"occlude: {int(b_shadow.payload[0].sum())} active shadow rays, {int(ok.sum())} blocked")

    timed = {
        "ray_keys": (lambda: envelope.ray_keys(*key_args), lambda: envelope.ray_keys_plain(*key_args)),
        "supertile_tables": (lambda: envelope.supertile_tables(*tab_args),
                             lambda: envelope.supertile_tables_plain(*tab_args)),
        "stream": (lambda: stream.stream_trace(b_bounce, cl, t_min),
                   lambda: stream.stream_trace_plain(b_bounce, cl, t_min)),
        "occlude": (lambda: occlude.occlude_trace(b_shadow, cl, t_min),
                    lambda: occlude.occlude_trace_plain(b_shadow, cl, t_min)),
    }
    for name, (kern, plain) in timed.items():
        table[name]["ms"] = cuda_ms(kern)
        table[name]["plain_ms"] = cuda_ms(plain)
        log(f"{name}: kernel {table[name]['ms']:.3f} ms, plain {table[name]['plain_ms']:.3f} ms "
            f"(bounce/shadow shapes, median of 5)")

    # 4. The main path.
    r = Renderer(colonnade(), dev, width=W, height=H, flags=RenderFlags(max_depth=8, max_medium_events=8),
                 samples_per_frame=4)
    kernels.reset_launches()
    r.path_trace()
    dts, segs, syncs = [], [], []
    for _ in range(3):
        seg0, t0 = r.segments_traced, time.perf_counter()
        r.path_trace()
        dts.append(time.perf_counter() - t0)
        segs.append(r.segments_traced - seg0)
        syncs.append(r.last_host_syncs)
    launches = dict(kernels.LAUNCHES)
    img = r.hdr_image()
    s_per = statistics.median(dts)
    log(f"render colonnade {W}x{H} depth 8, 4 spp/dispatch: {s_per:.3f} s/dispatch (median of {dts}), "
        f"{statistics.median(segs) / s_per:.0f} segments/s, {statistics.median(segs):.0f} segments/dispatch, "
        f"host syncs/dispatch {syncs}, launches over 4 dispatches {launches}")
    check(img.shape == (H, W, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          "render is finite with mean > 0")
    for name in REPLACES:
        check(launches[name] > 0, f"the main path launched {name}")
        table[name]["launches"] = launches[name]

    # 5. Kernel render against plain render.
    small = 128
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0))
    args = (data, meta, RenderFlags(max_depth=8, max_medium_events=8), default_params(dev, view_inv, proj_inv),
            2654435761, (small, small), torch.zeros((small, small, 3), device=dev), 0, 1)
    img_k = render_step(*args)[0].cpu().numpy()
    before = dict(kernels.LAUNCHES)
    with plain_kernels():
        img_p = render_step(*args)[0].cpu().numpy()
    check(kernels.LAUNCHES == before, "the plain render launched no kernel")
    p = psnr(np.clip(img_k, 0, 10), np.clip(img_p, 0, 10), 10.0)
    log(f"kernel vs plain render {small}x{small} 1 spp: PSNR {p:.1f} dB, "
        f"max abs diff {float(np.abs(img_k - img_p).max()):.3g}")
    check(p > 40.0, "kernel render within 40 dB PSNR of the plain render")

    print(smi)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
