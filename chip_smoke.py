"""Smoke run of vpt_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card, torch and CUDA versions;
  2. build the hand-written CUDA kernels (vpt_tpu_torch/csrc), one nvcc per
     source, all started together;
  3. every kernel against its plain torch version on the same inputs, at
     the main paths' shapes: the colonnade scene, 512x512 tiled primary
     rays, one bounce of cosine-diffuse rays and the 2N shadow batch;
     envelope kernels exactly at both shapes (ray_keys on the unsorted
     wavefront as prepare_bands hands it over and on the sorted rays,
     supertile_tables on the sorted rays), the stream trace by the tie
     rule, occlusion as equal booleans, the packet visit with equal ids, t,
     u and v on the same packets (512 bounce packets, 1,024 shadow
     packets), and the packet cull: supertile_tables at 512-ray tiles on
     the key-sorted packet rays (tmax -inf on inactive ones) against its
     plain version and against the dense (packets, rays, Gp) reduction it
     replaced, with the same candidate lists; CUDA-event medians of each
     kernel over 20 back-to-back launches per event pair (supertile_tables
     at 1024-ray supertiles and 512-ray packets, both shapes each) and of
     each plain version over one call, the plain visit timed once; the
     envelope work per ray (groups and union boxes entered, slab tests of
     the two-level walk, union boxes entered by any lane of a 32-ray warp,
     the share of rays that enter the last real union box with and without
     its padding) and the traversal work of the primary, bounce and shadow rays
     (clusters, sub-block boxes and triangle tests per ray, out to the
     final hit and out to tmax, with and without the sub-block cull), the
     packet visit's walk per ray (32-candidate steps, groups, member
     clusters, sub-blocks and triangle tests), and from them each kernel's
     bound;
  4. the energy-compensation table bake on the card (what the default
     `Renderer(lookup_tables="auto")` runs once and caches), timed; then
     the stream path: Renderer on colonnade at 512x512, max_depth 8,
     max_medium_events 8, 4 spp per dispatch, one warm-up and two timed
     dispatches, with every kernel's launch count; its fits must not be
     the constant fit;
  5. the packet path (integrator.TRACE_MODE = "packet") on the same
     Renderer, the same way: visit and supertile_tables (the packet cull)
     must launch and the stream and occlusion kernels must not; its
     s/dispatch beside the stream path's; then Renderer.save writes a PNG
     that is read back; then one torch.profiler trace of a stream and of a
     packet dispatch: kernel launches, device time and busy share (device
     time over the unprofiled s/dispatch), the top kernels;
  6. 128x128 1-spp renders with the kernels against the same renders with
     every plain version, stream and packet mode: PSNR > 40 dB, the packet
     render equal;
  7. the media path: the stream-mode Renderer with a 128^3 procedural
     cloud and a homogeneous ground haze added by `add_volume` (the merged
     march, delta tracking, ratio-tracked NEE, HG phase), driven like
     phase 4 but at max_depth 4 (MEDIA_FLAGS): ray_keys, supertile_tables,
     stream and occlude must launch and visit must not; then its 128x128
     kernel render against the plain one, PSNR > 40 dB.  The cloud comes
     from a .vdb that write_vdb writes in blosc mode (LZ4 through the C
     codec); placed at its origin, the grid load_grid reads equals the
     procedural grid exactly;
  8. the atmosphere path: the gallery's day setup (planet surface at
     y = 0, sky altitude 30 degrees) under colonnade's open sky, the same
     way;
  9. the user's entry points on the card:
     a. the textured colonnade (9 textures, ~4.7M texels of albedo and
        normal maps) at 512x512 with a metrics log, driven like phase 4
        beside phase 4's numbers: the four stream-path kernels launch,
        visit does not, the log holds one dispatch record per dispatch
        whose segments sum to segments_traced; one torch.profiler trace of
        a dispatch, as in phase 5; then its 128x128 kernel render against
        the plain one, PSNR > 40 dB;
     b. the textured colonnade written as a .glb (tests/gltf_scenes.py:
        PNG textures in buffer views, instanced nodes, a camera, the KHR
        extensions) and its sky as .npy; load_gltf gives its instances,
        triangles and textures (within 1/255) back; then
        `python -m vpt_tpu_torch render` of it at 512x512, 8 spp, exits 0
        with its stats line and a PNG that reads back, and its HDR is
        within 40 dB PSNR of the procedural scene's render at the same
        seeds;
     c. `python -m vpt_tpu_torch furnace`: mean error < 0.05 (960
        triangles: the brute-force trace, no kernel);
     d. `python -m vpt_tpu_torch bench`: its JSON line, 8 kept dispatches,
        the card's name and power limit;
     e. the TerminalViewer, headless, on sphere_garden (~96K triangles)
        at 128x128: two steps, then a move that restarts the accumulation,
        frames of ANSI half-blocks, the stream kernels launched.
The last lines are the card's name and power limit, the kernel table as
JSON and {"ok": true, ...}.  Without a CUDA device the script exits
non-zero and prints no result.

    python3 chip_smoke.py --compare OTHER_CU [OTHER_CU ...]

also builds other versions of a kernel source of csrc/ (envelope.cu,
trace.cu or visit.cu, with the current C interface: the source is the one
whose entry points the build defines), checks that each of its kernels
gives the current results on the phase-3 calls (visit: up to a share
AB_DIFFER of rays, see there) and times both in turns (other, current,
current, other; medians of 21), with the registers and spills of both
builds (ptxas -v) and the SASS of each kernel's innermost loop with slab
products (cuobjdump: instructions, slabs and min / max per slab); after
phase 4 it drives the path that runs the source (the packet path for
visit.cu, else the stream path) with each other build in the same turns,
twice.  One JSON line "ab".

A kernel's bound is the larger of its float operations over 67 TFLOP/s
(FP32 outside the tensor cores) and its bytes over 3.35 TB/s (H100 SXM
HBM3), each input read once and each output written once.  The operations
are those this run's rays need: for the envelope kernels, the two-level
walk (every ray against every union box, the 8 member slabs of each union
box it enters; the dense count, Gp slabs per ray, is printed beside); for
the traces, the cluster and sub-block slabs, instance
transforms and triangle tests out to each ray's final hit (the nearest
blocker for shadow rays), the same closest-hit work for the packet visit.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack
from typing import NamedTuple
from unittest import mock

import numpy as np
import torch

from vpt_tpu_torch import Renderer, RenderFlags
from vpt_tpu_torch.accel import cluster, envelope, kernels, occlude, stream, visit
from vpt_tpu_torch.accel.traverse import KERNEL_GROUP, T_MAX, T_MIN, guarded_inverse
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.bench import card_description
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import generate_primary_rays, perspective
from vpt_tpu_torch.core.tiling import tiled_pixel_order
from vpt_tpu_torch.io.image import read_png
from vpt_tpu_torch.io.metrics import psnr
from vpt_tpu_torch.render import integrator, lights, lookup, sampling, surface
from vpt_tpu_torch.render.lookup_fit import constant_fit
from vpt_tpu_torch.render.params import default_params
from vpt_tpu_torch.scene import blosc
from vpt_tpu_torch.scene.build import BRUTE_FORCE_MAX_TRIS, compile_scene
from vpt_tpu_torch.scene.gltf import load_gltf
from vpt_tpu_torch.scene.procedural import colonnade, colonnade_textured, furnace_sphere, sphere_garden
from vpt_tpu_torch.scene.types import Volume
from vpt_tpu_torch.scene.vdb import load_grid, procedural_cloud
from vpt_tpu_torch.scene.vdb_reader import read_vdb, write_vdb
from vpt_tpu_torch.viewer import TerminalViewer

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import gltf_scenes  # noqa: E402  (tests/gltf_scenes.py, jax-free: the .glb writer)

SOURCES = {
    "ray_keys": "vpt_tpu_torch/csrc/envelope.cu",
    "supertile_tables": "vpt_tpu_torch/csrc/envelope.cu",
    "stream": "vpt_tpu_torch/csrc/trace.cu",
    "occlude": "vpt_tpu_torch/csrc/trace.cu",
    "visit": "vpt_tpu_torch/csrc/visit.cu",
}
REPLACES = {
    "ray_keys": "vpt_tpu/accel/envelope.py:132",
    "supertile_tables": "vpt_tpu/accel/envelope.py:209",
    "stream": "vpt_tpu/accel/stream.py:490",
    "occlude": "vpt_tpu/accel/occlude.py:350",
    "visit": "vpt_tpu/accel/visit_kernel.py:302",
}
PLAIN = {
    "ray_keys": (envelope, "ray_keys", envelope.ray_keys_plain),
    "supertile_tables": (envelope, "supertile_tables", envelope.supertile_tables_plain),
    "stream": (stream, "stream_trace", stream.stream_trace_plain),
    "occlude": (occlude, "occlude_trace", occlude.occlude_trace_plain),
    "visit": (visit, "visit_trace", visit.visit_trace_plain),
}
STREAM_KERNELS = ("ray_keys", "supertile_tables", "stream", "occlude")
W = H = 512
TIMED_DISPATCHES = 2
# The media path at depth 4 (the others at 8): its dispatch is tens of seconds
# of host-bound loop steps, and the script stays within its time.
MEDIA_FLAGS = RenderFlags(max_depth=4, max_medium_events=8)
PEAK_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
SLAB_OPS = 24  # 6 subtractions, 6 products, 12 min / max
TRANSFORM_OPS = 36  # world -> local origin (18) and direction (15), 3 reciprocals
MT_OPS = 53  # Moller-Trumbore as in csrc/trace.cu: 47 arithmetic, 6 compares
LAUNCHES_PER_PAIR = 20  # back-to-back kernel launches per event pair
# The share of rays whose outputs may differ between another build of a
# kernel and the current one in --compare.  The parent's visit gated a member
# on "any ray of the packet enters it", the current one on the ray's own
# entry: a ray that meets a triangle only at the rounding edge of a member
# box it does not enter may then keep another hit.
AB_DIFFER = {"visit": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 5, launches: int = 1) -> float:
    """Median milliseconds of one call over `reps` event pairs (after one
    warm-up), each pair around `launches` calls back to back, so that the
    host's launch time hides behind the device's work."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, counting entries that are equal (the same infinity
    included) as 0."""
    return float(torch.where(a == b, 0.0, (a.double() - b.double()).abs()).max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int) -> dict:
    """The least time the card could take: operations or bytes, whichever is slower."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, moved / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def cluster_tables(cl):
    return (cl.aabbs, cl.count, cl.start, cl.block_id, cl.inst, cl.inv_rows, cl.tris, cl.sub_aabbs, cl.group_min,
            cl.group_max)


def band_inputs(bands):
    return (bands.ngrp, bands.order, bands.entry_sorted, bands.bits, bands.sent, bands.origin, bands.direction,
            bands.tmax, *bands.payload)


def trace_flops(w: stream.TraceWork, instanced: bool) -> float:
    clusters = float(w.clusters.sum())
    return (SLAB_OPS * (clusters + float(w.sub_slabs.sum())) + (TRANSFORM_OPS * clusters if instanced else 0.0)
            + MT_OPS * float(w.tests.sum()))


def log_trace_work(label, bands, cl, t_min, active, tf_final):
    """Log the traversal work per active ray out to the final hit and out to
    tmax; return the work out to the final hit."""
    need = stream.trace_work(bands, cl, t_min, active, tf_final)
    most = stream.trace_work(bands, cl, t_min, active, bands.tmax)
    n_act = max(int(active.sum()), 1)
    per = ", ".join(f"{f} {float(a.sum()) / n_act:.2f} / {float(b.sum()) / n_act:.2f}"
                    for f, a, b in zip(stream.TraceWork._fields, need, most))
    log(f"trace work {label}, per active ray ({n_act}), out to the final hit / out to tmax: {per}")
    return need


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


class EnvelopeCase(NamedTuple):
    """The envelope kernels' inputs at one main-path shape."""

    levels: int
    keys: tuple  # ray_keys' arguments on the unsorted wavefront, as prepare_bands passes them
    tables: tuple  # supertile_tables' arguments: the key-sorted rays
    active: torch.Tensor  # (N,) bool, unsorted
    perm: torch.Tensor  # (N,) sorted slot -> unsorted slot
    n_groups: int  # real groups, before the padding


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def envelope_case(cl, wave: stream.Wavefront, bands, t_min, levels) -> EnvelopeCase:
    check(bits_equal(wave.origin[bands.perm], bands.origin) and bits_equal(wave.tmax[bands.perm], bands.tmax),
          "the unsorted wavefront is the one prepare_bands sorted")
    gmin, gmax = stream.pad_groups(cl)
    tables = (bands.origin, stream.guarded_inverse(bands.direction), bands.tmax, gmin, gmax, t_min)
    return EnvelopeCase(levels, (wave.origin, wave.inv, wave.tmax, gmin, gmax, t_min, levels), tables, wave.active,
                        bands.perm, cl.group_min.shape[0])


def compare_envelope(case: EnvelopeCase, label: str, table) -> None:
    """Both envelope kernels against their plain versions, exactly: ray_keys
    on the unsorted and the sorted rays, supertile_tables on the sorted."""
    errs = []
    for order, args in (("unsorted", case.keys), ("sorted", (*case.tables, case.levels))):
        k_kernel, k_plain = envelope.ray_keys(*args), envelope.ray_keys_plain(*args)
        torch.cuda.synchronize()
        check(torch.equal(k_kernel, k_plain), f"ray_keys ({label}, levels {case.levels}, {order}) equals its plain version")
        errs.append(("ray_keys", max_abs_err(k_kernel, k_plain)))
    s_kernel, s_plain = envelope.supertile_tables(*case.tables), envelope.supertile_tables_plain(*case.tables)
    torch.cuda.synchronize()
    check(bits_equal(s_kernel, s_plain),
          f"supertile_tables ({label}, {s_kernel.shape[0]} supertiles) equals its plain version")
    errs.append(("supertile_tables", max_abs_err(s_kernel, s_plain)))
    for name, err in errs:
        table[name]["max_abs_err"] = max(table[name].get("max_abs_err", 0.0), err)
    log(f"envelope {label}: ray_keys (levels {case.levels}, unsorted and sorted) and supertile_tables "
        f"({s_kernel.shape[0]} supertiles) equal their plain versions")


def envelope_bounds(case: EnvelopeCase, label: str):
    """Log the envelope work per active ray; return the bounds of ray_keys
    and supertile_tables at this shape, from the two-level walk's work."""
    w_in = envelope.envelope_work(*case.keys[:6])  # input order: ray_keys' warps
    w_sorted = envelope.envelope_work(*case.tables)  # sorted order: supertile_tables' warps
    n, gp = case.keys[0].shape[0], case.keys[3].shape[1]
    n_chunks = gp // envelope.CHUNK
    act, act_sorted = case.active, case.active[case.perm]
    n_act = max(int(act.sum()), 1)

    def mean(x, a):
        return float(x[a].double().sum()) / n_act

    log(f"envelope work {label} ({n} rays, {n_act} active, Gp {gp}, {n_chunks} union boxes of {envelope.CHUNK}), "
        f"per active ray: groups entered {mean(w_in.groups, act):.2f}, union boxes entered "
        f"{mean(w_in.chunks, act):.2f}, slab tests of the two-level walk {mean(w_in.slabs, act):.1f} (dense {gp}), "
        f"union boxes entered by any lane of the ray's warp {mean(w_in.warp_chunks, act):.1f} in input order, "
        f"{mean(w_sorted.warp_chunks, act_sorted):.1f} sorted; all {n} rays: {int(w_in.slabs.sum())} slab tests "
        f"(dense {n * gp})")
    g, k = case.n_groups, envelope.CHUNK
    if g % k:  # the last real union box holds padding (3e9 points)
        origin, inv, tmax, gmin, gmax, t_min = case.keys[:6]
        c = g - g % k

        def share(end):  # of the active rays that enter the union box of groups c .. end - 1
            lo, hi = gmin[:, c:end].amin(dim=1, keepdim=True), gmax[:, c:end].amax(dim=1, keepdim=True)
            enter = torch.isfinite(envelope.slab_entry(origin, inv, tmax, lo, hi, t_min)[:, 0])
            return float((enter & act).sum()) / n_act

        padded, real = share(c + k), share(g)
        log(f"envelope {label}: the last real union box (groups {c}-{c + k - 1}, {g - c} of them real) is entered "
            f"by {100 * padded:.2f}% of the active rays, the union of its real members by {100 * real:.2f}%: the "
            f"padding adds {k * (padded - real):.2f} slab tests per active ray")
    unions, members = float(n * n_chunks), float(w_in.chunks.sum()) * envelope.CHUNK
    keys = bound(SLAB_OPS * unions + (SLAB_OPS + 2) * members, nbytes(*case.keys[:5]) + 4 * n)
    return keys, tables_bound(case.tables, w_sorted, stream.SUPERTILE)


def tables_bound(args, work: envelope.EnvelopeWork, tile: int) -> dict:
    """supertile_tables' bound from the two-level walk: every ray against
    every union box, the CHUNK member slabs of each union box it enters."""
    n, gp = args[0].shape[0], args[3].shape[1]
    unions, members = float(n * (gp // envelope.CHUNK)), float(work.chunks.sum()) * envelope.CHUNK
    return bound(SLAB_OPS * unions + (SLAB_OPS + 1) * members, nbytes(*args[:5]) + 4 * (n // tile) * gp)


def packet_cull_args(pk: cluster.Packets, cl, t_min) -> tuple:
    """supertile_tables' arguments for the packet cull, as prepare_packets
    passes them: the key-sorted packet rays, tmax -inf on inactive ones,
    512-ray tiles."""
    gmin, gmax = cluster.pad_groups(cl)
    return (pk.origin.reshape(-1, 3), guarded_inverse(pk.direction.reshape(-1, 3)),
            cluster.packet_cull_tmax(pk.tmax, pk.active).reshape(-1), gmin, gmax, t_min, cluster.PACKET_SIZE)


def dense_packet_cull(pk: cluster.Packets, cl, t_min) -> torch.Tensor:
    """The packet cull as the parent computed it in plain torch: per 32
    packets the dense (rays, Gp) slab entries, +inf on inactive rays, the
    minimum per packet."""
    n_pk, size = pk.active.shape
    origin, inv = pk.origin.reshape(-1, 3), guarded_inverse(pk.direction.reshape(-1, 3))
    tmax, active = pk.tmax.reshape(-1), pk.active.reshape(-1)
    gmin, gmax = cluster.pad_groups(cl)
    out = []
    for s in range(0, n_pk, 32):
        rows = slice(s * size, min(s + 32, n_pk) * size)
        ent = envelope.slab_entry(origin[rows], inv[rows], tmax[rows], gmin, gmax, t_min)
        out.append(torch.where(active[rows, None], ent, torch.inf).reshape(-1, size, gmin.shape[1]).amin(dim=1))
    return torch.cat(out)


def compare_packet_cull(pk: cluster.Packets, cl, t_min, label: str, table) -> tuple:
    """supertile_tables at 512-ray tiles against its plain version and the
    dense cull it replaced, bit for bit, and the candidate lists that
    prepare_packets made from it against the dense cull's.  Returns the
    kernel's arguments."""
    args = packet_cull_args(pk, cl, t_min)
    got, plain = envelope.supertile_tables(*args), envelope.supertile_tables_plain(*args)
    dense = dense_packet_cull(pk, cl, t_min)
    torch.cuda.synchronize()
    check(bits_equal(got, plain), f"supertile_tables ({label} packets, 512-ray tiles) equals its plain version")
    check(bits_equal(got, dense), f"supertile_tables ({label} packets, 512-ray tiles) equals the dense packet cull")
    entry_sorted, order = torch.sort(dense, dim=1, stable=True)
    check(torch.equal(pk.order, order.to(torch.int32)) and bits_equal(pk.entry_sorted, entry_sorted)
          and torch.equal(pk.nvis, torch.isfinite(dense).sum(dim=1).to(torch.int32)),
          f"prepare_packets' candidate lists ({label}) equal the dense cull's")
    row = table["supertile_tables"]
    row["max_abs_err"] = max(row.get("max_abs_err", 0.0), max_abs_err(got, plain))
    log(f"packet cull {label}: supertile_tables over {got.shape[0]} packets of 512 rays ({int(pk.active.sum())} "
        f"active) equals its plain version and the dense cull; order, entry_sorted and nvis equal the dense cull's")
    return args


def log_visit_work(label: str, pk: cluster.Packets, cl, t_min, t_final) -> None:
    """The packet visit's walk per active ray, out to the final hit and out
    to tmax (visit.visit_work)."""
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active)
    need = visit.visit_work(*args, t_final, cl, t_min)
    most = visit.visit_work(*args, pk.tmax, cl, t_min)
    act = pk.active
    n_act = max(int(act.sum()), 1)
    per = ", ".join(f"{f} {float(a[act].sum()) / n_act:.2f} / {float(b[act].sum()) / n_act:.2f}"
                    for f, a, b in zip(visit.VisitWork._fields, need, most))
    log(f"visit walk {label}, per active ray ({n_act}), out to the final hit / out to tmax: {per} "
        f"(each group entered tests its {KERNEL_GROUP} member boxes)")


def kernel_calls(cases, cl, t_min, b_bounce, b_shadow, visit_args, cull_args) -> dict:
    """Each kernel's phase-3 calls, {kernel: {shape: arguments}}; the first
    shape is the one the kernel table's `ms` takes."""
    calls = {name: {label: case.keys if name == "ray_keys" else case.tables for label, case in cases.items()}
             for name in ("ray_keys", "supertile_tables")}
    calls["supertile_tables"].update({"packet": cull_args["bounce"], "packet_shadow": cull_args["shadow"]})
    calls["stream"] = {"bounce": (b_bounce, cl, t_min)}
    calls["occlude"] = {"shadow": (b_shadow, cl, t_min)}
    calls["visit"] = dict(visit_args)
    return calls


def wrapper(name: str):
    """The kernel's wrapper, as the render path calls it."""
    module, attr, _ = PLAIN[name]
    return getattr(module, attr)


def differing(a, b) -> tuple:
    """(rays whose outputs differ, rays) of two results (a tensor or a tuple
    of them), floats compared bit for bit."""
    a, b = ((a,), (b,)) if torch.is_tensor(a) else (a, b)
    diff = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        diff |= (x.view(torch.int32) != y.view(torch.int32)) if x.dtype == torch.float32 else (x != y)
    return int(diff.sum()), diff.numel()


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_loops(lib_path: str) -> dict:
    """Per kernel function in the library's SASS (cuobjdump -sass): its
    innermost loop that holds slab products (a backward branch around FMULs;
    each slab has 6), with the loop's instruction count, slabs (FMUL / 6),
    instructions and FMNMX per slab, and its opcode counts."""
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    report = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        ins = [(int(a, 16), op) for a, op in SASS_LINE.findall(chunk)]
        loops = []
        for at, op in ins:
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < at:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= at]
                fmul = sum(1 for o in body if re.search(r"\bFMUL\b", o))
                if fmul:
                    loops.append((len(body), fmul, body))
        if not loops:
            report[name] = "no loop with slab products found"
            continue
        size, fmul, body = min(loops)
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", o).split()[0] for o in body)
        fmnmx = sum(v for k, v in ops.items() if k.startswith("FMNMX"))
        report[name] = {"loop_instructions": size, "slabs": fmul / 6, "per_slab": size * 6 / fmul,
                        "fmnmx_per_slab": fmnmx * 6 / fmul, "opcodes": dict(ops.most_common(12))}
    return report


class Build(NamedTuple):
    """Another build of one kernel source."""

    path: str
    source: str  # the kernels.SOURCES entry whose entry points it defines
    entry: dict  # entry point -> ctypes function
    ptxas: list  # ptxas -v register and spill lines
    sass: dict  # sass_loops()


def build_source(path: str, out_dir: str) -> Build:
    """nvcc one kernel source into out_dir with the kernels' flags and
    -Xptxas -v (the headers of csrc/ on the include path), and load it."""
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, f"lib{os.path.splitext(os.path.basename(path))[0]}.so")
    proc = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I", kernels.CSRC_DIR, "-o", lib_path, path],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc builds {path}:\n{proc.stderr}")
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if re.search(r"Compiling entry|registers|spill", line)]
    lib = ctypes.CDLL(lib_path)
    source = next((s for s, sig in kernels.SOURCES.items() if all(hasattr(lib, fn) for fn in sig)), None)
    check(source is not None, f"{path} defines the entry points of one of {sorted(kernels.SOURCES)}")
    entry = {fn: getattr(lib, fn) for fn in kernels.SOURCES[source]}
    for fn, argtypes in kernels.SOURCES[source].items():
        entry[fn].argtypes, entry[fn].restype = argtypes, ctypes.c_int
    return Build(path, source, entry, ptxas, sass_loops(lib_path))


@contextlib.contextmanager
def routed(build):
    """Route the kernel wrappers to another build's entry points (None: the
    current ones)."""
    with mock.patch.dict(kernels.library(), build.entry if build is not None else {}):
        yield


def compare_builds(paths, calls):
    """Build other versions of kernel sources; check that each of their
    kernels gives the current results on its phase-3 calls and time both
    in turns (other, current, current, other; medians of 21).  Returns the
    "ab" rows by path, and the builds for the stream-path turns."""
    out_dir = tempfile.mkdtemp(prefix="ab_")
    try:
        others = [build_source(p, os.path.join(out_dir, str(i))) for i, p in enumerate(paths)]
        current = {s: build_source(os.path.join(kernels.CSRC_DIR, s), os.path.join(out_dir, s))
                   for s in {b.source for b in others}}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ab = {}
    for b in others:
        cur = current[b.source]
        row = {"source": b.source, "ptxas": b.ptxas, "sass": b.sass, "current_ptxas": cur.ptxas,
               "current_sass": cur.sass}
        for entry in b.entry:
            name = entry.removeprefix("vpt_")
            fn = wrapper(name)
            for label, args in calls[name].items():
                want = fn(*args)
                with routed(b):
                    got = fn(*args)
                torch.cuda.synchronize()
                n_diff, rays = differing(got, want)
                check(n_diff <= AB_DIFFER.get(name, 0.0) * rays,
                      f"{b.path} gives the current {name} results ({label}): {n_diff} of {rays} rays differ")

                def timed(which):
                    with routed(which):
                        return cuda_ms(lambda: fn(*args), reps=21, launches=LAUNCHES_PER_PAIR)

                o1, c1, c2, o2 = timed(b), timed(None), timed(None), timed(b)
                row[f"{name}_{label}"] = {"other_ms": [o1, o2], "current_ms": [c1, c2], "differing_rays": n_diff}
                log(f"{name} {label}: {b.path} {o1:.4f} / {o2:.4f} ms, current {c1:.4f} / {c2:.4f} ms (other, "
                    f"current, current, other; medians of 21 x {LAUNCHES_PER_PAIR} launches); {n_diff} of {rays} "
                    f"rays differ")
        ab[b.path] = row
        log(f"{b.path}: ptxas {b.ptxas}; loops {b.sass}")
        log(f"current {b.source}: ptxas {cur.ptxas}; loops {cur.sass}")
    return ab, others


def drive_ab(r: Renderer, others, ab) -> None:
    """The path that runs each other build's source (the packet path for
    visit.cu, else the stream path) with that build and the current one, in
    turns (other, current, current, other, twice); prints the "ab" line."""
    for b in others:
        mode = "packet" if b.source == "visit.cu" else "stream"
        runs = {"other": [], "current": []}
        with mock.patch.object(integrator, "TRACE_MODE", mode):
            for which in (b, None, None, b) * 2:
                with routed(which):
                    key = "current" if which is None else "other"
                    runs[key].append(drive(r, f"{mode} ({b.path if which is not None else 'current'} {b.source})")[1])
        ab[b.path][f"{mode}_s_per_dispatch"] = runs
    print(json.dumps({"ab": ab}), flush=True)


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
    return max_abs_err(tk, tp), tp


def compare_visit(pk: cluster.Packets, cl, t_min, label):
    """The visit kernel against its plain version on the same packets: ids,
    t, u and v equal (the same gates and arithmetic, --fmad=false).  Returns
    the max abs t error, the plain version's milliseconds (this one run) and
    the kernel's t."""
    args = (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, cl, t_min)
    tk, trk, uk, vk = visit.visit_trace(*args)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    tp, trp, up, vp = visit.visit_trace_plain(*args)
    b.record()
    torch.cuda.synchronize()
    for name, got, want in (("ids", trk, trp), ("t", tk, tp), ("u", uk, up), ("v", vk, vp)):
        check(torch.equal(got, want), f"visit {name} ({label}) equal the plain version's")
    log(f"visit {label}: {pk.nvis.shape[0]} packets, {int(pk.active.sum())} active rays, "
        f"{int((trk >= 0).sum())} hits, candidate groups per packet mean {float(pk.nvis.float().mean()):.1f} "
        f"max {int(pk.nvis.max())}; ids, t, u and v equal the plain version's")
    return max_abs_err(tk, tp), a.elapsed_time(b), tk


def drive(r: Renderer, label: str):
    """One warm-up and TIMED_DISPATCHES timed dispatches of the Renderer,
    launch counts set to 0 just before and read just after: (launches,
    median s/dispatch, median segments/dispatch)."""
    r.reset_path_tracing()
    kernels.reset_launches()
    r.path_trace()
    dts, segs, syncs, steps = [], [], [], []
    for _ in range(TIMED_DISPATCHES):
        seg0, t0 = r.segments_traced, time.perf_counter()
        r.path_trace()
        dts.append(time.perf_counter() - t0)
        segs.append(r.segments_traced - seg0)
        syncs.append(r.last_host_syncs)
        steps.append(r.last_media_steps)
    launches = dict(kernels.LAUNCHES)
    img = r.hdr_image()
    s_per = statistics.median(dts)
    log(f"{label} render {r.meta.name} {W}x{H} depth {r.flags.max_depth}, {r.samples_per_frame} spp/dispatch: "
        f"{s_per:.3f} s/dispatch (median of {dts}), "
        f"{statistics.median(segs) / s_per:.0f} segments/s, {statistics.median(segs):.0f} segments/dispatch, "
        f"host syncs/dispatch {syncs}, media loop steps/dispatch {steps}, "
        f"launches over {TIMED_DISPATCHES + 1} dispatches {launches}, image mean {float(img.mean()):.4f}")
    check(img.shape == (H, W, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"{label} render is finite with mean > 0")
    return launches, s_per, statistics.median(segs)


def profile_dispatch(r: Renderer, label: str, wall_s: float) -> None:
    """One torch.profiler trace (CPU and CUDA activity) of a dispatch after
    an unprofiled one: device events (kernels, copies, fills), their summed
    time, the busy share against the unprofiled s/dispatch `wall_s` of this
    call and against the profiled device span, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    r.path_trace()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.path_trace()
        torch.cuda.synchronize()
    traced = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(len(events) > 0, f"the {label} profile holds device events")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(ms for ms, _ in by_name.values())
    span_ms = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    ours = sorted((m.group(1), ms, n) for name, (ms, n) in by_name.items()
                  if (m := re.search(r"((?:ray_keys|supertile_tables|trace|visit)_kernel<[^>]*>)", name)))
    log(f"profile {label} dispatch: {len(events)} device events, device time {busy_ms:.1f} ms: busy "
        f"{100 * busy_ms / (1e3 * wall_s):.1f}% of the unprofiled {wall_s:.3f} s/dispatch, "
        f"{100 * busy_ms / span_ms:.1f}% of the profiled device span {span_ms:.0f} ms (profiled wall {traced:.2f} s); "
        f"the csrc kernels {sum(ms for _, ms, _ in ours):.1f} ms: "
        + ", ".join(f"{name} {ms:.1f} ms x{n}" for name, ms, n in ours)
        + "; top: " + "; ".join(f"{name[:80]} {ms:.1f} ms x{n}" for name, (ms, n) in top))


def check_stream_launches(launches, label: str) -> None:
    for name in STREAM_KERNELS:
        check(launches[name] > 0, f"the {label} path launched {name}")
    check(launches["visit"] == 0, f"the {label} path did not launch visit")


def kernel_vs_plain_render(data, meta, flags, params, dev, label: str, exact: bool = False) -> None:
    """A 128x128 1-spp render with the kernels against the same render with
    every plain version (`params` made for a square image): within 40 dB
    PSNR, or with `exact` equal."""
    small = 128
    args = (data, meta, flags, params, 2654435761, (small, small), torch.zeros((small, small, 3), device=dev), 0, 1)
    img_k = render_step(*args)[0].cpu().numpy()
    before = dict(kernels.LAUNCHES)
    with plain_kernels():
        img_p = render_step(*args)[0].cpu().numpy()
    check(kernels.LAUNCHES == before, f"the plain {label} render launched no kernel")
    p = psnr(np.clip(img_k, 0, 10), np.clip(img_p, 0, 10), 10.0)
    log(f"{label} kernel vs plain render {small}x{small} 1 spp: PSNR {p:.1f} dB, "
        f"max abs diff {float(np.abs(img_k - img_p).max()):.3g}")
    check(p > 40.0, f"{label} kernel render within 40 dB PSNR of the plain render")
    check(not exact or np.array_equal(img_k, img_p), f"{label} kernel render equals the plain render")


def cloud_from_vdb() -> np.ndarray:
    """Phase 7's 128^3 cloud through a .vdb written in blosc mode (LZ4 by the
    C codec): load_grid gives read_vdb's dense box of the active leaves,
    which, placed at its origin, must equal the procedural grid exactly."""
    want = procedural_cloud((128, 128, 128), coverage=0.6, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.vdb")
        t0 = time.perf_counter()
        write_vdb(path, want, compress="blosc")
        t1 = time.perf_counter()
        got, box = load_grid(path), read_vdb(path)
        t2 = time.perf_counter()
        size = os.path.getsize(path)
    check(blosc._lib is not None, "the blosc LZ4 codec is the C library")
    check(np.array_equal(got, box.values), "load_grid(.vdb) gives read_vdb's values")
    (ox, oy, oz), (d, h, w) = box.origin_ijk, got.shape
    grid = np.zeros_like(want)
    grid[oz:oz + d, oy:oy + h, ox:ox + w] = got
    check(grid.dtype == want.dtype and np.array_equal(grid, want), "the .vdb cloud equals the procedural grid exactly")
    log(f"cloud.vdb (blosc, LZ4 by the C codec): {size} bytes, write_vdb {t1 - t0:.2f} s, load_grid + read_vdb "
        f"{t2 - t1:.2f} s; active box {got.shape} at {tuple(int(v) for v in box.origin_ijk)} placed at its origin "
        f"equals procedural_cloud((128, 128, 128)) exactly")
    return grid


def run_cli(*args: str) -> dict:
    """`python -m vpt_tpu_torch ARGS` from the checkout's root: it must exit
    0; returns its last line of output as JSON."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vpt_tpu_torch", *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0, f"python -m vpt_tpu_torch {' '.join(args)} exits 0 (rc {proc.returncode}):\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    log(f"python -m vpt_tpu_torch {args[0]}: exit 0 in {time.perf_counter() - t0:.1f} s; last line: {last}")
    return json.loads(last)


def textured_colonnade(dev, flags, square, untextured, tmp: str):
    """9a: the textured colonnade at full width with a metrics log, driven
    like phase 4 beside phase 4's (s/dispatch, segments/dispatch)
    `untextured`; then its 128x128 kernel render against the plain one.
    Returns the host scene."""
    t0 = time.perf_counter()
    scene = colonnade_textured()
    log_path = os.path.join(tmp, "log.jsonl")
    r = Renderer(scene, width=W, height=H, flags=flags, samples_per_frame=4, metrics_log=log_path, device=dev)
    texels = sum(t.shape[0] * t.shape[1] for t in scene.textures)
    log(f"Renderer(colonnade_textured, metrics_log=...): {time.perf_counter() - t0:.1f} s; {len(scene.textures)} "
        f"textures, {texels} texels, {nbytes(r.scene_data.textures)} bytes of packed RGBA8 texels on the card")
    check(r.meta.has_textures and len(scene.textures) == 9, "the textured colonnade carries its 9 textures")
    launches, tex_s, tex_segs = drive(r, "textured")
    check_stream_launches(launches, "textured")
    r.metrics.close()
    with open(log_path) as f:
        records = [json.loads(line) for line in f]
    check(len(records) == TIMED_DISPATCHES + 1 and all(x["event"] == "dispatch" for x in records)
          and set(records[0]) == {"ts", "event", "frame", "seed", "spp", "wall_s", "segments", "segs_per_s",
                                  "samples_accumulated", "resolution", "scene"},
          f"the metrics log holds {TIMED_DISPATCHES + 1} dispatch records with the JAX package's keys")
    check(sum(x["segments"] for x in records) == r.segments_traced, "the logged segments sum to segments_traced")
    un_s, un_segs = untextured
    log(f"textured colonnade {tex_s:.3f} s/dispatch, {tex_segs / tex_s:.0f} segments/s ({tex_segs:.0f} "
        f"segments/dispatch); untextured (phase 4, this call) {un_s:.3f} s/dispatch, {un_segs / un_s:.0f} "
        f"segments/s ({un_segs:.0f}): textured / untextured s/dispatch {tex_s / un_s:.3f}; log records "
        + ", ".join(f"frame {x['frame']} wall {x['wall_s']} s" for x in records))
    profile_dispatch(r, "textured", tex_s)
    kernel_vs_plain_render(r.scene_data, r.meta, r.flags, square, dev, "textured")
    return scene


def glb_through_cli(dev, scene, tmp: str) -> None:
    """9b: the textured colonnade as a .glb (PNG textures in buffer views,
    a node per instance, a camera, the KHR extensions) and its sky as .npy;
    load_gltf gives its instances, triangles and textures back; `python -m
    vpt_tpu_torch render` of it matches the procedural scene's render at the
    same seeds."""
    t0 = time.perf_counter()
    glb = gltf_scenes.scene_to_gltf(scene, os.path.join(tmp, "colonnade.glb"))
    sky = os.path.join(tmp, "sky.npy")
    np.save(sky, scene.env_map)
    t1 = time.perf_counter()
    loaded = load_gltf(glb)
    t2 = time.perf_counter()

    def tris(s):
        return sum(s.meshes[i.mesh].n_tris for i in s.instances)

    check(len(loaded.instances) == len(scene.instances) and tris(loaded) == tris(scene),
          "load_gltf gives the colonnade's instances and triangles")
    tex_err = max(float(np.abs(a[..., :3] - b[..., :3]).max()) for a, b in zip(loaded.textures, scene.textures))
    check(len(loaded.textures) == len(scene.textures)
          and all(a.shape[:2] == b.shape[:2] for a, b in zip(loaded.textures, scene.textures)) and tex_err <= 1 / 255,
          "load_gltf gives the textures back within 1/255")
    log(f"colonnade.glb: {os.path.getsize(glb)} bytes written in {t1 - t0:.1f} s; load_gltf {t2 - t1:.1f} s: "
        f"{len(loaded.instances)} instances, {tris(loaded)} triangles, {len(loaded.textures)} textures within "
        f"{tex_err * 255:.3f}/255")
    png, hdr, mlog = (os.path.join(tmp, n) for n in ("glb.png", "glb.npy", "glb_log.jsonl"))
    stats = run_cli("render", glb, "-o", png, "--hdr-output", hdr, "--env", sky, "--width", str(W), "--height", str(H),
                    "--spp", "8", "--spp-per-frame", "4", "--metrics-log", mlog)
    check(set(stats) == {"output", "spp", "seconds", "render_seconds", "segments", "segments_per_sec", "resolution"}
          and stats["spp"] == 8 and stats["resolution"] == [W, H], "render prints its stats line with JAX's keys")
    img = read_png(png)
    check(img.shape == (H, W, 3) and float(img.mean()) > 0.0, "the CLI's PNG reads back (512, 512, 3) with mean > 0")
    with open(mlog) as f:
        records = [json.loads(line) for line in f]
    check(len(records) == 2 and sum(x["segments"] for x in records) == stats["segments"],
          "the CLI's metrics log holds its 2 dispatches")
    ref = Renderer(scene, width=W, height=H, flags=RenderFlags(max_depth=8), samples_per_frame=4, max_samples=8,
                   device=dev)
    while not ref.path_trace():
        pass
    got, want = np.load(hdr), ref.hdr_image()
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), 10.0)
    log(f"CLI render of the .glb vs the procedural scene, {W}x{H} 8 spp at the same seeds: PSNR {p:.1f} dB, "
        f"segments {stats['segments']:.0f} vs {ref.segments_traced:.0f}")
    check(p > 40.0, "the .glb render through the CLI within 40 dB PSNR of the procedural scene's")


def check_ansi_frame(frame: str, rows: int, cols: int) -> None:
    lines = frame.split("\n")
    check(len(lines) == rows + 1 and all(line.count("▀") == cols and line.endswith("\x1b[0m")
                                         for line in lines[:-1]) and "spp" in lines[-1],
          f"a viewer frame is {rows} rows of {cols} ANSI half-blocks and a status line")


def viewer_headless(dev) -> None:
    """9e: the TerminalViewer on sphere_garden (the cluster path) at
    128x128: two steps accumulate, a move restarts the accumulation."""
    r = Renderer(sphere_garden(), width=128, height=128, flags=RenderFlags(max_depth=6), samples_per_frame=1,
                 max_samples=512, device=dev)
    check(not r.meta.use_brute_force, f"sphere_garden ({r.meta.n_tris} triangles) takes the cluster path")
    viewer = TerminalViewer(r, cols=100)
    kernels.reset_launches()
    t0 = time.perf_counter()
    frames = [viewer.step(), viewer.step()]
    check(r.samples_accumulated == 2, "two viewer steps accumulate 2 spp")
    before = r.camera.position.copy()
    frames.append(viewer.step("w"))
    dt = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(r.samples_accumulated == 1 and r.frame_count == 1 and not np.array_equal(r.camera.position, before),
          "a move restarts the accumulation")
    for frame in frames:
        check_ansi_frame(frame, 50, 100)
    check_stream_launches(launches, "viewer")
    log(f"viewer on sphere_garden ({r.meta.n_tris} triangles) 128x128: 3 steps in {dt:.2f} s, the move restarted "
        f"the accumulation (camera {before.tolist()} -> {r.camera.position.tolist()}), frames of 50 x 100 ANSI "
        f"half-blocks, launches {launches}")


def entry_points(dev, smi: str, flags, square, stream_s: float, stream_segs: float) -> None:
    """Phase 9: the user's entry points on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        scene = textured_colonnade(dev, flags, square, (stream_s, stream_segs), tmp)
        glb_through_cli(dev, scene, tmp)
    # 9c. The furnace self-test: 960 triangles, the brute-force trace.
    _, meta, _ = compile_scene(furnace_sphere(), dev)
    check(meta.n_tris == 960 and meta.n_tris <= BRUTE_FORCE_MAX_TRIS and meta.use_brute_force,
          "furnace_sphere (960 triangles) takes the brute-force trace, no kernel")
    line = run_cli("furnace")
    check(line["pass"] is True and line["furnace_mean_error"] < 0.05, "the furnace mean error is under 0.05")
    # 9d. The bench command.
    line = run_cli("bench")
    check(set(line) == {"metric", "value", "unit", "vs_baseline", "detail"} and line["detail"]["dispatches"] == 8
          and line["detail"]["device"] == smi and line["value"] > 0.0,
          "bench prints its line: 8 kept dispatches, the card's name and power limit")
    # 9e. The viewer.
    viewer_headless(dev)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--compare", metavar="OTHER_CU", nargs="+", default=[],
                        help="also time other versions of a csrc/ kernel source against the current kernels")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = card_description(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} | {smi}")

    # 2. Build.
    kernels.library()
    log(f"kernel build: {kernels.build_seconds:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")
    run(dev, smi, args.compare)
    return 0


def run(dev, smi: str, other_builds=()) -> None:
    """Phases 3-9 on `dev`, then the result lines."""
    # 3. Kernels against plain versions at the main path's shapes.
    t0 = time.perf_counter()
    data, meta, aux = compile_scene(colonnade(), dev)
    torch.cuda.synchronize()
    log(f"compile_scene(colonnade): {time.perf_counter() - t0:.1f} s, {meta.n_tris} triangles, "
        f"{data.clusters.count.shape[0]} clusters, {data.clusters.group_min.shape[0]} groups, "
        f"{meta.n_instances} instances")
    cl = data.clusters
    table = {k: {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k]} for k in REPLACES}
    t_min, primary, bounce, shadow = main_path_inputs(data, meta, aux, dev)
    b_primary = stream.trace_bands(*primary[:2], cl, t_min, T_MAX, primary[2], torch.zeros_like(primary[2]))
    b_bounce = stream.trace_bands(*bounce[:2], cl, t_min, T_MAX, bounce[2], torch.zeros_like(bounce[2]))
    b_shadow = occlude.shadow_bands(shadow["origin"], shadow["direction"], cl, t_min, shadow["tmax"],
                                    shadow["active"], shadow["extri"])
    cases = {
        "bounce": envelope_case(cl, stream.pad_wavefront(*bounce[:2], cl, t_min, T_MAX, bounce[2]), b_bounce, t_min, 2),
        "shadow": envelope_case(cl, stream.pad_wavefront(shadow["origin"], shadow["direction"], cl, t_min,
                                                         shadow["tmax"], shadow["active"]), b_shadow, t_min, 1),
    }
    for label, case in cases.items():
        compare_envelope(case, label, table)
    err_p, t_primary = compare_stream(b_primary, cl, t_min, "primary")
    err_b, t_bounce = compare_stream(b_bounce, cl, t_min, "bounce")
    table["stream"]["max_abs_err"] = max(err_p, err_b)
    ok = occlude.occlude_trace(b_shadow, cl, t_min)
    op = occlude.occlude_trace_plain(b_shadow, cl, t_min)
    torch.cuda.synchronize()
    check(torch.equal(ok, op), "occlude equals its plain version")
    table["occlude"]["max_abs_err"] = max_abs_err(ok, op)
    log(f"occlude: {int(b_shadow.payload[0].sum())} active shadow rays, {int(ok.sum())} blocked")

    # The work the rays need, and from it each kernel's bound.
    instanced = cl.inv_rows.shape[0] > 1
    log_trace_work("primary", b_primary, cl, t_min, (b_primary.payload[0] & 1) > 0, t_primary)
    w_bounce = log_trace_work("bounce", b_bounce, cl, t_min, (b_bounce.payload[0] & 1) > 0, t_bounce)
    near = torch.minimum(occlude.nearest_blocker_plain(b_shadow, cl, t_min), b_shadow.tmax)
    w_shadow = log_trace_work("shadow", b_shadow, cl, t_min, b_shadow.payload[0] > 0, near)
    check(2 * int(w_bounce.tests.sum()) < int(w_bounce.tests_unculled.sum()),
          "the sub-block cull halves the bounce rays' triangle tests")

    pk_bounce = cluster.prepare_packets(*bounce[:2], cl, t_min, T_MAX, bounce[2], sort_rays=True)
    pk_shadow = cluster.prepare_packets(shadow["origin"], shadow["direction"], cl, t_min, shadow["tmax"],
                                        shadow["active"], sort_rays=True)
    packets = {"bounce": pk_bounce, "shadow": pk_shadow}
    cull_args = {label: compare_packet_cull(pk, cl, t_min, label, table) for label, pk in packets.items()}
    err_b, plain_b, t_visit_b = compare_visit(pk_bounce, cl, t_min, "bounce")
    err_s, plain_s, t_visit_s = compare_visit(pk_shadow, cl, t_min, "shadow")
    table["visit"]["max_abs_err"] = max(err_b, err_s)
    log_visit_work("bounce", pk_bounce, cl, t_min, t_visit_b)
    log_visit_work("shadow", pk_shadow, cl, t_min, t_visit_s)
    visit_args = {label: (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, cl, t_min)
                  for label, pk in packets.items()}
    n_b, n_s = b_bounce.origin.shape[0], b_shadow.origin.shape[0]
    for label, case in cases.items():
        for name, b in zip(("ray_keys", "supertile_tables"), envelope_bounds(case, label)):
            if label == "bounce":
                table[name].update(b)
            else:
                table[name]["shadow_bound_ms"] = b["bound_ms"]
    for label, args in cull_args.items():
        work = envelope.envelope_work(*args[:6])
        act = packets[label].active.reshape(-1)
        n_act = max(int(act.sum()), 1)
        log(f"packet cull {label}, per active ray: groups entered {float(work.groups[act].sum()) / n_act:.2f}, "
            f"union boxes entered {float(work.chunks[act].sum()) / n_act:.2f}, by any lane of the ray's warp "
            f"{float(work.warp_chunks[act].sum()) / n_act:.1f} (of {args[3].shape[1] // envelope.CHUNK})")
        key = "packet_bound_ms" if label == "bounce" else "packet_shadow_bound_ms"
        table["supertile_tables"][key] = tables_bound(args, work, cluster.PACKET_SIZE)["bound_ms"]
    table["stream"].update(bound(trace_flops(w_bounce, instanced),
                                 nbytes(*band_inputs(b_bounce), *cluster_tables(cl)) + 16 * n_b))
    table["occlude"].update(bound(trace_flops(w_shadow, instanced),
                                  nbytes(*band_inputs(b_shadow), *cluster_tables(cl)) + 4 * n_s))
    # The visit does the same closest hits of the same rays as stream (bounce)
    # and the nearest-blocker search of occlude (shadow).
    for label, pk, work in (("bounce", pk_bounce, w_bounce), ("shadow", pk_shadow, w_shadow)):
        b = bound(trace_flops(work, instanced),
                  nbytes(pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.tmax, *cluster_tables(cl))
                  + 4 * pk.active.numel() + 16 * pk.active.numel())
        if label == "bounce":
            table["visit"].update(b)
        else:
            table["visit"]["shadow_bound_ms"] = b["bound_ms"]
    table["visit"]["plain_ms"], table["visit"]["shadow_plain_ms"] = plain_b, plain_s

    calls = kernel_calls(cases, cl, t_min, b_bounce, b_shadow, visit_args, cull_args)
    for name, shapes in calls.items():
        row = table[name]
        for i, (label, args) in enumerate(shapes.items()):
            pre = f"{label}_" if i else ""
            row[f"{pre}ms"] = cuda_ms(lambda: wrapper(name)(*args), launches=LAUNCHES_PER_PAIR)
            if name != "visit":  # the plain visit was timed once above
                row[f"{pre}plain_ms"] = cuda_ms(lambda: PLAIN[name][2](*args))
            log(f"{name} {label}: kernel {row[f'{pre}ms']:.4f} ms (median of 5 x {LAUNCHES_PER_PAIR} launches), "
                f"plain {row[f'{pre}plain_ms']:.3f} ms{' (timed once)' if name == 'visit' else ''}; "
                f"bound {row[f'{pre}bound_ms'] * 1e3:.2f} us by "
                f"{row['bound_by']}, the kernel at {100 * row[f'{pre}bound_ms'] / row[f'{pre}ms']:.2f}% of it; "
                f"library call: none")
    if other_builds:
        ab, others = compare_builds(other_builds, calls)

    # 4. The table bake the default Renderer runs (and caches), then the
    # stream path.
    cached = all(os.path.exists(os.path.join(lookup.CACHE_DIR, f"torch_lookup_{k}_4096.npy"))
                 for k in ("reflect", "refract_out", "refract_in"))
    t0 = time.perf_counter()
    tables = lookup.get_lookup_tables(device=dev)
    torch.cuda.synchronize()
    log(f"lookup tables ({'loaded from the cache' if cached else 'baked on the card'}, 4096 samples/texel): "
        f"{time.perf_counter() - t0:.1f} s; means " + ", ".join(f"{float(t.mean()):.4f}" for t in tables))
    check(all(bool(np.isfinite(t).all()) for t in tables) and tables[0].shape == lookup.REFLECT_SHAPE
          and tables[1].shape == tables[2].shape == lookup.REFRACT_SHAPE,
          "the baked tables are finite and of their shapes")
    flags = RenderFlags(max_depth=8, max_medium_events=8)
    t0 = time.perf_counter()
    r = Renderer(colonnade(), width=W, height=H, flags=flags, samples_per_frame=4, device=dev)
    log(f"Renderer(colonnade, lookup_tables='auto'): {time.perf_counter() - t0:.1f} s")
    check(not np.array_equal(r.scene_data.lookup_reflect.cpu().numpy(), constant_fit(1.0)),
          "the default Renderer carries the baked fits, not the constant fit")
    launches, stream_s, stream_segs = drive(r, "stream")
    check_stream_launches(launches, "stream")
    for name in STREAM_KERNELS:
        table[name]["launches"] = launches[name]
    if other_builds:
        drive_ab(r, others, ab)

    # 5. The packet path, then its image saved as a PNG and read back.
    with mock.patch.object(integrator, "TRACE_MODE", "packet"):
        launches, packet_s, _ = drive(r, "packet")
        check(launches["visit"] > 0, "the packet path launched visit")
        check(launches["supertile_tables"] > 0, "the packet path launched supertile_tables (the packet cull)")
        check(launches["stream"] == 0 and launches["occlude"] == 0,
              "the packet path launched neither stream nor occlude")
        table["visit"]["launches"] = launches["visit"]
        table["supertile_tables"]["packet_launches"] = launches["supertile_tables"]
        log(f"packet path {packet_s:.3f} s/dispatch, stream path {stream_s:.3f} s/dispatch in this call: "
            f"{packet_s / stream_s:.2f}x; supertile_tables launches over {TIMED_DISPATCHES + 1} dispatches: "
            f"{table['supertile_tables']['launches']} at 1024-ray tiles (stream path), "
            f"{launches['supertile_tables']} at 512-ray tiles (packet path)")
        with tempfile.TemporaryDirectory() as tmp:
            path = r.save(os.path.join(tmp, "packet.png"))
            png = read_png(path)
        log(f"saved {os.path.basename(path)}: {png.shape} uint8, mean {float(png.mean()):.1f}")
        check(png.shape == (H, W, 3) and float(png.mean()) > 0.0, "the saved PNG reads back (512, 512) with mean > 0")

    # One profiled dispatch of each mode.
    profile_dispatch(r, "stream", stream_s)
    with mock.patch.object(integrator, "TRACE_MODE", "packet"):
        profile_dispatch(r, "packet", packet_s)

    # 6. Kernel renders against plain renders.
    square = default_params(dev, np.linalg.inv(aux["camera_view"]),
                            np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0)))
    kernel_vs_plain_render(data, meta, flags, square, dev, "stream")
    with mock.patch.object(integrator, "TRACE_MODE", "packet"):
        kernel_vs_plain_render(data, meta, flags, square, dev, "packet", exact=True)

    # 7. The media path: a 128^3 cloud, read from a .vdb, and a ground haze
    # (README's cloud in a scene).
    cloud = cloud_from_vdb()
    t0 = time.perf_counter()
    r = Renderer(colonnade(), width=W, height=H, flags=MEDIA_FLAGS, samples_per_frame=4, device=dev)
    r.add_volume(Volume(corner_min=(-6, 3, -4), corner_max=(6, 9, 4), density=8.0, anisotropy=0.3,
                        density_grid=cloud))
    r.add_volume(Volume(corner_min=(-17, 0, -7), corner_max=(17, 1.5, 7), density=0.05, color=(0.9, 0.9, 0.9)))
    log(f"media Renderer with two volumes: {time.perf_counter() - t0:.1f} s; n_volumes {r.meta.n_volumes}, "
        f"n_het_volumes {r.meta.n_het_volumes}, grids {tuple(r.scene_data.volumes.density_grids.shape)}")
    check_stream_launches(drive(r, "media")[0], "media")
    kernel_vs_plain_render(r.scene_data, r.meta, r.flags, square, dev, "media")

    # 8. The atmosphere path: the day setup of scripts/gallery.py.
    r = Renderer(colonnade(), width=W, height=H, flags=flags, samples_per_frame=4, device=dev)
    r.set_enable_atmosphere(True)
    r.set_planet_position((0.0, -6360e3, 0.0))
    r.set_sky_altitude(30.0)
    check_stream_launches(drive(r, "atmosphere")[0], "atmosphere")
    kernel_vs_plain_render(r.scene_data, r.meta, r.flags, square._replace(sky_rotation_altitude=30.0,
                                                                          planet_position=r.params.planet_position),
                           dev, "atmosphere")

    # 9. The user's entry points.
    entry_points(dev, smi, flags, square, stream_s, stream_segs)

    print(smi)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
