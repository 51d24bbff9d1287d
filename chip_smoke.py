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
 3b. the port's own kernel, the dispatch graph's loop condition
     (csrc/graph_loop.cu vpt_loop_cond_kernel), against its plain version
     (render/loop.py:cond) in toy WHILE graphs (tests/while_toys.py):
     seeded live schedules (cap 0, every lane dead at entry, lanes alive
     at the cap, random ones, a 512x512 wavefront) give the plain host
     loop's step count, twice, and a nested pair counts its loops and
     steps; its time per run inside a WHILE body at 262,144 lanes beside
     the plain version's and its bound;
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
     that is read back (phase 12 profiles both modes);
  6. 128x128 1-spp renders with the kernels against the same renders with
     every plain version, stream and packet mode: PSNR > 40 dB, the packet
     render equal;
  7. the media path: the stream-mode Renderer with a 128^3 procedural
     cloud and a homogeneous ground haze added by `add_volume` (the merged
     march, delta tracking, ratio-tracked NEE, HG phase) at 512x512,
     max_depth 1 (MEDIA_FLAGS), 4 spp, one seed, its loop captured (one
     dispatch graph: a WHILE node over the iteration's segment graphs and,
     between them, a nested WHILE node over one step of each of its 5
     media loops) against the eager loop as phase 12 does it: after a
     warm-up of each way, eager, captured, captured, eager, the four images
     bitwise equal with equal segments, media loops, media loop steps and
     launches (ray_keys, supertile_tables, stream and occlude launch, visit
     does not; the loop condition only captured); each captured dispatch
     one graph launch with no host read inside its loop; both s/dispatch,
     segments/s, the launch's device time and busy share, the capture
     seconds and graph pool bytes, and a profile of a captured dispatch at
     PROFILE_SIZE^2, 1 spp; then its 128x128 kernel render against the
     plain one, PSNR > 40 dB.  The cloud comes from a .vdb that write_vdb writes in blosc
     mode (LZ4 through the C codec); placed at its origin, the grid
     load_grid reads equals the procedural grid exactly;
  8. the atmosphere path: the gallery's day setup (planet surface at
     y = 0, sky altitude 30 degrees) under colonnade's open sky, at depth
     2 (ATMOSPHERE_FLAGS; 7 media loops per iteration), the same way;
  9. the user's entry points on the card:
     a. the textured colonnade (9 textures, ~4.7M texels of albedo and
        normal maps) at 512x512 with a metrics log, driven like phase 4
        beside phase 4's numbers: the four stream-path kernels launch,
        visit does not, the log holds one dispatch record per dispatch
        whose segments sum to segments_traced (phase 12 profiles it); then
        its 128x128 kernel render against the plain one, PSNR > 40 dB;
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
        frames of ANSI half-blocks, the stream kernels launched;
 10. the sharded path (vpt_tpu_torch.dist), its wall time printed:
     a. a one-rank nccl group and make_mesh(1, 1): render_sharded of
        phase 4's colonnade 512x512, depth 8, 4 spp, one warm-up and two
        timed dispatches beside phase 4's s/dispatch, with the launch
        counts (the four stream-path kernels launch, visit does not), then
        render_step and render_sharded timed in turns (step, sharded,
        sharded, step); its
        image above 60 dB PSNR against integrator.render_samples over the
        same row-major pixels (bitwise equality reported), its segments
        within 0.05% of render_step's at the same seed (t ties only); the
        all_reduce of the 512x512 frame timed; then the one-rank render of
        the dry run's frame (colonnade 128x128, 4 spp, depth 8, the
        constant fit); then one dispatch of phase 7's media scene through
        render_sharded, its loop captured, bitwise render_samples over the
        same pixels with equal segments;
     b. dryrun_multichip(2, device="cuda"): two rank processes on the one
        card over gloo, colonnade 128x128, JAX's three checks; the (2, 1)
        and (1, 2) images agree above 60 dB with each other and with a's
        one-rank render;
 11. the image decoders (vpt_tpu_torch/io: the C codec csrc/imgcodec.c,
     built with gcc, and io/jpeg.py) on a machine without PIL:
     a. every fixture of tests/torch_images/ (baseline JPEGs at 4:4:4,
        4:2:2 and 4:2:0, gray, optimised, with restart markers, progressive
        4:2:0 and gray; 16-bit, Adam7 and 1/2/4-bit gray PNGs) decodes
        bitwise equal to PIL's decode recorded beside it, the 1024x1024
        JPEG to its recorded sha256;
     b. host seconds of `decode_rgba` on that 1024x1024 4:2:0 JPEG and on a
        2048x2048 RGBA PNG with Paeth rows made here (median of 5 each,
        under 0.5 s), beside the card's name and power limit;
     c. colonnade with a progressive JPEG base colour on its floor and a
        16-bit PNG one on its stone, written as a .glb and rendered by
        `python -m vpt_tpu_torch render` at 512x512, depth 8, 8 spp, against
        the same scene rendered in memory with PIL's recorded decodes as
        those textures, at the same seeds: equal segments, PSNR > 60 dB,
        bitwise equality printed; the in-memory render's launch counts
        (set to 0 just before it) show the four stream-path kernels.
 12. the captured loop (vpt_tpu_torch/render/graphs.py) against the eager
     one (graphs.CAPTURE = False) in the stream, packet, textured and
     one-rank nccl sharded paths, colonnade 512x512, depth 8, 4 spp, one
     seed: after a warm-up of each way, eager, captured, captured, eager;
     the four images bitwise equal with equal segments and launches (set
     to 0 just before each dispatch; the loop condition only captured);
     each captured dispatch one launch of its dispatch graph with no host
     read inside its loop and one after it (the graph's tallies); both
     s/dispatch, segments/s, the device time of one captured dispatch's
     launch (one CUDA event pair) and its busy share, the capture seconds
     and graph pool bytes, and, in the stream path (since the lossy AVIF
     slice; before, in each path), one torch.profiler trace of a captured
     dispatch and of an eager one: kernel launches, device time and busy share
     (device time over the unprofiled s/dispatch), the top kernels; one
     JSON line "graphs" with phases 7 and 8's rows first;
 13. the goldens and the gallery (vpt_tpu_torch/gallery.py):
     a. the four golden configurations of tests/test_golden.py whose
        scenes are in the repository (tests/torch_goldens.py), rendered
        captured on the card: SSIM against tests/golden at the JAX tests'
        bars, cornell and glass against the port's CPU render of the same
        configuration (within 40 dB and GOLDEN_CLOSE of the pixels close;
        smoke's and sunset's, which held nothing, not rendered since the
        lossy AVIF slice added to phase 17), no trace kernel launched
        (brute force); then sphere_garden(grid=3) at 48x48, 16 spp by
        brute force against the clusters, > 40 dB, stream and occlude
        launched in the cluster render and no trace kernel in the other;
     b. every gallery job through gallery.render at its committed TPU
        render's size (from Gallery/<name>.png's header), 16 spp, captured:
        seconds, s/dispatch, segments/s, capture seconds and launches; the
        image finite and not uniform; the four stream-path kernels launch
        for colonnade and sphere_garden and none for the brute-force
        scenes; PSNR and SSIM of the saved PNG against the TPU render, the
        PSNR at least GALLERY_PSNR_BARS; the step cache's steps and graph
        pool bytes and memory_reserved after the gallery: no step that a
        job made outlives its Renderer; then `python -m
        vpt_tpu_torch.gallery` at GALLERY_SIZE=64 GALLERY_SPP=8 into a
        temporary directory: exit 0, one PNG per job, viking_room skipped;
        one JSON line "gallery".
 14. the layout knobs and the dispatch tools (vpt_tpu_torch/tools):
     a. colonnade compiled at K = 64 and 256 (cluster.CLUSTER_SIZE, which
        compile_scene reads when called) and at groups of 4, 16, 48 and 64
        with K = 128 (cluster.GROUP_SIZE; 48 and 64 above the 32 members a
        warp tests at a time), each with phase 4's baked fits: at phase
        3's bounce and shadow shapes ray_keys and supertile_tables equal
        their plain versions, stream by the tie rule, occlude and the
        packet cull exactly, visit exactly on VISIT_SLICE bounce packets
        spread over them; CUDA-event medians of 20-launch pairs of the
        five kernels (bounce; occlude on the shadow batch) beside their
        bounds (phase 3's way); clusters, groups and Gp; one captured
        dispatch at LAYOUT_SIZE^2 (128x128), depth 8, 4 spp, at GRAPH_SEED
        after the one that captures: s/dispatch, segments and the image's
        PSNR against phase 4's configuration's K = 128 image at that size
        and seed (above LAYOUT_PSNR), and whether image and segments equal
        the default layout's;
     b. the packet path (integrator.TRACE_MODE "packet") at
        PACKET_LAYOUTS (cluster.PACKET_SIZE 256, 1024, and 64, 384 and 2048,
        which supertile_tables runs in its run-time tile, _SORT_KEY "fe",
        integrator._SORT_RAYS False): the packet cull at PACKET_SIZE-ray
        tiles against its plain version and the dense cull, the key-sorted
        (or unsorted) packets' visit on VISIT_SLICE packets spread over
        them exactly, the fe keys against their plain version; visit and the
        packet cull timed beside their bounds; one captured dispatch each
        as in a, visit launched and stream not;
     c. tools.profile_dispatch on the stream path (colonnade 512x512, 4
        spp) and on phase 7's media scene at PROFILE_SIZE^2, 1 spp: the
        host-driven profile's device events number the kernel, memcpy and
        memset nodes its graphs' replays ran within PROFILE_EVENTS, and its
        summed device ms is at most PROFILE_TOLERANCE above the device ms of
        the step's WHILE launch (one event pair, after the profiled run; the
        launch before it and the ratio are printed too); the top ops, the
        csrc kernels' shares and the SM clock around it;
     d. `python -m vpt_tpu_torch.tools.quick_bench 128`, then
        `python -m vpt_tpu_torch.tools.sweep_bench 128 4 --configs k128`
        (a K 64 and a K 256 dispatch run in a), as subprocesses: each
        RESULT line with the card's name and power limit;
     one JSON line "layouts".
 15. the probe kernels (csrc/probe.cu, tools/hopper_probe.py: the
     counterparts of scripts/mosaic_probe.py's and scripts/smem_probe.py's
     Pallas kernels), a path of their own: the counts set to 0, `python -m
     vpt_tpu_torch.tools.hopper_probe`'s run (tools.hopper_probe.Prober) in
     this process, every probe PASS and every probe kernel launched, its
     lines logged; the shared-memory boundary: probe8 and smem_probe run
     at hopper_probe.SMEM_LIMIT bytes (227 KB) of dynamic shared memory and
     are refused 16 bytes above it; then each of the 11 kernels against
     its plain version at its probe's shapes (hopper_probe.cases, bitwise,
     probe2's bins as sets), timed beside its bound, its plain version
     and, where one exists, its library call: a probe kernel is one small
     block that runs shorter than the host takes to issue it, so its ms
     (and the library call's) is per launch in a CUDA graph of 20 (the
     CUDA-event median of 5 replays), printed beside the median of 5
     event pairs around 20 back-to-back launches (`event_ms`, the host's
     issue rate); one JSON line "probes".
 16. the gaps against the JAX package closed last:
     a. the host C libraries (csrc/bvh_builder.cpp with g++, csrc/lz4_block.c
        with gcc) built from the port's own sources into a fresh temporary
        directory and loaded, their sources printed;
     b. build_bvh(use_native=False) (the NumPy builder) and the C++ builder
        on colonnade's largest unique mesh (11,264 triangles; a seeded
        20,000-triangle soup were it larger), each builder's host seconds;
        262,144 seeded rays (two thirds aimed at triangle centroids) traced
        through both trees with traverse.intersect_bvh on the card: t to
        rtol 1e-4 / atol 1e-5 and more than 99% of triangle ids equal
        (tests/test_native_bvh.py's bars);
     c. integrator.trace on phase 3's bounce rays with any_hit=True, then
        with a half-true anyhit_mask, in stream and in packet mode: the rays
        that hit are the closest-hit trace's, an any hit lies no nearer than
        the closest one, and the rays outside the mask keep their closest
        hits bit for bit;
     d. cluster.intersect_clusters(packet=P) on the bounce rays at P 64, 384
        and 2048 equals, bit for bit, the trace with cluster.PACKET_SIZE set
        to P (as phase 14b sets it);
     one JSON line "port_gaps".
 17. the image formats, on a machine without PIL, imageio or OpenCV:
     a. every fixture of tests/torch_formats/ (TIFF, GIF, BMP, CMYK / YCCK,
        4:4:0 / 4:1:1 and block-smoothed JPEGs), of tests/torch_webp/
        (WebP: the simple and normal loop filters at each sharpness, 2 / 4 /
        8 token partitions, segments, ALPH chunks under each filter, raw
        and lossless, lossless files, an animation's first frame at an
        offset) and of tests/torch_jpeg/ (arithmetic-coded sequential and
        progressive JPEGs, DAC conditioning, restart intervals, a
        block-smoothed SOF10, lossless JPEGs at predictors 1-7 and point
        transforms 0-3) and of tests/torch_pil_formats/ (TGA raw and RLE
        with packets over scanlines and colour maps, PCX planes, DDS BC1-BC7
        and uncompressed, Netpbm P1-P6 and PFM, QOI, SGI RLE, ICO / CUR, PSD;
        and its three 2048x2048 timing textures, made here from their seed
        by tests/pil_format_writers.py) and of tests/torch_jpeg2000/ (JPEG
        2000: PIL's and OpenCV's writers at their options, JP2 boxes and
        codestream edits built by tests/jpeg2000_cases.py, the timing
        textures and the sky) through decode_rgba and load_hdr, and of
        tests/torch_pil_rare/ (PIL's rarer plugins: BLP, icns, DCX, FITS,
        FTEX, GBR, IM, IM Tools, MSP, SPIDER, Sun raster, XBM, XPM, XV
        thumbnails, FLI / FLC, IPTC, McIdas, PIXAR, and files of the
        plugins that decode on neither machine; and the PhotoCD cases, the
        2048x2048 timing textures and the FITS sky that
        tests/pil_rare_writers.py makes here from seeds) through
        decode_rgba of the bytes and of the file, load_png and load_hdr,
        against its manifest: the sha256 of the JAX package's decode, or a
        ValueError where it refuses; so too every file of tests/torch_avif/
        (lossless and lossy AVIF PIL writes: every subsampling, RGBA with
        alpha premultiplied or not, both ranges, aom speeds 0-10, quality
        30-99 at every coefficient-CDF set, every transform size to 64x64,
        delta q and delta lf, tiles, palette, an avis sequence, and the
        1024x1024 timing textures and sky; the loop restoration, CDEF,
        quantizer-matrix, intra block copy, scaled-ispe and FCC-matrix files
        the port refuses by name where the JAX package reads them); every
        file of tests/torch_opencv/
        (what imageio hands to OpenCV: Radiance, Sun raster, BMP, PAM,
        Netpbm, JPEG with EXIF orientations, PNG, TIFF, WebP, GIF, JPEG
        2000, AVIF) named sky.exr through load_hdr against its manifest,
        or the refusal it records; the C codec (its arithmetic and
        lossless scan decoders and its TGA, PCX, SGI, QOI and PackBits loops
        too), the C WebP decoders, the C BC block decoders and the C JPEG
        2000 decoder and the C AV1 decoder loaded;
     b. a 4096x2048 float32 RGB sky (default_sky) written by
        `write_float_tiff` here as Deflate 256x256 tiles and as
        uncompressed strips: load_hdr gives it back bitwise; its host
        seconds (median of 5) beside load_radiance_hdr of the same sky by
        save_radiance_hdr, and load_hdr of that file named sky.HDR
        (OpenCV's route: 8-bit, io/cv_hdr.py) under OPENCV_LIMIT_S, with
        the card's name and power limit; the Deflate read under
        FORMAT_LIMIT_S; decode_rgba of the two 2048x2048
        WebP textures of tests/torch_webp/ (lossy with ALPH, lossless), host
        seconds (median of 5), each under WEBP_LIMIT_S; decode_rgba of the
        2048x2048 4:2:0 SOF10 texture and the 1024x1024 lossless RGB image
        of tests/torch_jpeg/, host seconds (median of 5), each under
        JPEG_LIMIT_S; decode_rgba of the 2048x2048 BC7 DDS, RLE TGA and QOI
        textures, host seconds (median of 5), each under PIL_LIMIT_S;
        decode_rgba of the 2048x2048 9/7 JP2 at a rate and the 1024x1024
        5/3 JP2 of 256x256 tiles of tests/torch_jpeg2000/, host seconds
        (median of 5) beside PIL's where the fixtures were made, each under
        JP2_LIMIT_S; decode_rgba of the 2048x2048 Sun raster RLE, MSP v2,
        FLC, XBM and BLP2 DXT5 textures, each under RARE_LIMIT_S, and
        load_hdr of the 4096x2048 float FITS sky under FITS_LIMIT_S, host
        seconds (median of 5); decode_rgba of the 1024x1024 lossless 4:2:0
        and RGBA AVIF textures and the lossy 4:2:0 one at PIL's defaults,
        each under AVIF_LIMIT_S, host seconds (median of 5);
     c. `python -m vpt_tpu_torch render garden` at 512x512, depth 8, 8 spp
        with --env sky.tif against --env sky.npy of the same array, with
        --env sky.jp2 against --env sky_jp2.npy of its decode, and with
        --env sky.HDR (a Radiance file of tests/torch_opencv/) against
        --env sky_HDR.npy of its manifest decode, and with --env sky.fits
        (a 1024x512 float FITS) against --env sky_fits.npy of its decode,
        and with --env sky.avif (a 1024x512 lossless AVIF) against --env
        sky_avif.npy of its manifest decode (ten processes at once):
        bitwise equal, with equal segments; then the colonnade as a
        .glb with
        a GIF, an RLE8 BMP, an LZW TIFF and a CMYK JPEG base colour, a lossy
        WebP with ALPH on the back wall, a lossless WebP on the brass, a
        SOF10 JPEG on the west wall, a lossless JPEG on the east wall, the
        BC7 DDS on the front wall, the RLE TGA and the QOI on two pedestals,
        a PCX on a drape, a PSD on a statue, a tiled JP2 on a third
        pedestal, the Sun raster RLE and the BLP2 DXT5 textures on two more,
        the FLC on a drape, an icns on a statue, a FITS image on a drape
        and the three 1024x1024 AVIF textures on a drape and two columns
        (each of these its own copy
        of its material), through the CLI, bitwise its in-memory render with
        those decodes (each the manifest's sha256);
     one JSON line "image_formats".  `--image-formats` runs this phase alone
     (after the build).
Every drive of phases 4-11, 13 and 14 checks that its loop ran captured (a
graph launch per dispatch); the plain-version renders run eagerly.
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

    python3 chip_smoke.py --gallery-full

builds the kernels and bakes the lookup tables, then renders every gallery
job at its committed TPU render's size and samples (TPU_SPP), with the
13b numbers and the same numbers of the accumulation after 16 spp (what
phase 13b renders, and what GALLERY_PSNR_BARS come from).  One JSON line
"gallery_full".

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
import dataclasses
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import weakref
import zlib
from contextlib import ExitStack
from typing import NamedTuple
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from vpt_tpu_torch import Renderer, RenderFlags, gallery
from vpt_tpu_torch.accel import bvh, cluster, envelope, kernels, occlude, stream, traverse, visit
from vpt_tpu_torch.accel.traverse import KERNEL_GROUP, T_MAX, T_MIN, guarded_inverse
from vpt_tpu_torch.api import render_step
from vpt_tpu_torch.bench import card_description
from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import generate_primary_rays, perspective
from vpt_tpu_torch.core.tiling import tiled_pixel_order
from vpt_tpu_torch.dist import dryrun
from vpt_tpu_torch.dist import mesh as dmesh
from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io.image import decode_rgba, load_png, load_radiance_hdr, read_png, save_radiance_hdr
from vpt_tpu_torch.io.metrics import psnr, ssim
from vpt_tpu_torch.render import graphs, integrator, lights, lookup, loop, sampling, surface
from vpt_tpu_torch.render.lookup_fit import constant_fit
from vpt_tpu_torch.render.params import default_params, scalar
from vpt_tpu_torch.scene import blosc
from vpt_tpu_torch.scene.build import BRUTE_FORCE_MAX_TRIS, compile_scene
from vpt_tpu_torch.scene.envmap import default_sky, load_hdr
from vpt_tpu_torch.scene.gltf import load_gltf
from vpt_tpu_torch.scene.procedural import colonnade, colonnade_textured, furnace_sphere, sphere_garden
from vpt_tpu_torch.scene.types import Volume, tree_to_device
from vpt_tpu_torch.scene.vdb import load_grid, procedural_cloud
from vpt_tpu_torch.scene.vdb_reader import read_vdb, write_vdb
from vpt_tpu_torch.tools import hopper_probe
from vpt_tpu_torch.tools import profile_dispatch as profile_tool
from vpt_tpu_torch.viewer import TerminalViewer

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import avif_cases  # noqa: E402  (tests/avif_cases.py, jax-free: the AVIF files the port refuses by name)
import gltf_scenes  # noqa: E402  (tests/gltf_scenes.py, jax-free: the .glb writer)
import pil_format_writers  # noqa: E402  (tests/pil_format_writers.py, numpy alone: 17b's 2048x2048 textures)
import pil_rare_writers  # noqa: E402  (tests/pil_rare_writers.py, numpy alone: PIL's rarer plugins' large files)
import torch_goldens  # noqa: E402  (tests/torch_goldens.py, jax-free: the golden configurations)
import while_toys  # noqa: E402  (tests/while_toys.py, jax-free: toy dispatch graphs)

SOURCES = {
    "ray_keys": "vpt_tpu_torch/csrc/envelope.cu",
    "supertile_tables": "vpt_tpu_torch/csrc/envelope.cu",
    "stream": "vpt_tpu_torch/csrc/trace.cu",
    "occlude": "vpt_tpu_torch/csrc/trace.cu",
    "visit": "vpt_tpu_torch/csrc/visit.cu",
    "loop_cond": "vpt_tpu_torch/csrc/graph_loop.cu",
}
REPLACES = {
    "ray_keys": "vpt_tpu/accel/envelope.py:132",
    "supertile_tables": "vpt_tpu/accel/envelope.py:209",
    "stream": "vpt_tpu/accel/stream.py:490",
    "occlude": "vpt_tpu/accel/occlude.py:350",
    "visit": "vpt_tpu/accel/visit_kernel.py:302",
    # The port's own kernel, no TPU kernel's counterpart: the condition of the
    # lax.while_loop that the dispatch graph's WHILE nodes run.
    "loop_cond": "vpt_tpu/render/integrator.py:838",
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
# The media path at depth 1 and the atmosphere at 2 (the others at 8; 4 and 8
# when the script ran 1,021 s, 2 and 4 when it ran 973.9 s with phase 17
# grown): an eager media dispatch is seconds of host-bound loop steps,
# phases 7, 8 and 10 run five of them, and the script stays within its time.
MEDIA_FLAGS = RenderFlags(max_depth=1, max_medium_events=8)
ATMOSPHERE_FLAGS = RenderFlags(max_depth=2, max_medium_events=8)
# The captured media and atmosphere dispatches are profiled at this size,
# 1 spp: a media dispatch issues ~300 kernels per loop step whatever its
# size, and a trace of millions of events takes minutes to gather.
PROFILE_SIZE = 64
PEAK_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
SLAB_OPS = 24  # 6 subtractions, 6 products, 12 min / max
TRANSFORM_OPS = 36  # world -> local origin (18) and direction (15), 3 reciprocals
MT_OPS = 53  # Moller-Trumbore as in csrc/trace.cu: 47 arithmetic, 6 compares
LAUNCHES_PER_PAIR = 20  # back-to-back kernel launches per event pair
COND_RUNS = 2000  # loop condition kernels run inside one WHILE graph launch when timing it
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
    """Route every kernel wrapper of the render path to its plain version,
    with the loop eager: the plain versions synchronise, and a captured
    step would replay the kernels."""
    stack = ExitStack()
    for module, name, plain in PLAIN.values():
        stack.enter_context(mock.patch.object(module, name, plain))
    stack.enter_context(mock.patch.object(graphs, "CAPTURE", False))
    return stack


def main_path_inputs(data, meta, aux, dev):
    """Primary rays, one diffuse bounce and the 2N shadow batch at 512x512."""
    view_inv = np.linalg.inv(aux["camera_view"])
    proj_inv = np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), W / H))
    params = default_params(view_inv, proj_inv, device=dev)
    pxy, pidx, _, _ = tiled_pixel_order(W, H)
    state = rng.seed(torch.as_tensor(pidx.astype(np.int64), device=dev), 0, 12345)
    state, org, d = generate_primary_rays(params.view_inverse, params.proj_inverse,
                                          torch.as_tensor(pxy, device=dev), (W, H), state, params.focus_distance,
                                          params.dof_strength)
    t_min = T_MIN * meta.scene_scale
    hit = stream.intersect_stream(org, d, data.clusters, t_min, T_MAX)
    found = hit.t >= 0
    tri = torch.clamp(hit.tri.to(torch.int64), 0, data.tri_p0.shape[0] - 1)
    surf = surface.make_surface(data, hit._replace(tri=tri), d, False, meta.has_textures)
    center = torch.tensor(meta.scene_center, device=dev)
    p_mag = torch.linalg.vector_norm(surf.world_pos - center, dim=-1) + 0.0346 * meta.scene_scale
    bounce_org = surf.world_pos + surf.geom_normal * (5.8e-4 * p_mag)[:, None]
    state, bounce_dir = sampling.sample_cosine_hemisphere(state, surf.geom_normal)
    state, to_sky, _ = lights.importance_sample_env(state, data.env, params.sky_rotation_azimuth,
                                                    params.sky_rotation_altitude, found.shape)
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
    tiles of the packets' size."""
    gmin, gmax = cluster.pad_groups(cl)
    return (pk.origin.reshape(-1, 3), guarded_inverse(pk.direction.reshape(-1, 3)),
            cluster.packet_cull_tmax(pk.tmax, pk.active).reshape(-1), gmin, gmax, t_min, pk.active.shape[1])


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
    """supertile_tables at PACKET_SIZE-ray tiles against its plain version
    and the dense cull it replaced, bit for bit, and the candidate lists
    that prepare_packets made from it against the dense cull's.  Returns the
    kernel's arguments."""
    args = packet_cull_args(pk, cl, t_min)
    size = args[-1]
    got, plain = envelope.supertile_tables(*args), envelope.supertile_tables_plain(*args)
    dense = dense_packet_cull(pk, cl, t_min)
    torch.cuda.synchronize()
    check(bits_equal(got, plain), f"supertile_tables ({label} packets, {size}-ray tiles) equals its plain version")
    check(bits_equal(got, dense), f"supertile_tables ({label} packets, {size}-ray tiles) equals the dense packet cull")
    entry_sorted, order = torch.sort(dense, dim=1, stable=True)
    check(torch.equal(pk.order, order.to(torch.int32)) and bits_equal(pk.entry_sorted, entry_sorted)
          and torch.equal(pk.nvis, torch.isfinite(dense).sum(dim=1).to(torch.int32)),
          f"prepare_packets' candidate lists ({label}) equal the dense cull's")
    row = table["supertile_tables"]
    row["max_abs_err"] = max(row.get("max_abs_err", 0.0), max_abs_err(got, plain))
    log(f"packet cull {label}: supertile_tables over {got.shape[0]} packets of {size} rays ({int(pk.active.sum())} "
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
    current ones).  The cached steps go on entry and on exit: a graph
    replays the build it was captured with."""
    graphs.clear()
    try:
        with mock.patch.dict(kernels.library(), build.entry if build is not None else {}):
            yield
    finally:
        graphs.clear()


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


def loop_cond_phase(dev, table) -> None:
    """Phase 3b: vpt_loop_cond_kernel (csrc/graph_loop.cu) against its plain
    version (render/loop.py:cond) in toy dispatch graphs (tests/
    while_toys.py): per seeded live schedule the WHILE node runs the plain
    host loop's count of steps (twice: the upstream condition restarts
    it), the final live mask equal; a nested pair counts its loops and
    steps as nested loops do; then its time per run inside a WHILE body
    over a 512x512 wavefront's live mask (COND_RUNS + 1 runs in one launch
    whose body is the condition alone, by one CUDA event pair), the plain
    version's time and the bound."""
    t_phase = time.perf_counter()
    worst = 0
    for name in while_toys.SCHEDULES:
        death, cap = while_toys.deaths(name, seed=1)
        d = torch.as_tensor(death, device=dev)
        want = while_toys.plain_count(d, cap)
        nodes, (live, steps, counts) = while_toys.single(d, cap, graphs.Recorder())
        toy = graphs.DispatchGraph(nodes, dev)
        got = []
        for _ in range(2):
            counts.zero_()
            graphs.launch(toy)
            torch.cuda.synchronize()
            got.append((int(steps), counts.tolist()))
            check(torch.equal(live, d > want), f"loop_cond {name}: the final live mask equals the plain loop's")
        worst = max(worst, *(abs(n - want) for n, _ in got))
        log(f"loop_cond {name}: {death.shape[0]} lanes, cap {cap}: WHILE node steps {got}, plain loop {want} "
            f"(expected {while_toys.expected(death, cap)})")
        check(all(n == want and c == [1, want] for n, c in got), f"loop_cond {name}: the WHILE node's steps")
    rng = np.random.default_rng(11)
    d_out, d_in = rng.integers(0, 9, 4096), rng.integers(0, 14, 262_144)
    nodes, (c_out, c_in) = while_toys.nested(torch.as_tensor(d_out, device=dev), 6,
                                             torch.as_tensor(d_in, device=dev), 5, graphs.Recorder())
    graphs.launch(graphs.DispatchGraph(nodes, dev))
    want = while_toys.expected_nested(d_out, 6, d_in, 5)
    got = (*c_out.tolist(), *c_in.tolist())
    log(f"loop_cond nested: outer [entered, steps] and inner [entered, steps] {got}, expected {(1, *want)}")
    check(got == (1, *want), "loop_cond nested: the WHILE nodes' loops and steps")
    n = W * H
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    counts = torch.zeros((2,), dtype=torch.int64, device=dev)
    spin = graphs.DispatchGraph([graphs.Cond(ones, steps, COND_RUNS, 0, True, counts),
                                 graphs.While(0, [graphs.Cond(ones, steps, COND_RUNS, 0, False, counts)])], dev)
    ms = cuda_ms(lambda: graphs.launch(spin)) / (COND_RUNS + 1)
    check(int(steps) == COND_RUNS, "the timing graph ran its condition COND_RUNS + 1 times")
    row = table["loop_cond"]
    row.update(bound(n, n + 2 * 8 + 2 * 16), max_abs_err=float(worst), ms=ms,
               plain_ms=cuda_ms(lambda: loop.cond(ones, steps, COND_RUNS + 1)))
    log(f"loop_cond at {n} lanes: {ms * 1e3:.2f} us per run inside a WHILE body (one launch of {COND_RUNS + 1} "
        f"runs), plain {row['plain_ms'] * 1e3:.1f} us (a host read); bound {row['bound_ms'] * 1e3:.3f} us by "
        f"{row['bound_by']}, the kernel at {100 * row['bound_ms'] / ms:.2f}% of it; library call: none")
    log(f"phase 3b (the loop condition): {time.perf_counter() - t_phase:.1f} s")


def drive(r: Renderer, label: str):
    """One warm-up and TIMED_DISPATCHES timed dispatches of the Renderer,
    launch counts set to 0 just before and read just after: (launches,
    median s/dispatch, median segments/dispatch)."""
    r.reset_path_tracing()
    kernels.reset_launches()
    with counted_launches() as launched:
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
    loop = "captured" if launched else "eager"
    check(loop == "captured", f"the {label} loop ran {loop}: captured")
    check(len(launched) == TIMED_DISPATCHES + 1, f"the {label} path launched one dispatch graph per dispatch")
    img = r.hdr_image()
    s_per = statistics.median(dts)
    log(f"{label} render {r.meta.name} {W}x{H} depth {r.flags.max_depth}, {r.samples_per_frame} spp/dispatch, "
        f"loop {loop}: {s_per:.3f} s/dispatch (median of {dts}), "
        f"{statistics.median(segs) / s_per:.0f} segments/s, {statistics.median(segs):.0f} segments/dispatch, "
        f"host reads/dispatch {syncs} (the graph's tallies after its launch), media loop steps/dispatch {steps}, "
        f"launches over {TIMED_DISPATCHES + 1} dispatches {launches}, image mean {float(img.mean()):.4f}")
    check(img.shape == (H, W, 3) and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"{label} render is finite with mean > 0")
    return launches, s_per, statistics.median(segs)


def profile_dispatch(dispatch, label: str, wall_s: float = None) -> dict:
    """One torch.profiler trace of `dispatch()`'s device activity (CUDA
    only: tracing an eager dispatch's ~100K host ops costs tens of seconds)
    after an unprofiled one: device events (kernels, copies, fills), their
    summed time, the busy share against the unprofiled s/dispatch `wall_s`
    of this call (by default that of an unprofiled dispatch after the
    first, which may capture) and against the profiled device span, and the
    top kernels.  Returns the events, device ms and busy share."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(1 if wall_s is not None else 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0 if wall_s is None else wall_s
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dispatch()
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
                  if (m := re.search(r"((?:ray_keys|supertile_tables|trace|visit)_kernel<[^>]*>|vpt_loop_cond_kernel)",
                                     name)))
    log(f"profile {label} dispatch: {len(events)} device events, device time {busy_ms:.1f} ms: busy "
        f"{100 * busy_ms / (1e3 * wall_s):.1f}% of the unprofiled {wall_s:.3f} s/dispatch, "
        f"{100 * busy_ms / span_ms:.1f}% of the profiled device span {span_ms:.0f} ms (profiled wall {traced:.2f} s); "
        f"the csrc kernels {sum(ms for _, ms, _ in ours):.1f} ms: "
        + ", ".join(f"{name} {ms:.1f} ms x{n}" for name, ms, n in ours)
        + "; top: " + "; ".join(f"{name[:80]} {ms:.1f} ms x{n}" for name, (ms, n) in top))
    return {"device_events": len(events), "device_ms": busy_ms, "busy": busy_ms / (1e3 * wall_s), "wall_s": wall_s,
            "csrc_kernels": sum(n for _, _, n in ours)}


@contextlib.contextmanager
def counted_launches():
    """The dispatch graphs launched inside the block, one entry per launch."""
    launched, launch = [], graphs.launch

    def counted(graph):
        launched.append(graph)
        launch(graph)

    with mock.patch.object(graphs, "launch", counted):
        yield launched


def trace_launches(launches: dict) -> int:
    """Launches of the five trace kernels (not the loop condition, which
    every captured dispatch runs)."""
    return sum(n for k, n in launches.items() if k != "loop_cond")


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
    _, meta, _ = compile_scene(furnace_sphere(), device=dev)
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


DRYRUN_SIZE = 128  # 10b's frame, and a's one-rank render of it
DRYRUN_DEPTH = 8


def sharded_path(dev, r: Renderer, stream_s: float, table, media_r: Renderer) -> None:
    """Phase 10: render_sharded on a one-rank nccl group beside phase 4's
    Renderer `r` (s/dispatch `stream_s`), and one dispatch of phase 7's
    media Renderer `media_r` through it against render_samples; then the
    two-rank dry run on the card over gloo against a one-rank render of its
    frame."""
    t_phase = time.perf_counter()
    seed, n_spp = 2654435761, r.samples_per_frame
    args = (r.scene_data, r.meta, r.flags, r.params, (W, H))
    host, meta, flags, cameras = dryrun.scene_setup("colonnade", DRYRUN_DEPTH)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}", world_size=1, rank=0)
        try:
            m = dmesh.make_mesh(1, 1)
            kernels.reset_launches()
            dmesh.render_sharded(*args, seed, n_spp, m)
            dts = []
            for _ in range(TIMED_DISPATCHES):
                t0 = time.perf_counter()
                img, segs = dmesh.render_sharded(*args, seed, n_spp, m)
                segs = int(segs)  # waits for the dispatch
                dts.append(time.perf_counter() - t0)
            launches = dict(kernels.LAUNCHES)
            check_stream_launches(launches, "sharded")
            for name in STREAM_KERNELS:
                table[name]["sharded_launches"] = launches[name]
            pxy, pidx = dmesh.pixel_grid(W, H)
            want, want_segs, _ = integrator.render_samples(*args[:4], torch.as_tensor(pxy, device=dev),
                                                           torch.as_tensor(pidx, device=dev), (W, H), seed, n_spp)
            want = want.reshape(H, W, 3)
            # Phase 4's function and the sharded one in turns (step, sharded,
            # sharded, step): the host's state late in the script moves both.
            turns = {"render_step": [], "render_sharded": []}
            for which in ("render_step", "render_sharded", "render_sharded", "render_step"):
                t0 = time.perf_counter()
                if which == "render_step":
                    step_segs = int(render_step(*args[:4], seed, (W, H), torch.zeros((H, W, 3), device=dev), 0,
                                                n_spp)[1])
                else:
                    int(dmesh.render_sharded(*args, seed, n_spp, m)[1])
                turns[which].append(time.perf_counter() - t0)
            frame = torch.zeros((W * H, 3), device=dev)
            all_reduce_ms = cuda_ms(lambda: dist.all_reduce(frame), reps=5, launches=LAUNCHES_PER_PAIR)
            small_data = tree_to_device(host, dev)
            small, _ = dmesh.render_sharded(small_data, meta, flags, default_params(*cameras, device=dev),
                                            (DRYRUN_SIZE, DRYRUN_SIZE), 99, 4, m)
            small = small.cpu().numpy()
            # One media dispatch through the sharded path, its loop captured.
            media_args = (media_r.scene_data, media_r.meta, media_r.flags, media_r.params, (W, H))
            with counted_launches() as launched:
                t0 = time.perf_counter()
                m_img, m_segs = dmesh.render_sharded(*media_args, seed, n_spp, m)
                m_segs = int(m_segs)
                m_s = time.perf_counter() - t0
            m_want, m_want_segs, m_stats = integrator.render_samples(
                *media_args[:4], torch.as_tensor(pxy, device=dev), torch.as_tensor(pidx, device=dev), (W, H), seed,
                n_spp)
            m_equal = torch.equal(m_img, m_want.reshape(H, W, 3))
        finally:
            dist.destroy_process_group()
    log(f"sharded media dispatch, one nccl rank: {m_s:.3f} s, loop {'captured' if launched else 'eager'}, "
        f"{m_segs} segments against render_samples' {int(m_want_segs)} ({m_stats.steps} media loop steps), "
        f"image bitwise equal {m_equal}")
    check(len(launched) == 1, "the sharded media dispatch is one launch of its dispatch graph")
    check(m_equal and m_segs == int(m_want_segs), "the sharded media dispatch equals render_samples, bit for bit")
    img_np, want_np = img.cpu().numpy(), want.cpu().numpy()
    p = dryrun.psnr_peak(want_np, img_np)
    s_per = statistics.median(dts)
    turn_ratio = statistics.median(turns["render_sharded"]) / statistics.median(turns["render_step"])
    log(f"sharded path, one nccl rank on a (1, 1) mesh: colonnade {W}x{H} depth {r.flags.max_depth}, {n_spp} spp: "
        f"{s_per:.3f} s/dispatch (median of {dts}) beside phase 4's {stream_s:.3f} (this call): "
        f"{s_per / stream_s:.3f}x; in turns render_step {turns['render_step']} s, render_sharded "
        f"{turns['render_sharded']} s: {turn_ratio:.3f}x; "
        f"{segs} segments against render_step's {step_segs} at the same seed "
        f"({100 * (segs - step_segs) / step_segs:+.4f}%) and render_samples' {int(want_segs)}; image against "
        f"render_samples over the same row-major pixels: PSNR {p:.1f} dB, bitwise equal "
        f"{bool(np.array_equal(img_np, want_np))}; all_reduce of the {W}x{H} float32 frame "
        f"({4 * 3 * W * H} bytes, one rank) {all_reduce_ms:.4f} ms; launches over {TIMED_DISPATCHES + 1} "
        f"dispatches {launches}")
    check(bool(np.isfinite(img_np).all()) and img_np.shape == (H, W, 3), "the sharded image is finite, (512, 512, 3)")
    check(p > 60.0, "the sharded image within 60 dB PSNR of render_samples")
    check(abs(segs - step_segs) <= 5e-4 * step_segs, "the sharded segments within 0.05% of render_step's")

    t0 = time.perf_counter()
    out = dryrun.dryrun_multichip(2, device="cuda", scene="colonnade", size=DRYRUN_SIZE, max_depth=DRYRUN_DEPTH)
    psnrs = {shape: dryrun.psnr_peak(small, img) for shape, img in out["images"].items()}
    log(f"dryrun_multichip(2, cuda, gloo) on colonnade {DRYRUN_SIZE}x{DRYRUN_SIZE}: {time.perf_counter() - t0:.1f} s; "
        f"PSNR between the shapes {out['psnr']}, against the one-rank nccl render {psnrs}; segments {out['segments']}")
    check(all(v > 60.0 for v in psnrs.values()), "the dry run's shapes within 60 dB of the one-rank render")
    log(f"phase 10 (the sharded path): {time.perf_counter() - t_phase:.1f} s")


GRAPH_SEED = 2654435761  # phase 12's dispatches, all at one seed


def captured_or_eager(dispatch, captured: bool) -> dict:
    """One dispatch with the loop captured or eager: its image, segments,
    media loops and steps, host reads inside the loop and after a graph's
    launch, graph launches, kernel launches (set to 0 just before) and host
    seconds."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(graphs, "CAPTURE", captured), counted_launches() as launched:
        img, segs, stats = dispatch()
        segs = int(segs)  # waits for the dispatch
    return {"img": img, "segments": segs, "loops": stats.loops, "media_steps": stats.steps, "syncs": stats.syncs,
            "launch_reads": stats.launch_reads, "graph_launches": len(launched), "graphs": launched,
            "launches": dict(kernels.LAUNCHES), "s": time.perf_counter() - t0}


def launch_device_time(dispatch) -> tuple:
    """One captured dispatch with a CUDA event pair around its graph's
    launch: (its host seconds, the device ms of the launch)."""
    pairs, launch = [], graphs.launch

    def timed(graph):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        launch(graph)
        b.record()
        pairs.append((a, b))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(graphs, "launch", timed), mock.patch.object(graphs, "CAPTURE", True):
        int(dispatch()[1])
    wall = time.perf_counter() - t0
    check(len(pairs) == 1, "a captured dispatch is one graph launch")
    return wall, pairs[0][0].elapsed_time(pairs[0][1])


def stepper(r: Renderer, size: int = W, n_samples: int = None):
    """render_step of the Renderer's scene, flags and parameters at one seed
    (GRAPH_SEED), size x size, from a zero accumulation: (image, segments,
    LoopStats)."""
    zeros = torch.zeros((size, size, 3), device=r.device)

    def dispatch():
        return render_step(r.scene_data, r.meta, r.flags, r.params, GRAPH_SEED, (size, size), zeros, 0,
                           n_samples or r.samples_per_frame)
    return dispatch


def graph_turns(label: str, dispatch, small=None, profile: bool = True) -> dict:
    """One path captured against eager: a warm-up of each way (the captured
    one captures where its step has no graph yet), then eager, captured,
    captured, eager.  The four images must be bitwise equal, with equal
    segments, media loops and steps, and kernel launches (the loop
    condition's launched on the captured path only); each captured
    dispatch must be one launch of its dispatch graph with no host read
    inside its loop and one after it.  Prints both s/dispatch, segments/s,
    the device time of one captured dispatch's launch (one CUDA event pair)
    and its share of that dispatch's wall, the step's loop sites, capture
    seconds and graph pool bytes, and, with `profile`, a profile of an eager
    and a captured dispatch.  `small` = (dispatch, size label): profile that
    captured dispatch alone instead (a media dispatch is millions of device
    events)."""
    captured_or_eager(dispatch, False)
    warm = captured_or_eager(dispatch, True)
    check(warm["graph_launches"] == 1, f"{label}: the captured dispatch launches its dispatch graph")
    step = next(st for st in graphs.steps() if st.graph is warm["graphs"][-1])
    runs = [captured_or_eager(dispatch, way) for way in (False, True, True, False)]
    first = runs[0]
    for run_ in runs[1:]:
        check(torch.equal(run_["img"], first["img"]), f"{label}: captured and eager images bitwise equal")
        check(all(run_[k] == first[k] for k in ("segments", "loops", "media_steps")),
              f"{label}: captured and eager segments, media loops and media loop steps equal")
        check({k: v for k, v in run_["launches"].items() if k != "loop_cond"}
              == {k: v for k, v in first["launches"].items() if k != "loop_cond"},
              f"{label}: captured and eager kernel launches equal")
    for run_, captured in zip(runs, (False, True, True, False)):
        if captured:
            check(run_["graph_launches"] == 1 and run_["syncs"] == 0 and run_["launch_reads"] == 1
                  and run_["launches"]["loop_cond"] > 0,
                  f"{label}: a captured dispatch is one graph launch, no host read inside its loop, one after it")
        else:
            check(run_["graph_launches"] == 0 and run_["launch_reads"] == 0 and run_["launches"]["loop_cond"] == 0,
                  f"{label}: an eager dispatch launches no dispatch graph")
    check(bool(torch.isfinite(first["img"]).all()) and float(first["img"].mean()) > 0.0,
          f"{label}: the image is finite with mean > 0")
    eager = [r_["s"] for r_ in (runs[0], runs[3])]
    captured = [r_["s"] for r_ in (runs[1], runs[2])]
    e_s, c_s = statistics.median(eager), statistics.median(captured)
    timed_s, launch_ms = launch_device_time(dispatch)
    profiles = {}
    if profile and small is None:
        for way, wall in (("eager", e_s), ("captured", c_s)):
            with mock.patch.object(graphs, "CAPTURE", way == "captured"):
                profiles[way] = profile_dispatch(dispatch, f"{label} {way}", wall)
    elif profile:
        with mock.patch.object(graphs, "CAPTURE", True):
            profiles["captured_" + small[1]] = profile_dispatch(small[0], f"{label} captured at {small[1]}")
    seen = [p["csrc_kernels"] for way, p in profiles.items() if way.startswith("captured")]
    row = {"path": label, "eager_s": eager, "captured_s": captured, "segments": first["segments"],
           "eager_host_syncs": first["syncs"], "captured_host_syncs": runs[1]["syncs"],
           "captured_launch_reads": runs[1]["launch_reads"], "graph_launches_per_dispatch": runs[1]["graph_launches"],
           "media_loops": first["loops"], "media_steps": first["media_steps"], "launches": runs[1]["launches"],
           "eager_segments_per_s": first["segments"] / e_s, "captured_segments_per_s": first["segments"] / c_s,
           "launch_device_ms": launch_ms, "launch_busy": launch_ms / (1e3 * timed_s),
           "sites": len(step.sites), "capture_s": step.capture_seconds, "pool_bytes": step.pool_bytes,
           "kernel_launches_per_segment_run": [launches for _, launches in step.segments],
           "kernel_launches_per_site_step": [site.launches for site in step.sites], "profiles": profiles}
    log(f"graphs {label}: eager {eager} s, captured {captured} s per dispatch (eager, captured, captured, eager): "
        f"{e_s / c_s:.2f}x; {first['segments']} segments/dispatch, {first['segments'] / e_s:.0f} -> "
        f"{first['segments'] / c_s:.0f} segments/s; device time of the graph's launch {launch_ms:.1f} ms of a "
        f"{timed_s:.3f} s dispatch ({100 * launch_ms / (1e3 * timed_s):.1f}% busy); host reads inside the loop "
        f"{first['syncs']} eager, {runs[1]['syncs']} captured (+{runs[1]['launch_reads']} after the launch); "
        f"graph launches per captured dispatch {runs[1]['graph_launches']}; media loops {first['loops']}, steps "
        f"{first['media_steps']}; launches {runs[1]['launches']}; images bitwise equal; {len(step.sites)} loop "
        f"sites, {len(step.segments)} segment graphs; capture {step.capture_seconds:.3f} s, graph pool "
        f"{step.pool_bytes} bytes; CUPTI sees csrc kernels inside the WHILE bodies: {seen}")
    return row


def graph_phase(dev, stream_r: Renderer, smi: str, media_rows: list) -> None:
    """Phase 12: the captured loop against the eager one in the stream,
    packet, textured and sharded paths (colonnade 512x512, depth 8, 4 spp;
    an eager and a captured dispatch profiled in the stream path alone, the
    others' device time by the event pair of their launch); its JSON line
    also holds phases 7 and 8's rows (`media_rows`)."""
    t_phase = time.perf_counter()
    rows = media_rows + [graph_turns("stream", stepper(stream_r))]
    with mock.patch.object(integrator, "TRACE_MODE", "packet"):
        rows.append(graph_turns("packet", stepper(stream_r), profile=False))
    textured = Renderer(colonnade_textured(), width=W, height=H, flags=stream_r.flags, samples_per_frame=4,
                        device=dev)
    rows.append(graph_turns("textured", stepper(textured), profile=False))
    del textured
    r = stream_r
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}", world_size=1, rank=0)
        try:
            m = dmesh.make_mesh(1, 1)
            stats = []
            render_samples = integrator.render_samples

            def spy(*args, **kwargs):
                out = render_samples(*args, **kwargs)
                stats.append(out[2])
                return out

            def sharded():
                stats.clear()
                with mock.patch.object(integrator, "render_samples", spy):
                    img, segs = dmesh.render_sharded(r.scene_data, r.meta, r.flags, r.params, (W, H), GRAPH_SEED,
                                                     r.samples_per_frame, m)
                return img, segs, stats[0]

            rows.append(graph_turns("sharded", sharded, profile=False))
        finally:
            dist.destroy_process_group()
    print(json.dumps({"graphs": rows, "device": smi}), flush=True)
    log(f"phase 12 (captured against eager): {time.perf_counter() - t_phase:.1f} s")


DECODE_LIMIT_S = 0.5  # host seconds for the 1024^2 JPEG and the 2048^2 PNG


def fixture_bytes(name: str) -> bytes:
    with open(os.path.join(gltf_scenes.IMAGE_DIR, name), "rb") as f:
        return f.read()


def recorded_decode(name: str) -> np.ndarray:
    """PIL's decode of fixture `name`, as (H, W, 4) float32 / 255."""
    return read_png(os.path.join(gltf_scenes.IMAGE_DIR, name + ".ref.png")).astype(np.float32) / 255.0


def host_seconds(fn, reps: int = 5) -> tuple:
    """(median, all) host seconds of `reps` calls of fn."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def paeth_png(size: int) -> tuple:
    """A size x size RGBA image (smooth colour fields and noise, seed 0) and
    its PNG with the Paeth filter on every row."""
    gen = np.random.default_rng(0)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([np.sin(9 * x + 3 * y), np.cos(7 * x * y + 2), np.sin(20 * (x - y) ** 2), x - y], axis=-1)
    img = np.clip(img * 110 + 128 + gen.normal(0.0, 6.0, img.shape), 0, 255).astype(np.uint8)
    return img, gltf_scenes.encode_png(img, 8, filters=(4,))


def image_decoders(dev, smi: str, table) -> None:
    """Phase 11: the image decoders against PIL's recorded decodes, their
    host seconds, and a .glb with a progressive JPEG and a 16-bit PNG
    texture through the CLI against the in-memory render."""
    t_phase = time.perf_counter()
    # 11a. The fixtures.
    for name in gltf_scenes.IMAGE_FIXTURES:
        got, want = decode_rgba(fixture_bytes(name), name), recorded_decode(name)
        check(got.shape == want.shape and np.array_equal(got, want), f"{name} decodes to PIL's recorded decode")
    big = fixture_bytes(gltf_scenes.TIMING_JPEG)
    with open(os.path.join(gltf_scenes.IMAGE_DIR, gltf_scenes.TIMING_JPEG + ".sha256")) as f:
        digest = f.read().strip()
    got = np.round(decode_rgba(big) * 255.0).astype(np.uint8)
    check(got.shape == (1024, 1024, 4) and hashlib.sha256(got.tobytes()).hexdigest() == digest,
          f"{gltf_scenes.TIMING_JPEG} decodes to the sha256 of PIL's decode")
    check(codec._lib is not None, "the decoders ran the C codec")
    log(f"image fixtures: {len(gltf_scenes.IMAGE_FIXTURES)} files bitwise equal to PIL's recorded decodes "
        f"({', '.join(gltf_scenes.IMAGE_FIXTURES)}), {gltf_scenes.TIMING_JPEG} ({len(big)} bytes) to its sha256")

    # 11b. Host decode seconds.
    jpeg_s, jpeg_ts = host_seconds(lambda: decode_rgba(big))
    img, png = paeth_png(2048)
    check(np.array_equal(decode_rgba(png), img.astype(np.float32) / 255.0), "the 2048^2 Paeth PNG decodes exactly")
    png_s, png_ts = host_seconds(lambda: decode_rgba(png))
    log(f"decode_rgba host seconds (median of 5; {smi}, host {os.cpu_count()} CPUs): 1024x1024 4:2:0 JPEG "
        f"({len(big)} bytes) {jpeg_s:.4f} s {jpeg_ts}; 2048x2048 RGBA PNG, Paeth rows ({len(png)} bytes) "
        f"{png_s:.4f} s {png_ts}")
    check(jpeg_s < DECODE_LIMIT_S and png_s < DECODE_LIMIT_S,
          f"both decodes under {DECODE_LIMIT_S} s of host time")

    # 11c. A .glb with JPEG and 16-bit PNG textures through the CLI.
    jpg_name, png_name = "jpeg_progressive_420.jpg", "png16_rgb.png"
    scene = colonnade()
    slots = {}
    for name, material in ((jpg_name, "floor"), (png_name, "stone")):
        scene.textures.append(recorded_decode(name))
        slots[name] = len(scene.textures) - 1
        mat = next(m for m in scene.materials if m.name == material)
        mat.base_color_texture = slots[name]
    with tempfile.TemporaryDirectory() as tmp:
        glb = gltf_scenes.scene_to_gltf(scene, os.path.join(tmp, "decoded.glb"), images={
            slots[jpg_name]: (fixture_bytes(jpg_name), "image/jpeg"),
            slots[png_name]: (fixture_bytes(png_name), "image/png")})
        sky = os.path.join(tmp, "sky.npy")
        np.save(sky, scene.env_map)
        hdr = os.path.join(tmp, "decoded.npy")
        stats = run_cli("render", glb, "-o", os.path.join(tmp, "decoded.png"), "--hdr-output", hdr, "--env", sky,
                        "--width", str(W), "--height", str(H), "--spp", "8", "--spp-per-frame", "4")
        got = np.load(hdr)
        ref_scene = load_gltf(glb)
    ref_scene.env_map = scene.env_map
    for name, material in ((jpg_name, "floor"), (png_name, "stone")):
        mat = next(m for m in ref_scene.materials if m.name == material)
        ref_scene.textures[mat.base_color_texture] = recorded_decode(name)
    ref = Renderer(ref_scene, width=W, height=H, flags=RenderFlags(max_depth=8), samples_per_frame=4, max_samples=8,
                   device=dev)
    kernels.reset_launches()
    while not ref.path_trace():
        pass
    launches = dict(kernels.LAUNCHES)
    check_stream_launches(launches, "decoded-texture")
    for name in STREAM_KERNELS:
        table[name]["decoded_texture_launches"] = launches[name]
    want = ref.hdr_image()
    p = psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), 10.0)
    log(f"CLI render of the .glb with {jpg_name} (floor) and {png_name} (stone) decoded by the port vs the "
        f"in-memory render with PIL's recorded decodes, {W}x{H} depth 8, 8 spp at the same seeds: PSNR {p:.1f} dB, "
        f"bitwise equal {bool(np.array_equal(got, want))}, segments {stats['segments']} vs {ref.segments_traced}; "
        f"in-memory launches over its 2 dispatches {launches}")
    check(got.shape == (H, W, 3) and bool(np.isfinite(got).all()), "the CLI's HDR image is finite, (512, 512, 3)")
    check(stats["segments"] == ref.segments_traced, "the CLI render's segments equal the in-memory render's")
    check(p > 60.0, "the CLI render within 60 dB PSNR of the in-memory render")
    log(f"phase 11 (the image decoders): {time.perf_counter() - t_phase:.1f} s")


GALLERY_SPP = 16  # 13b: two dispatches of gallery.SAMPLES_PER_FRAME
# The samples per pixel of the committed TPU renders in Gallery/ (the
# gallery's defaults, colonnade's and the atmosphere's as their commits say),
# which --gallery-full renders.
TPU_SPP = {"cornell_glass_gold": 384, "colonnade": 64, "atmosphere_day": 320, "atmosphere_sunset": 320}
# 13b's bars: a job's 16-spp render must come within this PSNR (dB) of the
# committed TPU render: 3 dB below what the 16-spp render of that job read in
# a run of `--gallery-full` on an NVIDIA H100 80GB HBM3 at 700.00 W (25.98,
# 24.82, 28.47, 24.59, 27.30, 24.64, 22.29, 14.87, 12.74 dB in this order;
# phase 13 read the same).  The TPU renders come from the JAX package of
# 2026-08-16/17, before later changes to its estimator, and at 192-384 spp.
GALLERY_PSNR_BARS = {"cornell_box": 22.97, "cornell_glass_gold": 21.82, "sphere_garden": 25.46, "cornell_dof": 21.59,
                     "cornell_smoke": 24.30, "cornell_bloom": 21.64, "colonnade": 19.28, "atmosphere_day": 11.87,
                     "atmosphere_sunset": 9.73}
# A kernel render of a golden configuration against the port's CPU render:
# the share of pixels within rtol 1e-3 / atol 1e-4 (test_torch_golden.py's).
GOLDEN_CLOSE = {"cornell": 0.99, "glass": 0.94}
BRUTE_VS_CLUSTER = (48, 16)  # tests/test_golden.py's size and samples


def png_size(path: str) -> tuple:
    """(width, height) from a PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is a PNG")
    return struct.unpack(">II", head[16:24])


def goldens_on_card(dev) -> None:
    """13a: the four golden configurations rendered on the card, against
    the goldens at the JAX tests' bars and, for those of GOLDEN_CLOSE,
    against the port's CPU render of the same configuration; then brute
    force against the clusters at the JAX test's 48x48, 16 spp."""
    for name, golden in torch_goldens.GOLDENS.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        with counted_launches() as launched:
            img = torch_goldens.render(golden.renderer(dev))
        dt = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        s = torch_goldens.golden_ssim(golden, img)
        log(f"golden {golden.file} on the card: {dt:.2f} s (captured, {len(launched)} graph launches), SSIM "
            f"{s:.5f} (bar {golden.bar}); launches {launches}")
        check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0, f"the {name} golden render is finite")
        check(len(launched) > 0, f"the {name} golden render ran captured")
        check(trace_launches(launches) == 0, f"the brute-force {name} golden render launched no trace kernel")
        check(s > golden.bar, f"the {name} render on the card within SSIM {golden.bar} of {golden.file}")
        if name in GOLDEN_CLOSE:  # the port's CPU render of the configuration (the media goldens' is not held)
            t0 = time.perf_counter()
            cpu = torch_goldens.render(golden.renderer("cpu"))
            cpu_s = time.perf_counter() - t0
            p = psnr(np.clip(img, 0, 10), np.clip(cpu, 0, 10), 10.0)
            close = float(np.isclose(img, cpu, rtol=1e-3, atol=1e-4).all(axis=-1).mean())
            log(f"golden {golden.file} against the port's CPU render ({cpu_s:.1f} s on the card's host): PSNR "
                f"{p:.2f} dB, {100 * close:.2f}% of pixels within rtol 1e-3 / atol 1e-4, max abs diff "
                f"{float(np.abs(img - cpu).max()):.3g}")
            check(p > 40.0 and close >= GOLDEN_CLOSE[name],
                  f"the {name} render on the card within 40 dB and {GOLDEN_CLOSE[name]} close of the CPU render")
    size, spp = BRUTE_VS_CLUSTER
    imgs, counts = [], []
    for r in torch_goldens.brute_and_cluster(size, spp, dev):
        kernels.reset_launches()
        imgs.append(torch_goldens.render(r))
        counts.append(dict(kernels.LAUNCHES))
    p = psnr(np.clip(imgs[0], 0, 10), np.clip(imgs[1], 0, 10), 10.0)
    log(f"brute force against the clusters, sphere_garden(grid=3) {size}x{size} {spp} spp: PSNR {p:.2f} dB; "
        f"launches brute {counts[0]}, clusters {counts[1]}")
    check(all(bool(np.isfinite(i).all()) for i in imgs) and p > 40.0, "brute force within 40 dB of the clusters")
    check(trace_launches(counts[0]) == 0, "the brute-force render launched no trace kernel")
    check(counts[1]["stream"] > 0 and counts[1]["occlude"] > 0, "the cluster render launched stream and occlude")


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a (nested) NamedTuple."""
    if torch.is_tensor(tree):
        return nbytes(tree)
    return sum(tree_bytes(x) for x in tree) if isinstance(tree, tuple) else 0


def gallery_job(job, dev, size: int, spp: int, out: str, snapshot: int = None, made: list = None) -> dict:
    """Render `job` through the gallery at size x size, `spp` samples, into
    `out`, launch counts set to 0 just before: seconds, s/dispatch,
    segments/s, capture seconds, launches, and PSNR / SSIM of the saved PNG
    against the committed TPU render (and of the accumulation after
    `snapshot` samples, tonemapped as saved, when given).  Weak references
    to the steps the job made are appended to `made`."""
    tpu = load_png(os.path.join(ROOT, "Gallery", f"{job.name}.png"))
    before = graphs.steps()  # held, so that no step made here takes the address of one evicted here
    kernels.reset_launches()
    early = {}
    if snapshot:
        path_trace = Renderer.path_trace

        def spy(r):
            done = path_trace(r)
            if r.samples_accumulated == snapshot:
                early["ldr"] = load_png(r.save(os.path.join(out, f"{job.name}_{snapshot}spp.png")))
            return done
    t0 = time.perf_counter()
    with mock.patch.object(Renderer, "path_trace", spy) if snapshot else contextlib.nullcontext(), \
            counted_launches() as launched:
        r = gallery.render(job, size, spp, dev, out)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    steps = [st for st in graphs.steps() if all(st is not b for b in before)]
    del before
    if made is not None:
        made.extend(weakref.ref(st) for st in steps)
    img = load_png(os.path.join(out, f"{job.name}.png"))
    hdr = r.hdr_image()
    row = {"name": job.name, "size": size, "spp": r.samples_accumulated, "seconds": seconds,
           "s_per_dispatch": r.render_seconds / r.frame_count, "segments_per_s": r.segments_traced / r.render_seconds,
           "capture_s": sum(st.capture_seconds or 0.0 for st in steps), "graph_launches": len(launched),
           "scene_bytes": tree_bytes(r.scene_data), "pool_bytes": sum(st.pool_bytes or 0 for st in steps),
           "launches": launches,
           "psnr": psnr(img, tpu, 1.0), "ssim": ssim(img, tpu, 1.0), "finite": bool(np.isfinite(hdr).all()),
           "uniform": bool(hdr.max() == hdr.min())}
    if "ldr" in early:
        row.update(snapshot_spp=snapshot, snapshot_psnr=psnr(early["ldr"], tpu, 1.0),
                   snapshot_ssim=ssim(early["ldr"], tpu, 1.0))
    log(f"gallery {job.name} {size}x{size} {row['spp']} spp: {seconds:.1f} s, {row['s_per_dispatch']:.3f} s/dispatch, "
        f"{row['segments_per_s']:.0f} segments/s, capture {row['capture_s']:.2f} s, {len(launched)} graph launches, "
        f"scene {row['scene_bytes']} bytes and graph pool {row['pool_bytes']} bytes on the card; against "
        f"Gallery/{job.name}.png: PSNR {row['psnr']:.2f} dB, SSIM {row['ssim']:.4f}"
        + (f"; at {snapshot} spp PSNR {row['snapshot_psnr']:.2f} dB, SSIM {row['snapshot_ssim']:.4f}"
           if "ldr" in early else "") + f"; launches {launches}")
    return row


def gallery_phase(dev, smi: str) -> None:
    """Phase 13: the goldens and the gallery on the card."""
    t_phase = time.perf_counter()
    goldens_on_card(dev)
    rows, made = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for job in gallery.jobs():
            size, height = png_size(os.path.join(ROOT, "Gallery", f"{job.name}.png"))
            check(size == height, f"Gallery/{job.name}.png is square")
            row = gallery_job(job, dev, size, GALLERY_SPP, tmp, made=made)
            rows.append(row)
            check(row["graph_launches"] > 0, f"the {job.name} render ran captured")
            check(row["finite"] and not row["uniform"], f"the {job.name} render is finite and not uniform")
            if job.name in ("colonnade", "sphere_garden"):
                check_stream_launches(row["launches"], job.name)
            else:
                check(trace_launches(row["launches"]) == 0,
                      f"the brute-force {job.name} render launched no trace kernel")
            check(row["psnr"] >= GALLERY_PSNR_BARS[job.name],
                  f"{job.name} within {GALLERY_PSNR_BARS[job.name]} dB PSNR of the TPU render")
        gc.collect()
        torch.cuda.empty_cache()
        pools = [st.pool_bytes or 0 for st in graphs.steps()]
        left = [ref() for ref in made if ref() is not None]
        log(f"step cache after the gallery's {len(rows)} Renderers were dropped: {len(pools)} steps (cap "
            f"{graphs.STEPS_CAP}), graph pools {sum(pools)} bytes {pools}; of the {len(made)} steps the gallery's "
            f"jobs made, {len(left)} alive, {sum(st in graphs.steps() for st in left)} cached, their pools "
            f"{sum(st.pool_bytes or 0 for st in left)} bytes; torch.cuda.memory_reserved "
            f"{torch.cuda.memory_reserved()} bytes (after empty_cache)")
        check(not left, "no step of the gallery's dropped Renderers outlives them")
        # The command line, once, small.
        out = os.path.join(tmp, "cli")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vpt_tpu_torch.gallery", out], cwd=ROOT, capture_output=True,
                              text=True, timeout=600, env={**os.environ, "GALLERY_SIZE": "64", "GALLERY_SPP": "8"})
        pngs = sorted(f for f in os.listdir(out) if f.endswith(".png")) if os.path.isdir(out) else []
        log(f"python -m vpt_tpu_torch.gallery at 64x64, 8 spp: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s, {len(pngs)} PNGs; output:\n{proc.stdout}{proc.stderr[-2000:]}")
        check(proc.returncode == 0, "python -m vpt_tpu_torch.gallery exits 0")
        check(pngs == sorted(f"{job.name}.png" for job in gallery.jobs()), "the gallery wrote one PNG per job")
        check("viking_room skipped:" in proc.stdout, "the gallery skipped viking_room")
    print(json.dumps({"gallery": rows, "device": smi}), flush=True)
    log(f"phase 13 (the goldens and the gallery): {time.perf_counter() - t_phase:.1f} s")


def gallery_full(dev, smi: str) -> None:
    """--gallery-full: every gallery job at its committed TPU render's size
    and samples, against that render, with the 16-spp numbers that
    GALLERY_PSNR_BARS come from; one JSON line "gallery_full"."""
    t0 = time.perf_counter()
    lookup.get_lookup_tables(device=dev)  # what the first Renderer would bake, outside the jobs' seconds
    log(f"lookup tables: {time.perf_counter() - t0:.1f} s")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for job in gallery.jobs():
            size, _ = png_size(os.path.join(ROOT, "Gallery", f"{job.name}.png"))
            rows.append(gallery_job(job, dev, size, TPU_SPP.get(job.name, gallery.SPP), tmp, snapshot=GALLERY_SPP))
    print(json.dumps({"gallery_full": rows, "device": smi}), flush=True)


# Phase 14: the layout knobs and the dispatch tools.
LAYOUT_KS = (64, 256)  # cluster sizes beside the default 128
# Group sizes beside the default 8, at K = 128: 48 and 64 above the 32 members
# one warp tests at a time (a partial second chunk, two full ones).
LAYOUT_GROUPS = (4, 16, 48, 64)
# (VPT_PACKET_SIZE, VPT_SORT_KEY, VPT_SORT_RAYS) of the packet path beside (512,
# fs, sorted); 64, 384 and 2048 rays run supertile_tables' run-time tile.
PACKET_LAYOUTS = ((256, "fs", True), (1024, "fs", True), (512, "fe", True), (512, "fs", False), (64, "fs", True),
                  (384, "fs", True), (2048, "fs", True))
# Packets whose visit phase 14 holds against the plain version (the plain
# visit takes ~80 ms a packet): 32 until the script took 1,054.7 s with
# phase 14 at 244.0 s on a slow host (PERF.md, "Findings"), 8 since.
VISIT_SLICE = 8
# A layout may change which of two triangles at equal t a ray takes; the
# path of such a sample continues elsewhere, an independent sample in that
# pixel.  So a layout's image is held to phase 4's K = 128 one at the same
# seed by a PSNR bar (dB, clipped to [0, 10] as kernel_vs_plain_render), not
# bitwise; on an H100 80GB HBM3 they read equal (stream) and 137 dB (packet
# mode).
LAYOUT_PSNR = 50.0
# The host-driven profile of a dispatch against its WHILE launch.  Its device
# events must number the kernel, memcpy and memset nodes its graphs' replays
# ran within PROFILE_EVENTS: the host's condition reads add a few events per
# loop condition (+0.2% stream, +1.7% media on an H100 80GB HBM3), and CUPTI
# can drop a few records; a profile of the media path's WHILE launch itself
# saw 5,439 of ~356K.  Its summed device time may exceed the launch's by at
# most PROFILE_TOLERANCE (the same kernels, less the loop condition's, timed
# by CUPTI).  It may fall short of it by more: the launch also holds the idle
# time between its nodes, and on that card the same step's launch read
# 341-419 ms within and between processes at a constant 342-346 ms of
# kernels, the parent commit's too (PERF.md §7); the ratio is printed.
PROFILE_EVENTS = 0.02
PROFILE_TOLERANCE = 0.05
# 14d's tools.sweep_bench configuration: K 128 alone (14a drives K 64 and
# K 256 already).
SWEEP = "k128"
# 14a-b's dispatches and 14d's quick_bench and sweep_bench run at
# LAYOUT_SIZE^2 (phase 4's 512^2 when phase 14 took 302 s of the run's
# 1,094 s; 256^2 when it took 336.8 s of 1,098.1 s):
# every layout and packet layout still renders, each image held to the
# K = 128 image at this size; each layout's kernel checks stay at phase 3's
# shapes.
LAYOUT_SIZE = 128


def slice_packets(pk: cluster.Packets, n: int) -> cluster.Packets:
    """n packets of `pk` spread evenly over them, the first and the last
    included (a visit needs nothing else of the others)."""
    idx = torch.linspace(0, pk.nvis.shape[0] - 1, n, device=pk.nvis.device).round().long()
    return pk._replace(**{f: getattr(pk, f).index_select(0, idx).contiguous()
                          for f in ("nvis", "order", "entry_sorted", "origin", "direction", "active", "tmax")})


def visit_call(pk: cluster.Packets, cl, t_min) -> tuple:
    """visit_trace's arguments for the packets `pk`."""
    return (pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.active, pk.tmax, cl, t_min)


def visit_bound(pk: cluster.Packets, cl, work, instanced: bool) -> dict:
    """The visit's bound: the closest-hit work of the same rays (phase 3's
    way), its packets' tables and rays read, the hits written."""
    return bound(trace_flops(work, instanced),
                 nbytes(pk.nvis, pk.order, pk.entry_sorted, pk.origin, pk.direction, pk.tmax, *cluster_tables(cl))
                 + 4 * pk.active.numel() + 16 * pk.active.numel())


def timed_row(fn, args, b: dict) -> dict:
    """A kernel's CUDA-event median over 20-launch pairs beside its bound."""
    ms = cuda_ms(lambda: fn(*args), launches=LAUNCHES_PER_PAIR)
    return {"ms": ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "bound_share": b["bound_ms"] / ms}


def layout_kernels(data, meta, aux, dev, label: str, table) -> dict:
    """Phase 14a's kernel checks of one cluster layout at phase 3's bounce
    and shadow shapes, and the five kernels' times beside their bounds."""
    cl = data.clusters
    t_min, _, bounce, shadow = main_path_inputs(data, meta, aux, dev)
    b_bounce = stream.trace_bands(*bounce[:2], cl, t_min, T_MAX, bounce[2], torch.zeros_like(bounce[2]))
    b_shadow = occlude.shadow_bands(shadow["origin"], shadow["direction"], cl, t_min, shadow["tmax"],
                                    shadow["active"], shadow["extri"])
    cases = {
        "bounce": envelope_case(cl, stream.pad_wavefront(*bounce[:2], cl, t_min, T_MAX, bounce[2]), b_bounce, t_min, 2),
        "shadow": envelope_case(cl, stream.pad_wavefront(shadow["origin"], shadow["direction"], cl, t_min,
                                                         shadow["tmax"], shadow["active"]), b_shadow, t_min, 1),
    }
    for shape, case in cases.items():
        compare_envelope(case, f"{label} {shape}", table)
    err, t_bounce = compare_stream(b_bounce, cl, t_min, f"{label} bounce")
    table["stream"]["max_abs_err"] = max(table["stream"]["max_abs_err"], err)
    ok, op = occlude.occlude_trace(b_shadow, cl, t_min), occlude.occlude_trace_plain(b_shadow, cl, t_min)
    torch.cuda.synchronize()
    check(torch.equal(ok, op), f"occlude ({label}) equals its plain version")
    pk = cluster.prepare_packets(*bounce[:2], cl, t_min, T_MAX, bounce[2], sort_rays=True)
    compare_packet_cull(pk, cl, t_min, f"{label} bounce", table)
    err_v, _, _ = compare_visit(slice_packets(pk, VISIT_SLICE), cl, t_min, f"{label} bounce, {VISIT_SLICE} packets")
    table["visit"]["max_abs_err"] = max(table["visit"]["max_abs_err"], err_v)
    instanced = cl.inv_rows.shape[0] > 1
    w_bounce = stream.trace_work(b_bounce, cl, t_min, (b_bounce.payload[0] & 1) > 0, t_bounce)
    near = torch.minimum(occlude.nearest_blocker_plain(b_shadow, cl, t_min), b_shadow.tmax)
    w_shadow = stream.trace_work(b_shadow, cl, t_min, b_shadow.payload[0] > 0, near)
    keys_b, tables_b = envelope_bounds(cases["bounce"], label)
    gp = cases["bounce"].keys[3].shape[1]
    row = {"layout": label, "K": cl.tris.shape[2], "G": cl.count.shape[0] // cl.group_min.shape[0],
           "P": cluster.PACKET_SIZE, "key": cluster._SORT_KEY, "sorted": True, "clusters": cl.count.shape[0],
           "groups": cl.group_min.shape[0], "Gp": gp, "kernels": {
               "ray_keys": timed_row(envelope.ray_keys, cases["bounce"].keys, keys_b),
               "supertile_tables": timed_row(envelope.supertile_tables, cases["bounce"].tables, tables_b),
               "stream": timed_row(stream.stream_trace, (b_bounce, cl, t_min),
                                   bound(trace_flops(w_bounce, instanced),
                                         nbytes(*band_inputs(b_bounce), *cluster_tables(cl)) + 16 * b_bounce.origin.shape[0])),
               "occlude": timed_row(occlude.occlude_trace, (b_shadow, cl, t_min),
                                    bound(trace_flops(w_shadow, instanced),
                                          nbytes(*band_inputs(b_shadow), *cluster_tables(cl)) + 4 * b_shadow.origin.shape[0])),
               "visit": timed_row(visit.visit_trace, visit_call(pk, cl, t_min),
                                  visit_bound(pk, cl, w_bounce, instanced)),
           }}
    log(f"layout {label}: K {row['K']}, groups of {row['G']}: {row['clusters']} clusters, {row['groups']} groups, Gp "
        f"{gp}; kernels equal their plain versions (stream by the tie rule, visit on {VISIT_SLICE} packets); "
        + "; ".join(f"{k} {v['ms']:.4f} ms, bound {v['bound_ms'] * 1e3:.2f} us by {v['bound_by']} "
                    f"({100 * v['bound_share']:.2f}%)" for k, v in row["kernels"].items()))
    return row


def layout_dispatch(data, meta, flags, params, base, label: str, mode: str = "stream", default=None) -> dict:
    """One captured dispatch of a layout at GRAPH_SEED (after the one that
    captures): s/dispatch, segments, launches and the image's PSNR against
    `base` (phase 4's configuration at K = 128, the same seed), and whether
    image and segments equal those of `default`, the default layout's
    dispatch in the same mode (`base` where None)."""
    zeros = torch.zeros((LAYOUT_SIZE, LAYOUT_SIZE, 3), device=params.view_inverse.device)

    def dispatch():
        return render_step(data, meta, flags, params, GRAPH_SEED, (LAYOUT_SIZE, LAYOUT_SIZE), zeros, 0, 4)

    captured_or_eager(dispatch, True)
    run_ = captured_or_eager(dispatch, True)
    check(run_["graph_launches"] == 1 and run_["syncs"] == 0, f"{label}: a captured dispatch, one graph launch")
    launches = run_["launches"]
    if mode == "packet":
        check(launches["visit"] > 0 and launches["stream"] == 0 and launches["occlude"] == 0,
              f"{label}: the packet path launched visit, neither stream nor occlude")
    else:
        check_stream_launches(launches, label)
    img = run_["img"].cpu().numpy()
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 0.0, f"{label}: the image is finite with mean > 0")
    p = psnr(np.clip(img, 0, 10), np.clip(base["img"].cpu().numpy(), 0, 10), 10.0)
    check(p > LAYOUT_PSNR, f"{label}: the image within {LAYOUT_PSNR} dB of the K = 128 stream image")
    default = base if default is None else default
    out = {"s_per_dispatch": run_["s"], "segments": run_["segments"], "segments_per_s": run_["segments"] / run_["s"],
           "psnr_vs_k128": p, "segments_vs_k128": run_["segments"] / base["segments"] - 1.0,
           "image_equals_default": bool(torch.equal(run_["img"], default["img"])),
           "segments_equal_default": run_["segments"] == default["segments"],
           "launches": {k: v for k, v in launches.items() if v}}
    log(f"layout {label} dispatch ({mode}, {LAYOUT_SIZE}x{LAYOUT_SIZE}, 4 spp, seed {GRAPH_SEED}): {run_['s']:.3f} s, "
        f"{run_['segments']} segments ({100 * out['segments_vs_k128']:+.4f}% against K = 128), "
        f"{out['segments_per_s'] / 1e6:.3f} M segs/s, PSNR {p:.1f} dB against the K = 128 image; image "
        f"{'equal to' if out['image_equals_default'] else 'NOT equal to'} and segments "
        f"{'equal to' if out['segments_equal_default'] else 'NOT equal to'} the default layout's ({mode}); "
        f"launches {out['launches']}")
    return out


def packet_layout(stream_r: Renderer, p3: dict, size: int, key: str, sort: bool, base, table, default) -> dict:
    """Phase 14b at one packet layout: the cull, the keys and the visit
    against their plain versions, their times and bounds, one dispatch."""
    data, t_min, bounce, shadow = p3["data"], p3["t_min"], p3["bounce"], p3["shadow"]
    cl = data.clusters
    label = f"P{size} {key}{'' if sort else ' unsorted'}"
    instanced = cl.inv_rows.shape[0] > 1
    with mock.patch.object(cluster, "PACKET_SIZE", size), mock.patch.object(cluster, "_SORT_KEY", key), \
            mock.patch.object(integrator, "_SORT_RAYS", sort):
        packets = {"bounce": cluster.prepare_packets(*bounce[:2], cl, t_min, T_MAX, bounce[2], sort_rays=sort),
                   "shadow": cluster.prepare_packets(shadow["origin"], shadow["direction"], cl, t_min, shadow["tmax"],
                                                     shadow["active"], sort_rays=sort)}
        for shape, pk in packets.items():
            check(pk.active.shape[1] == size and (pk.perm is None) == (not sort), f"{label} {shape}: the packets")
            compare_packet_cull(pk, cl, t_min, f"{label} {shape}", table)
            err, _, _ = compare_visit(slice_packets(pk, VISIT_SLICE), cl, t_min,
                                      f"{label} {shape}, {VISIT_SLICE} packets")
            table["visit"]["max_abs_err"] = max(table["visit"]["max_abs_err"], err)
        if key == "fe":
            w = stream.pad_wavefront(*bounce[:2], cl, t_min, T_MAX, bounce[2])
            gmin, gmax = cluster.pad_groups(cl)
            keys = (w.origin, w.inv, w.tmax, gmin, gmax, t_min, 1)
            diag = cluster.root_diagonal(cl)
            got, want = envelope.ray_keys(*keys, diag=diag), envelope.ray_keys_plain(*keys, diag=diag)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"ray_keys' fe key ({label}) equals its plain version")
            log(f"ray_keys fe ({label}): {got.shape[0]} keys equal their plain version")
        pk = packets["bounce"]
        cull = packet_cull_args(pk, cl, t_min)
        row = {"layout": label, "K": cl.tris.shape[2], "G": cl.count.shape[0] // cl.group_min.shape[0], "P": size,
               "key": key, "sorted": sort, "clusters": cl.count.shape[0], "groups": cl.group_min.shape[0],
               "Gp": cull[3].shape[1], "nvis_mean": float(pk.nvis.float().mean()), "kernels": {
                   "visit": timed_row(visit.visit_trace, visit_call(pk, cl, t_min),
                                      visit_bound(pk, cl, p3["w_bounce"], instanced)),
                   "visit_shadow": timed_row(visit.visit_trace, visit_call(packets["shadow"], cl, t_min),
                                             visit_bound(packets["shadow"], cl, p3["w_shadow"], instanced)),
                   "supertile_tables": timed_row(envelope.supertile_tables, cull,
                                                 tables_bound(cull, envelope.envelope_work(*cull[:6]), size)),
               }}
        log(f"packet layout {label}: {pk.nvis.shape[0]} bounce packets, candidate groups per packet mean "
            f"{row['nvis_mean']:.1f}; " + "; ".join(
                f"{k} {v['ms']:.4f} ms, bound {v['bound_ms'] * 1e3:.2f} us ({100 * v['bound_share']:.2f}%)"
                for k, v in row["kernels"].items()))
        with mock.patch.object(integrator, "TRACE_MODE", "packet"):
            row.update(layout_dispatch(stream_r.scene_data, stream_r.meta, stream_r.flags, stream_r.params, base, label,
                                       mode="packet", default=default))
    return row


def sm_clock() -> str:
    """The card's SM clock now, as nvidia-smi reads it."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def run_tool(*args: str, timeout: float = 600) -> list:
    """`python -m vpt_tpu_torch.tools.<args>` from the checkout's root with no
    VPT_* variable set: its output lines (raises on a non-zero exit)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("VPT_")}
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout.splitlines()


def layouts_phase(dev, smi: str, table, p3: dict, stream_r: Renderer, media_r: Renderer) -> None:
    """Phase 14: the layout knobs (a, b) and the dispatch tools (c, d)."""
    t_phase = time.perf_counter()
    base = captured_or_eager(stepper(stream_r, LAYOUT_SIZE), True)  # phase 4's configuration, K = 128, GRAPH_SEED
    tables = lookup.get_lookup_tables(device=dev)  # the cached bake: phase 4's fits
    rows = []
    # 14a. Cluster layouts.
    for knob, values in (("CLUSTER_SIZE", LAYOUT_KS), ("GROUP_SIZE", LAYOUT_GROUPS)):
        for value in values:
            label = f"K{value}" if knob == "CLUSTER_SIZE" else f"G{value}"
            t0 = time.perf_counter()
            with mock.patch.object(cluster, knob, value):
                data, meta, aux = compile_scene(colonnade(), tables, device=dev)
            torch.cuda.synchronize()
            log(f"compile_scene(colonnade) at {label}: {time.perf_counter() - t0:.1f} s")
            row = layout_kernels(data, meta, aux, dev, label, table)
            row.update(layout_dispatch(data, meta, stream_r.flags, stream_r.params, base, label))
            rows.append(row)
            del data, meta, aux
    log(f"phase 14a (cluster layouts): {time.perf_counter() - t_phase:.1f} s")
    # 14b. Packet layouts.
    t0 = time.perf_counter()
    with mock.patch.object(integrator, "TRACE_MODE", "packet"):
        captured_or_eager(stepper(stream_r, LAYOUT_SIZE), True)
        packet_base = captured_or_eager(stepper(stream_r, LAYOUT_SIZE), True)  # 512-ray packets, fs, sorted
    for size, key, sort in PACKET_LAYOUTS:
        rows.append(packet_layout(stream_r, p3, size, key, sort, base, table, packet_base))
    log(f"phase 14b (packet layouts): {time.perf_counter() - t0:.1f} s")
    # 14c. The profile tool against the WHILE launch.
    t0 = time.perf_counter()
    profiles = {}
    for name, r, size, spp in (("stream", stream_r, W, 4), ("media", media_r, PROFILE_SIZE, 1)):
        lines = []
        clocks = [sm_clock()]
        res = profile_tool.profile_step(r.scene_data, r.meta, r.flags, r.params, size, spp, out=lines.append)
        clocks.append(sm_clock())
        log(f"profile_dispatch {name}: SM clock before / after (nvidia-smi clocks.sm) {clocks}")
        check(lines[0] == profile_tool.HOST_DRIVEN, f"profile_dispatch ({name}) names its mode first")
        for line in lines[:3] + [x for x in lines if x.startswith(("profile device ms", "csrc", "device events"))]:
            log(f"profile_dispatch {name} {size}x{size} {spp} spp: {line}")
        top = next(iter(res["top"].values()))
        log(f"profile_dispatch {name} top ops: " + "; ".join(f"{n[:70]} {ms:.2f} ms x{c}" for n, ms, c in top[:12]))
        check(abs(res["events"] / res["replayed_nodes"] - 1.0) <= PROFILE_EVENTS,
              f"profile_dispatch ({name}): the profile's device events within {PROFILE_EVENTS:.0%} of the kernel, "
              "memcpy and memset nodes the graphs' replays ran")
        check(res["ratio"] <= 1.0 + PROFILE_TOLERANCE,
              f"profile_dispatch ({name}): the profile's device ms at most {PROFILE_TOLERANCE:.0%} above the WHILE "
              "launch's")
        profiles[name] = {k: res[k] for k in ("segments", "wall_s", "device_ms", "launch_ms", "launch_before_ms", "ratio",
                                              "events", "replayed_nodes", "csrc")}
        profiles[name]["within_5_percent"] = abs(res["ratio"] - 1.0) <= PROFILE_TOLERANCE
        profiles[name]["sm_clock"] = clocks
        profiles[name]["top"] = top[:15]
    log(f"phase 14c (profile_dispatch): {time.perf_counter() - t0:.1f} s")
    # 14d. quick_bench and sweep_bench as subprocesses.
    t0 = time.perf_counter()
    quick = run_tool("vpt_tpu_torch.tools.quick_bench", str(LAYOUT_SIZE))
    sweep = run_tool("vpt_tpu_torch.tools.sweep_bench", str(LAYOUT_SIZE), "4", "--configs", SWEEP, timeout=900)
    results = [x for x in quick if x.startswith("RESULT")] + [x for x in sweep if "RESULT" in x and "===" not in x
                                                                and not x.startswith("    ")]
    for line in quick[-3:] + sweep[sweep.index("=== sweep summary ==="):]:
        log(f"tools: {line}")
    check(quick[-1] == smi and sweep[-1] == smi, "quick_bench and sweep_bench end with the card's name and power limit")
    check(len(results) == 1 + len(SWEEP.split(",")), "one RESULT line per configuration")
    log(f"phase 14d (quick_bench, sweep_bench): {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"layouts": rows, "k128": {"s_per_dispatch": base["s"], "segments": base["segments"]},
                      "profiles": profiles, "tools": results, "device": smi}), flush=True)
    log(f"phase 14 (the layouts and the tools): {time.perf_counter() - t_phase:.1f} s")


# Phase 15: the probe kernels of csrc/probe.cu (tools/hopper_probe.py).
PROBE_SOURCE = "vpt_tpu_torch/csrc/probe.cu"


def graph_ms(fn, calls: int = LAUNCHES_PER_PAIR) -> float:
    """Milliseconds per call of fn inside a CUDA graph: `calls` calls
    captured into one graph (relaxed capture: a probe's
    cudaFuncSetAttribute may run while capturing), the median of 5 event
    pairs around its replay, over `calls`.  For a call shorter than the
    host's ~20 us to issue it (a probe kernel's single block), where an
    event pair around back-to-back calls times the host."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay) / calls


def probe_phase(dev, smi: str, table) -> None:
    """Phase 15: `python -m vpt_tpu_torch.tools.hopper_probe`'s run in this
    process with the counts set to 0 just before (its lines, every probe
    PASS, each probe kernel launched), the shared-memory boundary, then
    each kernel against its plain version at its probe's shapes and timed
    beside its bound, its plain version and its library call."""
    t_phase = time.perf_counter()
    lines = []
    prober = hopper_probe.Prober(dev, out=lines.append)
    kernels.reset_launches()
    ok = prober.run()
    launches = {k: kernels.LAUNCHES[k] for k in kernels.PROBES}
    for line in lines:
        log(f"hopper_probe: {line}")
    check(ok, "hopper_probe: every probe's result is right")
    check(lines[-1] == smi, "hopper_probe ends with the card's name and power limit")
    check(all(n > 0 for n in launches.values()), f"hopper_probe launched every probe kernel: {launches}")
    # The boundary: a block takes SMEM_LIMIT bytes of dynamic shared memory and no more.
    limit = hopper_probe.SMEM_LIMIT
    x8 = torch.ones((1, 1), dtype=torch.int32, device=dev)
    xs = torch.arange(limit // 4 + 4, dtype=torch.float32, device=dev).reshape(1, -1)
    boundary = {}
    for name, fn, at, above, want in (
            ("probe8", hopper_probe.probe8, (x8, limit // 4), (x8, limit // 4 + 4), 3.0),
            ("smem_probe", hopper_probe.smem_probe, (xs[:, : limit // 4].contiguous(),), (xs,), float(limit // 4 - 1))):
        try:
            value = float(fn(*at)[0, 0])
        except hopper_probe.Refused as e:
            raise RuntimeError(f"check failed: {name} refused at {limit} bytes ({e.name})") from e
        check(value == want, f"{name} at {limit} bytes of shared memory gives {want}")
        try:
            fn(*above)
            refused = None
        except hopper_probe.Refused as e:
            refused = e.name
        check(refused is not None, f"{name} above {limit} bytes of shared memory is refused")
        boundary[name] = {"runs_at_bytes": limit, "refused_at_bytes": limit + 16, "error": refused}
        log(f"{name}: runs at {limit} bytes of dynamic shared memory (value {value}), refused at {limit + 16} "
            f"({refused})")
    torch.cuda.synchronize()
    # Each kernel against its plain version, and its times.
    for name, case in hopper_probe.cases(dev).items():
        got, want = case.fn(*case.args), case.plain(*case.args)
        torch.cuda.synchronize()
        check(hopper_probe.same_result(name, got, want), f"{name} equals its plain version")
        outs = got if isinstance(got, tuple) else (got,)
        moved = nbytes(*(a for a in case.args if torch.is_tensor(a)), *outs)
        row = table.setdefault(name, {"name": name, "route": "cuda", "source": PROBE_SOURCE,
                                      "replaces": case.replaces})
        row.update(bound(case.ops, moved), launches=launches[name],
                   max_abs_err=0.0 if name == "probe2" else max_abs_err(got.double(), want.double()),
                   ms=graph_ms(lambda: case.fn(*case.args)),
                   event_ms=cuda_ms(lambda: case.fn(*case.args), launches=LAUNCHES_PER_PAIR),
                   plain_ms=cuda_ms(lambda: case.plain(*case.args)),
                   library_ms=None if case.library is None else graph_ms(case.library))
        log(f"{name}: kernel {row['ms'] * 1e3:.2f} us per launch in a graph of {LAUNCHES_PER_PAIR}, "
            f"{row['event_ms'] * 1e3:.2f} us per launch back to back (event pairs: the host's issue rate), plain "
            f"{row['plain_ms']:.3f} ms, library "
            + ("none" if row["library_ms"] is None else f"{row['library_ms'] * 1e3:.2f} us per call in a graph")
            + f"; bound {row['bound_ms'] * 1e6:.2f} ns by {row['bound_by']} ({moved} bytes, {case.ops:.0f} "
            f"operations), the kernel at {100 * row['bound_ms'] / row['ms']:.4f}% of it; launches {launches[name]}")
    print(json.dumps({"probes": {"lines": lines, "launches": launches, "boundary": boundary, "refused": prober.refused,
                                 "device": smi}}), flush=True)
    log(f"phase 15 (the probe kernels): {time.perf_counter() - t_phase:.1f} s")


GAP_RAYS = 262_144  # phase 16b's rays through the two BVH builders' trees
GAP_SOUP = 20_000  # 16b's triangles at most: a larger mesh gives way to a seeded soup of this size
GAP_PACKETS = (64, 384, 2048)  # 16d's packet sizes


def host_libraries(tmp: str) -> dict:
    """16a: the BVH builder and the LZ4 codec built from csrc/ into `tmp`
    and loaded: {source: seconds}."""
    out = {}
    for mod, what, symbols in ((bvh, "the BVH builder", ("vpt_build_bvh",)),
                               (blosc, "the LZ4 codec", ("vpt_lz4_compress", "vpt_lz4_decompress"))):
        check(os.path.dirname(mod._SRC) == kernels.CSRC_DIR, f"{what} builds from the port's csrc/")
        t0 = time.perf_counter()
        lib = ctypes.CDLL(kernels.host_library(mod._SRC, os.path.join(tmp, os.path.basename(mod._LIB)), mod._CMD,
                                               what))
        sec = time.perf_counter() - t0
        check(all(hasattr(lib, name) for name in symbols), f"{what}'s library exports {symbols}")
        rel = os.path.relpath(mod._SRC, ROOT)
        out[rel] = sec
        log(f"16a: {what} built from {rel} ({' '.join(mod._CMD)}) into a fresh directory in {sec:.2f} s")
    return out


def builders_phase(dev) -> dict:
    """16b: the NumPy and the C++ BVH builders on colonnade's largest unique
    mesh, and both trees traced on the card."""
    scene = colonnade()
    sizes = {i: np.asarray(scene.meshes[i].indices).size // 3 for i in sorted({x.mesh for x in scene.instances})}
    mi = max(sizes, key=sizes.get)
    if sizes[mi] <= GAP_SOUP:
        mesh = scene.meshes[mi]
        idx = np.asarray(mesh.indices).reshape(-1, 3)
        pos = np.asarray(mesh.positions, np.float32)
        v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        what = f"colonnade mesh {mi} ({v0.shape[0]} triangles)"
    else:
        g = np.random.default_rng(5)
        v0 = g.uniform(-5, 5, (GAP_SOUP, 3)).astype(np.float32)
        v1 = v0 + g.uniform(-0.5, 0.5, (GAP_SOUP, 3)).astype(np.float32)
        v2 = v0 + g.uniform(-0.5, 0.5, (GAP_SOUP, 3)).astype(np.float32)
        what = f"a seeded soup of {GAP_SOUP} triangles (colonnade's largest mesh has {sizes[mi]})"
    n = v0.shape[0]
    g = np.random.default_rng(16)
    lo, hi = np.minimum(v0, np.minimum(v1, v2)).min(0), np.maximum(v0, np.maximum(v1, v2)).max(0)
    span = hi - lo
    org = g.uniform(lo - 0.25 * span, hi + 0.25 * span, (GAP_RAYS, 3)).astype(np.float32)
    aim = ((v0 + v1 + v2) / 3)[g.integers(0, n, GAP_RAYS)]
    d = np.where((np.arange(GAP_RAYS) % 3 != 0)[:, None], aim - org, g.normal(size=(GAP_RAYS, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    org_t, d_t = torch.as_tensor(org, device=dev), torch.as_tensor(d, device=dev)
    row, res = {"mesh": what, "triangles": n, "rays": GAP_RAYS}, []
    for name, native in (("numpy", False), ("native", True)):
        t0 = time.perf_counter()
        tree = bvh.build_bvh(v0, v1, v2, use_native=native)
        row[f"{name}_build_s"] = time.perf_counter() - t0
        row[f"{name}_nodes"] = tree.n_nodes
        order = tree.tri_order

        def pad(a):
            return np.concatenate([a[order], np.zeros((bvh.LEAF_SIZE, 3), np.float32)])

        tables = [torch.as_tensor(x, device=dev) for x in (tree.aabb_min, tree.aabb_max, tree.first_tri,
                                                              tree.tri_count, tree.skip, pad(v0), pad(v1 - v0),
                                                              pad(v2 - v0))]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hit = traverse.intersect_bvh(org_t, d_t, *tables)
        torch.cuda.synchronize()
        row[f"{name}_trace_s"] = time.perf_counter() - t0
        tri = hit.tri.cpu().numpy()
        res.append((hit.t.cpu().numpy(), np.where(tri >= 0, order[np.clip(tri, 0, n - 1)], -1)))
    (t_np, id_np), (t_nat, id_nat) = res
    hits = t_np >= 0
    row["hits"] = int(hits.sum())
    row["t_max_abs_diff"] = float(np.abs(t_np - t_nat).max())
    row["ids_agree"] = float(((id_np == id_nat) | ~hits).mean())
    log(f"16b: {what}: NumPy builder {row['numpy_build_s']:.3f} s ({row['numpy_nodes']} nodes), C++ builder "
        f"{row['native_build_s']:.4f} s ({row['native_nodes']} nodes), host seconds, "
        f"{row['numpy_build_s'] / row['native_build_s']:.0f}x; {GAP_RAYS} rays through each tree on the card: "
        f"{row['hits']} hit, t max |diff| {row['t_max_abs_diff']:.3g}, ids agree on {100 * row['ids_agree']:.3f}% "
        f"(traces {row['numpy_trace_s']:.2f} / {row['native_trace_s']:.2f} s)")
    check(row["hits"] > GAP_RAYS // 4, "16b: most of the aimed rays hit")
    check(bool(np.allclose(t_np, t_nat, rtol=1e-4, atol=1e-5)), "16b: both trees give the same closest t")
    check(row["ids_agree"] > 0.99, "16b: more than 99% of the triangle ids agree")
    return row


def any_hit_phase(data, meta, p3: dict) -> dict:
    """16c: integrator.trace's any_hit and anyhit_mask in both trace modes on
    phase 3's bounce rays."""
    org, d, act = p3["bounce"]
    t_min = p3["t_min"]
    mask = torch.as_tensor(np.random.default_rng(17).uniform(size=org.shape[0]) < 0.5, device=org.device)
    out = {}
    for mode in ("stream", "packet"):
        with mock.patch.object(integrator, "TRACE_MODE", mode):
            kernels.reset_launches()
            closest = integrator.trace(data, meta, org, d, act, t_min)
            any_all = integrator.trace(data, meta, org, d, act, t_min, T_MAX, True)
            any_mask = integrator.trace(data, meta, org, d, act, t_min, anyhit_mask=mask)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        kernel = "stream" if mode == "stream" else "visit"
        check(launches[kernel] == 3, f"16c {mode}: the three traces launched {kernel}")
        hits = closest.t >= 0
        for label, got in (("any_hit", any_all), ("anyhit_mask", any_mask)):
            check(torch.equal(got.t >= 0, hits), f"16c {mode} {label}: the rays that hit are the closest trace's")
            check(bool((got.t[hits] >= closest.t[hits]).all()),
                  f"16c {mode} {label}: no any hit nearer than the closest")
        outside = ~mask
        check(all(torch.equal(getattr(any_mask, f)[outside], getattr(closest, f)[outside])
                  for f in ("t", "tri", "u", "v")),
              f"16c {mode}: rays outside the mask keep their closest hits bit for bit")
        farther = int((any_all.t[hits] > closest.t[hits]).sum())
        out[mode] = {"hits": int(hits.sum()), "any_hit_farther": farther,
                     "masked_farther": int((any_mask.t[hits & mask] > closest.t[hits & mask]).sum())}
        log(f"16c {mode}: {out[mode]['hits']} of {org.shape[0]} bounce rays hit in each trace; any_hit stopped "
            f"{farther} of them beyond the closest hit, anyhit_mask {out[mode]['masked_farther']} (inside the mask)")
    return out


def packet_argument_phase(data, p3: dict) -> dict:
    """16d: intersect_clusters(packet=P) against the trace at
    cluster.PACKET_SIZE = P."""
    org, d, act = p3["bounce"]
    cl, t_min = data.clusters, p3["t_min"]
    out = {}
    for size in GAP_PACKETS:
        got = cluster.intersect_clusters(org, d, cl, t_min, T_MAX, act, packet=size, sort_rays=True)
        with mock.patch.object(cluster, "PACKET_SIZE", size):
            want = cluster.intersect_clusters(org, d, cl, t_min, T_MAX, act, sort_rays=True)
        torch.cuda.synchronize()
        check(all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields),
              f"16d: intersect_clusters(packet={size}) equals the trace at PACKET_SIZE = {size}")
        out[size] = int((got.t >= 0).sum())
        log(f"16d: packet={size}: {out[size]} hits, bitwise the PACKET_SIZE = {size} trace's")
    return out


def port_gaps_phase(dev, smi: str, data, meta, p3: dict) -> None:
    """Phase 16: the port's own C sources, the NumPy BVH builder, the any-hit
    flags of integrator.trace and intersect_clusters' packet argument."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        built = host_libraries(tmp)
    row = {"device": smi, "host_libraries_s": built, "builders": builders_phase(dev),
           "any_hit": any_hit_phase(data, meta, p3), "packets": packet_argument_phase(data, p3)}
    print(json.dumps({"port_gaps": row}))
    log(f"phase 16 (the gaps against the JAX package): {time.perf_counter() - t_phase:.1f} s")


FORMAT_SKY = (2048, 4096)  # 17b's sky, rows x columns: the 4K equirectangular maps of the reference
FORMAT_TILE = 256  # 17b's Deflate tiles
FORMAT_RENDER_SKY = (512, 1024)  # 17c's sky
FORMAT_LIMIT_S = 2.0  # 17b: host seconds for load_hdr of the Deflate-tiled 4096x2048 float TIFF
# 17c's .glb: a fixture of tests/torch_formats/ as the base colour of each material.
FORMAT_TEXTURES = {"gif-local-interlaced-inside-transparent.gif": ("stone", "image/gif"),
                   "bmp-rle8-runs-h40.bmp": ("floor", "image/bmp"),
                   "pil-tiff-RGB-tiff_lzw.tif": ("drape-red", "image/tiff"),
                   "jpeg-pil-cmyk-q90.jpg": ("drape-green", "image/jpeg"),
                   # fixtures of tests/torch_webp/: lossy with ALPH on the back wall's own copy of stone, lossless
                   "vp8-alph-lossless-filter-best.webp": ("stone-wall-back", "image/webp"),
                   "vp8l-m6-q100-exact.webp": ("brass", "image/webp"),
                   # fixtures of tests/torch_jpeg/: arithmetic-coded progressive, lossless
                   "arith-prog-ycc420-37x29.jpg": ("stone-wall-west", "image/jpeg"),
                   "lossless-rgb-p7-pt3-37x29.jpg": ("stone-wall-east", "image/jpeg"),
                   # of tests/torch_pil_formats/ and its 2048x2048 timing textures (made from their seed here)
                   "timing-bc7.dds": ("stone-wall-front", "image/vnd-ms.dds"),
                   "timing-rle.tga": ("stone-ped0", "image/x-tga"),
                   "timing-ops.qoi": ("stone-ped1", "image/qoi"),
                   "pcx-pil-RGB-w13.pcx": ("drape-red-drape-n0", "image/x-pcx"),
                   "psd-rgba-packbits.psd": ("brass-statue0", "image/vnd.adobe.photoshop"),
                   # of tests/torch_jpeg2000/: the 1024x1024 5/3 JP2 of 256x256 tiles
                   "timing-1024-53-tiles.jp2": ("stone-ped2", "image/jp2")}
# 17c's instances that get a copy of their material, for a texture of their own.
OWN_MATERIALS = ("wall-back", "wall-west", "wall-east", "wall-front", "ped0", "ped1", "drape-n0", "statue0", "ped2",
                 "ped3", "ped4", "drape-s0", "statue2", "drape-n1", "drape-s1", "col0n", "col1n")
FORMAT_FOLDERS = ((gltf_scenes.FORMAT_DIR, gltf_scenes.FORMAT_FIXTURES),
                  (gltf_scenes.WEBP_DIR, gltf_scenes.WEBP_FIXTURES),
                  (gltf_scenes.JPEG_DIR, gltf_scenes.JPEG_FIXTURES),
                  (gltf_scenes.PIL_FORMAT_DIR, gltf_scenes.PIL_FORMAT_FIXTURES + gltf_scenes.PIL_FORMAT_TIMING),
                  (gltf_scenes.JPEG2000_DIR, gltf_scenes.jpeg2000_fixtures()),
                  (gltf_scenes.PIL_RARE_DIR, gltf_scenes.pil_rare_fixtures() + pil_rare_writers.generated_names()),
                  (gltf_scenes.AVIF_DIR, gltf_scenes.avif_fixtures()))
# The four decodes each fixture of tests/torch_pil_rare/ and tests/torch_avif/
# is held to (the other folders hold two).
RARE_KEYS = ("rgba", "rgba_file", "load_png", "load_hdr")
WEBP_LIMIT_S = 1.0  # 17b: host seconds for decode_rgba of each 2048x2048 WebP texture
JPEG_LIMIT_S = 1.0  # 17b: host seconds for decode_rgba of the SOF10 and lossless JPEG textures
PIL_LIMIT_S = 1.0  # 17b: host seconds for decode_rgba of the 2048x2048 BC7 DDS, RLE TGA and QOI textures
JP2_LIMIT_S = 3.0  # 17b: host seconds for decode_rgba of the 2048x2048 9/7 and 1024x1024 tiled 5/3 JP2 textures
RARE_LIMIT_S = 1.0  # 17b: host seconds for decode_rgba of each 2048x2048 texture of PIL's rarer plugins
FITS_LIMIT_S = 2.0  # 17b: host seconds for load_hdr of the 4096x2048 float FITS sky
AVIF_LIMIT_S = 1.0  # 17b: host seconds for decode_rgba of each 1024x1024 AVIF texture (lossless and lossy)
# 17c's AVIF textures (of tests/torch_avif/), each on a material of its own:
# the 1024x1024 lossless 4:2:0 timing texture, the RGBA one, and the lossy
# 4:2:0 one at PIL's defaults.
AVIF_TEXTURES = {gltf_scenes.AVIF_TIMING[0]: ("drape-green-drape-s1", "image/avif"),
                 gltf_scenes.AVIF_TIMING[1]: ("stone-col0n", "image/avif"),
                 gltf_scenes.AVIF_TIMING[2]: ("stone-col1n", "image/avif")}
# 17c's textures of PIL's rarer plugins, each on a material of its own: the
# 2048x2048 Sun raster RLE, BLP2 DXT5 and FLC timing textures (made from their
# seed here), an icns of RLE RGB with its mask, an 8-bit FITS image.
RARE_TEXTURES = {"timing-sun-rle-2048.ras": ("stone-ped3", "image/x-sun-raster"),
                 "timing-blp2-dxt5-2048.blp": ("stone-ped4", "image/x-blp"),
                 "timing-fli-brun-2048.flc": ("drape-red-drape-s0", "image/x-flc"),
                 "icns-rle-mask.icns": ("brass-statue2", "image/icns"),
                 "fits-bitpix8.fits": ("drape-green-drape-n1", "image/fits")}
OPENCV_DIR = os.path.join(ROOT, "tests", "torch_opencv")  # the files imageio hands to OpenCV, and their manifest
OPENCV_SKY = "hdr-sky-64x32.hdr"  # 17c's Radiance sky, named sky.HDR
OPENCV_LIMIT_S = 2.0  # 17b: host seconds for load_hdr of the 4096x2048 Radiance sky named sky.HDR (OpenCV's route)


def write_float_tiff(path: str, img: np.ndarray, tile: int = 0) -> None:
    """A baseline TIFF of an (H, W, 3) float32 image: little-endian, one
    directory, Deflate-compressed `tile` x `tile` tiles, or uncompressed
    strips of 16 rows for tile 0."""
    h, w, c = img.shape
    img = img.astype("<f4")
    if tile:
        pad = np.zeros((-(-h // tile) * tile, -(-w // tile) * tile, c), "<f4")
        pad[:h, :w] = img
        segs = [zlib.compress(pad[y : y + tile, x : x + tile].tobytes(), 6) for y in range(0, h, tile)
                for x in range(0, w, tile)]
    else:
        segs = [img[y : y + 16].tobytes() for y in range(0, h, 16)]
    n, body = len(segs), b"".join(segs)
    offsets = np.cumsum([8] + [len(x) for x in segs[:-1]]).tolist()
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [32] * c), 259: (3, [8 if tile else 1]), 262: (3, [2]),
            277: (3, [c]), 284: (3, [1]), 339: (3, [3] * c)}
    tags.update({322: (4, [tile]), 323: (4, [tile]), 324: (4, offsets), 325: (4, [len(x) for x in segs])} if tile
                else {273: (4, offsets), 278: (4, [16]), 279: (4, [len(x) for x in segs])})
    ifd_at = 8 + len(body)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, extra = b"", b""
    for code in sorted(tags):
        kind, values = tags[code]
        raw = struct.pack(f"<{len(values)}{'H' if kind == 3 else 'I'}", *values)
        field = raw.ljust(4, b"\0") if len(raw) <= 4 else struct.pack("<I", extra_at + len(extra))
        extra += b"" if len(raw) <= 4 else raw
        entries += struct.pack("<HHI", code, kind, len(values)) + field
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", ifd_at) + body + struct.pack("<H", len(tags)) + entries + bytes(4) + extra)
    check(n == len(offsets), "the TIFF writer's segments")


def fixture_array(path: str, name: str, key: str, manifest: dict):
    """17a: fixture `name` (the file `path`) of tests/torch_formats/,
    tests/torch_webp/, tests/torch_jpeg/, tests/torch_pil_formats/,
    tests/torch_jpeg2000/ or tests/torch_pil_rare/ (or a file made from a
    seed) through the texture decode of its bytes ("rgba") or of the file
    by its path ("rgba_file"), load_png or load_hdr, held to its manifest
    entry: the array (its sha256 that of the JAX package's decode), or None
    where the entry says the JAX package refuses it and the port raised a
    ValueError."""
    want = manifest[name][key]
    try:
        if key in ("rgba", "rgba_file"):
            with open(path, "rb") as f:
                got = decode_rgba(f.read(), name, from_file=key == "rgba_file")
        elif key == "load_png":
            got = load_png(path)
        else:
            got = load_hdr(path)
    except ValueError as e:
        check(want is None or avif_cases.REFUSED.get(name, "\0") in str(e),
              f"17a: {name} ({key}) decodes, as the JAX package's does; the port raised {e}")
        return None
    check(want == [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()],
          f"17a: {name} ({key}) decodes to its manifest entry {want}")
    return got


def opencv_fixtures() -> dict:
    """17a: every file of tests/torch_opencv/ named sky.exr (imageio's
    OpenCV plugin comes first for .exr) through load_hdr, held to the
    manifest: the sha256 and shape of the JAX package's decode, or a
    ValueError where it refuses or where the port refuses by name.  The
    arrays by name."""
    with open(os.path.join(OPENCV_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    out, refused = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for name, want in sorted(manifest.items()):
            path = os.path.join(tmp, "sky.exr")
            shutil.copy(os.path.join(OPENCV_DIR, name), path)
            try:
                got = load_hdr(path)
            except ValueError as e:
                check(want is None or want.get("port_refuses"), f"17a: {name} decodes, as the JAX package's does; "
                                                               f"the port raised {e}")
                refused.append(name)
                continue
            digest = hashlib.sha256(np.ascontiguousarray(got, np.float32).tobytes()).hexdigest()
            check(want is not None and not want.get("port_refuses") and list(got.shape) == want["shape"]
                  and digest == want["sha256"], f"17a: {name} decodes to its manifest entry {want}")
            out[name] = got
    check(codec._lib is not None and hasattr(codec._lib, "vpt_rgbe_cv"),
          "17a: the Radiance files ran the C codec's OpenCV scanline reader")
    log(f"17a: {len(manifest)} files of tests/torch_opencv/ through load_hdr as sky.exr (OpenCV's route) to their "
        f"manifest ({len(out)} arrays by sha256; {len(refused)} refused where the JAX package refuses or the port "
        f"refuses by name; {time.perf_counter() - t0:.2f} s)")
    return out


def image_formats_phase(dev, smi: str) -> None:
    """Phase 17: the TIFF, GIF, BMP, CMYK / any-sampling / smoothed JPEG,
    WebP, arithmetic-coded / lossless JPEG, TGA, DDS, Netpbm / PFM, QOI,
    SGI, PCX, ICO / CUR, PSD and JPEG 2000 decoders and the OpenCV route of
    load_hdr on the card's machine (no PIL or OpenCV there) against the
    manifests of tests/torch_formats/, tests/torch_webp/, tests/torch_jpeg/,
    tests/torch_pil_formats/, tests/torch_jpeg2000/ and tests/torch_opencv/,
    a 4096x2048 float TIFF sky read back bitwise and timed, the Radiance sky
    as sky.HDR timed, the 2048x2048 WebP, BC7 DDS, RLE TGA and QOI textures, the SOF10
    and lossless JPEG textures and the two JP2 textures timed, renders with
    a .tif sky against the same array as .npy, a .jp2 and a .HDR sky
    against the .npy of their decodes, and a .glb with GIF, RLE8 BMP, LZW TIFF, CMYK JPEG,
    WebP, SOF10, lossless JPEG, BC7 DDS, RLE TGA, QOI, PCX, PSD and JP2
    textures through the
    CLI against its in-memory render."""
    t_phase = time.perf_counter()
    # 17a. The fixtures, and the timing textures of tests/torch_pil_formats/ from their seed.
    t0 = time.perf_counter()
    timing = pil_format_writers.timing_textures()
    log(f"17a: the {len(timing)} 2048x2048 timing textures of pil_format_writers written in "
        f"{time.perf_counter() - t0:.2f} s ({', '.join(f'{n} {len(d)} bytes' for n, d in timing.items())})")
    t0 = time.perf_counter()
    rare = pil_rare_writers.generated()
    log(f"17a: the {len(rare)} large files of pil_rare_writers written in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{n} {len(d)} bytes' for n, d in rare.items())})")
    made = tempfile.mkdtemp()
    for name, data in {**timing, **rare}.items():
        with open(os.path.join(made, name), "wb") as f:
            f.write(data)
    decoded = {}
    for folder, names in FORMAT_FOLDERS:
        with open(os.path.join(folder, "manifest.json")) as f:
            manifest = json.load(f)
        check(sorted(manifest) == sorted(names), f"17a: the manifest of {folder} names every fixture")
        t0 = time.perf_counter()
        keys = RARE_KEYS if folder in (gltf_scenes.PIL_RARE_DIR, gltf_scenes.AVIF_DIR) else ("rgba", "load_hdr")
        got = {(name, key): fixture_array(os.path.join(made if name in timing or name in rare else folder, name), name,
                                          key, manifest)
               for name in names for key in keys}
        decoded.update(got)
        refused = sorted(f"{n} ({k})" for (n, k), v in got.items() if v is None)
        log(f"17a: {len(names)} fixtures of tests/{os.path.basename(folder)}/ decode to their manifest through "
            f"{', '.join(keys)} ({len(got) - len(refused)} arrays by sha256; {len(refused)} refused where "
            f"the JAX package refuses{': ' if refused else ''}{', '.join(refused)}; {time.perf_counter() - t0:.2f} s)")
    check(codec._lib is not None and hasattr(codec._lib, "vpt_tiff_lzw") and hasattr(codec._lib, "vpt_jpeg_arith_scan")
          and hasattr(codec._lib, "vpt_jpeg_lossless_scan"), "17a: the decoders ran the C codec")
    check(codec._webp_lib is not None and hasattr(codec._webp_lib, "vpt_vp8_decode"),
          "17a: the WebP fixtures ran the port's C WebP decoders")
    check(codec._bcn_lib is not None and all(hasattr(codec._lib, f) for f in (
        "vpt_tga_rle", "vpt_pcx_rle", "vpt_sgi_rle", "vpt_qoi_decode", "vpt_packbits_rows")),
        "17a: the TGA, PCX, SGI, QOI, PSD and DDS fixtures ran the C codec and the C block decoders")
    check(codec._j2k_lib is not None and hasattr(codec._j2k_lib, "vpt_j2k_decode"),
          "17a: the JPEG 2000 fixtures ran the port's C JPEG 2000 decoder")
    check(all(hasattr(codec._lib, f) for f in ("vpt_sun_rle", "vpt_msp_rle", "vpt_xbm_hex", "vpt_fli_decode",
                                                "vpt_pcd_planes", "vpt_bit_decode", "vpt_blp_dxt")),
          "17a: PIL's rarer plugins ran the C codec's Sun RLE, MSP, XBM, FLI, PhotoCD, bit and BLP DXT loops")
    check(codec._av1_lib is not None and hasattr(codec._av1_lib, "vpt_av1_decode"),
          "17a: the AVIF fixtures ran the port's C AV1 decoder")
    opencv_decoded = opencv_fixtures()

    # 17b. A 4096x2048 float TIFF sky.
    sky = default_sky(size=FORMAT_SKY)
    row = {"device": smi, "sky": list(sky.shape)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"deflate_tiles": os.path.join(tmp, "sky_tiles.tif"), "strips": os.path.join(tmp, "sky_strips.tif")}
        t0 = time.perf_counter()
        write_float_tiff(paths["deflate_tiles"], sky, FORMAT_TILE)
        write_float_tiff(paths["strips"], sky)
        hdr = os.path.join(tmp, "sky.hdr")
        save_radiance_hdr(hdr, sky)
        row["write_s"] = time.perf_counter() - t0
        for label, path in paths.items():
            got = load_hdr(path)
            check(got.dtype == np.float32 and got.shape == sky.shape and np.array_equal(got, sky),
                  f"17b: load_hdr gives the {label} TIFF sky back bitwise")
            row[f"{label}_bytes"] = os.path.getsize(path)
            row[f"{label}_s"], row[f"{label}_all_s"] = host_seconds(lambda: load_hdr(path))
        row["radiance_bytes"] = os.path.getsize(hdr)
        row["radiance_s"], row["radiance_all_s"] = host_seconds(lambda: load_radiance_hdr(hdr))
        upper = os.path.join(tmp, "sky.HDR")  # the same file under a name imageio gives OpenCV
        shutil.copy(hdr, upper)
        got = load_hdr(upper)
        check(got.dtype == np.float32 and got.shape == sky.shape and float(got.max()) <= 255.0
              and np.array_equal(got, np.rint(got)), "17b: load_hdr of sky.HDR is OpenCV's 8-bit decode")
        row["radiance_opencv_s"], row["radiance_opencv_all_s"] = host_seconds(lambda: load_hdr(upper))
    log(f"17b: load_hdr host seconds (median of 5; {smi}, host {os.cpu_count()} CPUs) of the {FORMAT_SKY[1]}x"
        f"{FORMAT_SKY[0]} float32 RGB sky: Deflate {FORMAT_TILE}x{FORMAT_TILE} tiles ({row['deflate_tiles_bytes']} "
        f"bytes) {row['deflate_tiles_s']:.4f} s {row['deflate_tiles_all_s']}; uncompressed strips "
        f"({row['strips_bytes']} bytes) {row['strips_s']:.4f} s {row['strips_all_s']}; load_radiance_hdr of the "
        f"same sky by save_radiance_hdr ({row['radiance_bytes']} bytes) {row['radiance_s']:.4f} s "
        f"{row['radiance_all_s']}; load_hdr of that file named sky.HDR (OpenCV's route, io/cv_hdr.py) "
        f"{row['radiance_opencv_s']:.4f} s {row['radiance_opencv_all_s']}; both TIFFs bitwise the array")
    check(row["radiance_opencv_s"] < OPENCV_LIMIT_S, f"17b: the sky.HDR sky reads in under {OPENCV_LIMIT_S} s")
    check(row["deflate_tiles_s"] < FORMAT_LIMIT_S, f"17b: the Deflate TIFF sky reads in under {FORMAT_LIMIT_S} s")
    row["webp"] = {}
    for name in gltf_scenes.WEBP_TIMING:
        with open(os.path.join(gltf_scenes.WEBP_DIR, name), "rb") as f:
            data = f.read()
        median, every = host_seconds(lambda: decode_rgba(data, name))
        row["webp"][name] = {"bytes": len(data), "s": median, "all_s": every}
        log(f"17b: decode_rgba of {name} (2048x2048, {len(data)} bytes; {smi}, host {os.cpu_count()} CPUs): "
            f"{median:.4f} s median of 5 {every}")
        check(median < WEBP_LIMIT_S, f"17b: {name} decodes in under {WEBP_LIMIT_S} s")
    row["jpeg"] = {}
    for name in gltf_scenes.JPEG_TIMING:
        with open(os.path.join(gltf_scenes.JPEG_DIR, name), "rb") as f:
            data = f.read()
        median, every = host_seconds(lambda: decode_rgba(data, name))
        shape = decoded[name, "rgba"].shape
        row["jpeg"][name] = {"bytes": len(data), "shape": list(shape), "s": median, "all_s": every}
        log(f"17b: decode_rgba of {name} ({shape[1]}x{shape[0]}, {len(data)} bytes; {smi}, host {os.cpu_count()} "
            f"CPUs): {median:.4f} s median of 5 {every}")
        check(median < JPEG_LIMIT_S, f"17b: {name} decodes in under {JPEG_LIMIT_S} s")
    row["pil_formats"] = {}
    for name, data in timing.items():
        median, every = host_seconds(lambda: decode_rgba(data, name))
        row["pil_formats"][name] = {"bytes": len(data), "s": median, "all_s": every}
        log(f"17b: decode_rgba of {name} (2048x2048, {len(data)} bytes; {smi}, host {os.cpu_count()} CPUs): "
            f"{median:.4f} s median of 5 {every}")
        check(median < PIL_LIMIT_S, f"17b: {name} decodes in under {PIL_LIMIT_S} s")
    row["jpeg2000"] = {}
    with open(os.path.join(gltf_scenes.JPEG2000_DIR, "pil_seconds.json")) as f:
        pil_seconds = json.load(f)
    for name in gltf_scenes.JPEG2000_TIMING:
        with open(os.path.join(gltf_scenes.JPEG2000_DIR, name), "rb") as f:
            data = f.read()
        median, every = host_seconds(lambda: decode_rgba(data, name))
        shape = decoded[name, "rgba"].shape
        row["jpeg2000"][name] = {"bytes": len(data), "shape": list(shape), "s": median, "all_s": every,
                                 "pil_s_where_made": pil_seconds[name]["pil_s"]}
        log(f"17b: decode_rgba of {name} ({shape[1]}x{shape[0]}, {len(data)} bytes; {smi}, host {os.cpu_count()} "
            f"CPUs): {median:.4f} s median of 5 {every}; PIL's decode where the fixture was made (CPU sandbox, "
            f"{pil_seconds['host']['cpus']} CPUs, tests/make_torch_jpeg2000.py): {pil_seconds[name]['pil_s']:.4f} s")
        check(median < JP2_LIMIT_S, f"17b: {name} decodes in under {JP2_LIMIT_S} s")

    row["pil_rare"] = {}
    for name in pil_rare_writers.TIMING:
        data = rare[name]
        median, every = host_seconds(lambda: decode_rgba(data, name))
        row["pil_rare"][name] = {"bytes": len(data), "s": median, "all_s": every}
        log(f"17b: decode_rgba of {name} (2048x2048, {len(data)} bytes; {smi}, host {os.cpu_count()} CPUs): "
            f"{median:.4f} s median of 5 {every}")
        check(median < RARE_LIMIT_S, f"17b: {name} decodes in under {RARE_LIMIT_S} s")
    fits_path = os.path.join(made, pil_rare_writers.SKY)
    median, every = host_seconds(lambda: load_hdr(fits_path))
    sky_fits = decoded[pil_rare_writers.SKY, "load_hdr"]
    row["pil_rare"][pil_rare_writers.SKY] = {"bytes": len(rare[pil_rare_writers.SKY]), "s": median, "all_s": every}
    log(f"17b: load_hdr of {pil_rare_writers.SKY} (4096x2048 BITPIX -32, {len(rare[pil_rare_writers.SKY])} bytes; "
        f"{smi}, host {os.cpu_count()} CPUs): {median:.4f} s median of 5 {every}; (2048, 4096, 3) float32, range "
        f"{float(sky_fits.min()):.3f}-{float(sky_fits.max()):.3f}")
    check(median < FITS_LIMIT_S, f"17b: the FITS sky reads in under {FITS_LIMIT_S} s")
    row["avif"] = {}
    for name in gltf_scenes.AVIF_TIMING:
        with open(os.path.join(gltf_scenes.AVIF_DIR, name), "rb") as f:
            data = f.read()
        median, every = host_seconds(lambda: decode_rgba(data, name))
        row["avif"][name] = {"bytes": len(data), "s": median, "all_s": every}
        kind = "lossy AV1 at PIL's defaults" if name == gltf_scenes.AVIF_TIMING[2] else "lossless AV1"
        log(f"17b: decode_rgba of {name} (1024x1024 {kind}, {len(data)} bytes; {smi}, host {os.cpu_count()} "
            f"CPUs): {median:.4f} s median of 5 {every}")
        check(median < AVIF_LIMIT_S, f"17b: {name} decodes in under {AVIF_LIMIT_S} s")

    # 17c. A .tif sky against the .npy of the same array, a .jp2 sky against the .npy of its decode; a .glb of
    # the new formats.
    with tempfile.TemporaryDirectory() as tmp:
        small = default_sky(size=FORMAT_RENDER_SKY)
        np.save(os.path.join(tmp, "sky.npy"), small)
        write_float_tiff(os.path.join(tmp, "sky.tif"), small, FORMAT_TILE)
        shutil.copy(os.path.join(gltf_scenes.JPEG2000_DIR, gltf_scenes.JPEG2000_SKY), os.path.join(tmp, "sky.jp2"))
        np.save(os.path.join(tmp, "sky_jp2.npy"), load_hdr(os.path.join(tmp, "sky.jp2")))
        shutil.copy(os.path.join(OPENCV_DIR, OPENCV_SKY), os.path.join(tmp, "sky.HDR"))
        np.save(os.path.join(tmp, "sky_HDR.npy"), opencv_decoded[OPENCV_SKY])
        with open(os.path.join(tmp, "sky.fits"), "wb") as f:  # floats as PIL's FITS plugin reads BITPIX -32
            f.write(pil_rare_writers.fits(small[..., 0], -32, little=True))
        np.save(os.path.join(tmp, "sky_fits.npy"), load_hdr(os.path.join(tmp, "sky.fits")))
        shutil.copy(os.path.join(gltf_scenes.AVIF_DIR, gltf_scenes.AVIF_SKY), os.path.join(tmp, "sky.avif"))
        np.save(os.path.join(tmp, "sky_avif.npy"), decoded[gltf_scenes.AVIF_SKY, "load_hdr"])
        skies = {"tif": "sky.tif", "npy": "sky.npy", "jp2": "sky.jp2", "jp2npy": "sky_jp2.npy", "HDR": "sky.HDR",
                 "HDRnpy": "sky_HDR.npy", "fits": "sky.fits", "fitsnpy": "sky_fits.npy", "avif": "sky.avif",
                 "avifnpy": "sky_avif.npy"}
        args = ("--width", str(W), "--height", str(H), "--spp", "8", "--spp-per-frame", "4", "--depth", "8")
        procs = {ext: subprocess.Popen([sys.executable, "-m", "vpt_tpu_torch", "render", "garden", "-o",
                                        os.path.join(tmp, f"garden_{ext}.png"), "--hdr-output",
                                        os.path.join(tmp, f"garden_{ext}.npy"), "--env",
                                        os.path.join(tmp, sky), *args], cwd=ROOT, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                 for ext, sky in skies.items()}
        outs = {ext: p.communicate(timeout=600) for ext, p in procs.items()}
        for ext, p in procs.items():
            check(p.returncode == 0, f"17c: render garden --env sky.{ext} exits 0:\n{outs[ext][0][-2000:]}\n"
                                     f"{outs[ext][1][-4000:]}")
        stats = {ext: json.loads(outs[ext][0].strip().splitlines()[-1]) for ext in outs}
        got, want = (np.load(os.path.join(tmp, f"garden_{ext}.npy")) for ext in ("tif", "npy"))
        row["env_render"] = {ext: {k: stats[ext][k] for k in ("seconds", "segments")} for ext in stats}
        log(f"17c: render garden {W}x{H} depth 8, 8 spp with --env sky.tif (Deflate tiles) and --env sky.npy "
            f"({FORMAT_RENDER_SKY[1]}x{FORMAT_RENDER_SKY[0]}, the same array), at once: bitwise equal "
            f"{bool(np.array_equal(got, want))}, segments {stats['tif']['segments']} vs {stats['npy']['segments']}")
        check(got.shape == (H, W, 3) and np.isfinite(got).all() and float(got.mean()) > 0.0,
              "17c: the --env sky.tif render is finite and lit")
        check(np.array_equal(got, want), "17c: the --env sky.tif render is bitwise the --env sky.npy render")
        got, want = (np.load(os.path.join(tmp, f"garden_{ext}.npy")) for ext in ("jp2", "jp2npy"))
        log(f"17c: render garden {W}x{H} depth 8, 8 spp with --env sky.jp2 ({gltf_scenes.JPEG2000_SKY}, 9/7) and "
            f"--env sky_jp2.npy (its load_hdr decode), at once: bitwise equal {bool(np.array_equal(got, want))}, "
            f"segments {stats['jp2']['segments']} vs {stats['jp2npy']['segments']}")
        check(got.shape == (H, W, 3) and np.isfinite(got).all() and float(got.mean()) > 0.0,
              "17c: the --env sky.jp2 render is finite and lit")
        check(np.array_equal(got, want), "17c: the --env sky.jp2 render is bitwise the --env sky_jp2.npy render")
        got, want = (np.load(os.path.join(tmp, f"garden_{ext}.npy")) for ext in ("HDR", "HDRnpy"))
        log(f"17c: render garden {W}x{H} depth 8, 8 spp with --env sky.HDR ({OPENCV_SKY}, a Radiance file that "
            f"imageio hands to OpenCV) and --env sky_HDR.npy (its manifest decode), at once: bitwise equal "
            f"{bool(np.array_equal(got, want))}, segments {stats['HDR']['segments']} vs {stats['HDRnpy']['segments']}")
        check(got.shape == (H, W, 3) and np.isfinite(got).all() and float(got.mean()) > 0.0,
              "17c: the --env sky.HDR render is finite and lit")
        check(np.array_equal(got, want), "17c: the --env sky.HDR render is bitwise the --env sky_HDR.npy render")
        got, want = (np.load(os.path.join(tmp, f"garden_{ext}.npy")) for ext in ("fits", "fitsnpy"))
        log(f"17c: render garden {W}x{H} depth 8, 8 spp with --env sky.fits ({FORMAT_RENDER_SKY[1]}x"
            f"{FORMAT_RENDER_SKY[0]} BITPIX -32, gray) and --env sky_fits.npy (its load_hdr decode), at once: bitwise "
            f"equal {bool(np.array_equal(got, want))}, segments {stats['fits']['segments']} vs "
            f"{stats['fitsnpy']['segments']}")
        check(got.shape == (H, W, 3) and np.isfinite(got).all() and float(got.mean()) > 0.0,
              "17c: the --env sky.fits render is finite and lit")
        check(np.array_equal(got, want), "17c: the --env sky.fits render is bitwise the --env sky_fits.npy render")
        check(stats["fits"]["segments"] == stats["fitsnpy"]["segments"], "17c: the FITS sky renders' segments equal")
        got, want = (np.load(os.path.join(tmp, f"garden_{ext}.npy")) for ext in ("avif", "avifnpy"))
        log(f"17c: render garden {W}x{H} depth 8, 8 spp with --env sky.avif ({gltf_scenes.AVIF_SKY}, lossless 4:2:0 "
            f"AV1) and --env sky_avif.npy (its manifest decode), at once: bitwise equal "
            f"{bool(np.array_equal(got, want))}, segments {stats['avif']['segments']} vs {stats['avifnpy']['segments']}")
        check(got.shape == (H, W, 3) and np.isfinite(got).all() and float(got.mean()) > 0.0,
              "17c: the --env sky.avif render is finite and lit")
        check(np.array_equal(got, want), "17c: the --env sky.avif render is bitwise the --env sky_avif.npy render")
        check(stats["avif"]["segments"] == stats["avifnpy"]["segments"], "17c: the AVIF sky renders' segments equal")

        scene = colonnade()
        for own in OWN_MATERIALS:  # each its own copy of its material, for a texture of its own
            inst = next(i for i in scene.instances if i.name == own)
            mat = scene.materials[inst.material]
            scene.materials.append(dataclasses.replace(mat, name=f"{mat.name}-{own}"))
            inst.material = len(scene.materials) - 1
        folders = {name: folder for folder, names in FORMAT_FOLDERS for name in names}
        images, textures = {}, {}
        for name, (material, mime) in {**FORMAT_TEXTURES, **RARE_TEXTURES, **AVIF_TEXTURES}.items():
            textures[name] = decoded[name, "rgba"]
            check(textures[name] is not None, f"17c: {name} is a texture the JAX package reads")
            scene.textures.append(textures[name])
            slot = len(scene.textures) - 1
            next(m for m in scene.materials if m.name == material).base_color_texture = slot
            if name in timing or name in rare:
                images[slot] = ({**timing, **rare}[name], mime)
            else:
                with open(os.path.join(folders[name], name), "rb") as f:
                    images[slot] = (f.read(), mime)
        glb = gltf_scenes.scene_to_gltf(scene, os.path.join(tmp, "formats.glb"), images=images)
        sky_path = os.path.join(tmp, "colonnade_sky.npy")
        np.save(sky_path, scene.env_map)
        hdr_out = os.path.join(tmp, "formats.npy")
        cli = run_cli("render", glb, "-o", os.path.join(tmp, "formats.png"), "--hdr-output", hdr_out, "--env",
                      sky_path, *args)
        got = np.load(hdr_out)
        ref_scene = load_gltf(glb)
    ref_scene.env_map = scene.env_map
    for name, (material, _) in {**FORMAT_TEXTURES, **RARE_TEXTURES, **AVIF_TEXTURES}.items():
        ref_scene.textures[next(m for m in ref_scene.materials if m.name == material).base_color_texture] = \
            textures[name]
    ref = Renderer(ref_scene, width=W, height=H, flags=RenderFlags(max_depth=8), samples_per_frame=4, max_samples=8,
                   device=dev)
    while not ref.path_trace():
        pass
    want = ref.hdr_image()
    row["glb_render"] = {"seconds": cli["seconds"], "segments": cli["segments"],
                         "bitwise": bool(np.array_equal(got, want))}
    log(f"17c: CLI render of the .glb with "
        f"{', '.join(f'{n} ({m})' for n, (m, _) in {**FORMAT_TEXTURES, **RARE_TEXTURES, **AVIF_TEXTURES}.items())} "
        f"decoded by the port vs the in-memory render with the decodes whose sha256 is the manifest's, {W}x{H} "
        f"depth 8, 8 spp: bitwise equal {row['glb_render']['bitwise']}, segments {cli['segments']} vs "
        f"{ref.segments_traced}")
    check(got.shape == (H, W, 3) and np.isfinite(got).all(), "17c: the .glb render is finite, (512, 512, 3)")
    check(row["glb_render"]["bitwise"], "17c: the .glb render through the CLI is bitwise its in-memory render")
    check(cli["segments"] == ref.segments_traced, "17c: the .glb render's segments equal the in-memory render's")
    shutil.rmtree(made)
    row["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"image_formats": row}))
    log(f"phase 17 (the image formats): {row['phase_s']:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--compare", metavar="OTHER_CU", nargs="+", default=[],
                        help="also time other versions of a csrc/ kernel source against the current kernels")
    parser.add_argument("--gallery-full", action="store_true",
                        help="only render the gallery at the committed TPU renders' sizes and samples")
    parser.add_argument("--image-formats", action="store_true",
                        help="only run phase 17, the image formats (after the kernel build)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = card_description(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} | {smi}")

    # 2. Build: the kernels, and the host image codecs in the background (gcc, one process each).
    host_codecs = threading.Thread(target=codec.build_all, daemon=True)
    host_codecs.start()
    kernels.library()
    log(f"kernel build: {kernels.build_seconds:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")
    if args.gallery_full:
        gallery_full(dev, smi)
        print(smi)
        return 0
    if args.image_formats:
        lookup.get_lookup_tables(device=dev)  # the CLI's renders read the cached tables, as after phase 4
        image_formats_phase(dev, smi)
        print(smi)
        return 0
    run(dev, smi, args.compare)
    return 0


def run(dev, smi: str, other_builds=()) -> None:
    """Phases 3-17 on `dev`, then the result lines."""
    # 3. Kernels against plain versions at the main path's shapes.
    t0 = time.perf_counter()
    data, meta, aux = compile_scene(colonnade(), device=dev)
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

    p3 = {"data": data, "t_min": t_min, "bounce": bounce, "shadow": shadow, "w_bounce": w_bounce, "w_shadow": w_shadow}
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
    loop_cond_phase(dev, table)

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
    stream_r = r
    check_stream_launches(launches, "stream")
    for name in (*STREAM_KERNELS, "loop_cond"):
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

    # 6. Kernel renders against plain renders.
    square = default_params(np.linalg.inv(aux["camera_view"]),
                            np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0)), device=dev)
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
    media_r = r
    t0 = time.perf_counter()
    media_rows = [graph_turns("media", stepper(r), small=(stepper(r, PROFILE_SIZE, 1), f"{PROFILE_SIZE}^2 1 spp"))]
    check_stream_launches(media_rows[-1]["launches"], "media")
    log(f"phase 7 (the media path, captured against eager): {time.perf_counter() - t0:.1f} s")
    kernel_vs_plain_render(r.scene_data, r.meta, r.flags, square, dev, "media")

    # 8. The atmosphere path: the day setup of scripts/gallery.py.
    r = Renderer(colonnade(), width=W, height=H, flags=ATMOSPHERE_FLAGS, samples_per_frame=4, device=dev)
    r.set_enable_atmosphere(True)
    r.set_planet_position((0.0, -6360e3, 0.0))
    r.set_sky_altitude(30.0)
    t0 = time.perf_counter()
    media_rows.append(graph_turns("atmosphere", stepper(r), small=(stepper(r, PROFILE_SIZE, 1),
                                                                   f"{PROFILE_SIZE}^2 1 spp")))
    check_stream_launches(media_rows[-1]["launches"], "atmosphere")
    log(f"phase 8 (the atmosphere path, captured against eager): {time.perf_counter() - t0:.1f} s")
    kernel_vs_plain_render(r.scene_data, r.meta, r.flags, square._replace(sky_rotation_altitude=scalar(30.0, dev),
                                                                          planet_position=r.params.planet_position),
                           dev, "atmosphere")

    # 9. The user's entry points.
    entry_points(dev, smi, flags, square, stream_s, stream_segs)

    # 10. The sharded path.
    sharded_path(dev, stream_r, stream_s, table, media_r)

    # 11. The image decoders.
    image_decoders(dev, smi, table)

    # 12. The captured loop against the eager one.
    graph_phase(dev, stream_r, smi, media_rows)

    # 13. The goldens and the gallery.
    gallery_phase(dev, smi)

    # 14. The layout knobs and the dispatch tools.
    layouts_phase(dev, smi, table, p3, stream_r, media_r)

    # 15. The probe kernels.
    probe_phase(dev, smi, table)

    # 16. The gaps against the JAX package.
    port_gaps_phase(dev, smi, data, meta, p3)

    # 17. The image formats.
    image_formats_phase(dev, smi)

    print(smi)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
