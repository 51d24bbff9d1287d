"""Command-line interface of the port (port of vpt_tpu/cli.py):

    python -m vpt_tpu_torch render scene.gltf -o out.png --spp 256 --depth 8
    python -m vpt_tpu_torch render cornell --spp 64      # builtin scenes
    python -m vpt_tpu_torch furnace                      # physics self-test
    python -m vpt_tpu_torch bench                        # segments/s line
    python -m vpt_tpu_torch bake-lookups                 # energy-comp tables
    python -m vpt_tpu_torch view garden                  # terminal viewer

The JAX package's subcommands, flags and builtin scenes (cornell,
cornell-empty, garden, furnace; anything else is a .gltf / .glb path),
plus `--device` (default cuda): every command runs on the card unless
asked for the CPU with `--device cpu`, and without a CUDA device the
default fails.  The JSON lines that render, furnace and bake-lookups print
carry the JAX package's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from vpt_tpu_torch.api import Renderer
from vpt_tpu_torch.render.params import RenderFlags
from vpt_tpu_torch.scene import procedural

BUILTIN = {
    "cornell": procedural.cornell_box,
    "cornell-empty": lambda: procedural.cornell_box(with_boxes=False),
    "garden": procedural.sphere_garden,
    "furnace": procedural.furnace_sphere,
}


def _load_scene(spec: str):
    if spec in BUILTIN:
        return BUILTIN[spec]()
    from vpt_tpu_torch.scene.gltf import load_gltf

    return load_gltf(spec)


def cmd_render(args) -> int:
    scene = _load_scene(args.scene)
    if args.env:
        from vpt_tpu_torch.scene.envmap import load_hdr

        scene.env_map = load_hdr(args.env)
    flags = RenderFlags(
        max_depth=args.depth,
        furnace_test_mode=args.furnace,
        enable_sky_mis=not args.no_sky_mis,
        enable_mesh_mis=not args.no_mesh_mis,
        use_energy_compensation=not args.no_energy_compensation,
        enable_atmosphere=args.atmosphere,
    )
    r = Renderer(scene, width=args.width, height=args.height, flags=flags, samples_per_frame=args.spp_per_frame,
                 max_samples=args.spp, lookup_tables=None if args.no_energy_compensation else "auto",
                 metrics_log=args.metrics_log, device=args.device)
    if args.exposure is not None:
        r.post.exposure = args.exposure
    if args.bloom:
        r.post.enable_bloom = True
    if args.dof:
        r.set_focus_distance(args.focus)
        r.set_dof_strength(args.dof)
    if args.checkpoint and args.resume and os.path.exists(args.checkpoint):
        r.load_checkpoint(args.checkpoint)
        print(f"resumed at {r.samples_accumulated} spp", file=sys.stderr)

    t0 = time.time()
    while not r.path_trace():
        if args.verbose and r.frame_count % 8 == 0:
            done = r.samples_accumulated
            eta = r.render_seconds * (r.max_samples - done) / max(done, 1)
            rate = r.segments_traced / max(r.render_seconds, 1e-9) / 1e6
            print(f"[{done}/{r.max_samples} spp] {r.render_seconds:.1f}s elapsed, ETA {eta:.0f}s, "
                  f"{rate:.2f} Msegs/s", file=sys.stderr)
        if args.checkpoint and r.frame_count % args.checkpoint_every == 0:
            r.save_checkpoint(args.checkpoint)
    out = r.save(args.output, embed_stats=args.embed_stats)
    if args.hdr_output:
        r.save(args.hdr_output)
    r.metrics.close()
    stats = {
        "output": out,
        "spp": r.samples_accumulated,
        "seconds": round(time.time() - t0, 2),
        "render_seconds": round(r.render_seconds, 2),
        "segments": r.segments_traced,
        "segments_per_sec": r.segments_traced / max(r.render_seconds, 1e-9),
        "resolution": [r.width, r.height],
    }
    print(json.dumps(stats))
    return 0


def cmd_furnace(args) -> int:
    """Energy-conservation self-test: a white sphere under a white sky in
    furnace mode must vanish (every pixel 1)."""
    r = Renderer(
        procedural.furnace_sphere(), width=64, height=64,
        flags=RenderFlags(max_depth=32, furnace_test_mode=True, enable_mesh_mis=False,
                          use_energy_compensation=False),
        samples_per_frame=8, max_samples=args.spp, lookup_tables=None, device=args.device,
    )
    img = r.render()
    err = float(np.abs(img - 1.0).mean())
    ok = err < 0.05
    print(json.dumps({"furnace_mean_error": err, "pass": ok}))
    return 0 if ok else 1


def cmd_bench(args) -> int:
    from vpt_tpu_torch import bench

    bench.main(args.device)
    return 0


def cmd_bake_lookups(args) -> int:
    from vpt_tpu_torch.render.lookup import get_lookup_tables

    t0 = time.time()
    tables = get_lookup_tables(n_samples=args.samples, device=args.device)
    shapes = [list(t.shape) for t in tables]
    print(json.dumps({"tables": shapes, "seconds": round(time.time() - t0, 1)}))
    return 0


def cmd_view(args) -> int:
    from vpt_tpu_torch.viewer import TerminalViewer

    r = Renderer(_load_scene(args.scene), width=args.size, height=args.size, flags=RenderFlags(max_depth=args.depth),
                 samples_per_frame=args.spp_per_frame, max_samples=args.spp, device=args.device)
    TerminalViewer(r, cols=args.cols).run()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vpt_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device(sp):
        sp.add_argument("--device", default="cuda", help="torch device to run on (default cuda; cpu for the CPU)")

    pr = sub.add_parser("render", help="render a scene to PNG")
    pr.add_argument("scene", help="glTF path or builtin: cornell, cornell-empty, garden, furnace")
    pr.add_argument("-o", "--output", default="render.png")
    pr.add_argument("--hdr-output", default=None, help="also dump raw HDR (.npy)")
    pr.add_argument("--width", type=int, default=None)
    pr.add_argument("--height", type=int, default=None)
    pr.add_argument("--spp", type=int, default=256)
    pr.add_argument("--spp-per-frame", type=int, default=4)
    pr.add_argument("--depth", type=int, default=8, help="max path depth")
    pr.add_argument("--env", default=None, help="HDR environment map path")
    pr.add_argument("--exposure", type=float, default=None)
    pr.add_argument("--bloom", action="store_true")
    pr.add_argument("--dof", type=float, default=0.0, help="depth of field strength")
    pr.add_argument("--focus", type=float, default=1.0, help="focus distance")
    pr.add_argument("--furnace", action="store_true")
    pr.add_argument("--atmosphere", action="store_true")
    pr.add_argument("--no-sky-mis", action="store_true")
    pr.add_argument("--no-mesh-mis", action="store_true")
    pr.add_argument("--no-energy-compensation", action="store_true")
    pr.add_argument("--checkpoint", default=None, help="checkpoint file (npz)")
    pr.add_argument("--checkpoint-every", type=int, default=16)
    pr.add_argument("--resume", action="store_true")
    pr.add_argument("--embed-stats", action="store_true", help="spp+time in filename")
    pr.add_argument("--metrics-log", default=None, help="append per-dispatch JSONL records to this file")
    pr.add_argument("-v", "--verbose", action="store_true")
    add_device(pr)
    pr.set_defaults(fn=cmd_render)

    pf = sub.add_parser("furnace", help="energy conservation self-test")
    pf.add_argument("--spp", type=int, default=64)
    add_device(pf)
    pf.set_defaults(fn=cmd_furnace)

    pb = sub.add_parser("bench", help="path segments/sec benchmark")
    add_device(pb)
    pb.set_defaults(fn=cmd_bench)

    pl = sub.add_parser("bake-lookups", help="bake energy-compensation tables")
    pl.add_argument("--samples", type=int, default=4096)
    add_device(pl)
    pl.set_defaults(fn=cmd_bake_lookups)

    pv = sub.add_parser("view", help="interactive terminal viewer (progressive + fly camera)")
    pv.add_argument("scene", help="glTF path or builtin: cornell, garden, ...")
    pv.add_argument("--size", type=int, default=128, help="render resolution")
    pv.add_argument("--cols", type=int, default=100, help="terminal columns")
    pv.add_argument("--spp", type=int, default=512, help="sample budget")
    pv.add_argument("--spp-per-frame", type=int, default=1)
    pv.add_argument("--depth", type=int, default=6)
    add_device(pv)
    pv.set_defaults(fn=cmd_view)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
