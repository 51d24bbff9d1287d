"""Rank launcher, the one-device entry point and the multi-rank dry run of
the sharded render (port of __graft_entry__.py).

    python -m vpt_tpu_torch.dist.dryrun N [--device cpu] [--backend gloo]

starts N rank processes and runs JAX's three checks on them: every mesh
shape (N, 1), (N/2, 2), (N/4, 4) that divides draws the same image (PSNR >
60 dB between shapes), the band-tiled final frame, and a 15x13 frame that
no tile axis divides.  The backend defaults to nccl for one rank per card,
to gloo on the CPU, and to gloo on CUDA tensors when there are more ranks
than cards (NCCL refuses two ranks on one device).  A rank that raises makes
the whole launch raise.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vpt_tpu_torch.core.camera import perspective
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.dist.mesh import make_mesh, render_sharded, render_tiled_final_frame
from vpt_tpu_torch.render import integrator
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene.build import compile_scene
from vpt_tpu_torch.scene.procedural import colonnade, cornell_box
from vpt_tpu_torch.scene.types import tree_to_device

FOREIGN = ("jax", "jaxlib", "vpt_tpu", "PIL", "imageio")  # what the card's machine does not have
SCENES = {"cornell": cornell_box, "colonnade": colonnade}


def foreign_modules() -> list:
    """The modules of JAX, the JAX package, PIL or imageio loaded in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)


def default_backend(n_ranks: int, device_type: str) -> str:
    if device_type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_main(rank, n_ranks, tmp, backend, device_type, fn, args):
    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    os.environ["LOCAL_RANK"] = str(rank)  # one host: make_mesh takes the device from it
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}", world_size=n_ranks,
                            rank=rank)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(f"{path}.tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(f"{path}.tmp", path)


def run_ranks(n_ranks: int, fn, *args, backend: str | None = None, device="cuda") -> list:
    """Spawn `n_ranks` processes on one host, each in one process group
    (rendezvous through a file store in a directory of this call's own),
    each calling fn(*args) with its default group running; CPU ranks take
    one thread each.  `fn` must be importable by name and its return value
    picklable (host values, not device tensors).  The ranks re-import the
    caller's main module, so a script guards its work with
    ``if __name__ == "__main__":``.  Returns the values by rank."""
    device_type = resolve_device(device).type
    backend = backend or default_backend(n_ranks, device_type)
    tmp = tempfile.mkdtemp(prefix="vpt_ranks_")
    try:
        mp.start_processes(_rank_main, args=(n_ranks, tmp, backend, device_type, fn, args), nprocs=n_ranks,
                           join=True, start_method="spawn")
        results = []
        for rank in range(n_ranks):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def host_tree(tree):
    """A (nested) NamedTuple of tensors as numpy leaves, to hand to ranks."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(host_tree(x) for x in tree))
    return tree.cpu().numpy()


def render_jobs(host_data, meta, flags, cameras, jobs, device):
    """A rank's body: the scene's numpy leaves go to this rank's device
    (`device`'s type; on CUDA the current device), then each job renders on
    a (tile, spp) mesh.  A job is ("sharded", (tile, spp), (width, height),
    frame_seed, n_samples) or ("tiled", ..., n_samples, tile_rows).  Returns
    ([(host image, float segments) per job], foreign_modules())."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    data = tree_to_device(host_data, dev)
    params = default_params(*cameras, device=dev)
    meshes, out = {}, []
    for kind, shape, resolution, seed, n_samples, *rest in jobs:
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device_type=dev.type)
        if kind == "sharded":
            img, segs = render_sharded(data, meta, flags, params, resolution, seed, n_samples, meshes[shape])
            out.append((img.cpu().numpy(), float(segs)))
        else:
            out.append(render_tiled_final_frame(data, meta, flags, params, resolution, n_samples, meshes[shape],
                                                tile_rows=rest[0], frame_seed=seed))
    return out, foreign_modules()


def scene_setup(scene: str = "cornell", max_depth: int = 3):
    """JAX's dry-run setup on the host: the compiled scene as numpy leaves,
    its meta, the flags and the (view_inverse, proj_inverse) of a square
    frame."""
    data, meta, aux = compile_scene(SCENES[scene](), device="cpu")
    cameras = (np.linalg.inv(aux["camera_view"]), np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0)))
    return host_tree(data), meta, RenderFlags(max_depth=max_depth, max_medium_events=2), cameras


def _cornell_setup(size, max_depth, device):
    data, meta, flags, cameras = scene_setup("cornell", max_depth)
    dev = resolve_device(device)
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    pixel_xy = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32), device=dev)
    # The transposed stream ids of the JAX package's entry, kept as they are.
    pixel_index = torch.as_tensor((ys.reshape(-1) + size * xs.reshape(-1)).astype(np.int64), device=dev)
    return (tree_to_device(data, dev), meta, flags, default_params(*cameras, device=dev), pixel_xy, pixel_index,
            (size, size))


def entry(device="cuda"):
    """(fn, example_args): one 2-spp render step of the wavefront integrator
    over a 32x32 Cornell box at depth 4, fn returning the (N, 3) radiance."""
    data, meta, flags, params, pixel_xy, pixel_index, resolution = _cornell_setup(32, 4, device)

    def fn(scene_data, render_params, pxy, pidx, frame_seed):
        return integrator.render_samples(scene_data, meta, flags, render_params, pxy, pidx, resolution, frame_seed,
                                         2)[0]

    return fn, (data, params, pixel_xy, pixel_index, 1234)


def psnr_peak(base: np.ndarray, img: np.ndarray) -> float:
    """PSNR with the base image's maximum as the peak (the dry run's
    measure); inf for equal images."""
    mse = float(np.mean((base.astype(np.float64) - img) ** 2))
    peak = max(float(base.max()), 1e-9)
    return float(10.0 * np.log10(peak * peak / mse)) if mse > 0 else float("inf")


def dryrun_multichip(n_ranks: int, device="cuda", backend: str | None = None, *, scene: str = "cornell",
                     size: int = 16, max_depth: int = 3) -> dict:
    """JAX's three checks on `n_ranks` ranks started by run_ranks: the mesh
    shapes (n, 1), (n/2, 2), (n/4, 4) where they divide, at cross-shape PSNR
    > 60 dB (`size`^2, 4 spp); the tiled final frame on the last shape
    (tile_rows 2); 15x13 on (n, 1).  Every rank must return the same images
    and load no JAX.  Prints JAX's OK line; returns the shapes, their
    images, every job's segment count and the cross-shape PSNRs."""
    data, meta, flags, cameras = scene_setup(scene, max_depth)
    n_samples = 4
    shapes = [(n_ranks, 1), (n_ranks // 2, 2)] if n_ranks % 2 == 0 else [(n_ranks, 1)]
    if n_ranks % 4 == 0:
        shapes.append((n_ranks // 4, 4))
    jobs = [("sharded", s, (size, size), 99, n_samples) for s in shapes]
    jobs += [("tiled", shapes[-1], (size, size), 1234, shapes[-1][1], 2), ("sharded", (n_ranks, 1), (15, 13), 7, 1)]
    ranks = run_ranks(n_ranks, render_jobs, data, meta, flags, cameras, jobs, device, backend=backend, device=device)

    for rank, (results, foreign) in enumerate(ranks):
        assert not foreign, f"rank {rank} loaded {foreign}"
        for (a, sa), (b, sb) in zip(results, ranks[0][0]):
            assert np.array_equal(a, b) and sa == sb, f"rank {rank} returned another image than rank 0"
    results = ranks[0][0]
    imgs = [img for img, _ in results[: len(shapes)]]
    for img in imgs:
        assert img.shape == (size, size, 3) and np.isfinite(img).all()
    psnrs = {}
    for shape, img in zip(shapes[1:], imgs[1:]):
        psnrs[shape] = psnr_peak(imgs[0], img)
        assert psnrs[shape] > 60.0, f"mesh {shape} diverges from {shapes[0]}: {psnrs[shape]:.1f} dB"
    tiled, tsegs = results[len(shapes)]
    assert tiled.shape == (size, size, 3) and np.isfinite(tiled).all() and tiled.max() > 0
    odd, osegs = results[-1]
    assert odd.shape == (13, 15, 3) and np.isfinite(odd).all()
    segs_total = sum(s for _, s in results[: len(shapes)])
    print(f"dryrun_multichip OK: shapes {shapes} cross-shape PSNR > 60 dB, tiled final frame ok, "
          f"non-divisible 15x13 ok, image mean {imgs[0].mean():.4f}, {segs_total + tsegs + osegs:.0f} segments",
          flush=True)
    return {"shapes": shapes, "images": dict(zip(shapes, imgs)), "segments": [s for _, s in results],
            "psnr": psnrs}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="The multi-rank dry run of the sharded render.")
    parser.add_argument("n_ranks", type=int, nargs="?", default=8)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--backend", default=None, help="nccl or gloo (default: see the module docstring)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_ranks, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    from vpt_tpu_torch.dist.dryrun import main as _main  # the spawned ranks import the functions by this name

    sys.exit(_main())
