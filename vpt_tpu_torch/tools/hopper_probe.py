"""The port's counterpart of scripts/mosaic_probe.py and scripts/smem_probe.py:
the Mosaic probes' questions asked of the card.

    python -m vpt_tpu_torch.tools.hopper_probe [--device cuda|cpu]

The TPU probes measure what the Pallas trace kernels were designed around:
how much per-cluster metadata fits in fast memory (smem_probe, probe8), a
data-dependent scalar read or store in it (probes 1, 4, 5, 6), binning rays
into per-group lists there (probe2), an async copy into it followed by
scalar reads (probe9), ray-major and scalar-broadcast Moller-Trumbore tiles
(probes 3, 10), a tile reduction read back as a scalar (probe11) and the
sorts and gathers of the trace wrappers (probe7, plain XLA there, plain
torch here).  Each Pallas kernel is a CUDA kernel of csrc/probe.cu here,
with its wrapper and its plain torch version below; on a CUDA tensor the
wrapper launches the kernel (and counts it in kernels.LAUNCHES under the
probe's name), on a CPU tensor it runs the plain version.  `--device cpu`
runs the plain versions where the JAX script's `interpret` ran its kernels;
there is no fallback from one device to the other.

Each probe prints its line in the JAX scripts' words (PASS / FAIL, or a
timing line), in mosaic_probe.main's order: the correctness probes 2, 3, 8,
9, 10, 1, 5, then the timing probes 11, 4, 6, 7, then smem_probe; last,
the card's name and power limit (or the CPU named as such).  The inputs are
the JAX probes' own, made with numpy.  Times on the card are CUDA-event
medians of 5 pairs of 20 launches, launch included; on the CPU, host-clock
times of the plain versions.  A shared-memory size the card refuses (above
227 KB a block on an H100) prints FAIL with its CUDA error, as the JAX
probes print theirs, and ends that probe's sizes; it is the probe's answer,
not a failure.  Exit status 1 if a probe's result is wrong.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from vpt_tpu_torch.accel import kernels
from vpt_tpu_torch.accel.traverse import moller_trumbore_scalar
from vpt_tpu_torch.device import resolve_device
from vpt_tpu_torch.tools.common import device_line

F32, I32 = torch.float32, torch.int32
ROWS, LANES = 8, 128  # the TPU probes' (8, 128) tile
PERM_LEN = 1024  # the timing probes' permutation
MT_TMIN = 1e-4  # the Moller-Trumbore probes' t > 1e-4 test
BINS = (16, 256)  # probe2's groups and slots per group
TIMED_ITERS = 8192  # probes 4 and 6
DRAINS = (256, 2048)  # probe11
SCRATCH_KB = (64, 128, 256, 512)  # probe8
OPERAND_KB = (16, 32, 64, 128, 256, 512, 1024)  # smem_probe
SORT_SIZES = (262144, 524288, 1048576, 2097152)  # probe7
SORT_ROWS, SORT_OPS = 262144, (2, 10, 14)
REPS, LAUNCHES_PER_PAIR = 5, 20
SMEM_LIMIT = 232_448  # bytes of shared memory an H100 block may take (227 KB): more is refused


class Refused(RuntimeError):
    """A launch the card refused, with its CUDA error (`err`, `name`)."""

    def __init__(self, entry: str, err: int):
        self.err = err
        self.name = error_name(err)
        super().__init__(f"{entry} refused: {self.name} ({err})")


def error_name(err: int) -> str:
    buf = ctypes.create_string_buffer(96)
    kernels.library()["vpt_probe_error_name"](err, buf, len(buf))
    return buf.value.decode()


def _launch(entry: str, counter: str, *args) -> None:
    """One probe kernel on the current stream; raise Refused where the card
    refuses the launch (its error read by cudaGetLastError and cleared)."""
    err = kernels.library()[entry](*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise Refused(entry, err)
    kernels.LAUNCHES[counter] += 1


_p = kernels.ptr


def _check(t: torch.Tensor, shape: tuple, dtype: torch.dtype, name: str) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} of shape {shape}, got {t.dtype} {tuple(t.shape)}")


def ordered_sum(vals: torch.Tensor) -> torch.Tensor:
    """The float32 sum of `vals` added one after another in index order (a
    0-d tensor on vals' device), as one thread's loop adds them."""
    acc = torch.zeros((), dtype=F32)
    for v in vals.cpu():
        acc = acc + v
    return acc.to(vals.device)


# -- The JAX probes' inputs ---------------------------------------------------

def lane_perm(n: int, shift: int = 0) -> np.ndarray:
    """(1, n) int32 (i * 37 + shift) % 128: the probes' data-dependent lanes."""
    return ((np.arange(n) * 37 + shift) % LANES).astype(np.int32).reshape(1, n)


def arange_tile() -> np.ndarray:
    return np.arange(ROWS * LANES, dtype=np.float32).reshape(ROWS, LANES)


def group_ids() -> np.ndarray:
    """probe2's (1, 1024) group ids (i * 7) % 16."""
    return ((np.arange(1024) * 7) % BINS[0]).astype(np.int32).reshape(1, 1024)


def mt_inputs():
    """probes 3 and 10: (8, 8) rays [o.xyz, d.xyz, tmax, pad] and (9, 128)
    triangle rows p0, e1, e2, from default_rng(0) as the JAX probes make
    them."""
    rng = np.random.default_rng(0)
    rays = np.zeros((8, 8), np.float32)
    rays[:, 0:3] = rng.normal(size=(8, 3)) * 0.1
    rays[:, 3:6] = rng.normal(size=(8, 3))
    rays[:, 3:6] /= np.linalg.norm(rays[:, 3:6], axis=1, keepdims=True)
    p0 = rng.normal(size=(128, 3)).astype(np.float32) * 2
    e1 = rng.normal(size=(128, 3)).astype(np.float32)
    e2 = rng.normal(size=(128, 3)).astype(np.float32)
    return rays, np.concatenate([p0.T, e1.T, e2.T], axis=0).astype(np.float32)


def mt_oracle(rays: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """The JAX probes' NumPy oracle of the Moller-Trumbore tile."""
    p0, e1, e2 = tris[0:3].T, tris[3:6].T, tris[6:9].T
    o, d = rays[:, None, 0:3], rays[:, None, 3:6]
    pv = np.cross(d, e2[None])
    det = np.sum(e1[None] * pv, axis=2)
    inv_det = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
    tv = o - p0[None]
    uu = np.sum(tv * pv, axis=2) * inv_det
    qv = np.cross(tv, e1[None])
    vv = np.sum(d * qv, axis=2) * inv_det
    tt = np.sum(e2[None] * qv, axis=2) * inv_det
    valid = (np.abs(det) > 1e-12) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > MT_TMIN)
    return np.where(valid, tt, np.inf)


# -- Kernels and their plain versions ------------------------------------------

def probe1_plain(perm, x):
    return x[torch.arange(LANES, device=x.device) % ROWS, perm[0]].reshape(1, LANES)


def probe1(perm, x):
    """(1, 128) out[0, i] = x[i % 8, perm[0, i]]: perm (1, 128) int32 lanes in
    0..127 (the kernel takes them mod 128), x (8, 128) float32
    (mosaic_probe.py probe1)."""
    _check(perm, (1, LANES), I32, "perm")
    _check(x, (ROWS, LANES), F32, "x")
    if not x.is_cuda:
        return probe1_plain(perm, x)
    out = torch.empty((1, LANES), dtype=F32, device=x.device)
    _launch("vpt_probe1", "probe1", _p(perm, I32), _p(x, F32), _p(out, F32))
    return out


def probe2_plain(gid, groups: int = BINS[0], cap: int = BINS[1]):
    g = gid[0].long()
    if g.numel() and not 0 <= int(g.min()) <= int(g.max()) < groups:
        raise ValueError(f"probe2's group ids must lie in 0..{groups - 1}")
    order = torch.sort(g, stable=True).indices
    cnt = torch.bincount(g, minlength=groups)
    first = torch.cumsum(cnt, 0) - cnt
    slot = torch.arange(g.shape[0], device=g.device) - first[g[order]]
    keep = slot < cap
    bins = torch.full((groups * cap,), -1, dtype=I32, device=g.device)
    bins[g[order][keep] * cap + slot[keep]] = order[keep].to(I32)
    return bins.reshape(groups, cap), cnt.to(I32).reshape(1, groups)


def probe2(gid, groups: int = BINS[0], cap: int = BINS[1]):
    """(bins (groups, cap), counts (1, groups)), int32: ray i of gid (1, n)
    int32, ids in 0..groups-1 (the kernel skips others, the plain version
    raises), appended to its group's bin; slots past a bin's count hold -1
    (mosaic_probe.py probe2).  The kernel fills a bin
    in the order its threads arrive: compare bins as sets (`bins_as_sets`)."""
    if gid.dim() != 2 or gid.shape[0] != 1 or gid.dtype != I32:
        raise ValueError(f"gid must be (1, n) int32, got {gid.dtype} {tuple(gid.shape)}")
    if not gid.is_cuda:
        return probe2_plain(gid, groups, cap)
    bins = torch.empty((groups, cap), dtype=I32, device=gid.device)
    cnt = torch.empty((1, groups), dtype=I32, device=gid.device)
    _launch("vpt_probe2", "probe2", _p(gid, I32), gid.shape[1], groups, cap, _p(bins, I32), _p(cnt, I32))
    return bins, cnt


def bins_as_sets(bins, cnt):
    """Each bin's filled slots in ascending order, -1 after them."""
    filled = torch.arange(bins.shape[1], device=bins.device)[None, :] < cnt.reshape(-1, 1)
    big = torch.iinfo(I32).max
    rows = torch.sort(torch.where(filled, bins, big), dim=1).values
    return torch.where(rows == big, -1, rows)


def mt_plain(rays, tris):
    """(R, T) t of ray r against triangle j, +inf where it is not a valid hit:
    traverse.moller_trumbore_scalar's order, which csrc/probe.cu repeats."""
    o = [rays[:, k : k + 1] for k in range(3)]
    d = [rays[:, 3 + k : 4 + k] for k in range(3)]
    t, _, _, ok = moller_trumbore_scalar(*o, *d, tris, MT_TMIN)
    return torch.where(ok, t, torch.inf)


def _mt_args(rays, tris):
    if rays.dim() != 2 or rays.shape[1] != 8 or tris.dim() != 2 or tris.shape[0] != 9:
        raise ValueError(f"rays must be (R, 8) and tris (9, T), got {tuple(rays.shape)} and {tuple(tris.shape)}")
    if rays.dtype != F32 or tris.dtype != F32:
        raise ValueError("rays and tris must be float32")
    return rays.shape[0], tris.shape[1]


def probe3(rays, tris):
    """Ray-major Moller-Trumbore (mosaic_probe.py probe3): (R, T) t or +inf,
    rays (R, 8), tris (9, T), R * T <= 1024 on the card (one block)."""
    n_rays, n_tris = _mt_args(rays, tris)
    if not rays.is_cuda:
        return mt_plain(rays, tris)
    if n_rays * n_tris > 1024:
        raise ValueError(f"probe3 takes R * T <= 1024 pairs in one block, got {n_rays} x {n_tris}")
    out = torch.empty((n_rays, n_tris), dtype=F32, device=rays.device)
    _launch("vpt_probe3", "probe3", _p(rays, F32), _p(tris, F32), n_rays, n_tris, _p(out, F32))
    return out


def probe10(rays, tris):
    """Scalar-broadcast Moller-Trumbore (mosaic_probe.py probe10): as probe3,
    a block per ray, T <= 1024 on the card."""
    n_rays, n_tris = _mt_args(rays, tris)
    if not rays.is_cuda:
        return mt_plain(rays, tris)
    if n_tris > 1024:
        raise ValueError(f"probe10 takes at most 1024 triangles (a thread each), got {n_tris}")
    out = torch.empty((n_rays, n_tris), dtype=F32, device=rays.device)
    _launch("vpt_probe10", "probe10", _p(rays, F32), _p(tris, F32), n_rays, n_tris, _p(out, F32))
    return out


def _timed_index(n_iter: int, perm, dev):
    i = torch.arange(n_iter, device=dev)
    return ((i % 64) // ROWS) * LANES + perm[0, i % PERM_LEN].long()


def probe4_plain(perm, x, n_iter: int = TIMED_ITERS):
    return ordered_sum(x.reshape(-1)[_timed_index(n_iter, perm, x.device)]).reshape(1, 1)


def probe4(perm, x, n_iter: int = TIMED_ITERS):
    """(1, 1) sum of x[(i % 64) // 8, perm[0, i % 1024]] over i < n_iter, in
    order: perm (1, 1024) int32 lanes, x (8, 128) (mosaic_probe.py
    probe4_timing)."""
    _check(perm, (1, PERM_LEN), I32, "perm")
    _check(x, (ROWS, LANES), F32, "x")
    if not x.is_cuda:
        return probe4_plain(perm, x, n_iter)
    out = torch.empty((1, 1), dtype=F32, device=x.device)
    _launch("vpt_probe4", "probe4", _p(perm, I32), _p(x, F32), n_iter, _p(out, F32))
    return out


def _last_store(idx, vals, size: int):
    """A zeroed (size,) float32 row after storing vals[i] at idx[i] in
    order, the vals increasing with i: the last store to a slot is its
    largest value."""
    return torch.zeros(size, dtype=F32, device=idx.device).scatter_reduce(0, idx, vals, "amax")


def probe5_plain(perm, n: int = LANES):
    i = torch.arange(n, device=perm.device)
    idx = (i % ROWS) * LANES + perm[0, :n].long()
    return _last_store(idx, (i + 1).to(F32), ROWS * LANES).reshape(ROWS, LANES)


def probe5(perm, n: int = LANES):
    """(8, 128) zeros with out[i % 8, perm[0, i]] = i + 1 stored for i < n in
    order (mosaic_probe.py probe5); perm (1, n) int32 lanes."""
    if perm.dim() != 2 or perm.shape[0] != 1 or perm.shape[1] < n or perm.dtype != I32:
        raise ValueError(f"perm must be (1, >= {n}) int32, got {perm.dtype} {tuple(perm.shape)}")
    if not perm.is_cuda:
        return probe5_plain(perm, n)
    out = torch.empty((ROWS, LANES), dtype=F32, device=perm.device)
    _launch("vpt_probe5", "probe5", _p(perm, I32), n, _p(out, F32))
    return out


def probe6_plain(perm, n_iter: int = TIMED_ITERS):
    i = torch.arange(n_iter, device=perm.device)
    return _last_store(_timed_index(n_iter, perm, perm.device), i.to(F32), ROWS * LANES).reshape(ROWS, LANES)


def probe6(perm, n_iter: int = TIMED_ITERS):
    """(8, 128) zeros with out[(i % 64) // 8, perm[0, i % 1024]] = i stored
    for i < n_iter in order (mosaic_probe.py probe6_timing)."""
    _check(perm, (1, PERM_LEN), I32, "perm")
    if not perm.is_cuda:
        return probe6_plain(perm, n_iter)
    out = torch.empty((ROWS, LANES), dtype=F32, device=perm.device)
    _launch("vpt_probe6", "probe6", _p(perm, I32), n_iter, _p(out, F32))
    return out


def probe8_plain(x, n: int):
    scratch = torch.zeros(n, dtype=I32, device=x.device)
    scratch[0] = x[0, 0]
    scratch[n - 1] = x[0, 0] + 1
    return (scratch[0] + scratch[n - 1]).reshape(1, 1)


def probe8(x, n: int):
    """(1, 1) int32: a scratch of n int32 in fast memory, written x and x + 1
    at its ends and read back summed (mosaic_probe.py probe8); x (1, 1)
    int32.  On the card the scratch is dynamic shared memory of 4n bytes:
    Refused above what a block may take."""
    _check(x, (1, 1), I32, "x")
    if n < 1:
        raise ValueError(f"probe8 takes a scratch of at least one int, got {n}")
    if not x.is_cuda:
        return probe8_plain(x, n)
    out = torch.empty((1, 1), dtype=I32, device=x.device)
    _launch("vpt_probe8", "probe8", _p(x, I32), n, _p(out, I32))
    return out


def probe9_plain(x):
    i = torch.arange(LANES, device=x.device)
    return ordered_sum(x.reshape(-1)[(i % ROWS) * LANES + (i * 37) % LANES]).reshape(1, 1)


def probe9(x):
    """(1, 1) sum of x[i % 8, (i * 37) % 128] over i < 128, in order, after
    an async copy of the (8, 128) float32 tile into fast memory
    (mosaic_probe.py probe9; cp.async.bulk on the card, which needs x on a
    16-byte boundary)."""
    _check(x, (ROWS, LANES), F32, "x")
    if not x.is_cuda:
        return probe9_plain(x)
    if x.data_ptr() % 16:
        raise ValueError("probe9's bulk copy needs x on a 16-byte boundary")
    out = torch.empty((1, 1), dtype=F32, device=x.device)
    _launch("vpt_probe9", "probe9", _p(x, F32), _p(out, F32))
    return out


def tile_sum(x):
    """The (8, 128) tile's float32 sum in the kernel's order: per warp of 32
    consecutive elements a butterfly (element l + element l + 16, then + 8,
    ... + 1), then the same butterfly over the 32 warp sums."""
    v = x.reshape(32, 32)
    for _ in range(2):
        for off in (16, 8, 4, 2, 1):
            v = v[:, :off] + v[:, off : 2 * off]
        v = v.reshape(1, -1)
    return v.reshape(())


def probe11_plain(x, n: int):
    i = torch.arange(n, device=x.device)
    total = tile_sum(x)
    last = torch.full((LANES,), -1, dtype=torch.int64, device=x.device).scatter_reduce(
        0, i % LANES, torch.where(total + i.to(F32) > -1.0, i, -1), "amax")  # the last drain stored in each slot
    return torch.where(last >= 0, total + last.clamp(min=0).to(F32), 0.0).reshape(1, LANES)


def probe11(x, n: int):
    """(1, 128): n drains, each w = sum(x) + i stored at out[0, i % 128]
    where w > -1, over slots that start at 0 (mosaic_probe.py
    probe11_drain_cost); x (8, 128) float32."""
    _check(x, (ROWS, LANES), F32, "x")
    if not x.is_cuda:
        return probe11_plain(x, n)
    out = torch.empty((1, LANES), dtype=F32, device=x.device)
    _launch("vpt_probe11", "probe11", _p(x, F32), n, _p(out, F32))
    return out


def smem_probe_plain(x):
    return (x[0, 0] + x[0, -1]).reshape(1, 1)


def smem_probe(x):
    """(1, 1) x[0, 0] + x[0, n - 1] with the whole (1, n) float32 operand in
    fast memory (smem_probe.py kernel): on the card, 4n bytes of dynamic
    shared memory, Refused above what a block may take."""
    if x.dim() != 2 or x.shape[0] != 1 or x.dtype != F32:
        raise ValueError(f"x must be (1, n) float32, got {x.dtype} {tuple(x.shape)}")
    if not x.is_cuda:
        return smem_probe_plain(x)
    out = torch.empty((1, 1), dtype=F32, device=x.device)
    _launch("vpt_smem_probe", "smem_probe", _p(x, F32), x.shape[1], _p(out, F32))
    return out


class ProbeCase(NamedTuple):
    """One probe kernel at its probe's shapes: the wrapper, its plain
    version, the arguments, the operations the call does, and one PyTorch
    call (or two: probe2's sort and counts) computing the same function
    where there is one, made so that a CUDA graph can hold it."""

    fn: Callable
    plain: Callable
    args: tuple
    ops: float
    library: Optional[Callable]
    replaces: str  # file:line of the Pallas kernel's probe function


def cases(device) -> dict:
    """{probe: ProbeCase} on `device`, at the JAX probes' inputs; where a
    sum's order decides its rounding (probes 4, 9, 11) the tile is random,
    so that only the plain version's order gives the kernel's bits."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def tile():
        return t(rng.normal(size=(ROWS, LANES)).astype(np.float32))

    rays, tris = (t(a) for a in mt_inputs())
    perm128, perm1k, gid = t(lane_perm(LANES)), t(lane_perm(PERM_LEN)), t(group_ids())
    x1, x4, x9, x11 = t(arange_tile()), tile(), tile(), tile()
    rows = torch.arange(LANES, device=dev) % ROWS
    vals5 = torch.arange(1, LANES + 1, device=dev, dtype=F32)
    g = gid[0].long()
    counts, ones = torch.zeros(BINS[0], dtype=torch.int64, device=dev), torch.ones_like(g)  # bincount, without its host read
    mt_ops = 53.0 * rays.shape[0] * tris.shape[1]  # Moller-Trumbore as csrc/trace.cu counts it
    mosaic = "scripts/mosaic_probe.py:"
    return {
        "probe1": ProbeCase(probe1, probe1_plain, (perm128, x1), 0.0, lambda: x1[rows, perm128[0]], f"{mosaic}29"),
        "probe2": ProbeCase(probe2, probe2_plain, (gid,), float(g.numel()),
                            lambda: (torch.sort(g, stable=True), counts.zero_().index_add_(0, g, ones)), f"{mosaic}59"),
        "probe3": ProbeCase(probe3, mt_plain, (rays, tris), mt_ops, None, f"{mosaic}102"),
        "probe4": ProbeCase(probe4, probe4_plain, (perm1k, x4), float(TIMED_ITERS), None, f"{mosaic}162"),
        "probe5": ProbeCase(probe5, probe5_plain, (perm128,), 0.0,
                            lambda: torch.zeros((ROWS, LANES), device=dev).index_put_((rows, perm128[0].long()),
                                                                                        vals5),
                            f"{mosaic}198"),
        "probe6": ProbeCase(probe6, probe6_plain, (t(lane_perm(PERM_LEN, shift=3)),), 0.0, None, f"{mosaic}230"),
        "probe8": ProbeCase(probe8, probe8_plain, (t(np.full((1, 1), 5, np.int32)), SCRATCH_KB[1] * 256), 2.0, None,
                            f"{mosaic}327"),
        "probe9": ProbeCase(probe9, probe9_plain, (x9,), float(LANES), None, f"{mosaic}354"),
        "probe10": ProbeCase(probe10, mt_plain, (rays, tris), mt_ops, None, f"{mosaic}389"),
        "probe11": ProbeCase(probe11, probe11_plain, (x11, DRAINS[1]), DRAINS[1] * (ROWS * LANES + 1.0),
                             lambda: torch.sum(x11), f"{mosaic}456"),
        "smem_probe": ProbeCase(smem_probe, smem_probe_plain, (t(np.arange(32768, dtype=np.float32).reshape(1, -1)),),
                                1.0, None, "scripts/smem_probe.py:16"),
    }


def same_result(probe: str, got, want) -> bool:
    """A kernel's result against its plain version's: bitwise, probe2's
    bins as sets and its counts exactly."""
    if probe == "probe2":
        return torch.equal(got[1], want[1]) and torch.equal(bins_as_sets(*got), bins_as_sets(*want))
    return got.dtype == want.dtype and torch.equal(got, want)


# -- The probes -----------------------------------------------------------------

def timed_ms(fn, dev: torch.device, reps: int = REPS, launches: int = LAUNCHES_PER_PAIR) -> float:
    """Milliseconds per call after a warm-up: on the card the median of `reps`
    CUDA-event pairs around `launches` calls; on the CPU one host-clock
    call."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def _how(dev: torch.device) -> str:
    return "CUDA events, launch included" if dev.type == "cuda" else "host clock, plain version"


def _word(ok: bool, bad: str = "FAIL") -> str:
    return "PASS" if ok else bad


class Prober:
    """The probes on one device; `out` takes each line, `ok` turns False on
    a wrong result, `refused` keeps each refused size's CUDA error name."""

    def __init__(self, dev: torch.device, out=print):
        self.dev, self.out, self.ok, self.refused = dev, out, True, {}

    def t(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.dev)

    def report(self, ok: bool, line: str) -> None:
        self.ok = self.ok and ok
        self.out(line)

    def probe1(self):
        x, perm = arange_tile(), lane_perm(LANES)
        got = probe1(self.t(perm), self.t(x)).cpu().numpy()
        ok = np.allclose(got[0], x[np.arange(LANES) % ROWS, perm[0]])
        self.report(ok, f"probe1 dynamic-lane scalar VMEM read: {_word(ok)}")

    def probe2(self):
        gid = group_ids()
        bins, cnt = (a.cpu() for a in probe2(self.t(gid)))
        ok = bool((cnt == gid.shape[1] // BINS[0]).all())
        sets = bins_as_sets(bins, cnt).numpy()
        for j in range(BINS[0]):
            want = np.flatnonzero(gid[0] == j)
            ok = ok and np.array_equal(sets[j, : want.size], want)
        self.report(ok, f"probe2 scalar SMEM binning: {_word(ok)}")

    def _mt(self, fn, line: str, bad: str):
        rays, tris = mt_inputs()
        got = fn(self.t(rays), self.t(tris)).cpu().numpy()
        ok = np.allclose(got, mt_oracle(rays, tris), rtol=1e-4, atol=1e-5, equal_nan=True)
        self.report(ok, f"{line}: {_word(ok, bad)}")

    def probe3(self):
        self._mt(probe3, "probe3 ray-major MT", "FAIL")

    def probe10(self):
        self._mt(probe10, "probe10 scalar-broadcast MT", "BAD VALUE")

    def probe5(self):
        perm = lane_perm(LANES)
        want = np.zeros((ROWS, LANES), np.float32)
        for i in range(LANES):
            want[i % ROWS, perm[0, i]] = i + 1
        ok = np.allclose(probe5(self.t(perm)).cpu().numpy(), want)
        self.report(ok, f"probe5 dynamic-lane scalar VMEM store: {_word(ok)}")

    def probe8(self):
        for kb in SCRATCH_KB:
            try:
                value = int(probe8(self.t(np.ones((1, 1), np.int32)), kb * 256).cpu()[0, 0])
            except Refused as e:
                self.refused[f"probe8 {kb} KB"] = e.name
                self.out(f"probe8 SMEM scratch {kb} KB: FAIL ({e.name}: {kb * 1024} bytes of shared memory refused)")
                break
            self.report(value == 3, f"probe8 SMEM scratch {kb} KB: {_word(value == 3, 'BAD VALUE')}")

    def probe9(self):
        x = arange_tile()
        got = float(probe9(self.t(x)).cpu()[0, 0])
        want = sum(float(x[i % ROWS, (i * 37) % LANES]) for i in range(LANES))
        ok = abs(got - want) < 1e-3
        self.report(ok, f"probe9 VMEM->SMEM DMA + scalar reads: {_word(ok, 'BAD VALUE')}")

    def _timed_check(self, got, want, line: str):
        """A timing probe's line, FAIL appended where its result is not the
        plain version's on the CPU."""
        ok = torch.equal(got.cpu(), want)
        self.report(ok, line if ok else f"{line}: FAIL (not its plain version's result)")

    def probe11(self):
        x = self.t(np.ones((ROWS, LANES), np.float32))
        for n in DRAINS:
            ms = timed_ms(lambda: probe11(x, n), self.dev)
            self._timed_check(probe11(x + 1.0, n), probe11_plain((x + 1.0).cpu(), n),
                              f"probe11 {n} drains(+sum): {ms:.4f} ms ({ms / n * 1e6:.1f} ns/drain incl. the launch; "
                              f"{_how(self.dev)})")

    def probe4(self):
        perm, x = self.t(lane_perm(PERM_LEN)), self.t(np.ones((ROWS, LANES), np.float32))
        ms = timed_ms(lambda: probe4(perm, x), self.dev)
        self._timed_check(probe4(perm, x + 1.0), probe4_plain(perm.cpu(), (x + 1.0).cpu()),
                          f"probe4 {TIMED_ITERS} dynamic scalar VMEM reads: {ms:.4f} ms "
                          f"({ms / TIMED_ITERS * 1e6:.2f} ns/read incl. the launch; {_how(self.dev)})")

    def probe6(self):
        perm = self.t(lane_perm(PERM_LEN))
        ms = timed_ms(lambda: probe6(perm), self.dev)
        p2 = self.t(lane_perm(PERM_LEN, shift=1))
        self._timed_check(probe6(p2), probe6_plain(p2.cpu()),
                          f"probe6 {TIMED_ITERS} dynamic scalar VMEM stores: {ms:.4f} ms "
                          f"({ms / TIMED_ITERS * 1e6:.2f} ns/store incl. the launch; {_how(self.dev)})")

    def probe7(self):
        """torch.sort and row gathers at the trace wrappers' shapes (plain
        XLA in the JAX probe, plain torch here); each call's input changes
        with its seed, as the JAX probe's does."""
        rng = np.random.default_rng(0)
        reps = REPS if self.dev.type == "cuda" else 1

        def ms(fn):
            return timed_ms(fn, self.dev, reps=reps, launches=1)

        for m in SORT_SIZES:
            vals = self.t(rng.integers(0, 1 << 28, m, dtype=np.int32))
            seed = iter(range(1 << 30))
            self.out(f"probe7 sort single-i32 {m}: {ms(lambda: torch.sort(vals ^ next(seed))):.2f} ms")
        fvals = self.t(rng.uniform(size=(12, SORT_ROWS)).astype(np.float32))
        for n_ops in SORT_OPS:
            seed = iter(range(1 << 30))

            def sortk(k=n_ops):
                key = (fvals[0] * 1e6).to(I32) + next(seed)
                perm = torch.sort(key, stable=True).indices
                return fvals[1:k][:, perm]

            self.out(f"probe7 sort {SORT_ROWS}x{n_ops}ops: {ms(sortk):.2f} ms")
        tbl = self.t(rng.uniform(size=(SORT_ROWS, 8)).astype(np.float32))
        local = (np.arange(SORT_ROWS) // 1024) * 1024 + (np.arange(SORT_ROWS) * 37) % 1024
        for name, perm in (("random", rng.permutation(SORT_ROWS)), ("local1k", np.clip(local, 0, SORT_ROWS - 1))):
            for rows in (SORT_ROWS, 2 * SORT_ROWS):
                idx = self.t(np.tile(perm, rows // SORT_ROWS))
                seed = iter(range(1 << 30))
                self.out(f"probe7 gather (262144,8) {name} x{rows}: "
                         f"{ms(lambda: torch.index_select(tbl + float(next(seed)), 0, idx)):.2f} ms")

    def smem(self):
        for kb in OPERAND_KB:
            n = kb * 256
            x = self.t(np.arange(n, dtype=np.float32).reshape(1, n))
            try:
                v = float(smem_probe(x).cpu()[0, 0])
            except Refused as e:
                self.refused[f"smem_probe {kb} KB"] = e.name
                self.out(f"SMEM {kb:5d} KB: FAIL {e.name}: {kb * 1024} bytes of shared memory refused")
                break
            ok = v == float(n - 1)
            self.report(ok, f"SMEM {kb:5d} KB: OK (checksum {v})" if ok else f"SMEM {kb:5d} KB: FAIL (checksum {v})")

    ORDER = ("probe2", "probe3", "probe8", "probe9", "probe10", "probe1", "probe5",  # mosaic_probe.main's
             "probe11", "probe4", "probe6", "probe7", "smem")

    def run(self) -> bool:
        for name in self.ORDER:
            getattr(self, name)()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.out(device_line(self.dev))
        return self.ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda (the kernels, the default) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    prober = Prober(resolve_device(args.device), out=lambda line: print(line, flush=True))
    return 0 if prober.run() else 1


if __name__ == "__main__":
    sys.exit(main())
