"""The probe kernels' plain versions (vpt_tpu_torch/tools/hopper_probe.py; the
kernels are csrc/probe.cu) against the JAX package's Mosaic probes,
scripts/mosaic_probe.py and scripts/smem_probe.py, on the CPU.

The JAX probes return PASS / FAIL only, so each test runs one probe with
`mosaic_probe.pl.pallas_call` wrapped (unittest.mock.patch) by a recorder
that keeps every call's inputs and outputs and runs it in interpret mode,
the timing probes' calls too (they pass no `interpret`, and their jax.jit
is lifted so that the outputs are concrete); neither scripts/ nor vpt_tpu/
changes.  smem_probe's module-level `kernel` is built into a pallas_call
in interpret mode here.  The port's plain version then runs on each
recorded call's inputs.

Tolerances: exact for probes 1, 2 (bins as sets, the counts exact), 4, 5,
6, 8, 11 and smem_probe (their inputs are integers, whose sums are exact in
any order); rtol 1e-4 / atol 1e-5 for the Moller-Trumbore probes 3 and 10,
JAX's own oracle tolerance (mosaic_probe.py:155), with the +inf entries
equal; probe9 exact, summed in JAX's order.  The command line on the CPU
prints every probe's line and imports no JAX.
"""

import importlib.util
import os
import re
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from vpt_tpu_torch.tools import hopper_probe as hp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name: str):
    """scripts/<name>.py loaded by path, as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


mosaic = _script("mosaic_probe")
smem = _script("smem_probe")


class _Recorder:
    """pl.pallas_call in interpret mode, keeping each call's (inputs,
    outputs) as numpy."""

    def __init__(self):
        self.calls = []
        self._pallas_call = pl.pallas_call

    def __call__(self, kernel, *args, **kw):
        f = self._pallas_call(kernel, *args, **dict(kw, interpret=True))

        def call(*inputs):
            out = f(*inputs)
            self.calls.append(([np.asarray(x) for x in inputs], jax.tree.map(np.asarray, out)))
            return out

        return call


class _Eager:
    """The jax module with jit the identity: the timing probes' pallas_call
    runs outside a trace, so its outputs can be recorded."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **_):
        return fn


def _record(run):
    """The pallas_call calls of one JAX probe run: [(inputs, outputs)]."""
    rec = _Recorder()
    with mock.patch.object(mosaic.pl, "pallas_call", rec), mock.patch.object(mosaic, "jax", _Eager()):
        ok = run()
    assert ok is not False, "the JAX probe reported FAIL"
    assert rec.calls
    return rec.calls


def _t(a):
    return torch.as_tensor(np.array(a))  # a writable copy


def _exact(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_probe1_plain_equals_jax():
    ((perm, x), out), = _record(lambda: mosaic.probe1(True))
    _exact(hp.probe1(_t(perm), _t(x)), out)
    np.testing.assert_array_equal(perm, hp.lane_perm(128))
    np.testing.assert_array_equal(x, hp.arange_tile())


def test_probe2_plain_equals_jax_as_sets():
    ((gid,), (bins, cnt)), = _record(lambda: mosaic.probe2(True))
    np.testing.assert_array_equal(gid, hp.group_ids())
    got_bins, got_cnt = hp.probe2(_t(gid))
    _exact(got_cnt, cnt)
    assert got_bins.shape == bins.shape == hp.BINS
    np.testing.assert_array_equal(hp.bins_as_sets(got_bins, got_cnt).numpy(),
                                  hp.bins_as_sets(_t(bins), _t(cnt)).numpy())
    assert int(got_cnt.sum()) == gid.shape[1]


@pytest.mark.parametrize("probe", ["probe3", "probe10"])
def test_moller_trumbore_plain_equals_jax(probe):
    run = mosaic.probe3 if probe == "probe3" else mosaic.probe10_scalar_mt_row
    ((rays, tris), out), = _record(lambda: run(True))
    want_rays, want_tris = hp.mt_inputs()
    np.testing.assert_array_equal(rays, want_rays)
    np.testing.assert_array_equal(tris, want_tris)
    got = getattr(hp, probe)(_t(rays), _t(tris)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(out))
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-5)
    assert np.isfinite(got).sum() > 0  # some pairs hit (6 of 1,024)


def test_probe4_plain_equals_jax():
    calls = _record(mosaic.probe4_timing)
    assert len(calls) == 6  # the warm-up and five timed calls, x + i
    for (perm, x), out in calls:
        _exact(hp.probe4(_t(perm), _t(x)), out)
    np.testing.assert_array_equal(calls[0][0][0], hp.lane_perm(hp.PERM_LEN))


def test_probe5_plain_equals_jax():
    ((perm,), out), = _record(lambda: mosaic.probe5(True))
    _exact(hp.probe5(_t(perm)), out)


def test_probe6_plain_equals_jax():
    calls = _record(mosaic.probe6_timing)
    assert len(calls) == 11  # the warm-up, five identical and five shifted permutations
    for (perm,), out in calls:
        _exact(hp.probe6(_t(perm)), out)
    assert not np.array_equal(calls[0][0][0], calls[-1][0][0])


def test_probe8_plain_equals_jax():
    calls = _record(lambda: mosaic.probe8_smem_capacity(True))
    assert len(calls) == len(hp.SCRATCH_KB)  # interpret mode takes every size
    for kb, ((x,), out) in zip(hp.SCRATCH_KB, calls):
        _exact(hp.probe8(_t(x), kb * 256), out)
        assert int(out[0, 0]) == 3


def test_probe9_plain_equals_jax_in_order():
    ((x,), out), = _record(lambda: mosaic.probe9_vmem_to_smem_dma(True))
    _exact(hp.probe9(_t(x)), out)


def test_probe11_plain_equals_jax():
    calls = _record(mosaic.probe11_drain_cost)
    assert len(calls) == 6 * len(hp.DRAINS)
    for k, ((x,), out) in enumerate(calls):
        _exact(hp.probe11(_t(x), hp.DRAINS[k // 6]), out)


@pytest.mark.parametrize("kb", [16, 64])
def test_smem_probe_plain_equals_jax(kb):
    n = kb * 256
    f = pl.pallas_call(
        smem.kernel,
        in_specs=[pl.BlockSpec((1, n), lambda: (0, 0), memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, 1), lambda: (0, 0), memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jax.numpy.float32),
        interpret=True,
    )
    x = np.arange(n, dtype=np.float32).reshape(1, n)
    want = np.asarray(f(x))
    _exact(hp.smem_probe(_t(x)), want)
    assert float(want[0, 0]) == n - 1


def test_tile_sum_is_the_kernels_butterfly():
    """probe11's plain tile sum adds in csrc/probe.cu's order: on a tile
    whose sum rounds, it equals a butterfly written out lane by lane."""
    x = np.random.default_rng(4).normal(size=(8, 128)).astype(np.float32)

    def butterfly(v):
        v = list(v)
        for off in (16, 8, 4, 2, 1):
            v = [np.float32(v[lane] + v[lane ^ off]) for lane in range(32)]
        return v[0]

    warps = [butterfly(x.reshape(32, 32)[w]) for w in range(32)]
    assert hp.tile_sum(_t(x)).item() == butterfly(warps)


LINES = ([r"probe2 scalar SMEM binning: PASS", r"probe3 ray-major MT: PASS"]
         + [rf"probe8 SMEM scratch {kb} KB: PASS" for kb in hp.SCRATCH_KB]
         + [r"probe9 VMEM->SMEM DMA \+ scalar reads: PASS", r"probe10 scalar-broadcast MT: PASS",
            r"probe1 dynamic-lane scalar VMEM read: PASS", r"probe5 dynamic-lane scalar VMEM store: PASS"]
         + [rf"probe11 {n} drains\(\+sum\): [\d.]+ ms \([\d.]+ ns/drain incl\. the launch; host clock, plain version\)"
            for n in hp.DRAINS]
         + [r"probe4 8192 dynamic scalar VMEM reads: [\d.]+ ms \([\d.]+ ns/read .*\)",
            r"probe6 8192 dynamic scalar VMEM stores: [\d.]+ ms \([\d.]+ ns/store .*\)"]
         + [rf"probe7 sort single-i32 {m}: [\d.]+ ms" for m in hp.SORT_SIZES]
         + [rf"probe7 sort 262144x{k}ops: [\d.]+ ms" for k in hp.SORT_OPS]
         + [rf"probe7 gather \(262144,8\) {name} x{rows}: [\d.]+ ms" for name in ("random", "local1k")
            for rows in (262144, 524288)]
         + [rf"SMEM {kb:5d} KB: OK \(checksum {kb * 256 - 1}\.0\)" for kb in hp.OPERAND_KB]
         + [r"cpu \(no card: times are the host's\)"])


def test_command_line_on_the_cpu_prints_every_probe_and_imports_no_jax():
    """`python -m vpt_tpu_torch.tools.hopper_probe --device cpu`: exit 0,
    every probe's line in mosaic_probe.main's order, then smem_probe's;
    `-X importtime` lists every module the run imports, and none is JAX's
    or the JAX package's."""
    proc = subprocess.run([sys.executable, "-X", "importtime", "-m", "vpt_tpu_torch.tools.hopper_probe", "--device",
                           "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == len(LINES), lines
    for line, pattern in zip(lines, LINES):
        assert re.fullmatch(pattern, line), (line, pattern)
    imported = [m.group(1).strip() for m in re.finditer(r"^import time:[^|]*\|[^|]*\|\s*(\S+)", proc.stderr, re.M)]
    assert "vpt_tpu_torch.tools.hopper_probe" in imported or "vpt_tpu_torch.accel.kernels" in imported
    assert not [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "vpt_tpu")]


def test_command_line_takes_no_card_it_does_not_have():
    """--device cuda where torch has no CUDA device raises, as every entry
    point of the port does: there is no fallback to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        hp.main(["--device", "cuda"])
