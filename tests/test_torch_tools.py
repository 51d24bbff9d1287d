"""The port's dispatch tools (python -m vpt_tpu_torch.tools.profile_dispatch,
quick_bench, sweep_bench) with --device cpu at 16x16, 1 spp, on a
brute-force scene (cornell_box) and a cluster scene (sphere_garden): each
prints the JAX scripts' lines (scripts/profile_dispatch.py,
scripts/quick_bench.py, scripts/sweep_bench.py) and exits 0; the sweep runs
two configurations, each in a process of its own."""

import os
import re
import subprocess
import sys

import pytest
import torch

from vpt_tpu_torch.tools import profile_dispatch, quick_bench, sweep_bench

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ["cornell_box", "sphere_garden"]


@pytest.mark.parametrize("scene", SCENES)
def test_profile_dispatch_on_the_cpu(scene, capsys):
    assert profile_dispatch.main(["16", "1", scene, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == profile_dispatch.EAGER_CPU  # the mode, first
    segs = int(re.fullmatch(r"segments per dispatch: (\d+)", lines[1]).group(1))
    assert segs >= 256  # at least one segment per pixel
    assert re.fullmatch(r"wall: [\d.]+ ms  \([\d.]+ M segs/s\)", lines[2])
    assert "lanes:" in lines and "  host: " in "\n".join(lines)
    top = lines.index(next(line for line in lines if line.startswith("top ops in 'host'")))
    ops = [line for line in lines[top + 1 :] if re.match(r"\s+[\d.]+ ms  x\d+ ", line)]
    assert 10 <= len(ops) <= profile_dispatch.TOP
    assert any(line.startswith("profile CPU ms") and "not measured (CPU)" in line for line in lines)
    assert lines[-1] == "cpu (no card: times are the host's)"


@pytest.mark.parametrize("scene", SCENES)
def test_quick_bench_on_the_cpu(scene, capsys):
    assert quick_bench.main(["16", "1", scene, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("layout: K=128 groups of 8 packets of 512 sort key fs sorted True trace stream")
    assert re.fullmatch(r"compile\+first: [\d.]+s  clusters=\d+", lines[1])
    assert sum(bool(re.fullmatch(r"dispatch \d: [\d.]+s  \d+ segments  [\d.]+ M segs/s", x)) for x in lines) == 3
    assert re.fullmatch(r"RESULT 128/fs/512/stream: median [\d.]+ M segs/s", lines[-2])
    assert lines[-1] == "cpu (no card: times are the host's)"


def test_sweep_bench_runs_each_configuration_in_its_own_process():
    """Two configurations of CONFIGS, K = 64 on the stream path and 256-ray
    packets with the fe key: each RESULT line names its layout."""
    proc = subprocess.run([sys.executable, "-m", "vpt_tpu_torch.tools.sweep_bench", "16", "1", "--scene",
                           "sphere_garden", "--device", "cpu", "--configs", "k64,packet256-fe"],
                          cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={k: v for k, v in os.environ.items() if not k.startswith("VPT_")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    summary = lines[lines.index("=== sweep summary ===") + 1 :]
    assert re.fullmatch(r"k64 +RESULT 64/fs/512/stream: median [\d.]+ M segs/s", summary[0])
    assert re.fullmatch(r"packet256-fe +RESULT 128/fe/256/packet: median [\d.]+ M segs/s", summary[1])
    assert summary[-1] == "cpu (no card: times are the host's)"
    assert [label for label, _ in sweep_bench.CONFIGS] == [
        "k64", "k128", "k256", "packet256-fs", "packet256-fe", "packet512-fs", "packet512-fe", "packet1024-fs",
        "packet1024-fe"]


def test_sweep_bench_refuses_an_unknown_configuration():
    with pytest.raises(ValueError, match="unknown configurations"):
        sweep_bench.sweep("16", "1", "cornell_box", "cpu", ["rows16"])
