"""The port's command line (`python -m vpt_tpu_torch`) against the JAX
package's `vpt_tpu.cli.main`: a Cornell render with the HDR, metrics-log
and checkpoint options gives JAX's HDR within test_torch_render.py's bar
and its stats keys, and a resume continues the sample count; view refuses
to run without a TTY as JAX's does; the subcommands and flags are JAX's
plus `--device`, whose default is the card: without one the commands
fail.  (furnace and bake-lookups: test_torch_selftest.py.)"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vpt_tpu import cli as jcli
from vpt_tpu.io.metrics import psnr
from vpt_tpu_torch import cli

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER = ["render", "cornell", "--width", "16", "--height", "16", "--spp", "4", "--spp-per-frame", "2",
          "--depth", "3", "--no-energy-compensation"]


def _run(main, argv, capsys) -> dict:
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_render(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    out = str(tmp / "out.png")
    hdr = str(tmp / "out.npy")
    assert jcli.main(RENDER + ["-o", out, "--hdr-output", hdr]) == 0
    return np.load(hdr)


def test_render_matches_jax_cli(tmp_path, capsys, jax_render):
    out, hdr, log = (str(tmp_path / n) for n in ("out.png", "out.npy", "log.jsonl"))
    ckpt = str(tmp_path / "ckpt.npz")
    stats = _run(cli.main, RENDER + ["-o", out, "--hdr-output", hdr, "--metrics-log", log, "--checkpoint", ckpt,
                                     "--checkpoint-every", "1", "--device", "cpu"], capsys)
    assert set(stats) == {"output", "spp", "seconds", "render_seconds", "segments", "segments_per_sec",
                          "resolution"}
    assert stats["output"] == out and stats["spp"] == 4 and stats["resolution"] == [16, 16]
    got = np.load(hdr)
    p = psnr(np.clip(got, 0, 10), np.clip(jax_render, 0, 10), data_range=10.0)
    assert p > 40.0, f"PSNR {p:.1f} dB"
    assert np.isclose(got, jax_render, rtol=1e-3, atol=1e-4).all(axis=-1).mean() >= 0.99
    records = [json.loads(line) for line in open(log)]
    assert [r["frame"] for r in records] == [1, 2] and [r["samples_accumulated"] for r in records] == [2, 4]
    assert sum(r["segments"] for r in records) == stats["segments"]
    assert os.path.exists(ckpt)

    # A resume continues the count from the checkpoint, which the loop writes
    # after every dispatch but the last (frame 1, 2 spp, as JAX's CLI does):
    # two more dispatches to 6 spp, logged as frames 2 and 3.
    stats = _run(cli.main, RENDER[:7] + ["6"] + RENDER[8:] + ["-o", out, "--metrics-log", log, "--checkpoint", ckpt,
                                                               "--resume", "--device", "cpu"], capsys)
    assert stats["spp"] == 6
    records = [json.loads(line) for line in open(log)]
    assert [r["frame"] for r in records] == [1, 2, 2, 3]
    assert [r["samples_accumulated"] for r in records] == [2, 4, 4, 6]


def test_view_without_a_tty_raises_like_jax(monkeypatch):
    """`view` builds its Renderer with the default tables; the constant fit
    stands in for them here (a 4,096-sample bake takes minutes on a CPU)."""
    from vpt_tpu.render import lookup as jlookup
    from vpt_tpu_torch import api

    monkeypatch.setattr(jlookup, "get_lookup_tables", lambda **kw: None)
    monkeypatch.setattr(api, "get_lookup_tables", lambda **kw: None)
    monkeypatch.setattr(sys, "stdin", type("S", (), {"isatty": lambda s: False})())
    argv = ["view", "cornell", "--size", "8", "--spp", "1", "--depth", "2"]
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(RuntimeError, match="needs a TTY"):
            main(argv + extra)


def test_subcommands_and_flags_follow_jax():
    def flags(main, cmd):
        import argparse

        seen = {}

        def capture(self, args=None, namespace=None):
            seen["parser"] = self
            raise SystemExit(0)

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                main([cmd])
        finally:
            argparse.ArgumentParser.parse_args = orig
        sub = next(a for a in seen["parser"]._actions if isinstance(a, argparse._SubParsersAction))
        return {cmd: sorted(s for a in p._actions for s in a.option_strings) for cmd, p in sub.choices.items()}

    ours, theirs = flags(cli.main, "render"), flags(jcli.main, "render")
    assert sorted(ours) == sorted(theirs) == ["bake-lookups", "bench", "furnace", "render", "view"]
    for cmd in theirs:
        assert sorted(set(ours[cmd]) - {"--device"}) == theirs[cmd], cmd
        assert "--device" in ours[cmd]
    assert sorted(cli.BUILTIN) == ["cornell", "cornell-empty", "furnace", "garden"]


@pytest.mark.parametrize("argv", [["furnace", "--spp", "1"], ["render", "cornell", "--spp", "1"],
                                  ["bake-lookups", "--samples", "4"], ["bench"]])
def test_default_device_is_the_card(argv):
    """Without --device the commands run on cuda; with no CUDA device they fail
    and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run on it")
    proc = subprocess.run([sys.executable, "-m", "vpt_tpu_torch", *argv], cwd=_ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in proc.stderr
