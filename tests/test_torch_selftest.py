"""The CLI's self-test and table bake on `--device cpu`: `furnace` passes
(mean error < 0.05, the JAX package's keys) and `bake-lookups` bakes into
the cache directory it is pointed at, with the JAX package's keys."""

import json
import os

import torch

from vpt_tpu_torch import cli
from vpt_tpu_torch.render import lookup

torch.set_num_threads(1)


def _run(argv, capsys) -> dict:
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_furnace_passes_on_the_cpu(capsys):
    line = _run(["furnace", "--device", "cpu", "--spp", "8"], capsys)
    assert set(line) == {"furnace_mean_error", "pass"} and line["pass"] and line["furnace_mean_error"] < 0.05


def test_bake_lookups_into_a_cache(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(lookup, "CACHE_DIR", str(tmp_path))
    line = _run(["bake-lookups", "--samples", "16", "--device", "cpu"], capsys)
    assert set(line) == {"tables", "seconds"}
    assert line["tables"] == [list(lookup.REFLECT_SHAPE), list(lookup.REFRACT_SHAPE), list(lookup.REFRACT_SHAPE)]
    assert sorted(os.listdir(tmp_path)) == [f"torch_lookup_{k}_16.npy" for k in ("reflect", "refract_in",
                                                                                  "refract_out")]
