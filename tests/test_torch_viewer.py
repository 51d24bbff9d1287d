"""The terminal viewer, the metrics log, the image metrics, the envguard
and the bench module of the port against the JAX package: the JAX
package's own viewer tests (tests/test_viewer.py) run against a port
TerminalViewer, and `ansi_frame` gives JAX's string; `Renderer(metrics_log=
path)` writes JAX's record keys, frames, seeds and spp, with segment sums
equal to `segments_traced`, and a dispatch record equals JAX's, its
rounding included; `psnr` and `ssim` equal JAX's; the envguard's
and the bench's refusals."""

import json

import numpy as np
import pytest
import torch

import test_viewer
from vpt_tpu.api import Renderer as JRenderer
from vpt_tpu.io import metrics as jmetrics
from vpt_tpu.io.metrics_log import RenderLog as JRenderLog
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.scene import procedural as jproc
from vpt_tpu.viewer import TerminalViewer as JViewer
from vpt_tpu_torch import bench, envguard
from vpt_tpu_torch.api import Renderer
from vpt_tpu_torch.io import metrics
from vpt_tpu_torch.io.metrics_log import RenderLog
from vpt_tpu_torch.render.params import RenderFlags
from vpt_tpu_torch.scene import procedural as tproc
from vpt_tpu_torch.viewer import TerminalViewer

torch.set_num_threads(1)

VIEWER = dict(width=32, height=32, samples_per_frame=1, max_samples=8, lookup_tables=None)
# The JAX package's viewer tests, in their order (they share one viewer).
VIEWER_CASES = [n for n in vars(test_viewer) if n.startswith("test_")]


@pytest.fixture(scope="module")
def viewer():
    r = Renderer(tproc.cornell_box(), flags=RenderFlags(max_depth=3, max_medium_events=2), device="cpu", **VIEWER)
    return TerminalViewer(r, cols=24)


@pytest.mark.parametrize("name", VIEWER_CASES)
def test_jax_viewer_case_against_the_port(name, viewer, monkeypatch):
    fn = getattr(test_viewer, name)
    fn(viewer, monkeypatch) if fn.__code__.co_argcount == 2 else fn(viewer)


def test_ansi_frame_equals_jax():
    flags = dict(max_depth=3, max_medium_events=2)
    ours = TerminalViewer(Renderer(tproc.cornell_box(), flags=RenderFlags(**flags), device="cpu", **VIEWER), cols=20)
    theirs = JViewer(JRenderer(jproc.cornell_box(), flags=JFlags(**flags), **VIEWER), cols=20)
    assert ours.move_speed == pytest.approx(theirs.move_speed, rel=1e-6)
    img = np.random.default_rng(1).uniform(-0.1, 1.1, (32, 32, 3)).astype(np.float32)
    ours.move_speed = theirs.move_speed
    assert ours.ansi_frame(img) == theirs.ansi_frame(img)
    for keys in ("wwd", "jji+"):
        assert ours.apply_keys(keys) == theirs.apply_keys(keys)
        np.testing.assert_allclose(ours.r.camera.position, theirs.r.camera.position, rtol=1e-6)
        assert (ours.r.camera.yaw, ours.r.camera.pitch) == pytest.approx((theirs.r.camera.yaw, theirs.r.camera.pitch))


def test_metrics_log_records_match_jax(tmp_path):
    kw = dict(width=24, height=24, samples_per_frame=2, max_samples=6, lookup_tables=None)
    flags = dict(max_depth=2, max_medium_events=0)
    logs = {}
    for tag, make in (("port", lambda p: Renderer(tproc.cornell_box(with_boxes=False), flags=RenderFlags(**flags),
                                                   metrics_log=p, device="cpu", **kw)),
                      ("jax", lambda p: JRenderer(jproc.cornell_box(with_boxes=False), flags=JFlags(**flags),
                                                  metrics_log=p, **kw))):
        path = str(tmp_path / f"{tag}.jsonl")
        r = make(path)
        r.render()
        logs[tag] = [json.loads(line) for line in open(path)]
        assert sum(d["segments"] for d in logs[tag]) == r.segments_traced
    ours, theirs = logs["port"], logs["jax"]
    assert [list(d) for d in ours] == [list(d) for d in theirs]
    for key in ("event", "frame", "seed", "spp", "samples_accumulated", "resolution", "scene"):
        assert [d[key] for d in ours] == [d[key] for d in theirs], key
    for d in ours:
        assert d["segments"] > 0 and d["wall_s"] > 0 and d["segs_per_s"] > 0
    for a, b in zip(ours, theirs):
        assert abs(a["segments"] - b["segments"]) <= 0.01 * b["segments"]


def test_metrics_log_null_and_object():
    r = Renderer(tproc.cornell_box(with_boxes=False), 8, 8, RenderFlags(max_depth=1, max_medium_events=0),
                 max_samples=2, lookup_tables=None, device="cpu")
    r.render()
    assert r.metrics.path is None and r.metrics.records == 2
    log = RenderLog.null()
    r = Renderer(tproc.cornell_box(with_boxes=False), 8, 8, RenderFlags(max_depth=1, max_medium_events=0),
                 max_samples=1, lookup_tables=None, metrics_log=log, device="cpu")
    r.render()
    assert r.metrics is log and log.records == 1


@pytest.mark.parametrize("wall_s,segments", [(0.123456789, 1234567.0), (2e-12, 3.0), (1.00005, 4650088.0)])
def test_dispatch_record_equals_jax(tmp_path, wall_s, segments):
    """The same dispatch gives JAX's record, its rounding included; the file
    holds that record as one JSON line."""
    kw = dict(frame=3, seed=2654435761, spp=4, wall_s=wall_s, segments=segments, samples_accumulated=12,
              resolution=(512, 256), scene="colonnade")
    log = RenderLog.open(str(tmp_path / "log.jsonl"))
    ours, theirs = log.dispatch(**kw), JRenderLog.null().dispatch(**kw)
    log.close()
    assert {k: v for k, v in ours.items() if k != "ts"} == {k: v for k, v in theirs.items() if k != "ts"}
    assert [json.loads(line) for line in open(tmp_path / "log.jsonl")] == [ours]


def test_psnr_and_ssim_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.random((40, 36, 3))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b) and metrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    assert metrics.psnr(a, b, data_range=10.0) == jmetrics.psnr(a, b, data_range=10.0)
    for x, y in ((a, b), (a[..., 0], b[..., 0]), (a * 5, b)):
        assert metrics.ssim(x, y) == jmetrics.ssim(x, y)
    with pytest.raises(ValueError):
        metrics.ssim(a, b[:-1])


@pytest.fixture
def clean_env(monkeypatch):
    import os

    for k in list(os.environ):
        if k.startswith("VPT_"):
            monkeypatch.delenv(k)
    return monkeypatch


def test_envguard_knob_and_goldens_mode(clean_env):
    assert envguard.poisoned_ablations() == []
    envguard.guard_ablations()
    envguard.require_clean_env()
    clean_env.setenv("VPT_TRACE", "packet")
    assert envguard.poisoned_ablations() == ["VPT_TRACE"]
    envguard.guard_ablations()  # allowed outside goldens mode
    clean_env.setenv("VPT_REQUIRE_GOLDENS", "1")
    with pytest.raises(RuntimeError, match="VPT_TRACE"):
        envguard.guard_ablations()
    clean_env.setenv("VPT_TRACE", "stream")
    envguard.guard_ablations()
    with pytest.raises(RuntimeError, match="VPT_TRACE"):
        envguard.require_clean_env()  # any VPT_* variable, even at its default
    clean_env.delenv("VPT_TRACE")
    envguard.require_clean_env()  # VPT_REQUIRE_GOLDENS itself is allowed


def test_bench_refuses_any_vpt_variable(clean_env):
    clean_env.setenv("VPT_CLUSTER_SIZE", "512")
    with pytest.raises(RuntimeError, match="VPT_CLUSTER_SIZE"):
        bench.main("cpu")


def test_bench_needs_a_cuda_device(clean_env):
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main("cpu")


def test_bench_screen_and_summary():
    """The outlier screen and the JSON line of root bench.py, with the card's
    description in place of the TPU-derived fields."""
    kept = []
    for rate in (10.0, 11.0, 9.0):
        assert bench.screen(kept, rate)
        kept.append((rate, rate * 2, 2.0))
    assert not bench.screen(kept, 31.0) and not bench.screen(kept, 3.0) and bench.screen(kept, 25.0)
    assert bench.prune(kept + [(40.0, 80.0, 2.0)]) == kept
    line = bench.summarize(kept + [(12.0, 24.0, 2.0)], 1, 1234, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert line["value"] == 10.5 and line["detail"]["dispatches"] == 4 and line["detail"]["discarded"] == 1
    assert line["detail"]["time_to_1024spp_s"] == 512.0 and line["detail"]["device"].endswith("700.00 W")
    assert not {"cycles_per_segment", "mt_utilization_pct"} & set(line["detail"])
