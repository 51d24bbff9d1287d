"""The port's sharded render on torch.distributed, on the CPU: rank groups of
2 and 4 processes on gloo (started by dryrun.run_ranks), cornell 16^2
without boxes, depth 3, against the port's one-process render_samples over
the same row-major pixels at the same seeds.

Every mesh shape draws the one-process sample set, so its image agrees
above 60 dB PSNR (peak = the reference's maximum) and its segment count is
equal: the brute-force trace and the shading are per lane, and no path of
depth 3 reaches the iteration cap.  This file imports neither JAX nor the
JAX package (tests/test_torch_dist_jax.py holds the port against JAX)."""

import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vpt_tpu_torch.core import rng
from vpt_tpu_torch.core.camera import perspective
from vpt_tpu_torch.dist import dryrun, mesh
from vpt_tpu_torch.render import integrator
from vpt_tpu_torch.render.params import RenderFlags, default_params
from vpt_tpu_torch.scene.build import compile_scene
from vpt_tpu_torch.scene.procedural import cornell_box

torch.set_num_threads(1)

SIZE = 16
FLAGS = RenderFlags(max_depth=3, max_medium_events=2)
SHAPES_2 = [(2, 1), (1, 2)]
SHAPES_4 = [(4, 1), (2, 2), (1, 4)]
BANDS = [2, 3]  # 3 bands of 6 rows: the last one is short (4 rows + 2 pad rows)


@pytest.fixture(scope="module")
def setup():
    data, meta, aux = compile_scene(cornell_box(with_boxes=False), device="cpu")
    cameras = (np.linalg.inv(aux["camera_view"]), np.linalg.inv(perspective(np.radians(aux["camera_fov_deg"]), 1.0)))
    return data, meta, cameras


def _one_process(setup, pixel_xy, pixel_index, resolution, seed, n_samples, sample_offset=0):
    data, meta, cameras = setup
    rad, segs, _ = integrator.render_samples(data, meta, FLAGS, default_params(*cameras, device="cpu"),
                                             torch.as_tensor(pixel_xy), torch.as_tensor(pixel_index), resolution,
                                             seed, n_samples, sample_offset=sample_offset)
    return rad.numpy(), int(segs)


@pytest.fixture(scope="module")
def single(setup):
    """One-process renders: the 16^2 frame at seeds 99 and 1234 (4 spp), the
    2 pad rows of the short band, and the 15x13 frame at seed 7 (1 spp)."""
    pxy, pidx = mesh.pixel_grid(SIZE, SIZE)
    out = {seed: _one_process(setup, pxy, pidx, (SIZE, SIZE), seed, 4) for seed in (99, 1234)}
    n_pad = 2 * SIZE
    out["band_pad"] = _one_process(setup, np.zeros((n_pad, 2), np.float32), SIZE * SIZE + np.arange(n_pad),
                                   (SIZE, SIZE), 1234, 4)
    pxy, pidx = mesh.pixel_grid(15, 13)
    out["odd"] = _one_process(setup, pxy, pidx, (15, 13), 7, 1)
    out["odd_pad"] = _one_process(setup, np.zeros((1, 2), np.float32), np.array([15 * 13]), (15, 13), 7, 1)
    return out


def _jobs(shapes, tiled_shape=None):
    jobs = [("sharded", s, (SIZE, SIZE), 99, 4) for s in shapes]
    if tiled_shape is not None:
        jobs += [("tiled", tiled_shape, (SIZE, SIZE), 1234, 4, rows) for rows in BANDS]
        jobs += [("sharded", (4, 1), (15, 13), 7, 1)] * 2
    return jobs


@pytest.fixture(scope="module")
def ranks(setup):
    """Rank results {n_ranks: [(results, foreign modules) by rank]}: the 2-rank
    group renders SHAPES_2, the 4-rank group SHAPES_4, the tiled frames on
    (2, 2) and the 15x13 frame twice on (4, 1)."""
    data, meta, cameras = setup
    host = dryrun.host_tree(data)
    return {
        2: dryrun.run_ranks(2, dryrun.render_jobs, host, meta, FLAGS, cameras, _jobs(SHAPES_2), "cpu", device="cpu"),
        4: dryrun.run_ranks(4, dryrun.render_jobs, host, meta, FLAGS, cameras, _jobs(SHAPES_4, (2, 2)), "cpu",
                            device="cpu"),
    }


def _result(ranks, shape):
    n = shape[0] * shape[1]
    shapes = SHAPES_2 if n == 2 else SHAPES_4
    return ranks[n][0][0][shapes.index(shape)]


@pytest.mark.parametrize("shape", SHAPES_2 + SHAPES_4)
def test_mesh_shape_agrees_with_one_process_render(ranks, single, shape):
    img, _ = _result(ranks, shape)
    want = single[99][0].reshape(SIZE, SIZE, 3)
    assert img.shape == (SIZE, SIZE, 3) and np.isfinite(img).all() and img.max() > 0
    assert dryrun.psnr_peak(want, img) > 60.0
    assert dryrun.psnr_peak(_result(ranks, (4, 1))[0], img) > 60.0


@pytest.mark.parametrize("shape", SHAPES_2 + SHAPES_4)
def test_mesh_shape_segments_equal_one_process(ranks, single, shape):
    assert _result(ranks, shape)[1] == single[99][1]


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_every_rank_returns_the_whole_image_and_loads_no_jax(ranks, n_ranks):
    group = ranks[n_ranks]
    assert len(group) == n_ranks
    for results, foreign in group:
        assert foreign == []
        for (img, segs), (img0, segs0) in zip(results, group[0][0]):
            assert np.array_equal(img, img0) and segs == segs0


@pytest.mark.parametrize("bands", BANDS)
def test_tiled_final_frame(ranks, single, bands):
    img, segs = ranks[4][0][0][len(SHAPES_4) + BANDS.index(bands)]
    assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.float32 and np.isfinite(img).all()
    assert isinstance(segs, float)
    want, want_segs = single[1234]
    assert dryrun.psnr_peak(want.reshape(SIZE, SIZE, 3), img) > 60.0
    # The short band's 2 pad rows trace pixel (0, 0) and count, as in JAX.
    assert segs == want_segs + (single["band_pad"][1] if bands == 3 else 0)


def test_nondivisible_frame_is_deterministic_and_pads(ranks, single):
    results = ranks[4][0][0]
    (a, sa), (b, sb) = results[-2], results[-1]
    assert a.shape == (13, 15, 3) and np.isfinite(a).all() and a.max() > 0
    assert np.array_equal(a, b) and sa == sb
    want, want_segs = single["odd"]
    assert dryrun.psnr_peak(want.reshape(13, 15, 3), a) > 60.0
    assert sa == want_segs + single["odd_pad"][1]  # 195 pixels + 1 pad lane


def test_pixel_grid_and_pad():
    pxy, pidx = mesh.pixel_grid(15, 13)
    assert pxy.shape == (195, 2) and pidx.dtype == np.int64
    assert np.array_equal(pidx, pxy[:, 0] + 15 * pxy[:, 1])
    pxy2, pidx2, pad = mesh._pad_pixels(pxy, pidx, 4, 195)
    assert pad == 1 and pxy2.shape == (196, 2) and np.array_equal(pxy2[-1], [0, 0]) and pidx2[-1] == 195
    assert mesh._pad_pixels(pxy, pidx, 5, 195)[2] == 0


@pytest.mark.parametrize("n_samples, n_spp, ok", [(4, 2, True), (4, 4, True), (3, 2, False), (1, 2, False)])
def test_check_samples(n_samples, n_spp, ok):
    if ok:
        mesh._check_samples(n_samples, n_spp)
    else:
        with pytest.raises(AssertionError, match="positive multiple of the spp axis"):
            mesh._check_samples(n_samples, n_spp)


@pytest.fixture
def one_rank_group():
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_make_mesh_asserts_its_size_and_renders_one_rank_bitwise(one_rank_group, setup, single):
    with pytest.raises(AssertionError, match=r"mesh 2x1 != 1 devices"):
        mesh.make_mesh(tile=2, device_type="cpu")
    m = mesh.make_mesh(device_type="cpu")
    assert m.mesh_dim_names == ("tile", "spp") and tuple(m.mesh.shape) == (1, 1)
    data, meta, cameras = setup
    img, segs = mesh.render_sharded(data, meta, FLAGS, default_params(*cameras, device="cpu"), (SIZE, SIZE), 99, 4, m)
    assert segs.dtype == torch.int64 and segs.ndim == 0 and int(segs) == single[99][1]
    assert np.array_equal(img.numpy(), single[99][0].reshape(SIZE, SIZE, 3))


def test_make_mesh_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_mesh()


@pytest.mark.parametrize("n_samples", [2, 9])  # precomputed primary rays, and reseeded above 8 samples
def test_sample_offset_wraps_as_uint32(setup, n_samples):
    idx = torch.tensor([2**32 - 1, 2**32, 2**32 + 5])
    pidx = torch.arange(3)
    got = rng.seed(pidx, idx, 1234)
    want = torch.cat([rng.seed(pidx[i: i + 1], s, 1234) for i, s in enumerate((2**32 - 1, 0, 5))])
    assert torch.equal(got, want)
    # Samples 2**32 - 1, 0, 1, ..., n - 2: the first alone plus n - 1 from 0.
    pxy, pidx = mesh.pixel_grid(8, 8)
    got, got_segs = _one_process(setup, pxy, pidx, (8, 8), 5, n_samples, sample_offset=2**32 - 1)
    last, last_segs = _one_process(setup, pxy, pidx, (8, 8), 5, 1, sample_offset=2**32 - 1)
    rest, rest_segs = _one_process(setup, pxy, pidx, (8, 8), 5, n_samples - 1)
    np.testing.assert_allclose(got * n_samples, last + rest * (n_samples - 1), rtol=1e-5, atol=1e-6)
    assert got_segs == last_segs + rest_segs


def test_dryrun_multichip_prints_ok(capsys):
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK: shapes [(4, 1), (2, 2), (1, 4)]" in capsys.readouterr().out
    assert all(p > 60.0 for p in out["psnr"].values())


def test_entry_renders_the_cornell_step():
    fn, args = dryrun.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (32 * 32, 3) and bool(torch.isfinite(out).all()) and float(out.mean()) > 0
    assert torch.equal(fn(*args), out)


def test_a_rank_that_raises_fails_the_launch():
    with pytest.raises(Exception, match="invalid literal"):
        dryrun.run_ranks(2, int, "not a number", device="cpu")
