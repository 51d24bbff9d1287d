"""The four hand-written CUDA kernels of vpt_tpu_torch against their plain
torch versions, on a CUDA device at small shapes.  These tests skip where
there is no CUDA device; they import no JAX, so on a GPU machine without
JAX run them with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from vpt_tpu_torch.accel import envelope, occlude, stream
from vpt_tpu_torch.accel.bvh import LEAF_SIZE, build_bvh
from vpt_tpu_torch.accel.cluster import assemble_clusters, build_mesh_clusters
from vpt_tpu_torch.scene.types import tree_to_device

pytestmark = pytest.mark.gpu
T_MIN = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _clusters(dev, instanced: bool):
    rng = np.random.default_rng(5)
    v0 = rng.uniform(-4, 4, (3000, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.5, 0.5, (3000, 3)).astype(np.float32)
    order = build_bvh(v0, v1, v2).tri_order

    def pad(a):
        return np.concatenate([a, np.zeros((LEAF_SIZE, 3), np.float32)])

    mc = build_mesh_clusters(build_bvh(v0, v1, v2), pad(v0[order]), pad((v1 - v0)[order]), pad((v2 - v0)[order]))
    specs = [(0, np.eye(4, dtype=np.float32), 0)]
    if instanced:
        m = np.diag([0.8, 1.3, 1.0, 1.0]).astype(np.float32)
        m[:3, 3] = [7.0, 0.5, -1.0]
        specs.append((1, m, 10000))
    return tree_to_device(assemble_clusters([mc, mc] if instanced else [mc], specs), dev), rng


def _rays(rng, dev, n=5000):
    org = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = rng.uniform(-3, 3, (n, 3)).astype(np.float32) - org
    d = np.where((np.arange(n) % 2 == 0)[:, None], aim, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[0] = (1.0, 0.0, 0.0)  # axis-aligned
    return torch.tensor(org, device=dev), torch.tensor(d, device=dev)


@pytest.mark.parametrize("levels", [1, 2])
def test_envelope_kernels_match_plain(cuda, levels):
    cl, rng = _clusters(cuda, instanced=False)
    org, d = _rays(rng, cuda)
    active = torch.tensor(rng.uniform(size=org.shape[0]) < 0.9, device=cuda)
    b = stream.prepare_bands(org, d, cl, T_MIN, 1e8, active, levels=levels)
    gmin, gmax = stream.pad_groups(cl)
    args = (b.origin, stream.guarded_inverse(b.direction), b.tmax, gmin, gmax, T_MIN)
    assert torch.equal(envelope.ray_keys(*args, levels), envelope.ray_keys_plain(*args, levels))
    assert torch.equal(envelope.supertile_tables(*args), envelope.supertile_tables_plain(*args))


@pytest.mark.parametrize("instanced", [False, True])
def test_stream_kernel_matches_plain(cuda, instanced):
    cl, rng = _clusters(cuda, instanced)
    org, d = _rays(rng, cuda)
    n = org.shape[0]
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    b = stream.trace_bands(org, d, cl, T_MIN, 1e8, active, torch.tensor(np.arange(n) % 4 == 0, device=cuda))
    tk, trk, uk, vk = stream.stream_trace(b, cl, T_MIN)
    tp, trp, up, vp = stream.stream_trace_plain(b, cl, T_MIN)
    torch.cuda.synchronize()
    closest = (b.payload[0] & 2) == 0
    assert torch.allclose(tk[closest], tp[closest], rtol=1e-5, atol=1e-6)
    same = trk == trp
    tie = (tk - tp).abs() <= 1e-5 + 1e-5 * tp.abs()
    assert bool((same | (tie & (trp >= 0)) | ~closest).all())
    assert torch.allclose(uk[same & closest], up[same & closest], rtol=1e-4, atol=1e-5)
    assert torch.equal(trk >= 0, trp >= 0)  # any-hit rays: a hit iff one exists
    assert int((trk >= 0).sum()) > 500


def test_occlude_kernel_matches_plain(cuda):
    cl, rng = _clusters(cuda, instanced=True)
    org, d = _rays(rng, cuda)
    n = org.shape[0]
    active = torch.tensor(rng.uniform(size=n) < 0.9, device=cuda)
    extri = torch.tensor(rng.integers(-1, 3000, n).astype(np.int32), device=cuda)
    tmax = torch.tensor(rng.uniform(0.5, 20.0, n).astype(np.float32), device=cuda)
    b = occlude.shadow_bands(org, d, cl, T_MIN, tmax, active, extri)
    blocked = occlude.occlude_trace(b, cl, T_MIN)
    assert torch.equal(blocked, occlude.occlude_trace_plain(b, cl, T_MIN))
    assert int(blocked.sum()) > 200
