"""Volume grids: dense loaders and procedural generators (jax-free copy of
vpt_tpu/scene/vdb.py).

Dense (D, H, W) float32 bricks are the device format.  `load_grid` reads
`.npy` / `.npz` and OpenVDB `.vdb` files (scene/vdb_reader.py, with zlib,
blosc and half-float value buffers).  The procedural fbm cloud and smoke
plume draw from numpy's generator with the JAX package's seeds and give the
same grids.
"""

from __future__ import annotations

import numpy as np


def load_grid(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    if path.endswith(".npz"):
        d = np.load(path)
        key = "density" if "density" in d else list(d.keys())[0]
        return np.asarray(d[key], np.float32)
    if path.endswith(".vdb"):
        from vpt_tpu_torch.scene.vdb_reader import read_vdb

        return read_vdb(path).values
    if path.endswith(".nvdb"):
        raise NotImplementedError("NanoVDB (.nvdb) is a GPU-baked format; load the source .vdb instead")
    raise ValueError(f"unsupported grid format: {path}")


def _value_noise3(shape, freq, rng):
    """Trilinear value noise at integer lattice frequency."""
    d, h, w = shape
    lattice = rng.random((freq + 1, freq + 1, freq + 1)).astype(np.float32)
    zs = np.linspace(0, freq, d, endpoint=False)
    ys = np.linspace(0, freq, h, endpoint=False)
    xs = np.linspace(0, freq, w, endpoint=False)
    z0, y0, x0 = zs.astype(int), ys.astype(int), xs.astype(int)
    fz = (zs - z0)[:, None, None]
    fy = (ys - y0)[None, :, None]
    fx = (xs - x0)[None, None, :]

    def g(dz, dy, dx):
        return lattice[np.minimum(z0 + dz, freq)][:, np.minimum(y0 + dy, freq)][:, :, np.minimum(x0 + dx, freq)]

    c00 = g(0, 0, 0) * (1 - fx) + g(0, 0, 1) * fx
    c01 = g(0, 1, 0) * (1 - fx) + g(0, 1, 1) * fx
    c10 = g(1, 0, 0) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(1, 1, 0) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def fbm_noise(shape=(64, 64, 64), octaves=4, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.zeros(shape, np.float32)
    amp, freq, total = 1.0, 4, 0.0
    for _ in range(octaves):
        out += amp * _value_noise3(shape, freq, rng)
        total += amp
        amp *= 0.5
        freq *= 2
    return out / total


def procedural_cloud(shape=(64, 64, 64), coverage=0.45, seed=0) -> np.ndarray:
    """Puffy cloud: fbm density carved by a squashed-sphere falloff."""
    noise = fbm_noise(shape, octaves=4, seed=seed)
    d, h, w = shape
    z, y, x = np.meshgrid(np.linspace(-1, 1, d), np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    shell = np.clip(1.0 - np.sqrt(x * x + (y * 1.6) ** 2 + z * z), 0.0, 1.0)
    dens = np.clip(noise - (1.0 - coverage), 0.0, None) * shell
    m = dens.max()
    return (dens / m if m > 0 else dens).astype(np.float32)


def procedural_smoke_plume(shape=(96, 64, 64), seed=3) -> np.ndarray:
    """Rising plume: radius tapering with height, plus swirl noise."""
    noise = fbm_noise(shape, octaves=5, seed=seed)
    d, h, w = shape
    z, y, x = np.meshgrid(np.linspace(-1, 1, d), np.linspace(0, 1, h), np.linspace(-1, 1, w), indexing="ij")
    radius = 0.15 + 0.5 * y
    cx = 0.25 * np.sin(4.0 * y)  # wobble
    rr = np.sqrt((x - cx) ** 2 + z * z)
    core = np.clip(1.0 - rr / np.maximum(radius, 1e-3), 0.0, 1.0)
    fade = np.clip(1.2 - y, 0.0, 1.0)
    dens = core * fade * (0.4 + 0.6 * noise)
    m = dens.max()
    return (dens / m if m > 0 else dens).astype(np.float32)
