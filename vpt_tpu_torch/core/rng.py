"""Carried-state PCG random numbers (port of vpt_tpu/core/rng.py).

The generator is bit-exact with the JAX package.  torch has no full uint32
arithmetic, so a state is an int64 tensor holding a value in [0, 2**32):
every product and sum is masked with `& 0xFFFFFFFF`.  The operands stay
below 2**63 (a 32-bit state times a 30-bit constant), so the int64 result
is exact before the mask and its low 32 bits are the uint32 result.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_UINT_MAX_F = 4294967295.0


def pcg_hash(x):
    """One round of the PCG-RXS-M-XS-32 output hash, on int64-held uint32
    tensors or on Python ints."""
    state = (x * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def seed(pixel_index: torch.Tensor, sample_index, frame_seed) -> torch.Tensor:
    """Initial per-ray state from (pixel, sample within frame, frame seed);
    the two scalar hashes run on the host."""
    s = pcg_hash((int(sample_index) & _MASK) ^ 0x9E3779B9)
    f = pcg_hash((int(frame_seed) + s) & _MASK)
    return (pixel_index.to(torch.int64) + f) & _MASK


def next_float(state: torch.Tensor):
    """Uniform float32 in [0, 1]: (new_state, draw), draw = state / UINT_MAX."""
    new = pcg_hash(state)
    return new, new.to(torch.float32) / torch.tensor(_UINT_MAX_F, dtype=torch.float32)


def next_float2(state: torch.Tensor):
    state, x1 = next_float(state)
    state, x2 = next_float(state)
    return state, torch.stack([x1, x2], dim=-1)


def next_float3(state: torch.Tensor):
    state, x1 = next_float(state)
    state, x2 = next_float(state)
    state, x3 = next_float(state)
    return state, torch.stack([x1, x2, x3], dim=-1)
