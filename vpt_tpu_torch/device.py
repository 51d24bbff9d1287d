"""Device selection for the port: always from an explicit argument.

Nothing on the render path picks "cuda if available else cpu"; callers name
the device, and asking for CUDA where there is none is an error.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """A `torch.device` from a device, a string such as "cuda:0", or an index."""
    if device is None:
        raise ValueError("pass a device explicitly, e.g. 'cpu' or 'cuda'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev
