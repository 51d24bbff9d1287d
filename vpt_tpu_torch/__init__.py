"""vpt_tpu_torch: the path tracer ported to PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A package beside `vpt_tpu`, with its module names.  It imports torch and
never JAX or `vpt_tpu`; the host scene code it needs is carried as
jax-free numpy copies.  Every function takes its device explicitly.
"""

import torch

# Camera and transform products stay in full float32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from vpt_tpu_torch.api import Renderer, render_step  # noqa: E402
from vpt_tpu_torch.render.params import RenderFlags  # noqa: E402

__all__ = ["Renderer", "RenderFlags", "render_step"]
