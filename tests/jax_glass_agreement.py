"""How closely the JAX package agrees with itself on the glass golden's
configuration (tests/test_golden.py's glass Cornell box, 48x48, 24 spp,
depth 8, seed 17), beside the port: its jitted render, its op-by-op render
(`jax.disable_jit()`, about 6 minutes on a CPU) and the port's CPU render,
each pair's PSNR on the images clipped to [0, 10] and share of pixels
within rtol 1e-3 / atol 1e-4.  tests/test_torch_golden.py takes its glass
bar (CLOSE_SHARE) from this.  Run from the repository root:

    JAX_PLATFORMS=cpu python tests/jax_glass_agreement.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from tests import torch_goldens  # noqa: E402
from tests.test_torch_golden import _jax_glass  # noqa: E402
from vpt_tpu_torch.io.metrics import psnr  # noqa: E402


def agreement(a, b) -> str:
    close = np.isclose(a, b, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    return (f"PSNR {psnr(np.clip(a, 0, 10), np.clip(b, 0, 10), 10.0):.2f} dB, {100 * close:.2f}% of pixels close, "
            f"max abs diff {np.abs(a - b).max():.3g}")


def main() -> None:
    port = torch_goldens.render(torch_goldens.glass("cpu"))
    jitted = _jax_glass()
    with jax.disable_jit():
        eager = _jax_glass()
    print("port against JAX jitted:", agreement(port, jitted))
    print("port against JAX op by op:", agreement(port, eager))
    print("JAX jitted against JAX op by op:", agreement(jitted, eager))


if __name__ == "__main__":
    main()
