"""The port runs where JAX is not installed: importing vpt_tpu_torch and every
module of the ported slice must pull in neither `jax` nor `vpt_tpu`."""

import os
import subprocess
import sys

import pytest

SLICE_MODULES = [
    "vpt_tpu_torch",
    "vpt_tpu_torch.device",
    "vpt_tpu_torch.api",
    "vpt_tpu_torch.accel.kernels",
    "vpt_tpu_torch.accel.bvh",
    "vpt_tpu_torch.accel.cluster",
    "vpt_tpu_torch.accel.traverse",
    "vpt_tpu_torch.accel.envelope",
    "vpt_tpu_torch.accel.stream",
    "vpt_tpu_torch.accel.occlude",
    "vpt_tpu_torch.core.rng",
    "vpt_tpu_torch.core.vecmath",
    "vpt_tpu_torch.core.camera",
    "vpt_tpu_torch.core.tiling",
    "vpt_tpu_torch.render.params",
    "vpt_tpu_torch.render.sampling",
    "vpt_tpu_torch.render.bsdf",
    "vpt_tpu_torch.render.surface",
    "vpt_tpu_torch.render.lights",
    "vpt_tpu_torch.render.lookup_fit",
    "vpt_tpu_torch.render.integrator",
    "vpt_tpu_torch.scene.types",
    "vpt_tpu_torch.scene.envmap",
    "vpt_tpu_torch.scene.procedural",
    "vpt_tpu_torch.scene.build",
    "vpt_tpu_torch.scene.convert",
]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("script", ["port", "chip_smoke"])
def test_imports_pull_in_no_jax(script):
    if script == "port":
        code = "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in SLICE_MODULES)
    else:
        code = "import importlib.util, sys\nsys.path.insert(0, '.')\nimport chip_smoke\n"
    code += (
        "import sys\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vpt_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
