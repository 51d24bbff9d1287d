"""The port runs where JAX, PIL and imageio are not installed: importing
vpt_tpu_torch and every module of the ported slice, or chip_smoke.py, must
pull in neither `jax`, `vpt_tpu`, `PIL` nor `imageio`."""

import os
import subprocess
import sys

import pytest

SLICE_MODULES = [
    "vpt_tpu_torch",
    "vpt_tpu_torch.device",
    "vpt_tpu_torch.api",
    "vpt_tpu_torch.cli",
    "vpt_tpu_torch.bench",
    "vpt_tpu_torch.envguard",
    "vpt_tpu_torch.viewer",
    "vpt_tpu_torch.gallery",
    "vpt_tpu_torch.accel.kernels",
    "vpt_tpu_torch.accel.bvh",
    "vpt_tpu_torch.accel.cluster",
    "vpt_tpu_torch.accel.traverse",
    "vpt_tpu_torch.accel.envelope",
    "vpt_tpu_torch.accel.stream",
    "vpt_tpu_torch.accel.occlude",
    "vpt_tpu_torch.accel.visit",
    "vpt_tpu_torch.core.rng",
    "vpt_tpu_torch.core.vecmath",
    "vpt_tpu_torch.core.camera",
    "vpt_tpu_torch.core.tiling",
    "vpt_tpu_torch.io.image",
    "vpt_tpu_torch.io.codec",
    "vpt_tpu_torch.io.jpeg",
    "vpt_tpu_torch.io.metrics",
    "vpt_tpu_torch.io.metrics_log",
    "vpt_tpu_torch.post.tonemap",
    "vpt_tpu_torch.post.bloom",
    "vpt_tpu_torch.render.params",
    "vpt_tpu_torch.render.sampling",
    "vpt_tpu_torch.render.bsdf",
    "vpt_tpu_torch.render.surface",
    "vpt_tpu_torch.render.lights",
    "vpt_tpu_torch.render.lookup_fit",
    "vpt_tpu_torch.render.lookup",
    "vpt_tpu_torch.render.loop",
    "vpt_tpu_torch.render.volumes",
    "vpt_tpu_torch.render.atmosphere",
    "vpt_tpu_torch.render.integrator",
    "vpt_tpu_torch.scene.types",
    "vpt_tpu_torch.scene.envmap",
    "vpt_tpu_torch.scene.procedural",
    "vpt_tpu_torch.scene.build",
    "vpt_tpu_torch.scene.vdb",
    "vpt_tpu_torch.scene.vdb_reader",
    "vpt_tpu_torch.scene.blosc",
    "vpt_tpu_torch.scene.gltf",
    "vpt_tpu_torch.scene.convert",
    "vpt_tpu_torch.dist",
    "vpt_tpu_torch.dist.mesh",
    "vpt_tpu_torch.dist.dryrun",
    "vpt_tpu_torch.tools.common",
    "vpt_tpu_torch.tools.profile_dispatch",
    "vpt_tpu_torch.tools.quick_bench",
    "vpt_tpu_torch.tools.sweep_bench",
    "vpt_tpu_torch.tools.hopper_probe",
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vpt_tpu', 'PIL', 'imageio'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_modules():
    """Every module of vpt_tpu_torch, by its file."""
    pkg = os.path.join(_ROOT, "vpt_tpu_torch")
    names = []
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if os.path.exists(os.path.join(dirpath, d, "__init__.py")))
        rel = os.path.relpath(dirpath, _ROOT).replace(os.sep, ".")
        names += [rel if f == "__init__.py" else f"{rel}.{f[:-3]}" for f in sorted(files) if f.endswith(".py")]
    return names


def _is_cpu(value) -> bool:
    import torch

    return (isinstance(value, str) and value.split(":")[0] == "cpu") or (
        isinstance(value, torch.device) and value.type == "cpu")


@pytest.mark.parametrize("module", _port_modules())
def test_entry_points_default_to_the_card(module):
    """No public function, class or method of the port takes a `device`
    whose default is the CPU: its entry points run on the card unless the
    caller asks for the CPU."""
    import importlib
    import inspect

    mod = importlib.import_module(module)
    found = []
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != module:
            continue
        funcs = [(name, obj)] if inspect.isfunction(obj) else []
        if inspect.isclass(obj):
            funcs += [(f"{name}.{m}", f) for m, f in vars(obj).items()
                      if inspect.isfunction(f) and (m == "__init__" or not m.startswith("_"))]
        for qual, fn in funcs:
            for p in inspect.signature(fn).parameters.values():
                if "device" in p.name and _is_cpu(p.default):
                    found.append(f"{qual}({p.name}={p.default!r})")
    assert not found, f"{module}: device parameters that default to the CPU: {found}"
