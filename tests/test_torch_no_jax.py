"""The port runs where JAX, PIL, imageio and OpenCV are not installed:
importing vpt_tpu_torch and every module of the ported slice, or
chip_smoke.py, must pull in neither `jax`, `vpt_tpu`, `PIL`, `imageio`,
`tifffile` nor `cv2`; and the port alone decodes WebP, arithmetic-coded and
lossless JPEG, TGA, DDS, Netpbm, QOI, SGI, PCX, ICO / CUR and PSD, and
PIL's rarer plugins with its own decoders, where PIL, imageio and cv2
cannot be imported."""

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
    "vpt_tpu_torch.io.tiff",
    "vpt_tpu_torch.io.gif",
    "vpt_tpu_torch.io.bmp",
    "vpt_tpu_torch.io.webp",
    "vpt_tpu_torch.io.probe",
    "vpt_tpu_torch.io.tga",
    "vpt_tpu_torch.io.dds",
    "vpt_tpu_torch.io.netpbm",
    "vpt_tpu_torch.io.qoi",
    "vpt_tpu_torch.io.sgi",
    "vpt_tpu_torch.io.pcx",
    "vpt_tpu_torch.io.ico",
    "vpt_tpu_torch.io.psd",
    "vpt_tpu_torch.io.raw",
    "vpt_tpu_torch.io.dcx",
    "vpt_tpu_torch.io.ftex",
    "vpt_tpu_torch.io.xvthumb",
    "vpt_tpu_torch.io.pixar",
    "vpt_tpu_torch.io.mcidas",
    "vpt_tpu_torch.io.spider",
    "vpt_tpu_torch.io.im",
    "vpt_tpu_torch.io.gbr",
    "vpt_tpu_torch.io.fits",
    "vpt_tpu_torch.io.sun",
    "vpt_tpu_torch.io.msp",
    "vpt_tpu_torch.io.xbm",
    "vpt_tpu_torch.io.xpm",
    "vpt_tpu_torch.io.blp",
    "vpt_tpu_torch.io.icns",
    "vpt_tpu_torch.io.fli",
    "vpt_tpu_torch.io.iptc",
    "vpt_tpu_torch.io.pcd",
    "vpt_tpu_torch.io.jpeg2000",
    "vpt_tpu_torch.io.lab",
    "vpt_tpu_torch.io.imageio_order",
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'vpt_tpu', 'PIL', 'imageio', 'tifffile', 'cv2'))\n"
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


_ALONE = """
import importlib.util, os, sys
import numpy as np
assert importlib.util.find_spec("vpt_tpu") is None, "the JAX package is importable"
from vpt_tpu_torch.accel import bvh
from vpt_tpu_torch.scene import blosc, vdb, vdb_reader
here = os.getcwd()
rng = np.random.default_rng(0)
v0 = rng.uniform(-5, 5, (2000, 3)).astype(np.float32)
v1 = v0 + rng.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
v2 = v0 + rng.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
for use_native in (True, False):
    tree = bvh.build_bvh(v0, v1, v2, use_native=use_native)
    assert sorted(tree.tri_order.tolist()) == list(range(2000)) and tree.tri_count.sum() == 2000
vals = vdb.procedural_cloud((40, 32, 48), coverage=0.6, seed=2)
path = os.path.join(here, "cloud.vdb")
vdb_reader.write_vdb(path, vals, voxel_size=0.25, compress="blosc")
got = vdb_reader.read_vdb(path)
ox, oy, oz = (int(v) for v in got.origin_ijk)
d, h, w = got.values.shape
assert np.array_equal(got.values, vals[oz:oz + d, oy:oy + h, ox:ox + w])
assert np.array_equal(vdb.load_grid(path)[oz:oz + d, oy:oy + h, ox:ox + w], got.values)
for mod, lib in ((bvh, "libvpt_bvh.so"), (blosc, "libvpt_lz4.so")):
    assert mod._lib is not None and mod._SRC.startswith(here) and mod._LIB.startswith(here), mod._SRC
    assert os.path.exists(os.path.join(here, "vpt_tpu_torch", "build", lib)), lib
from vpt_tpu_torch.io import codec
blocks = rng.integers(0, 256, (4, 16), np.uint8)
blocks[:, 0] = 0x40  # BC7 mode 6
assert codec.bcn_decode(blocks.tobytes(), 8, 8, 7).shape == (8, 8, 4)
assert codec._bcn_lib is not None and codec._BCN_SRC.startswith(here) and codec._BCN_LIB.startswith(here)
assert os.path.exists(os.path.join(here, "vpt_tpu_torch", "build", "libvpt_bcndec.so"))
assert not any(m.split(".")[0] in ("jax", "vpt_tpu") for m in sys.modules)
print("alone ok")
"""


def test_the_port_alone_builds_and_reads(tmp_path):
    """vpt_tpu_torch/ copied without vpt_tpu/ beside it (its build/ left
    behind): in a process that can import nothing of the repository but the
    copy, both BVH builders run on a seeded soup, a .vdb that the port's
    writer compresses with blosc reads back equal, and BC7 blocks decode.
    So the C BVH builder, the LZ4 codec and the DDS block decoders build
    from the port's own csrc/, and nothing reads a file of the JAX package."""
    import shutil

    shutil.copytree(os.path.join(_ROOT, "vpt_tpu_torch"), str(tmp_path / "vpt_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__", "*.so"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _ALONE], cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0 and "alone ok" in proc.stdout, proc.stderr[-3000:]


_WEBP_ALONE = """
import hashlib, json, os, sys
for blocked in ("PIL", "PIL._webp", "imageio", "webp", "cv2"):
    sys.modules[blocked] = None  # any import of these raises
from vpt_tpu_torch.io import codec, image
from vpt_tpu_torch.scene import envmap
here = os.getcwd()
fixtures = sys.argv[1]
with open(os.path.join(fixtures, "manifest.json")) as f:
    manifest = json.load(f)
for name, entry in sorted(manifest.items()):
    with open(os.path.join(fixtures, name), "rb") as f:
        got = image.decode_rgba(f.read(), name)
    assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == entry["rgba"], name
    sky = envmap.load_hdr(os.path.join(fixtures, name))
    assert [list(sky.shape), str(sky.dtype), hashlib.sha256(sky.tobytes()).hexdigest()] == entry["load_hdr"], name
assert codec._webp_lib is not None and codec._WEBP_SRC.startswith(here) and codec._WEBP_LIB.startswith(here)
with open("/proc/self/maps") as f:
    assert "libwebp" not in f.read()
print("webp alone ok", len(manifest))
"""


def test_the_port_alone_decodes_webp(tmp_path):
    """vpt_tpu_torch/ copied on its own (its build/ left behind), in a
    process where PIL, PIL._webp and imageio cannot be imported: every
    fixture of tests/torch_webp/ decodes, through the texture path and
    load_hdr, to its manifest (the JAX package's decodes), with the WebP
    decoders built from the copy's csrc/ and no libwebp mapped into the
    process."""
    import shutil

    shutil.copytree(os.path.join(_ROOT, "vpt_tpu_torch"), str(tmp_path / "vpt_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__", "*.so"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _WEBP_ALONE, os.path.join(_ROOT, "tests", "torch_webp")],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "webp alone ok" in proc.stdout, proc.stderr[-3000:]


_JPEG_ALONE = """
import hashlib, json, os, sys
for blocked in ("PIL", "imageio", "cv2"):
    sys.modules[blocked] = None  # any import of these raises
from vpt_tpu_torch.io import codec, image
from vpt_tpu_torch.scene import envmap
here = os.getcwd()
fixtures = sys.argv[1]
with open(os.path.join(fixtures, "manifest.json")) as f:
    manifest = json.load(f)
refused = 0
for name, entry in sorted(manifest.items()):
    path = os.path.join(fixtures, name)
    for key, read in (("rgba", lambda: image.decode_rgba(open(path, "rb").read(), name)),
                      ("load_hdr", lambda: envmap.load_hdr(path))):
        try:
            got = read()
        except ValueError:
            assert entry[key] is None, (name, key)
            refused += 1
            continue
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == entry[key], name
assert codec._lib is not None and codec._SRC.startswith(here) and codec._LIB.startswith(here)
with open("/proc/self/maps") as f:
    assert "libjpeg" not in f.read()
print("jpeg alone ok", len(manifest), refused)
"""


def test_the_port_alone_decodes_arithmetic_and_lossless_jpegs(tmp_path):
    """vpt_tpu_torch/ copied on its own (its build/ left behind), in a
    process where PIL and imageio cannot be imported: every fixture of
    tests/torch_jpeg/ (SOF9, SOF10, SOF3) decodes, through the texture path
    and load_hdr, to its manifest, or raises a ValueError where the manifest
    says the JAX package refuses it, with the codec built from the copy's
    csrc/ and no libjpeg mapped into the process."""
    import shutil

    shutil.copytree(os.path.join(_ROOT, "vpt_tpu_torch"), str(tmp_path / "vpt_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__", "*.so"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _JPEG_ALONE, os.path.join(_ROOT, "tests", "torch_jpeg")],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "jpeg alone ok 54 8" in proc.stdout, proc.stderr[-3000:]


_PIL_FORMATS_ALONE = """
import hashlib, json, os, sys
for blocked in ("PIL", "imageio", "cv2"):
    sys.modules[blocked] = None  # any import of these raises
from vpt_tpu_torch.io import codec, image
from vpt_tpu_torch.scene import envmap
here = os.getcwd()
fixtures, tests = sys.argv[1], sys.argv[2]
sys.path.insert(0, tests)
import pil_format_writers  # numpy alone
with open(os.path.join(fixtures, "manifest.json")) as f:
    manifest = json.load(f)
files = {name: os.path.join(fixtures, name) for name in manifest if os.path.exists(os.path.join(fixtures, name))}
for name, data in pil_format_writers.timing_textures().items():
    files[name] = os.path.join(here, name)
    with open(files[name], "wb") as f:
        f.write(data)
assert sorted(files) == sorted(manifest)
refused = 0
for name, path in sorted(files.items()):
    for key, read in (("rgba", lambda: image.decode_rgba(open(path, "rb").read(), name)),
                      ("load_hdr", lambda: envmap.load_hdr(path))):
        try:
            got = read()
        except ValueError:
            assert manifest[name][key] is None, (name, key)
            refused += 1
            continue
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == manifest[name][key], name
assert codec._lib is not None and codec._SRC.startswith(here) and codec._LIB.startswith(here)
assert codec._bcn_lib is not None and codec._BCN_SRC.startswith(here)
print("pil formats alone ok", len(files), refused)
"""


def test_the_port_alone_decodes_the_pil_formats(tmp_path):
    """vpt_tpu_torch/ copied on its own (its build/ left behind), in a
    process where PIL, imageio and cv2 cannot be imported: every fixture of
    tests/torch_pil_formats/ and the three 2048x2048 timing textures (from
    tests/pil_format_writers.py, numpy alone) decode, through the texture
    path and load_hdr, to the manifest, or raise a ValueError where the
    manifest says the JAX package refuses them, with the codec and the DDS
    block decoders built from the copy's csrc/."""
    import shutil

    shutil.copytree(os.path.join(_ROOT, "vpt_tpu_torch"), str(tmp_path / "vpt_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__", "*.so"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PIL_FORMATS_ALONE, os.path.join(_ROOT, "tests", "torch_pil_formats"),
                           os.path.join(_ROOT, "tests")], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "pil formats alone ok 55 7" in proc.stdout, proc.stderr[-3000:] + proc.stdout


_JPEG2000_ALONE = """
import hashlib, json, os, sys
for blocked in ("PIL", "imageio", "cv2"):
    sys.modules[blocked] = None  # any import of these raises
from vpt_tpu_torch.io import codec, image
from vpt_tpu_torch.scene import envmap
here = os.getcwd()
fixtures = sys.argv[1]
with open(os.path.join(fixtures, "manifest.json")) as f:
    manifest = json.load(f)
refused = 0
for name in sorted(manifest):
    path = os.path.join(fixtures, name)
    for key, read in (("rgba", lambda: image.decode_rgba(open(path, "rb").read(), name)),
                      ("load_hdr", lambda: envmap.load_hdr(path))):
        try:
            got = read()
        except ValueError:
            assert manifest[name][key] is None, (name, key)
            refused += 1
            continue
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == manifest[name][key], name
assert codec._j2k_lib is not None and codec._J2K_SRC.startswith(here) and codec._J2K_LIB.startswith(here)
print("jpeg2000 alone ok", len(manifest), refused)
"""


def test_the_port_alone_decodes_jpeg2000(tmp_path):
    """vpt_tpu_torch/ copied on its own (its build/ left behind), in a
    process where PIL, imageio and cv2 cannot be imported: every file of
    tests/torch_jpeg2000/ decodes, through the texture path and load_hdr,
    to the manifest (the JAX package's decodes), or raises a ValueError
    where the manifest says the JAX package refuses it, with the JPEG 2000
    decoder built from the copy's csrc/."""
    import shutil

    shutil.copytree(os.path.join(_ROOT, "vpt_tpu_torch"), str(tmp_path / "vpt_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__", "*.so"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _JPEG2000_ALONE, os.path.join(_ROOT, "tests", "torch_jpeg2000")],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "jpeg2000 alone ok 172 34" in proc.stdout, proc.stderr[-3000:] + proc.stdout


_PIL_RARE_ALONE = """
import hashlib, json, os, sys
for blocked in ("PIL", "imageio", "cv2"):
    sys.modules[blocked] = None  # any import of these raises
from vpt_tpu_torch.io import codec, image
from vpt_tpu_torch.scene import envmap
here = os.getcwd()
fixtures, tests = sys.argv[1], sys.argv[2]
sys.path.insert(0, tests)
import pil_rare_writers  # numpy alone
with open(os.path.join(fixtures, "manifest.json")) as f:
    manifest = json.load(f)
files = {name: os.path.join(fixtures, name) for name in manifest if os.path.exists(os.path.join(fixtures, name))}
for name in pil_rare_writers.PCD:
    files[name] = os.path.join(here, name)
    with open(files[name], "wb") as f:
        f.write(pil_rare_writers.pcd_case(int(name[len("pcd-orientation")])))
refused = 0
for name, path in sorted(files.items()):
    data = open(path, "rb").read()
    for key, read in (("rgba", lambda: image.decode_rgba(data, name)),
                      ("rgba_file", lambda: image.decode_rgba(data, name, from_file=True)),
                      ("load_png", lambda: image.load_png(path)), ("load_hdr", lambda: envmap.load_hdr(path))):
        try:
            got = read()
        except ValueError:
            assert manifest[name][key] is None, (name, key)
            refused += 1
            continue
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == manifest[name][key], \
            (name, key)
assert codec._lib is not None and codec._SRC.startswith(here) and codec._LIB.startswith(here)
print("pil rare alone ok", len(files), refused)
"""


def test_the_port_alone_decodes_the_rare_pil_formats(tmp_path):
    """vpt_tpu_torch/ copied on its own (its build/ left behind), in a
    process where PIL, imageio and cv2 cannot be imported: every committed
    fixture of tests/torch_pil_rare/ and the three PhotoCD cases (from
    tests/pil_rare_writers.py, numpy alone) decode on the texture path
    (from memory and from a file), load_png and load_hdr to the manifest,
    or raise a ValueError where the manifest says the JAX package refuses
    them, with the codec built from the copy's csrc/."""
    import shutil

    shutil.copytree(os.path.join(_ROOT, "vpt_tpu_torch"), str(tmp_path / "vpt_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__", "*.so"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PIL_RARE_ALONE, os.path.join(_ROOT, "tests", "torch_pil_rare"),
                           os.path.join(_ROOT, "tests")], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "pil rare alone ok" in proc.stdout, proc.stderr[-3000:] + proc.stdout
