"""The rest of the port's `Renderer` and its image I/O against the JAX
package: PNG and Radiance HDR files, FlyCamera, the post-processed output,
every ported setter (the atmosphere's and the phase function's
included), the volume methods, and checkpoints.  Both `Renderer`s are
built with `lookup_tables=None`, the constant energy-compensation fit, so
that nothing bakes the tables on the CPU."""

import dataclasses
import inspect
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vpt_tpu.api import Renderer as JRenderer
from vpt_tpu.core.camera import FlyCamera as JFlyCamera
from vpt_tpu.io import image as jimage
from vpt_tpu.render.params import RenderFlags as JFlags
from vpt_tpu.scene import procedural as jproc
from vpt_tpu.scene.types import Material as JMaterial
from vpt_tpu_torch.api import Renderer
from vpt_tpu_torch.core.camera import FlyCamera
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.render.params import RenderFlags
from vpt_tpu_torch.scene import procedural as tproc
from vpt_tpu_torch.scene.types import Material

torch.set_num_threads(1)
FLAGS = dict(max_depth=2, max_medium_events=2)


# ---------------------------------------------------------------- image I/O


@pytest.mark.parametrize("channels", [3, 4])
def test_png_decodes_to_the_array_jax_writes(tmp_path, channels):
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (19, 23, channels)).astype(np.float32)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    timage.save_png(ours, img)
    jimage.save_png(theirs, img)  # PIL
    want = np.asarray(Image.open(theirs))
    np.testing.assert_array_equal(timage.read_png(ours), want)
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), want)  # a valid PNG for other readers
    np.testing.assert_array_equal(timage.to_uint8(img), want)


def test_radiance_hdr_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    img = (rng.random((33, 47, 3)).astype(np.float32) ** 2) * 1000.0
    img[0, 0] = 0.0
    img[1, 1] = [1e-4, 5e5, 2.0]
    ours, theirs = str(tmp_path / "port.hdr"), str(tmp_path / "jax.hdr")
    timage.save_hdr(ours, img)
    jimage.save_hdr(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(timage.load_radiance_hdr(theirs), jimage.load_radiance_hdr(theirs))
    timage.save_hdr(str(tmp_path / "port.npy"), img)
    np.testing.assert_array_equal(np.load(str(tmp_path / "port.npy")), img)


@pytest.mark.parametrize("kind", ["old_rle", "adaptive_rle", "trailing_bytes"])
def test_radiance_hdr_scanline_kinds_match_jax(tmp_path, kind):
    p = str(tmp_path / f"{kind}.hdr")
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
    with open(p, "wb") as f:
        if kind == "old_rle":
            f.write(head + b"-Y 2 +X 4\n")
            f.write(bytes([128, 64, 32, 130, 1, 1, 1, 3]) + bytes([10, 20, 30, 129]) * 4)
        elif kind == "adaptive_rle":
            w = 9
            f.write(head + f"-Y 2 +X {w}\n".encode())
            for row in range(2):
                f.write(bytes([2, 2, 0, w]))
                for c in range(4):  # a run of 5, then 4 literals
                    f.write(bytes([128 + 5, 100 + c + row]) + bytes([4]) + bytes([10 * c + k for k in range(4)]))
        else:
            f.write(head + b"-Y 4 +X 12\n" + bytes([90, 60, 30, 131]) * 48 + b"\x00\x00\x00junk")
    np.testing.assert_array_equal(timage.load_radiance_hdr(p), jimage.load_radiance_hdr(p))


def test_export_filename_matches_jax():
    assert timage.export_filename("out/img", 512, 12.345) == jimage.export_filename("out/img", 512, 12.345)


# ---------------------------------------------------------------- camera


def test_fly_camera_matches_jax():
    kw = dict(position=np.array([1.0, 2.0, 3.0], np.float32), yaw=-120.0, pitch=15.0, fov_deg=50.0, aspect=1.5)
    cam, jcam = FlyCamera(**kw), JFlyCamera(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                                                for k, v in kw.items()})
    for c in (cam, jcam):
        c.move("forward", 2.0)
        c.rotate(90.0, 200.0)  # pitch clamps at 89
        c.move("left", 0.5)
    assert cam.pitch == jcam.pitch == 89.0
    np.testing.assert_array_equal(cam.position, jcam.position)
    for name in ("view_matrix", "proj_matrix", "view_inverse", "proj_inverse"):
        np.testing.assert_array_equal(getattr(cam, name)(), getattr(jcam, name)(), err_msg=name)
    back, jback = FlyCamera.from_matrices(cam.view_matrix(), cam.proj_matrix()), \
        JFlyCamera.from_matrices(jcam.view_matrix(), jcam.proj_matrix())
    assert dataclasses.astuple(back)[1:5] == dataclasses.astuple(jback)[1:5]
    np.testing.assert_array_equal(back.position, jback.position)


def _png_rows(path):
    """(filter type of every row, IDAT chunk count) of a PNG file."""
    data = open(path, "rb").read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, _, ctype = header[:4]
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    return set(raw[:, 0].tolist()), len(idat)


def _test_image(rng, h, w, shape):
    """Noise, flat rows and ramps: rows that PIL's adaptive filter encodes
    with different filter types."""
    img = rng.integers(0, 256, (h, w) + shape).astype(np.uint8)
    img[: h // 4] = 200
    ramp = (np.arange(w) * 3 % 256).astype(np.uint8)
    img[h // 4 : h // 2] = ramp.reshape((1, w) + (1,) * len(shape))
    img[h // 2 : 3 * h // 4] = (np.arange(h // 2, 3 * h // 4)[:, None] + np.arange(w)[None, :]).astype(
        np.uint8).reshape((-1, w) + (1,) * len(shape))
    return img


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_load_png_equals_jax_on_pil_files(tmp_path, mode):
    """PNGs that PIL writes (adaptive row filters; the RGBA one in several
    IDAT chunks): the port's load_png equals the JAX package's (PIL), shape
    and dtype included."""
    shape = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}[mode]
    h, w = (300, 320) if mode == "RGBA" else (41, 57)
    img = _test_image(np.random.default_rng(len(mode)), h, w, shape)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img, mode).save(path)
    got, want = timage.load_png(path), jimage.load_png(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(timage.read_png(path), img)
    filters, chunks = _png_rows(path)
    assert len(filters) >= 2, filters
    assert chunks > 1 or mode != "RGBA"


def _filtered(img, kinds):
    """PNG scanlines of `img` (h, w, c) uint8, row y filtered with
    kinds[y % len(kinds)], as the PNG spec defines the five filters."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        b = rows[y - 1] if y else np.zeros_like(x)
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), b[:-c]])
        kind = kinds[y % len(kinds)]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = [np.zeros_like(x), a, b, (a + b) // 2, paeth][kind]
        out.append(np.concatenate([[kind], (x - pred) % 256]).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_row_filters(tmp_path, channels):
    """Rows this test filters itself with each of the five filter types
    (Paeth included), the data split over three IDAT chunks: read_png
    gives the image back and equals PIL's decoding."""
    img = _test_image(np.random.default_rng(channels), 23, 29, (channels,))
    data = zlib.compress(_filtered(img, [0, 1, 2, 3, 4, 4, 3, 1]).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    path = str(tmp_path / "filtered.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(timage._chunk(b"IHDR", struct.pack(">IIBBBBB", 29, 23, 8, ctype, 0, 0, 0)))
        for part in (data[:10], data[10 : len(data) // 2], data[len(data) // 2 :]):
            f.write(timage._chunk(b"IDAT", part))
        f.write(timage._chunk(b"IEND", b""))
    got = timage.read_png(path)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(timage.load_png(path), jimage.load_png(path))


def test_png_refusals_name_the_reason(tmp_path):
    """16-bit and interlaced PNGs, and JPEG files, raise a ValueError that
    says so; palette PNGs are read (as their palette's colours)."""
    rng = np.random.default_rng(3)
    pal = str(tmp_path / "palette.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8), "RGB").convert("P").save(pal)
    np.testing.assert_array_equal(timage.read_png(pal), np.asarray(Image.open(pal).convert("RGB")))
    jpeg = str(tmp_path / "photo.png")
    Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8), "RGB").save(jpeg, format="JPEG")
    deep = str(tmp_path / "deep.png")
    Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.uint16)).save(deep)
    laced = str(tmp_path / "interlaced.png")
    with open(laced, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(timage._chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)))
        f.write(timage._chunk(b"IDAT", zlib.compress(bytes(4 * 13))))
        f.write(timage._chunk(b"IEND", b""))
    for path, reason in ((deep, "16-bit"), (laced, "interlaced"), (jpeg, "JPEG")):
        with pytest.raises(ValueError, match=reason):
            timage.load_png(path)


# ---------------------------------------------------------------- Renderer


def test_renderer_parameters_follow_the_jax_package():
    """The port's Renderer parameters other than the keyword-only `device`
    are a prefix of the JAX package's, in its order, with its defaults."""
    port = inspect.signature(Renderer).parameters
    jax_params = inspect.signature(JRenderer).parameters
    names = [n for n in port if n != "device"]
    assert names == list(jax_params)[: len(names)]
    assert all(port[n].kind is inspect.Parameter.POSITIONAL_OR_KEYWORD for n in names)
    for n in ("width", "height", "samples_per_frame", "max_samples", "lookup_tables"):
        assert port[n].default == jax_params[n].default, n
    assert port["device"].kind is inspect.Parameter.KEYWORD_ONLY and port["device"].default == "cuda"


@pytest.fixture(scope="module")
def renderers():
    r = Renderer(tproc.cornell_box(), device="cpu", width=12, height=8, flags=RenderFlags(**FLAGS),
                 samples_per_frame=2, max_samples=4, lookup_tables=None)
    j = JRenderer(jproc.cornell_box(), width=12, height=8, flags=JFlags(**FLAGS), samples_per_frame=2,
                  max_samples=4, lookup_tables=None)
    return r, j


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _env(r):
    return {f: _np(getattr(r.scene_data.env, f)) for f in ("image", "alias", "quad")}


_ENV = np.random.default_rng(3).uniform(0.0, 4.0, (8, 16, 3)).astype(np.float32)
_VIEW = np.array([[1, 0, 0, -0.5], [0, 1, 0, -1.0], [0, 0, 1, -6.0], [0, 0, 0, 1]], np.float32)

# (setter, arguments, what it changes): a flag, a parameter or an attribute name.
SETTERS = [
    ("set_max_depth", (5,), "flag:max_depth"),
    ("set_samples_per_frame", (3,), "attr:samples_per_frame"),
    ("set_max_luminance", (120.0,), "param:max_luminance"),
    ("set_focus_distance", (3.0,), "param:focus_distance"),
    ("set_dof_strength", (0.25,), "param:dof_strength"),
    ("set_sky_azimuth", (45.0,), "param:sky_rotation_azimuth"),
    ("set_sky_altitude", (-10.0,), "param:sky_rotation_altitude"),
    ("set_sky_intensity", (2.0,), "param:environment_intensity"),
    ("set_emissive_pdf_bias", (0.1,), "param:emissive_pdf_bias"),
    ("set_sky_mis", (False,), "flag:enable_sky_mis"),
    ("set_mesh_mis", (False,), "flag:enable_mesh_mis"),
    ("set_env_map_shown_directly", (False,), "flag:show_env_map_directly"),
    ("set_use_only_geometry_normals", (True,), "flag:use_only_geometry_normals"),
    ("set_use_energy_compensation", (False,), "flag:use_energy_compensation"),
    ("set_furnace_test_mode", (True,), "flag:furnace_test_mode"),
    ("set_enable_atmosphere", (True,), "flag:enable_atmosphere"),
    ("set_phase_function", ("hg_draine",), "flag:phase_function"),
    ("set_sun_color", ((0.9, 0.7, 0.4),), "param:sun_color"),
    ("set_planet_position", ((0.0, -6360e3, 10.0),), "param:planet_position"),
    ("set_planet_radius", (6371e3,), "param:planet_radius"),
    ("set_atmosphere_height", (80e3,), "param:atmosphere_height"),
    ("set_rayleigh_scattering_multiplier", ((1.0, 1.5, 2.0),), "param:rayleigh_scattering_multiplier"),
    ("set_mie_scattering_multiplier", ((0.5, 0.5, 0.7),), "param:mie_scattering_multiplier"),
    ("set_ozone_absorption_multiplier", ((2.0, 1.0, 0.1),), "param:ozone_absorption_multiplier"),
    ("set_rayleigh_density_falloff", (7994.3,), "param:rayleigh_density_falloff"),
    ("set_mie_density_falloff", (1100.1,), "param:mie_density_falloff"),
    ("set_ozone_density_falloff", (4500.0,), "param:ozone_density_falloff"),
    ("set_ozone_peak", (25000.7,), "param:ozone_peak"),
    ("set_camera", (_VIEW, None), "param:view_inverse"),
    ("set_env_map", (_ENV,), "env"),
    ("set_material", (1, "blue"), "material"),
    ("resize_image", (16, 10), "resize"),
    ("sync_fly_camera", (), "fly"),
]


def _field(r, what):
    kind, _, name = what.partition(":")
    if kind == "flag":
        return getattr(r.flags, name)
    if kind == "param":
        return _np(getattr(r.params, name))
    if kind == "attr":
        return getattr(r, name)
    if kind == "env":
        return _env(r)
    if kind == "material":
        attr = r.scene_data.material_attr if hasattr(r.scene_data, "material_attr") else r.scene_data.materials.attr
        return _np(attr)
    if kind == "resize":
        return (r.width, r.height, tuple(r._accum.shape), _np(r.params.proj_inverse), r.camera.aspect)
    return _np(r.params.view_inverse), _np(r.params.proj_inverse)


def _assert_same(a, b):
    if isinstance(a, str):
        assert a == b
    elif isinstance(a, dict):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-6, atol=0)


@pytest.mark.parametrize("setter,args,what", SETTERS, ids=[s[0] for s in SETTERS])
def test_setter_changes_the_jax_field_and_resets(renderers, setter, args, what):
    r, j = renderers
    before = _field(r, what)
    for ren in (r, j):
        ren.frame_count, ren.samples_accumulated = 3, 6
        call_args = args
        if setter == "set_material":
            mat = Material if ren is r else JMaterial
            call_args = (1, mat(name="blue", base_color=(0.1, 0.1, 0.9), roughness=0.3))
        if setter == "sync_fly_camera":
            ren.camera.move("left", 0.5)
        getattr(ren, setter)(*call_args)
        assert ren.frame_count == 0 and ren.samples_accumulated == 0, f"{setter} did not reset"
    got = _field(r, what)
    _assert_same(got, _field(j, what))
    if what not in ("fly",):
        with pytest.raises(AssertionError):
            _assert_same(got, before)  # the setter did change the field


def test_set_phase_function_rejects_unknown_names(renderers):
    r, _ = renderers
    with pytest.raises(ValueError, match="phase function"):
        r.set_phase_function("mie")


def _volume_state(r):
    table = r.scene_data.volumes
    return ((r.meta.n_volumes, r.meta.n_het_volumes),
            {f: _np(getattr(table, f)) for f in type(table)._fields})


def test_volume_methods_match_jax(tmp_path):
    """add_volume, set_volume, the density-data methods (an array and .npy
    paths) and remove_volume: each rebuilds the volume table and meta as
    the JAX package does and resets accumulation."""
    from vpt_tpu.scene.types import Volume as JVolume
    from vpt_tpu.scene.vdb import procedural_cloud
    from vpt_tpu_torch.scene.types import Volume

    r = Renderer(tproc.cornell_box(), device="cpu", width=8, height=8, flags=RenderFlags(**FLAGS), lookup_tables=None)
    j = JRenderer(jproc.cornell_box(), width=8, height=8, flags=JFlags(**FLAGS), lookup_tables=None)
    cloud = procedural_cloud((12, 10, 8), seed=2)
    temp = np.random.default_rng(1).uniform(0.0, 1000.0, (12, 10, 8)).astype(np.float32)
    np.save(tmp_path / "cloud.npy", cloud)
    np.save(tmp_path / "temp.npy", temp)
    first = dict(corner_min=(-0.5, -0.5, -0.5), corner_max=(0.5, 0.5, 0.5), density=2.0)
    second = dict(corner_min=(-1.0, -1.0, -1.0), corner_max=(1.0, 0.0, 1.0), density=0.3, color=(0.5, 0.6, 0.7))
    steps = [
        ("add_volume", lambda V: (V(**first),)),
        ("add_volume", lambda V: (V(**second, density_grid=cloud),)),
        ("set_volume", lambda V: (0, V(**first, anisotropy=0.5))),
        ("add_density_data_to_volume", lambda V: (0, str(tmp_path / "cloud.npy"), str(tmp_path / "temp.npy"))),
        ("add_density_data_to_volume", lambda V: (1, cloud * 2.0)),
        ("remove_density_data_from_volume", lambda V: (0,)),
        ("remove_volume", lambda V: (1,)),
    ]
    for name, args in steps:
        for ren, V in ((r, Volume), (j, JVolume)):
            ren.frame_count, ren.samples_accumulated = 3, 6
            getattr(ren, name)(*args(V))
            assert ren.frame_count == 0 and ren.samples_accumulated == 0, f"{name} did not reset"
        (counts, table), (jcounts, jtable) = _volume_state(r), _volume_state(j)
        assert counts == jcounts, name
        for f, v in table.items():
            np.testing.assert_array_equal(v, jtable[f], err_msg=f"{name}: {f}")
        assert len(r.volumes) == len(j.volumes)
    assert counts == (1, 0)


def test_max_samples_and_counts_match_jax(renderers):
    r, j = renderers
    for ren in (r, j):
        ren.set_max_samples(9)
    assert r.max_samples == j.max_samples == 9
    assert r.total_vertex_count == j.total_vertex_count and r.total_index_count == j.total_index_count
    assert r.get_material(2).name == j.get_material(2).name and len(r.materials) == len(j.materials)


def test_set_env_map_from_an_hdr_file(tmp_path, renderers):
    r, j = renderers
    p = str(tmp_path / "env.hdr")
    timage.save_radiance_hdr(p, _ENV)
    r.set_env_map(p)
    j.set_env_map(p)
    _assert_same(_env(r), _env(j))


@pytest.mark.parametrize("mode,enable_bloom", [("aces", False), ("agx:punchy", True)])
def test_output_image_matches_jax(renderers, mode, enable_bloom):
    r, j = renderers
    img = np.random.default_rng(4).uniform(0.0, 3.0, (r.height, r.width, 3)).astype(np.float32)
    for ren in (r, j):
        ren.post.tonemap_mode, ren.post.enable_bloom, ren.post.exposure = mode, enable_bloom, 1.3
    r._accum = torch.tensor(img)
    j._accum = jnp.asarray(img)
    np.testing.assert_allclose(r.output_image(), j.output_image(), atol=1e-4)  # AGX: see test_torch_post.py


def test_render_save_and_checkpoint_resume(tmp_path):
    """A checkpoint taken after one dispatch resumes to the identical
    accumulation; `save` writes the tonemapped PNG, the HDR .npy, and
    spp/seconds into the name."""
    def make():
        return Renderer(tproc.cornell_box(), device="cpu", width=8, height=8, flags=RenderFlags(**FLAGS),
                        samples_per_frame=1, max_samples=3, lookup_tables=None)

    r = make()
    r.path_trace()
    ck = str(tmp_path / "ck.npz")
    r.save_checkpoint(ck)
    img = r.render()  # two more dispatches
    assert r.samples_accumulated == 3 and r.segments_traced > 0 and r.render_seconds > 0
    resumed = make()
    resumed.load_checkpoint(ck)
    assert (resumed.frame_count, resumed.samples_accumulated) == (1, 1)
    np.testing.assert_array_equal(resumed.render(), img)

    png = r.save(str(tmp_path / "out.png"))
    np.testing.assert_array_equal(timage.read_png(png), timage.to_uint8(r.output_image()))
    assert timage.read_png(png).mean() > 0
    np.testing.assert_array_equal(np.load(r.save(str(tmp_path / "hdr.npy"))), img)
    named = r.save(str(tmp_path / "stats.png"), embed_stats=True)
    assert named.endswith(".png") and "_3spp_" in named
    r.reset_path_tracing()
    assert (r.frame_count, r.samples_accumulated, r.segments_traced, r.render_seconds) == (0, 0, 0.0, 0.0)

