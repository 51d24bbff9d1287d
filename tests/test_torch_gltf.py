"""The port's glTF loader against vpt_tpu.scene.gltf.load_gltf (PIL's image
decode) on files that tests/gltf_scenes.py writes: `.gltf` with an external
buffer and image files, `.gltf` with `data:` URIs and `.glb` with images in
buffer views, covering u8 / u16 / u32 indices, a byteStride, missing NORMAL
and TEXCOORD_0, a primitive without indices, matrix and TRS hierarchies, a
camera, the metallicRoughness split, normal and emissive textures and the
three KHR extensions.  Every Scene field must be equal, textures included;
the textured colonnade written as a .glb loads back with its instances,
triangles and textures (within the PNG's 1/255), and the CLI's render of
it equals the procedural scene's; palette PNGs decode as
PIL's convert("RGBA"); JPEG raises."""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

import gltf_scenes
from test_torch_textured import SMALL
from vpt_tpu.io.metrics import psnr
from vpt_tpu.scene.gltf import load_gltf as jax_load_gltf
from vpt_tpu_torch import Renderer, RenderFlags, cli
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import procedural as tproc
from vpt_tpu_torch.scene.gltf import load_gltf

LAYOUTS = {"glb": ".glb", "external": ".gltf", "data": ".gltf"}


def assert_loaded_equal(got, want):
    assert got.name == want.name
    assert (len(got.meshes), len(got.instances), len(got.materials), len(got.textures)) == (
        len(want.meshes), len(want.instances), len(want.materials), len(want.textures))
    for a, b in zip(got.meshes, want.meshes):
        assert a.name == b.name
        for f in ("positions", "normals", "uvs", "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f
    for a, b in zip(got.instances, want.instances):
        assert (a.mesh, a.material, a.name) == (b.mesh, b.material, b.name)
        assert a.transform.dtype == b.transform.dtype and np.array_equal(a.transform, b.transform)
    assert [dataclasses.asdict(m) for m in got.materials] == [dataclasses.asdict(m) for m in want.materials]
    for a, b in zip(got.textures, want.textures):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert (got.camera_view is None) == (want.camera_view is None)
    if got.camera_view is not None:
        assert got.camera_view.dtype == want.camera_view.dtype and np.array_equal(got.camera_view, want.camera_view)
    assert (got.camera_fov_deg, got.camera_aspect) == (want.camera_fov_deg, want.camera_aspect)


def _palette_png() -> bytes:
    rng = np.random.default_rng(4)
    img = Image.fromarray(rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)).convert(
        "P", palette=Image.ADAPTIVE, colors=12)
    out = io.BytesIO()
    img.save(out, format="PNG", transparency=bytes([0, 40, 255, 90]))
    return out.getvalue()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_feature_scene_equals_jax(tmp_path, layout):
    path = gltf_scenes.feature_scene(str(tmp_path / f"f{LAYOUTS[layout]}"), layout, extra_png=_palette_png())
    got = load_gltf(path)
    assert_loaded_equal(got, jax_load_gltf(path))
    # What the document holds, as the JAX loader reads it.
    assert [m.name for m in got.meshes] == ["two-prims"] * 2 + ["u32-and-soup"] * 2
    assert [i.name for i in got.instances] == ["parent"] * 2 + ["child"] * 2 + ["second"] * 2
    metal, lamp, glass = got.materials
    assert metal.metallic == 1.0 and metal.roughness == pytest.approx(0.4)  # metallicFactor's default
    assert (metal.roughness_texture, metal.metallic_texture) == (lamp.roughness_texture, lamp.metallic_texture)
    np.testing.assert_allclose(lamp.emissive_color, (12.0, 6.0, 3.0))
    assert (glass.name, glass.transmission, glass.ior) == ("material2", 1.0, pytest.approx(1.33))
    assert got.textures[metal.base_color_texture][..., 3].min() == 0.0  # the palette's tRNS alphas
    np.testing.assert_array_equal(np.linalg.norm(got.meshes[1].normals, axis=-1) > 0.99, True)  # face normals
    assert got.meshes[3].indices.tolist() == list(range(9))
    assert got.camera_fov_deg == pytest.approx(np.degrees(0.7)) and got.camera_aspect == 1.5


def test_async_import_equals_sync(tmp_path):
    path = gltf_scenes.feature_scene(str(tmp_path / "f.glb"), "glb", extra_png=_palette_png())
    assert_loaded_equal(load_gltf(path, async_import=True), load_gltf(path, async_import=False))


def test_textured_colonnade_glb_round_trip(tmp_path):
    scene = tproc.colonnade_textured(**SMALL)
    path = gltf_scenes.scene_to_gltf(scene, str(tmp_path / "colonnade.glb"))
    got = load_gltf(path)
    assert_loaded_equal(got, jax_load_gltf(path))
    assert len(got.instances) == len(scene.instances) == 25

    def tris(s):
        return sum(s.meshes[i.mesh].n_tris for i in s.instances)

    assert tris(got) == tris(scene)
    for a, b in zip(got.instances, scene.instances):
        np.testing.assert_array_equal(got.meshes[a.mesh].positions, scene.meshes[b.mesh].positions)
        np.testing.assert_array_equal(a.transform, b.transform)
    assert len(got.textures) == 9
    for k in range(3, 9):
        assert got.textures[k].shape[:2] == scene.textures[k].shape[:2]
        assert np.abs(got.textures[k][..., :3] - scene.textures[k][..., :3]).max() <= 0.5 / 255 + 1e-7
    np.testing.assert_allclose(got.camera_view, scene.camera_view, atol=1e-5)
    assert got.camera_fov_deg == pytest.approx(55.0)


def test_glb_render_through_the_cli_equals_the_procedural_scene(tmp_path, capsys):
    """`python -m vpt_tpu_torch render` of the small textured colonnade's .glb
    with its sky from a .npy gives the procedural scene's render at the same
    seeds: the textures come back through 8-bit PNG, which the device packs
    as RGBA8 anyway."""
    torch.set_num_threads(1)
    scene = tproc.colonnade_textured(**SMALL)
    glb = gltf_scenes.scene_to_gltf(scene, str(tmp_path / "colonnade.glb"))
    np.save(str(tmp_path / "sky.npy"), scene.env_map)
    hdr = str(tmp_path / "out.npy")
    assert cli.main(["render", glb, "-o", str(tmp_path / "out.png"), "--hdr-output", hdr, "--env",
                     str(tmp_path / "sky.npy"), "--width", "20", "--height", "20", "--spp", "4", "--spp-per-frame", "2",
                     "--no-energy-compensation", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["spp"] == 4
    ref = Renderer(scene, 20, 20, RenderFlags(max_depth=8, use_energy_compensation=False), samples_per_frame=2,
                   max_samples=4, lookup_tables=None, device="cpu")
    ref.render()
    got, want = np.load(hdr), ref.hdr_image()
    assert psnr(np.clip(got, 0, 10), np.clip(want, 0, 10), data_range=10.0) > 60.0


def test_jpeg_raises_naming_format_and_image(tmp_path):
    out = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(out, format="JPEG")
    w = gltf_scenes.GltfWriter()
    mat = w.material(pbrMetallicRoughness={"baseColorTexture": {"index": w.texture(w.image(out.getvalue(), "wall"))}})
    w.mesh([{"attributes": {"POSITION": w.accessor(np.eye(3, dtype=np.float32))}, "material": mat}])
    w.node(mesh=0)
    path = w.save(str(tmp_path / "jpeg.glb"))
    assert len(jax_load_gltf(path).textures) == 4  # PIL reads it
    with pytest.raises(ValueError, match="wall: JPEG"):
        load_gltf(path)


def test_palette_png_decodes_as_pil_converts_it(tmp_path):
    """Palette PNGs (8-bit and packed 1/2/4-bit, with and without tRNS):
    decode_rgba equals PIL's convert("RGBA") / 255, and read_png gives the
    palette's colours."""
    rng = np.random.default_rng(5)
    rgb = Image.fromarray(rng.integers(0, 256, (17, 23, 3)).astype(np.uint8))
    for colors, bits, trns in ((256, 8, None), (12, 8, bytes([0, 128, 255])), (2, 1, None), (4, 2, b"\x00"),
                               (16, 4, bytes(range(0, 256, 16)))):
        img = rgb.convert("P", palette=Image.ADAPTIVE, colors=colors)
        out = io.BytesIO()
        img.save(out, format="PNG", bits=bits, **({} if trns is None else {"transparency": trns}))
        data = out.getvalue()
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0
        np.testing.assert_array_equal(timage.decode_rgba(data, "p.png"), want)
        path = tmp_path / f"p{colors}.png"
        path.write_bytes(data)
        colours = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA" if trns else "RGB"))
        np.testing.assert_array_equal(timage.read_png(str(path)), colours)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_decode_rgba_expands_like_pil(mode):
    rng = np.random.default_rng(len(mode))
    shape = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}[mode]
    arr = rng.integers(0, 256, (11, 7) + shape).astype(np.uint8)
    out = io.BytesIO()
    kw = {"transparency": int(arr[2, 3])} if mode == "L" else {}
    Image.fromarray(arr, mode).save(out, format="PNG", **kw)
    want = np.asarray(Image.open(io.BytesIO(out.getvalue())).convert("RGBA"), np.float32) / 255.0
    np.testing.assert_array_equal(timage.decode_rgba(out.getvalue()), want)
