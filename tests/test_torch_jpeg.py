"""The port's image decoding (io/jpeg.py, io/image.py and the C codec of
csrc/imgcodec.c) against the JAX package's, which decodes with PIL (and
imageio for `load_hdr`): every case must be bitwise equal, shapes and
dtypes included.

- The JPEG matrix, encoded by PIL at test time: sizes 1x1, 8x8, 37x29 and
  255x3; qualities 50, 75 and 95; gray, and RGB at subsampling 0, 1 and 2
  (4:4:4, 4:2:2, 4:2:0); progressive on and off, optimised Huffman tables
  on and off, restart markers on and off.  The port's `decode_rgba` and
  glTF `_load_image` against JAX's `_load_image`, its `load_png` against
  JAX's `load_png`.
- PNGs that tests/gltf_scenes.py writes (PIL writes no 16-bit colour and no
  interlaced PNG): every colour type and bit depth, plain and Adam7, at
  three sizes, with all five row filters; tRNS keys of 16-bit and low-bit
  gray and of 16-bit RGB.
- `load_gltf` of documents with JPEG, 16-bit and interlaced PNG textures
  (a JPEG labelled image/png among them: both read by content).
- `load_hdr` of PNG (8- and 16-bit, gray, gray+alpha, palette, 1-bit) and
  JPEG files against JAX's (imageio).
- The committed fixtures of tests/torch_images/ against their recorded PIL
  decodes and against PIL here.
- The refusals that stay, each naming the format: truncated, 12-bit,
  arithmetic-coded lossless (SOF11) and hierarchical (SOF5) JPEGs, a lossless
  one whose scan names no predictor, an OpenEXR texture, a colour PFM
  environment map, `.exr` and `.pfm` environment maps.  The CMYK and 4:4:0
  JPEGs, the progressive JPEG that libjpeg smooths, a Huffman-coded file
  whose frame says arithmetic coding (PIL decodes its data as arithmetic
  code), the GIF, lossless and lossy WebP and the `.tif` environment map once
  refused here now equal the JAX package's decodes
  (tests/test_torch_image_formats.py, tests/test_torch_webp.py and
  tests/test_torch_jpeg_arith_lossless.py hold every such format); corrupt
  files raise ValueErrors only, and seeded mutants of Huffman-coded files
  decode to PIL's pixels or raise where PIL raises; a Motion-JPEG frame (no
  DHT) decodes with T.81's standard tables as in libjpeg; a failed gcc
  build of the codec raises; threads share one build.
"""

import base64
import hashlib
import io
import os
import struct
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

import format_writers
import gltf_scenes
from vpt_tpu.io import image as jimage
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import envmap as tenvmap
from vpt_tpu_torch.scene import gltf as tgltf

SIZES = {"1x1": (1, 1), "8x8": (8, 8), "37x29": (37, 29), "255x3": (255, 3)}  # width x height
KINDS = {"gray": None, "rgb-444": 0, "rgb-422": 1, "rgb-420": 2}  # PIL's subsampling argument


def photo(seed: int, w: int, h: int) -> np.ndarray:
    """(h, w, 3) uint8: smooth colour fields, a dark disc and noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w, 2)
    img = np.stack([np.sin(9 * x + 3 * y), np.cos(7 * x * y + 2), np.sin(20 * (x - y) ** 2)], axis=-1) * 110 + 128
    img[(x - 0.5) ** 2 + (y - 0.4) ** 2 < 0.05] *= 0.4
    return np.clip(img + rng.normal(0.0, 12.0, img.shape), 0, 255).astype(np.uint8)


def jpeg_bytes(img: np.ndarray, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(img).save(out, format="JPEG", **kw)
    return out.getvalue()


def gltf_image(data: bytes, mime: str) -> dict:
    """A glTF document whose one image is `data` as a data: URI."""
    return {"images": [{"uri": f"data:{mime};base64," + base64.b64encode(data).decode(), "mimeType": mime}]}


def assert_same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def assert_decodes_as_jax(tmp_path, data: bytes, mime: str, suffix: str) -> None:
    """decode_rgba and the glTF texture decode against JAX's `_load_image`
    (PIL's convert("RGBA") / 255); load_png against JAX's load_png."""
    doc = gltf_image(data, mime)
    want = jgltf._load_image(doc, [], str(tmp_path), 0)
    assert_same(timage.decode_rgba(data, "image"), want)
    assert_same(tgltf._load_image(doc, [], str(tmp_path), 0), want)
    path = str(tmp_path / f"image{suffix}")
    with open(path, "wb") as f:
        f.write(data)
    assert_same(timage.load_png(path), jimage.load_png(path))


# ------------------------------------------------------------------ JPEG


@pytest.mark.parametrize("restart", [0, 2], ids=["no-rst", "rst2"])
@pytest.mark.parametrize("optimize", [False, True], ids=["std", "opt"])
@pytest.mark.parametrize("progressive", [False, True], ids=["seq", "prog"])
@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("size", list(SIZES))
def test_jpeg_matrix_equals_jax(tmp_path, size, kind, quality, progressive, optimize, restart):
    w, h = SIZES[size]
    img = photo(zlib.crc32(f"{size} {kind} {quality}".encode()), w, h)
    if kind == "gray":
        img, kw = img.mean(axis=-1).astype(np.uint8), {}
    else:
        kw = {"subsampling": KINDS[kind]}
    data = jpeg_bytes(img, quality=quality, progressive=progressive, optimize=optimize,
                      restart_marker_blocks=restart, **kw)
    assert_decodes_as_jax(tmp_path, data, "image/jpeg", ".jpg")


@pytest.mark.parametrize("case", ["keep-rgb", "keep-rgb-progressive", "quality-100", "16-bit-tables", "large-420",
                                  "noise-progressive-444", "odd-422"])
def test_jpeg_other_encodings_equal_jax(tmp_path, case):
    """RGB stored without YCbCr (an Adobe marker with transform 0), 16-bit
    quantisation tables, quality 100, and larger and odd sizes."""
    w, h = {"large-420": (203, 157), "odd-422": (67, 5)}.get(case, (61, 43))
    img = photo(len(case), w, h)
    kw = {"keep-rgb": dict(keep_rgb=True), "keep-rgb-progressive": dict(keep_rgb=True, progressive=True),
          "quality-100": dict(quality=100, subsampling=2),
          "16-bit-tables": dict(qtables=[[300 + i for i in range(64)], [3] * 64]),
          "large-420": dict(quality=85, subsampling=2, progressive=True),
          "noise-progressive-444": dict(quality=60, subsampling=0, progressive=True),
          "odd-422": dict(quality=70, subsampling=1, restart_marker_blocks=3)}[case]
    if case == "noise-progressive-444":
        img = np.random.default_rng(3).integers(0, 256, img.shape).astype(np.uint8)
    data = jpeg_bytes(img, **kw)
    if case == "16-bit-tables":
        assert b"\xff\xdb" in data and data[data.index(b"\xff\xdb") + 4] >> 4 == 1  # a 16-bit DQT
    assert_decodes_as_jax(tmp_path, data, "image/jpeg", ".jpg")


def without_dht(data: bytes) -> bytes:
    """A JPEG with the DHT segments before its first scan taken out, as a
    Motion-JPEG frame is."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        end = pos + 2 + ((data[pos + 2] << 8) | data[pos + 3])
        if data[pos + 1] != 0xC4:
            out += data[pos:end]
        pos = end
    return bytes(out + data[pos:])


@pytest.mark.parametrize("kind", ["baseline-rgb", "baseline-gray", "baseline-rst", "progressive"])
def test_jpeg_without_huffman_tables_as_libjpeg_reads_it(tmp_path, kind):
    """libjpeg-turbo's sequential Huffman decoder puts T.81 K.3's tables in
    the slots a file leaves undefined (Motion-JPEG frames carry no DHT): the
    port decodes such a file as PIL does.  Its progressive decoder does not:
    both refuse that one."""
    img = photo(13, 29, 21)
    kw = {"baseline-gray": {}, "baseline-rst": dict(restart_marker_blocks=2), "progressive": dict(progressive=True)}
    data = without_dht(jpeg_bytes(img.mean(axis=-1).astype(np.uint8) if kind == "baseline-gray" else img,
                                  quality=70, **kw.get(kind, {})))
    assert b"\xff\xc4" not in data[: data.index(b"\xff\xda")]  # (a progressive file defines more between scans)
    if kind == "progressive":
        with pytest.raises(OSError):
            jgltf._load_image(gltf_image(data, "image/jpeg"), [], str(tmp_path), 0)
        with pytest.raises(ValueError, match="Huffman table it never defines"):
            timage.decode_rgba(data)
        return
    assert_decodes_as_jax(tmp_path, data, "image/jpeg", ".jpg")


def test_standard_huffman_tables_are_k3s():
    """The port's copy of T.81 K.3's tables equals the DHT segments PIL's
    libjpeg-turbo writes without optimize (its standard tables)."""
    from vpt_tpu_torch.io import jpeg

    data = jpeg_bytes(photo(14, 16, 16), quality=75, optimize=False)
    written, pos = {}, 2
    while data[pos + 1] != 0xDA:
        end = pos + 2 + ((data[pos + 2] << 8) | data[pos + 3])
        if data[pos + 1] == 0xC4:
            seg, i = data[pos + 4 : end], 0
            while i < len(seg):
                n = sum(seg[i + 1 : i + 17])
                written[(seg[i] >> 4, seg[i] & 15)] = (seg[i + 1 : i + 17].hex(), seg[i + 17 : i + 17 + n].hex())
                i += 17 + n
        pos = end
    assert written == jpeg._STD_HUFFMAN


# ------------------------------------------------------------------- PNG


PNG_TYPES = [(16, 0), (16, 2), (16, 4), (16, 6), (1, 0), (2, 0), (4, 0), (8, 0), (8, 2), (8, 3), (8, 4), (8, 6),
             (1, 3), (2, 3), (4, 3)]


def png_samples(rng, depth: int, ctype: int, h: int, w: int) -> np.ndarray:
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = 7 if ctype == 3 else 1 << depth
    return rng.integers(0, top, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)


@pytest.mark.parametrize("size", ["13x11", "1x1", "2x9"])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth,ctype", PNG_TYPES, ids=[f"{d}bit-type{t}" for d, t in PNG_TYPES])
def test_png_types_equal_jax(tmp_path, depth, ctype, interlace, size):
    """Every colour type and depth: PIL's modes (16-bit colour as its high
    bytes, 16-bit gray as uint16, 16-bit gray+alpha as RGBA, 1-bit gray as
    booleans, 2- and 4-bit gray scaled, palette indices)."""
    h, w = (int(v) for v in size.split("x"))
    rng = np.random.default_rng(depth * 16 + ctype)
    samples = png_samples(rng, depth, ctype, h, w)
    palette = rng.integers(0, 256, (7, 3)) if ctype == 3 else None
    data = gltf_scenes.encode_png(samples, depth, ctype, filters=(0, 1, 2, 3, 4, 4, 1), interlace=interlace,
                                  palette=palette)
    assert_decodes_as_jax(tmp_path, data, "image/png", ".png")


TRNS_CASES = {
    "gray16-value": (16, 0, lambda s: [int(s[0, 0, 0])]),
    "gray16-clipped": (16, 0, lambda s: [65535]),  # every sample >= 255 matches after the clip
    "gray16-low-byte": (16, 0, lambda s: [256]),  # matches 0: the key's low byte
    "gray8": (8, 0, lambda s: [int(s[1, 1, 0])]),
    "gray8-over-255": (8, 0, lambda s: [256 + int(s[1, 1, 0])]),
    "gray1-one": (1, 0, lambda s: [1]),
    "gray1-zero": (1, 0, lambda s: [0]),
    "gray2-zero": (2, 0, lambda s: [0]),
    "gray2-three": (2, 0, lambda s: [3]),  # compared with the scaled samples: matches nothing
    "gray4-zero": (4, 0, lambda s: [0]),
    "rgb8": (8, 2, lambda s: [int(v) for v in s[2, 3]]),
    "rgb16-high-bytes": (16, 2, lambda s: [int(v) >> 8 for v in s[2, 3]]),
    "rgb16-value": (16, 2, lambda s: [int(v) for v in s[2, 3]]),
}


@pytest.mark.parametrize("case", list(TRNS_CASES))
def test_png_transparency_keys_equal_jax(tmp_path, case):
    """tRNS colour keys: alpha 0 where the 8-bit gray or RGB value equals
    the key's low bytes (a 1-bit key scaled to 0 / 255 first), as PIL's
    convert("RGBA") does."""
    depth, ctype, key = TRNS_CASES[case]
    rng = np.random.default_rng(len(case))
    samples = png_samples(rng, depth, ctype, 9, 12)
    if depth == 16 and ctype == 0:
        samples[:3] //= 300  # some samples under 255, one of them 0
        samples[0, 0] = 0
    if case == "rgb16-high-bytes":
        samples[5, 5] = samples[2, 3] | 0xFF  # another pixel with the same high bytes
    trns = struct.pack(f">{len(key(samples))}H", *key(samples))
    data = gltf_scenes.encode_png(samples, depth, ctype, filters=(4, 3), trns=trns)
    want = jgltf._load_image(gltf_image(data, "image/png"), [], str(tmp_path), 0)
    assert_same(timage.decode_rgba(data), want)
    if case in ("gray16-clipped", "gray16-low-byte", "gray1-one", "rgb16-high-bytes"):
        assert (want[..., 3] == 0).any()


def test_read_png_keeps_its_png_contract(tmp_path):
    """read_png gives uint8 samples of any PNG (1-bit as 0 / 255, 16-bit
    colour as high bytes, palettes as colours) and refuses other files."""
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (5, 9)).astype(np.uint8)
    path = tmp_path / "bits.png"
    path.write_bytes(gltf_scenes.encode_png(bits, 1, filters=(1, 4)))
    np.testing.assert_array_equal(timage.read_png(str(path)), bits * 255)
    deep = png_samples(rng, 16, 2, 4, 6)
    path.write_bytes(gltf_scenes.encode_png(deep, 16, interlace=True))
    np.testing.assert_array_equal(timage.read_png(str(path)), (deep >> 8).astype(np.uint8))
    jpg = tmp_path / "photo.png"
    jpg.write_bytes(jpeg_bytes(photo(0, 8, 8)))
    with pytest.raises(ValueError, match="not a PNG"):
        timage.read_png(str(jpg))


# ----------------------------------------------------- glTF and load_hdr


@pytest.mark.parametrize("layout", ["glb", "external", "data"])
def test_load_gltf_jpeg_and_16bit_textures_equal_jax(tmp_path, layout):
    """A document with a progressive JPEG base colour, a 16-bit PNG normal
    map, an Adam7 16-bit metallicRoughness map, a 4:2:2 JPEG labelled
    image/png (read by its content) and a 4-bit gray emissive map: every
    texture equals the JAX loader's."""
    rng = np.random.default_rng(7)
    w = gltf_scenes.GltfWriter()
    base = w.texture(w.image(jpeg_bytes(photo(1, 40, 24), progressive=True), "base", "image/jpeg"))
    normal = w.texture(w.image(gltf_scenes.encode_png(png_samples(rng, 16, 2, 17, 23), 16, filters=(4, 1)), "nrm"))
    mr = w.texture(w.image(gltf_scenes.encode_png(png_samples(rng, 16, 6, 9, 14), 16, interlace=True), "mr"))
    mislabelled = w.texture(w.image(jpeg_bytes(photo(2, 21, 13), subsampling=1), "jpeg as png", "image/png"))
    emissive = w.texture(w.image(gltf_scenes.encode_png(png_samples(rng, 4, 0, 6, 5), 4), "emi"))
    m0 = w.material(pbrMetallicRoughness={"baseColorTexture": {"index": base},
                                          "metallicRoughnessTexture": {"index": mr}},
                    normalTexture={"index": normal}, emissiveTexture={"index": emissive}, emissiveFactor=[1, 1, 1])
    m1 = w.material(pbrMetallicRoughness={"baseColorTexture": {"index": mislabelled}})
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    w.mesh([{"attributes": {"POSITION": w.accessor(pos), "TEXCOORD_0": w.accessor(uv)}, "material": m0},
            {"attributes": {"POSITION": w.accessor(pos + 2.0), "TEXCOORD_0": w.accessor(uv)}, "material": m1}])
    w.node(mesh=0)
    path = w.save(str(tmp_path / ("scene.glb" if layout == "glb" else "scene.gltf")), layout)
    got, want = tgltf.load_gltf(path), jgltf.load_gltf(path)
    assert len(got.textures) == len(want.textures) > 3 + 5  # the defaults, 5 images, the split metallicRoughness
    for a, b in zip(got.textures, want.textures):
        assert_same(a, b)
    assert [m.base_color_texture for m in got.materials] == [m.base_color_texture for m in want.materials]


def hdr_files(tmp_path) -> dict:
    rng = np.random.default_rng(9)
    files = {
        "rgb8.png": gltf_scenes.encode_png(png_samples(rng, 8, 2, 6, 10), 8, filters=(4,)),
        "rgb16.png": gltf_scenes.encode_png(png_samples(rng, 16, 2, 6, 10), 16, filters=(1, 3)),
        "gray16.png": gltf_scenes.encode_png(png_samples(rng, 16, 0, 6, 10), 16, interlace=True),
        "gray-alpha8.png": gltf_scenes.encode_png(png_samples(rng, 8, 4, 6, 10), 8),
        "palette.png": gltf_scenes.encode_png(png_samples(rng, 8, 3, 6, 10), 8, 3, palette=rng.integers(0, 256, (7, 3)),
                                              trns=b"\x00\x80"),
        "gray1.png": gltf_scenes.encode_png(png_samples(rng, 1, 0, 6, 10), 1),
        "photo.jpg": jpeg_bytes(photo(4, 33, 20)),
        "gray.jpeg": jpeg_bytes(photo(5, 33, 20).mean(axis=-1).astype(np.uint8), progressive=True),
    }
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    return {name: str(tmp_path / name) for name in files}


@pytest.mark.parametrize("name", ["rgb8.png", "rgb16.png", "gray16.png", "gray-alpha8.png", "palette.png",
                                  "gray1.png", "photo.jpg", "gray.jpeg"])
def test_load_hdr_png_and_jpeg_equal_jax(tmp_path, name):
    """The samples as imageio gives them: not divided by 255, gray repeated,
    a palette as its RGB colours, [..., :3] (a gray+alpha PNG keeps its 2
    channels, as in JAX)."""
    path = hdr_files(tmp_path)[name]
    assert_same(tenvmap.load_hdr(path), jenvmap.load_hdr(path))


# -------------------------------------------------------------- fixtures


@pytest.mark.parametrize("name", gltf_scenes.IMAGE_FIXTURES)
def test_fixtures_equal_their_recorded_pil_decodes(name):
    """Each committed fixture decodes to its NAME.ref.png (PIL's decode
    when it was written, as chip_smoke.py phase 11a checks it) and to PIL's
    decode here."""
    with open(os.path.join(gltf_scenes.IMAGE_DIR, name), "rb") as f:
        data = f.read()
    got = timage.decode_rgba(data, name)
    ref = timage.read_png(os.path.join(gltf_scenes.IMAGE_DIR, name + ".ref.png")).astype(np.float32) / 255.0
    assert_same(got, ref)
    assert_same(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0)


def test_timing_fixture_equals_its_recorded_digest():
    with open(os.path.join(gltf_scenes.IMAGE_DIR, gltf_scenes.TIMING_JPEG), "rb") as f:
        data = f.read()
    with open(os.path.join(gltf_scenes.IMAGE_DIR, gltf_scenes.TIMING_JPEG + ".sha256")) as f:
        digest = f.read().strip()
    got = np.round(timage.decode_rgba(data) * 255.0).astype(np.uint8)
    assert got.shape == (1024, 1024, 4) and len(data) <= 200_000
    assert hashlib.sha256(got.tobytes()).hexdigest() == digest
    size = sum(os.path.getsize(os.path.join(gltf_scenes.IMAGE_DIR, n)) for n in os.listdir(gltf_scenes.IMAGE_DIR))
    assert size < 300_000


# -------------------------------------------------------------- refusals


def patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """`data` with the byte `offset` bytes after the first `marker` set."""
    i = data.index(marker) + offset
    return data[:i] + bytes([value]) + data[i + 1 :]


def incomplete_progressive() -> bytes:
    """A progressive JPEG cut after its first four scans, with its EOI: the
    first AC coefficients stay incomplete."""
    data = jpeg_bytes(photo(6, 24, 16), progressive=True)
    starts = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[: starts[4]] + b"\xff\xd9"


def gif_bytes() -> bytes:
    out = io.BytesIO()
    Image.fromarray(photo(9, 13, 11)).save(out, format="GIF")
    return out.getvalue()


def webp_bytes(lossless: bool) -> bytes:
    out = io.BytesIO()
    Image.fromarray(photo(10, 13, 11)).save(out, format="WEBP", lossless=lossless)
    return out.getvalue()


def pfm_bytes() -> bytes:
    """A colour PFM: little-endian float32 rows, bottom row first."""
    rgb = np.random.default_rng(11).uniform(0, 7, (5, 6, 3)).astype("<f4")
    return b"PF\n6 5\n-1.0\n" + rgb[::-1].tobytes()


def refusal_cases() -> dict:
    """case -> (bytes, the refusal's words, or None for a file the port now
    reads as PIL does)."""
    rgb = jpeg_bytes(photo(8, 24, 16))
    cmyk = io.BytesIO()
    Image.new("CMYK", (9, 7), (10, 20, 30, 40)).save(cmyk, format="JPEG")
    sof = b"\xff\xc0"
    return {
        "cmyk": (cmyk.getvalue(), None),
        "truncated": (rgb[: len(rgb) // 2], "truncated"),
        "no-eoi": (rgb[:-2], "truncated"),
        "arithmetic": (patched(rgb, sof, 1, 0xC9), None),
        "12-bit": (patched(rgb, sof, 4, 12), "12-bit"),
        "lossless": (patched(rgb, sof, 1, 0xC3), "lossless"),
        "arithmetic-lossless": (patched(rgb, sof, 1, 0xCB), "arithmetic-coded lossless"),
        "hierarchical": (patched(rgb, sof, 1, 0xC5), "hierarchical"),
        "sampling-440": (patched(patched(rgb, sof, 11, 0x12), sof, 14, 0x11), None),
        "smoothing": (incomplete_progressive(), None),
        "gif": (gif_bytes(), None),
        "webp-lossless": (webp_bytes(True), None),
        "webp-lossy": (webp_bytes(False), None),
        "exr": (b"\x76\x2f\x31\x01" + bytes(64), "OpenEXR"),
        "pfm": (pfm_bytes(), "PFM"),
    }


@pytest.mark.parametrize("case", ["cmyk", "truncated", "no-eoi", "arithmetic", "12-bit", "lossless",
                                  "arithmetic-lossless", "hierarchical", "sampling-440", "smoothing", "gif",
                                  "webp-lossless", "webp-lossy", "exr", "pfm"])
def test_refusals_name_the_format(tmp_path, case):
    """What the port refuses it refuses naming the format and the image:
    SOF11, SOF5, 12-bit samples, a lossless frame whose scan has Ss 0 (no
    predictor) and a colour PFM texture as PIL refuses them (the colour PFM
    as an environment map reads as the JAX package's imageio reads it).  The CMYK JPEG, the 4:4:0 one, the
    progressive one that libjpeg smooths, the GIF, the lossless and lossy
    WebPs, and the Huffman-coded file whose SOF0 says SOF9 (PIL decodes its
    data as arithmetic code, to an image of noise), once refused, now decode
    as PIL decodes them (the JAX package's `_load_image`)."""
    data, reason = refusal_cases()[case]
    doc = gltf_image(data, "image/jpeg")
    doc["images"][0]["name"] = "wall"
    if reason is None:
        want = jgltf._load_image(doc, [], str(tmp_path), 0)
        assert want.shape[2] == 4
        assert_same(timage.decode_rgba(data, "wall"), want)
        assert_same(tgltf._load_image(doc, [], str(tmp_path), 0), want)
        return
    with pytest.raises(ValueError, match=reason):
        timage.decode_rgba(data, "wall")
    with pytest.raises(ValueError, match=f"wall: .*{reason}"):
        tgltf._load_image(doc, [], str(tmp_path), 0)
    if case in ("truncated", "no-eoi", "12-bit", "lossless", "arithmetic-lossless", "hierarchical"):
        # PIL refuses these too
        with pytest.raises(OSError):
            jgltf._load_image(doc, [], str(tmp_path), 0)
    if case == "pfm":  # as an environment map imageio reads one through OpenCV (as uint8), and so does the port
        path = tmp_path / "sky.pfm"
        path.write_bytes(data)
        assert_same(tenvmap.load_hdr(str(path)), jenvmap.load_hdr(str(path)))


@pytest.mark.parametrize("ext", [".exr", ".tif", ".pfm"])
def test_load_hdr_other_formats_raise(tmp_path, ext):
    """EXR and PFM raise naming the extension (the JAX package cannot read
    EXR here either: imageio finds no backend).  A float TIFF, once refused,
    now equals the JAX package's load_hdr (imageio's tifffile)."""
    path = tmp_path / f"sky{ext}"
    if ext == ".tif":
        sky = np.random.default_rng(12).uniform(0, 50, (6, 10, 3)).astype(np.float32)
        path.write_bytes(format_writers.encode_tiff(sky, compression=8, predictor=3, rows_per_strip=4))
        assert_same(tenvmap.load_hdr(str(path)), jenvmap.load_hdr(str(path)))
        np.testing.assert_array_equal(tenvmap.load_hdr(str(path)), sky)
        return
    path.write_bytes(b"\x76\x2f\x31\x01" + bytes(64))
    with pytest.raises(ValueError, match=ext.replace(".", r"\.")):
        tenvmap.load_hdr(str(path))
    if ext == ".exr":
        with pytest.raises(Exception):
            jenvmap.load_hdr(str(path))


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_files_raise_value_errors(seed):
    """Bytes changed, cut out or put in (1-5 edits) anywhere in JPEGs of
    each kind and in Adam7 and low-bit PNGs: every file decodes or raises
    a ValueError; nothing else escapes the parser or the C codec."""
    rng = np.random.default_rng(seed)
    img = photo(seed, 31, 23)
    seeds = [jpeg_bytes(img), jpeg_bytes(img, progressive=True), jpeg_bytes(img, subsampling=0,
                                                                            restart_marker_blocks=1),
             jpeg_bytes(img, progressive=True, subsampling=1),
             gltf_scenes.encode_png(png_samples(rng, 16, 6, 9, 7), 16, filters=(0, 1, 2, 3, 4), interlace=True),
             gltf_scenes.encode_png(png_samples(rng, 2, 0, 9, 13), 2, filters=(4, 3))]
    decoded = 0
    for i in range(150):
        data = bytearray(seeds[i % len(seeds)])
        for _ in range(int(rng.integers(1, 6))):
            at, kind = int(rng.integers(0, len(data))), int(rng.integers(0, 3))
            if kind == 0:
                data[at] = int(rng.integers(0, 256))
            elif kind == 1:
                del data[at : at + int(rng.integers(1, 40))]
            else:
                data[at:at] = rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
        try:
            decoded += timage.decode_rgba(bytes(data)).ndim == 3
        except ValueError:
            pass
    assert decoded > 0


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_huffman_files_match_pil(seed):
    """60 mutants per seed (a byte flipped, the file cut, a marker put in;
    tests/test_torch_jpeg_arith_lossless.mutant) of baseline, progressive,
    restart-marked and gray Huffman-coded JPEGs: where PIL decodes one the
    port gives the same pixels, bit for bit (a code that is no code decodes
    as 0, a marker inside the data leaves the MCUs after it, restart markers
    are resynchronised, block smoothing of a cut progressive file takes the
    bits before its last scan past the last good iMCU row, as libjpeg-turbo
    does); where PIL raises the port raises a ValueError."""
    from test_torch_jpeg_arith_lossless import mutant

    rng = np.random.default_rng(100 + seed)
    img = photo(seed, 37, 29)
    seeds = [jpeg_bytes(img, quality=80), jpeg_bytes(img, progressive=True), jpeg_bytes(img, restart_marker_blocks=2),
             jpeg_bytes(img.mean(axis=-1).astype(np.uint8), progressive=True, restart_marker_blocks=3)]
    read = refused = 0
    for i in range(60):
        data = mutant(rng, seeds[i % len(seeds)], i % 3)
        try:
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0
        except Exception:  # noqa: BLE001  (PIL raises many kinds; the port must raise a ValueError)
            with pytest.raises(ValueError):
                timage.decode_rgba(data)
            refused += 1
            continue
        got = timage.decode_rgba(data)
        assert got.shape == want.shape and np.array_equal(got, want), i
        read += 1
    assert read > 20 and refused > 5


# ------------------------------------------------------------- the codec


def test_failed_codec_build_raises(tmp_path, monkeypatch):
    """No fallback: when gcc cannot build the codec, the first decode raises."""
    monkeypatch.setattr(codec, "_lib", None)
    monkeypatch.setattr(codec, "_LIB", str(tmp_path / "libvpt_imgcodec.so"))
    monkeypatch.setattr(codec, "_SRC", str(tmp_path / "broken.c"))
    (tmp_path / "broken.c").write_text("this is not C\n")
    with pytest.raises(RuntimeError, match="gcc failed to build the image codec"):
        timage.decode_rgba(gltf_scenes.encode_png(np.zeros((2, 2, 3), np.uint8)))
    with pytest.raises(RuntimeError, match="gcc failed"):
        timage.decode_rgba(jpeg_bytes(photo(0, 8, 8)))
    assert not os.path.exists(str(tmp_path / "libvpt_imgcodec.so"))


def test_threads_share_one_build(tmp_path, monkeypatch):
    """Twelve threads decode at once from a cold codec: one build, loaded
    once, and every thread's image equal to the one-thread decode."""
    monkeypatch.setattr(codec, "_lib", None)
    monkeypatch.setattr(codec, "_LIB", str(tmp_path / "libvpt_imgcodec.so"))
    datas = [jpeg_bytes(photo(i, 40, 30), progressive=bool(i % 2)) for i in range(4)]
    datas += [gltf_scenes.encode_png(png_samples(np.random.default_rng(i), 16, 6, 20, 30), 16, interlace=True)
              for i in range(2)]
    results, errors = {}, []
    loads = []
    real_cdll = codec.ctypes.CDLL
    monkeypatch.setattr(codec.ctypes, "CDLL", lambda path: loads.append(path) or real_cdll(path))

    def work(i):
        try:
            results[i] = timage.decode_rgba(datas[i % len(datas)])
        except Exception as e:  # noqa: BLE001  (reported by the assertion below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads) and len(results) == 12
    assert len(loads) == 1
    for i, got in results.items():
        np.testing.assert_array_equal(got, timage.decode_rgba(datas[i % len(datas)]))

