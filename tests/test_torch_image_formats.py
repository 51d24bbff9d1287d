"""The port's TIFF, GIF and BMP decoders and its CMYK / YCCK, any-sampling
and block-smoothed JPEGs (io/tiff.py, io/gif.py, io/bmp.py, io/jpeg.py and
the C codec of csrc/imgcodec.c) against the JAX package, which reads them
with PIL (`gltf._load_image`: `convert("RGBA")`) and imageio (`load_hdr`:
the bundled tifffile for .tif / .tiff, PIL for the rest): every case of
tests/format_cases.py must give the same shape, dtype and values on both
paths, or, where the JAX package raises, make the port raise a ValueError
that names the file.

Also: the cases each path of the JAX package refuses (so that no equality
above is vacuous), the codec's LZW, PackBits and predictors on their own,
corrupt TIFF, GIF, BMP and JPEG files (each decodes or raises a
ValueError), and the committed fixtures of tests/torch_formats/ against
their manifest (what chip_smoke.py phase 17a checks on the card's machine).
"""

import base64
import hashlib
import json
import os
import re
import warnings

import numpy as np
import pytest

import format_cases
import format_writers as fw
import gltf_scenes
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import envmap as tenvmap
from vpt_tpu_torch.scene import gltf as tgltf

CASES = sorted(format_cases.CASES)
# Files both packages refuse: a GIF whose codes end before its last pixel,
# JPEGs with 11 blocks in an MCU or sampling ratios that are no integers,
# BMP bit fields PIL has no raw mode for.
BROKEN = {"gif-codes-end-early", "jpeg-sampling-11-blocks-37x29", "jpeg-sampling-11-blocks-9x70",
          "jpeg-sampling-fractional-37x29", "jpeg-sampling-fractional-9x70", "bmp-bitfields-rgba-h40",
          "bmp-bitfields-rgb-green-high-h40", "bmp-bitfields-rgb-green-high-h56", "bmp-bitfields-rgb-green-high-h124"}


def pil_refuses(name: str) -> bool:
    """The TIFFs PIL opens no mode for (float RGB, float16 and float64,
    64-bit integers, big-endian 32-bit unsigned) or cannot parse (big-endian
    BigTIFF)."""
    if name.startswith("tifffile-"):
        return any(k in name for k in ("f32-rgb", "f16", "f64"))
    if not name.startswith("spec-"):
        return False
    layout = re.match(r"spec-(ii|mm)-\w+-p(\d)-\w+$", name)
    if layout:
        return layout[2] != "2" or (layout[1] == "mm" and format_cases.is_bigtiff(name))
    return any(k in name for k in ("predictor3", "shaped-description", "u64")) or name == "spec-u32-lzw-mm" or \
        name == "spec-u32-packbits-mm"


def tifffile_refuses(name: str) -> bool:
    """imageio's tifffile refuses the floating-point predictor in tiles."""
    return bool(re.match(r"spec-(ii|mm)-\w+-p3-tiles$", name))


def gltf_doc(data: bytes) -> dict:
    return {"images": [{"uri": "data:application/octet-stream;base64," + base64.b64encode(data).decode(),
                        "name": "wall"}]}


def outcome(fn):
    """(value, None) or (None, the exception) of fn()."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(), None
    except Exception as e:  # noqa: BLE001  (the JAX package's readers raise many kinds)
        return None, e


def assert_same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def jax_outcomes(name: str, tmp_path) -> tuple:
    """The file of case `name` at tmp_path, and the JAX package's texture
    and load_hdr outcomes on it."""
    ext, _ = format_cases.CASES[name]
    data = format_cases.case_bytes(name)
    path = tmp_path / f"sky{ext}"
    path.write_bytes(data)
    tex = outcome(lambda: jgltf._load_image(gltf_doc(data), [], str(tmp_path), 0))
    hdr = outcome(lambda: jenvmap.load_hdr(str(path)))
    return data, str(path), tex, hdr


@pytest.mark.parametrize("name", CASES)
def test_format_case_equals_jax(tmp_path, name):
    """The glTF texture decode and load_hdr of one file: equal to the JAX
    package's, or a ValueError naming the file where it raises."""
    data, path, (tex, tex_err), (hdr, hdr_err) = jax_outcomes(name, tmp_path)
    if tex_err is None:
        assert_same(tgltf._load_image(gltf_doc(data), [], str(tmp_path), 0), tex)
        assert_same(timage.decode_rgba(data, name), tex)
    else:
        with pytest.raises(ValueError, match="wall"):
            tgltf._load_image(gltf_doc(data), [], str(tmp_path), 0)
    if hdr_err is None:
        assert_same(tenvmap.load_hdr(path), hdr)
    else:
        with pytest.raises(ValueError, match="sky"):
            tenvmap.load_hdr(path)


def test_the_jax_package_reads_the_cases_it_is_held_to(tmp_path):
    """Which cases each path of the JAX package refuses, so that the
    equalities above are not vacuous: the broken files on both paths, the
    TIFF layouts PIL has no mode for on the texture path, tiled
    floating-point predictors on load_hdr's; it reads every other case."""
    for name in CASES:
        _, _, (_, tex_err), (_, hdr_err) = jax_outcomes(name, tmp_path)
        assert (tex_err is not None) == (name in BROKEN or pil_refuses(name)), (name, tex_err)
        assert (hdr_err is not None) == (name in BROKEN or tifffile_refuses(name)), (name, hdr_err)


# ------------------------------------------------------------- the codec


@pytest.mark.parametrize("size", [1, 2, 300, 5000, 70000])
def test_tiff_lzw_and_packbits_round_trip(size):
    """The codec decodes what tests/format_writers.py encodes: random bytes
    and runs, past the 4,096-entry table (CLEAR codes) and at every width."""
    rng = np.random.default_rng(size)
    data = (np.repeat(rng.integers(0, 256, size // 3 + 1), rng.integers(1, 6, size // 3 + 1))[:size]
            .astype(np.uint8).tobytes())
    assert codec.tiff_lzw(fw.tiff_lzw(data), len(data)).tobytes() == data
    assert codec.tiff_lzw(fw.tiff_lzw(data), 0, count=True) == len(data)
    assert codec.packbits(fw.packbits(data), len(data)).tobytes() == data
    with pytest.raises(ValueError, match="CLEAR"):
        codec.tiff_lzw(b"\x00\x00\x00\x00", 10)


@pytest.mark.parametrize("dtype", ["u1", "u2", "i4", "u8"])
def test_horizontal_predictor_wraps(dtype):
    rng = np.random.default_rng(len(dtype))
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, (5, 12), dtype=dtype)
    diff = x.copy()
    diff[:, 3:] = x[:, 3:] - x[:, :-3]
    codec.tiff_unpredict(diff, 3)
    np.testing.assert_array_equal(diff, x)


@pytest.mark.parametrize("dtype", ["f2", "f4", "f8"])
def test_floating_point_predictor(dtype):
    x = np.random.default_rng(4).normal(0, 100, (3, 7, 2)).astype(dtype)
    raw = np.frombuffer(fw._predict(x, 3, "<"), np.uint8)
    out = codec.tiff_unpredict_float(raw, 3, 14, 2, x.dtype.itemsize).view(dtype).reshape(x.shape)
    np.testing.assert_array_equal(out, x)


# --------------------------------------------------------------- corrupt


def corrupt(rng, data: bytes) -> bytes:
    data = bytearray(data)
    for _ in range(int(rng.integers(1, 6))):
        at, kind = int(rng.integers(0, len(data))), int(rng.integers(0, 3))
        if kind == 0:
            data[at] = int(rng.integers(0, 256))
        elif kind == 1:
            del data[at : at + int(rng.integers(1, 40))]
        else:
            data[at:at] = rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8).tobytes()
    return bytes(data)


SWEEP_SEEDS = {
    "tiff": ["spec-ii-lzw-p2-tiles", "spec-mm-deflate-p3-strips", "spec-mm-packbits-p1-planar", "tifffile-f32-rgb",
             "spec-palette-8bit-lzw-mm", "spec-bilevel-none-ii", "spec-gray-4bit-lzw-mm", "pil-tiff-RGB-tiff_lzw"],
    "gif": ["gif-global-interlaced-inside-transparent", "gif-local-rows-past", "gif-256-colours-table-resets"],
    "bmp": ["bmp-rle8-runs-h40", "bmp-rle4-noise-h124", "bmp-p4-h12", "bmp-bitfields-565-h56", "bmp-32-h124-top-down"],
    "jpeg": ["jpeg-sampling-440-37x29", "jpeg-4-components-adobe-2-420", "jpeg-smoothing-420-17x70-2-scans"],
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", sorted(SWEEP_SEEDS))
def test_corrupt_files_raise_value_errors(tmp_path, kind, seed):
    """Bytes changed, cut out or put in (1-5 edits) anywhere in each kind's
    seed files: every file decodes or raises a ValueError, on both paths;
    nothing else escapes the parsers or the C codec."""
    rng = np.random.default_rng(seed * 7 + len(kind))
    names = SWEEP_SEEDS[kind]
    decoded = 0
    for i in range(90):
        name = names[i % len(names)]
        data = corrupt(rng, format_cases.case_bytes(name))
        try:
            decoded += timage.decode_rgba(data, name).ndim == 3
        except ValueError:
            pass
        path = tmp_path / f"sky{format_cases.CASES[name][0]}"
        path.write_bytes(data)
        try:
            tenvmap.load_hdr(str(path))
        except ValueError:
            pass
    assert decoded > 0


# -------------------------------------------------------------- fixtures


def test_format_fixtures_fit_their_budget():
    names = sorted(os.listdir(gltf_scenes.FORMAT_DIR))
    assert set(names) == set(gltf_scenes.FORMAT_FIXTURES) | {"manifest.json"}
    assert sum(os.path.getsize(os.path.join(gltf_scenes.FORMAT_DIR, n)) for n in names) < 200_000


@pytest.mark.parametrize("name", gltf_scenes.FORMAT_FIXTURES)
def test_format_fixture_matches_its_manifest(tmp_path, name):
    """Each committed fixture decodes, through the texture path and
    load_hdr, to its manifest entry (shape, dtype, sha256 of the bytes, as
    the JAX package decoded it when it was written), and to the JAX
    package's decode here."""
    with open(os.path.join(gltf_scenes.FORMAT_DIR, "manifest.json")) as f:
        entry = json.load(f)[name]
    path = os.path.join(gltf_scenes.FORMAT_DIR, name)
    with open(path, "rb") as f:
        data = f.read()
    for key, port, jax in (("rgba", lambda: timage.decode_rgba(data, name),
                            lambda: jgltf._load_image(gltf_doc(data), [], ".", 0)),
                           ("load_hdr", lambda: tenvmap.load_hdr(path), lambda: jenvmap.load_hdr(path))):
        want, err = outcome(jax)
        if entry[key] is None:
            assert err is not None
            with pytest.raises(ValueError, match=name):
                port()
            continue
        got = port()
        assert_same(got, want)
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == entry[key]


# ------------------------------------------------- formats PIL opens


def pil_bytes(fmt: str, mode: str = "RGB", **kw) -> bytes:
    from io import BytesIO

    from PIL import Image

    out = BytesIO()
    img = Image.fromarray(np.random.default_rng(len(fmt)).integers(0, 256, (6, 7, 3), np.uint8)).convert(mode)
    img.save(out, format=fmt, **kw)
    return out.getvalue()


PIL_ONLY = {  # case -> (the file, the format named in the refusal, or None where the port reads it)
    "ppm-p6": (lambda: pil_bytes("PPM"), None),
    "pgm-p5": (lambda: pil_bytes("PPM", "L"), None),
    "pbm-p4": (lambda: pil_bytes("PPM", "1"), None),
    "pbm-p1-ascii": (lambda: b"P1\n3 2\n1 0 1\n0 1 0\n", None),
    "pgm-p2-ascii": (lambda: b"P2\n3 2\n255\n0 128 255\n7 8 9\n", None),
    "ppm-p3-ascii": (lambda: b"P3\n2 1\n255\n255 0 0 0 0 255\n", None),
    "qoi": (lambda: pil_bytes("QOI"), None),
    "dds": (lambda: pil_bytes("DDS"), None),
    "jpeg2000-jp2": (lambda: pil_bytes("JPEG2000"), None),
    "jpeg2000-codestream": (lambda: pil_bytes("JPEG2000", no_jp2=True), None),
    "sgi": (lambda: pil_bytes("SGI"), None),
    "avif": (lambda: pil_bytes("AVIF", quality=60, advanced={"enable-qm": "1"}), "AVIF"),  # quantizer matrices
}


@pytest.mark.parametrize("case", list(PIL_ONLY))
def test_formats_pil_opens_are_refused_by_name(tmp_path, case):
    """Files that the JAX package reads (PIL opens them): the port's texture
    decode gives the JAX package's array where it reads the format (Netpbm,
    QOI, DDS, SGI, JPEG 2000), and where it does not read it yet (AVIF
    with quantizer matrices) raises a ValueError naming the image, the
    format and that PIL opens it, not "unknown format"."""
    make, kind = PIL_ONLY[case]
    data = make()
    doc = {"images": [{"uri": "data:image/x;base64," + base64.b64encode(data).decode(), "name": "wall"}]}
    want = jgltf._load_image(doc, [], str(tmp_path), 0)
    assert want.ndim == 3
    if kind is None:
        assert_same(tgltf._load_image(doc, [], str(tmp_path), 0), want)
        return
    with pytest.raises(ValueError, match=re.escape(f"wall: {kind} images are not read yet (PIL opens them")):
        tgltf._load_image(doc, [], str(tmp_path), 0)
