"""The port's AVIF decoding (io/avif.py: the ISOBMFF container, the alpha
item or track, libavif's YUV -> RGB(A) as PIL asks for it; io/av1.py: the
OBU, sequence and frame headers, tiles; csrc/av1dec.c: the coded-lossless
key-frame decode) against the JAX package, which reads AVIF with PIL 12.1's
libavif 1.3.0 (`gltf._load_image` of the bytes and of the file,
`io.image.load_png`, `envmap.load_hdr` through imageio's pillow plugin).

Every fixture of tests/torch_avif/ (tests/make_torch_avif.py, cases in
tests/avif_cases.py) must give the same shape, dtype and values on the
four paths, bit for bit; a file the port refuses by name (lossy AV1, intra
block copy, a matrix it does not convert) is one the JAX package reads,
and the port's ValueError names the feature.  Also: the manifest (what
chip_smoke.py holds the port to on the card's machine), the matrix
coefficients libavif converts, edited into a file's `colr` box, and seeded
random lossless files under random settings.
"""

import base64
import hashlib
import io
import json
import os
import warnings

import numpy as np
import pytest

import avif_cases
import gltf_scenes
from vpt_tpu.io import image as jimage
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import av1, avif
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import envmap as tenvmap
from vpt_tpu_torch.scene import gltf as tgltf

FIXTURES = gltf_scenes.avif_fixtures()
with open(os.path.join(gltf_scenes.AVIF_DIR, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _data(name: str) -> bytes:
    with open(os.path.join(gltf_scenes.AVIF_DIR, name), "rb") as f:
        return f.read()


def _memory(data: bytes) -> dict:
    return {"images": [{"uri": "data:image/avif;base64," + base64.b64encode(data).decode(), "name": "wall"}]}


PATHS = {  # path -> (the JAX package's reader, the port's), each of (bytes, a file holding them)
    "rgba": (lambda d, p: jgltf._load_image(_memory(d), [], os.path.dirname(p), 0),
             lambda d, p: tgltf._load_image(_memory(d), [], os.path.dirname(p), 0)),
    "rgba_file": (lambda d, p: jgltf._load_image({"images": [{"uri": os.path.basename(p)}]}, [], os.path.dirname(p), 0),
                  lambda d, p: tgltf._load_image({"images": [{"uri": os.path.basename(p), "name": "wall"}]}, [],
                                                 os.path.dirname(p), 0)),
    "load_png": (lambda d, p: jimage.load_png(p), lambda d, p: timage.load_png(p)),
    "load_hdr": (lambda d, p: jenvmap.load_hdr(p), lambda d, p: tenvmap.load_hdr(p)),
}


def outcome(fn):
    """(value, None) or (None, the exception) of fn()."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(), None
    except Exception as e:  # noqa: BLE001  (PIL and imageio raise many kinds)
        return None, e


def held_to_jax(data: bytes, path: str, refused: str = None) -> None:
    """The four paths of the port on the file against the JAX package's:
    equal arrays; or, for a file the port refuses by name, a JAX read and
    the port's ValueError holding `refused`."""
    with open(path, "wb") as f:
        f.write(data)
    for key, (jax_read, port_read) in PATHS.items():
        want, err = outcome(lambda: jax_read(data, path))
        if refused is not None:
            assert err is None, (key, err)
            with pytest.raises(ValueError, match=refused):
                port_read(data, path)
            continue
        assert err is None, (key, err)
        got = port_read(data, path)
        assert got.dtype == want.dtype and got.shape == want.shape, (key, got.dtype, want.dtype, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_equals_jax(tmp_path, name):
    held_to_jax(_data(name), str(tmp_path / "sky.avif"), avif_cases.REFUSED.get(name))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_matches_manifest(tmp_path, name):
    """The port's four decodes against the manifest (the JAX package's
    decodes when the fixtures were made), as chip_smoke.py phase 17 checks
    them on a machine without PIL."""
    path = str(tmp_path / name)
    data = _data(name)
    with open(path, "wb") as f:
        f.write(data)
    for key, (_, port_read) in PATHS.items():
        want = MANIFEST[name][key]
        if name in avif_cases.REFUSED:
            assert want is not None
            with pytest.raises(ValueError):
                port_read(data, path)
            continue
        got = port_read(data, path)
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == want, key


def test_fixtures_are_the_cases():
    """tests/torch_avif/ holds each case of tests/avif_cases.py, under 2 MB
    in all; its timing textures and sky are among them."""
    assert sorted(FIXTURES) == sorted(avif_cases.CASES) == sorted(MANIFEST)
    assert set(gltf_scenes.AVIF_TIMING) | {gltf_scenes.AVIF_SKY} <= set(FIXTURES)
    assert gltf_scenes.AVIF_TIMING == avif_cases.TIMING and gltf_scenes.AVIF_SKY == avif_cases.SKY
    assert sum(len(_data(n)) for n in FIXTURES) < 2_000_000


def test_exif_orientation_leaves_pixels_unturned():
    """PIL writes an EXIF orientation as irot / imir and reads the pixels
    as stored (the orientation goes to the EXIF it reports): the port's
    array is the image PIL was given, up to the YUV round trip and 4:2:0
    chroma, in its stored orientation (not turned to 17x21)."""
    arr, mode = avif.read_pil(_data("exif-orientation-6.avif"))
    assert mode == "RGB" and arr.shape == (21, 17, 3)
    assert np.abs(arr.astype(int) - avif_cases.field("smooth", 21, 17, 3, 30)).mean() < 3  # 4:2:0 chroma


def test_sequence_reads_frame_zero():
    """An avis sequence opens as its first frame, with the alpha track's
    first sample."""
    for name, ch in (("avis-2-frames.avif", 3), ("avis-2-frames-rgba.avif", 4)):
        arr, mode = avif.read_pil(_data(name))
        first = avif_cases.field("noise", 24, 30, ch, 40)
        assert arr.shape == first.shape and mode == ("RGBA" if ch == 4 else "RGB")
        if ch == 4:
            np.testing.assert_array_equal(arr[..., 3], first[..., 3])


@pytest.mark.parametrize("sub", ["4:4:4", "4:2:0", "4:0:0"])
@pytest.mark.parametrize("mc", [0, 1, 2, 5, 6, 9])
def test_matrix_coefficients_as_libavif(tmp_path, sub, mc):
    """A file's colr matrix coefficients edited, full and limited range, RGB
    and RGBA: the port's decode equals PIL's, both refuse it, or the port
    refuses it by name (the matrices libavif converts by its own float path,
    and identity with subsampled chroma, which libavif refuses)."""
    counts = {"equal": 0, "refused": 0}
    for ch in (3, 4):
        base = avif_cases.pil_avif(avif_cases.field("noise", 9, 14, ch, mc + 10 * ch), subsampling=sub, speed=9)
        at = base.find(b"nclx") + 8
        for full in (0, 1):
            data = base[:at] + mc.to_bytes(2, "big") + bytes([full << 7]) + base[at + 3 :]
            want, err = outcome(lambda: jgltf._load_image(_memory(data), [], str(tmp_path), 0))
            got, mine = outcome(lambda: timage.decode_rgba(data, "wall"))
            if err is None and mine is None:
                np.testing.assert_array_equal(got, want)
                counts["equal"] += 1
            else:
                assert isinstance(mine, ValueError) and "wall" in str(mine), (ch, full, err, mine)
                assert err is not None or "matrix coefficients" in str(mine), (ch, full, mine)
                counts["refused"] += 1
    assert counts["equal"] >= (0 if (mc, sub) == (0, "4:2:0") else 1 if mc in (0, 9) else 4), counts


@pytest.mark.parametrize("seed", range(3))
def test_random_lossless_files_equal_pil(seed):
    """Seeded random images under random lossless settings (subsampling,
    range, alpha and its premultiplication, speed, tiles, size, content):
    the port's texture decode equals the JAX package's, or the port refuses
    intra block copy by name (aom's pick for some flat graphics)."""
    rng = np.random.default_rng(100 + seed)
    counts = {"equal": 0, "intrabc": 0}
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        ch = int(rng.choice([3, 4]))
        kind = str(rng.choice(["noise", "smooth", "flat"]))
        kw = {"subsampling": str(rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])),
              "range": str(rng.choice(["full", "limited"])), "speed": int(rng.choice([4, 6, 8, 10])),
              "alpha_premultiplied": bool(rng.integers(0, 2))}
        data = avif_cases.pil_avif(avif_cases.field(kind, h, w, ch, int(rng.integers(0, 1 << 30))), **kw)
        want, err = outcome(lambda: jgltf._load_image(_memory(data), [], ".", 0))
        assert err is None, err
        got, mine = outcome(lambda: timage.decode_rgba(data, "wall"))
        if mine is not None:
            assert isinstance(mine, av1.Refused) and "allow_intrabc" in str(mine), (kw, mine)
            counts["intrabc"] += 1
            continue
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, ch, kind, kw)))
        counts["equal"] += 1
    assert counts["equal"] >= 8, counts


def test_refusals_name_the_feature_and_its_queue():
    """Each refusal names the feature and ROADMAP's queue item."""
    for name, words in avif_cases.REFUSED.items():
        with pytest.raises(ValueError, match=words) as err:
            avif.read_pil(_data(name), name)
        assert "ROADMAP Queue 1" in str(err.value) and name in str(err.value)


def test_truncated_and_foreign_containers():
    """An AVIF cut inside its item data is refused as libavif refuses it; a
    file whose ftyp names no AVIF brand is passed on to PIL's next plugin,
    and neither PIL nor the port opens it."""
    data = _data("sub-420-smooth-65x33.avif")
    with pytest.raises(ValueError):
        avif.read_pil(data[: len(data) - 40], "cut")
    foreign = data[:8] + b"mif1" + data[12:16] + b"mif1" * ((data.find(b"meta") - 20) // 4) + data[data.find(b"meta") - 4 :]
    with pytest.raises(ValueError):
        timage.decode_rgba(foreign, "wall")
    with pytest.raises(Exception):  # noqa: B017  (PIL's UnidentifiedImageError)
        from PIL import Image

        Image.open(io.BytesIO(foreign)).load()
