"""JPEG 2000 in the port (io/jpeg2000.py, csrc/j2kdec.c) against the JAX
package, which reads it through PIL 12.1 and OpenJPEG 2.5.4.

Every case of tests/jpeg2000_cases.py (PIL's and OpenCV's writers at their
options, JP2 boxes and codestream edits built here) on the three paths: the
glTF texture decode from memory and from a file, `load_png`, and `load_hdr`
under each of the six JPEG 2000 extensions: equal arrays, or a ValueError
where the JAX package raises.  The fixtures of tests/torch_jpeg2000/ against
their manifest; a seeded corrupt sweep against PIL; PIL's YCbCr table over
all 2**24 inputs (the sYCC unpacker).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

import gltf_scenes
import jpeg2000_cases as jc
import pil_format_checks as chk
from vpt_tpu_torch.io import codec, jpeg2000
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import envmap as tenvmap

NAMES = sorted(jc.CASES)
# The cases the JAX package decodes on none of its paths (PIL or OpenJPEG
# refuses them), which the port must refuse too.
REFUSED = {"box-pclr-16bit", "box-pclr-300", "box-colr17-3", "box-colr16-1", "box-colr24-3", "box-jp-after",
           "box-ihdr-size", "cs-style01-97", "cs-style04-97", "cs-style03-97", "cs-style40", "cs-style40-97",
           "cs-rgn31", "cs-scod4", "cs-cbd-wrong-count", "cs-mco-bad-size", "cs-mcc-missing-array"}


@pytest.mark.parametrize("name", NAMES)
def test_cases_equal_jax_on_every_path(tmp_path, name):
    result = chk.compare(jc.case_bytes(name), str(tmp_path), gltf_scenes.JPEG2000_EXTENSIONS)
    assert [v for k, v in result.items() if k != "_jax" and v] == []
    keys = {k for k in result if k != "_jax"}
    assert set(result["_jax"]) == (set() if name in REFUSED else keys)


def test_repacked_headers_decode_as_the_plain_codestream():
    """Packet headers moved to PPM / PPT markers, SOP and EPH markers put
    in: the same pixels as the plain codestream (all from one seed), which
    is PIL's lossless decode of the image."""
    plain = timage._pil_image(jc.case_bytes("cs-repacked"), "plain")[0]
    want = jc.image(np.random.default_rng(2000), 21, 23, 3)
    np.testing.assert_array_equal(plain, want)
    for name in ("cs-ppm", "cs-ppt", "cs-sop-eph", "cs-ppm-sop-eph", "cs-ppt-eph"):
        np.testing.assert_array_equal(timage._pil_image(jc.case_bytes(name), name)[0], plain)


@pytest.mark.parametrize("seed", range(16))
def test_corrupt_files_equal_pil(seed):
    """Corrupt copies (a byte set, the file cut, a byte put in; 24 per seed,
    each of another case): PIL and the port both raise, or give equal
    arrays (the texture decode, PIL's `convert("RGBA")`)."""
    for k in range(24):
        name = NAMES[(seed * 24 + k) * 7 % len(NAMES)]
        data = jc.mutants(name, seed, 1)[0]
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")).astype(np.float32) / np.float32(255)
        except Exception:  # noqa: BLE001  (PIL raises many kinds)
            want = None
        if want is None:
            with pytest.raises(ValueError):
                timage.decode_rgba(data, name)
        else:
            np.testing.assert_array_equal(timage.decode_rgba(data, name), want, err_msg=f"{name} seed {seed}")


def _fixture(fname: str) -> bytes:
    with open(os.path.join(gltf_scenes.JPEG2000_DIR, fname), "rb") as f:
        return f.read()


def _manifest() -> dict:
    with open(os.path.join(gltf_scenes.JPEG2000_DIR, "manifest.json")) as f:
        return json.load(f)


def test_fixtures_are_the_cases():
    """tests/torch_jpeg2000/ holds every case under its name and extension
    (as tests/make_torch_jpeg2000.py wrote it), the timing textures and the
    sky, and its manifest names each."""
    names = gltf_scenes.jpeg2000_fixtures()
    want = {n + jc.CASES[n][0] for n in NAMES} | set(gltf_scenes.JPEG2000_TIMING) | {gltf_scenes.JPEG2000_SKY}
    assert set(names) == want
    assert sorted(_manifest()) == sorted(names)
    for name in NAMES[::9]:  # the writers here still make the committed bytes
        assert jc.case_bytes(name) == _fixture(name + jc.CASES[name][0]), name
    for fname in gltf_scenes.JPEG2000_TIMING:
        assert len(_fixture(fname)) <= 500_000


@pytest.mark.parametrize("fname", [n for n in gltf_scenes.jpeg2000_fixtures() if not n.startswith("timing")])
def test_fixture_matches_manifest(tmp_path, fname):
    """The port's texture decode and load_hdr of each fixture to the sha256
    of the JAX package's (null: both refuse), as chip_smoke.py phase 17a
    checks on the card's machine."""
    entry = _manifest()[fname]
    data = _fixture(fname)
    for key, fn in (("rgba", lambda: timage.decode_rgba(data, fname)),
                    ("load_hdr", lambda: tenvmap.load_hdr(os.path.join(gltf_scenes.JPEG2000_DIR, fname)))):
        if entry[key] is None:
            with pytest.raises(ValueError):
                fn()
            continue
        got = fn()
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == entry[key], key


def test_timing_textures_match_manifest():
    entry = _manifest()
    for fname in gltf_scenes.JPEG2000_TIMING:
        got = timage.decode_rgba(_fixture(fname), fname)
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == entry[fname]["rgba"]


def test_ycc_tables_are_pil_s():
    """The sYCC unpacker's YCbCr -> RGB tables give PIL's conversion on all
    2**24 inputs."""
    v = np.arange(1 << 24, dtype=np.uint32)
    ycc = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), ycc.tobytes()).convert("RGB")).astype(np.int32)
    t = jpeg2000._ycc_tables().astype(np.int32)
    y, cb, cr = (ycc[..., k].astype(np.int32) for k in range(3))
    got = np.stack([y + (t[cr] >> 6), y + ((t[256 + cb] + t[512 + cr]) >> 6), y + (t[768 + cb] >> 6)], -1)
    np.testing.assert_array_equal(np.clip(got, 0, 255), want)


def test_refusals_name_what_is_not_read():
    """High-throughput code-blocks are refused by name; PIL's errors before
    decoding pass the file on or refuse it as PIL does."""
    with pytest.raises(ValueError, match="high-throughput"):
        timage.decode_rgba(jc.case_bytes("cs-style40"), "ht")
    with pytest.raises(ValueError, match="unknown format"):  # SIZ cut: PIL's struct.error passes it on, no plugin takes it
        timage.decode_rgba(jpeg2000.CODESTREAM + b"\x00\x29\x00", "cut")


def test_the_decoder_is_built_from_its_source():
    lib = codec.j2k_library()
    assert os.path.basename(codec._J2K_SRC) == "j2kdec.c" and hasattr(lib, "vpt_j2k_decode")
    assert "-ffp-contract=off" in codec._J2K_CMD


def test_threads_decode_as_one_does():
    """load_gltf decodes its images on a thread pool, and ctypes lets the C
    decoder run without the interpreter lock: 48 decodes at once give the
    arrays of one decode at a time."""
    from concurrent.futures import ThreadPoolExecutor

    datas = [jc.case_bytes(n) for n in NAMES if n not in REFUSED][:48]
    want = [timage.decode_rgba(d, "one") for d in datas]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda d: timage.decode_rgba(d, "threads"), datas))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rows_past_pil_s_tobytes_limit_are_refused():
    """`np.asarray` of a PIL image goes through `tobytes`, which refuses a
    row wider than INT_MAX // bits - 7 pixels: a JPEG 2000 file of one row
    that wide decodes in PIL and then fails on every path; the port refuses
    it at the same width (67,108,857 RGBA pixels)."""
    im = Image.new("RGBA", (0x7FFFFFFF // 32 - 6, 1))
    with pytest.raises(MemoryError):
        np.asarray(im)
    with pytest.raises(ValueError, match="tobytes"):
        timage._as_array_check(0x7FFFFFFF // 32 - 6, "RGBA", "wide")
    timage._as_array_check(0x7FFFFFFF // 32 - 7, "RGBA", "wide")
    timage._as_array_check(0x7FFFFFFF // 8 - 7, "L", "wide")
