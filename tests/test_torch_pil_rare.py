"""PIL's rarer plugins in the port (io/blp.py, icns.py, dcx.py, fits.py,
ftex.py, gbr.py, im.py, msp.py, spider.py, sun.py, xbm.py, xpm.py,
xvthumb.py, fli.py, iptc.py, mcidas.py, pcd.py, pixar.py, raw.py and the C
loops of csrc/imgcodec.c) against the JAX package, which reads them with
PIL (the glTF texture decode from memory and from a file, `load_png`) and
imageio (`load_hdr` under each extension): every case of
tests/pil_rare_cases.py and a seeded sweep of corrupt copies give the same
arrays on every path, or a ValueError where the JAX package raises; the
committed fixtures of tests/torch_pil_rare/ and the generated files decode
to their manifest; PIL's raw unpackers, its PhotoYCC and YCbCr conversions
equal the port's on every input; and the plugins that decode on neither
machine (BUFR, GRIB, HDF5, EPS, MPEG, WMF) raise in both packages.
"""

import functools
import hashlib
import io
import json
import os
import re
import warnings

import numpy as np
import pytest
from PIL import Image

import gltf_scenes
import pil_format_checks as chk
import pil_rare_cases as pc
import pil_rare_writers as pw
from vpt_tpu.io import image as jimage
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.io import pcd, raw
from vpt_tpu_torch.scene import envmap as tenvmap

NAMES = [n for n in pc.CASES if not n.startswith("never")]
# Cases the JAX package refuses on every path (it reads the rest on every
# path but those of PARTIAL).
REFUSED = {"dcx-no-page", "ftex-two-formats", "ftex-kind-3", "pixar-other-mode", "im-type-pa", "im-float-size",
           "sun-palette-on-rgb", "xpm-none-used", "blp-blp2-dxt-other", "fli-prefix-chunk", "iptc-long-field-iim",
           "fits-gzip-32"}
_PIL_ONLY = {"texture", "texture-file", "load_png"}  # imageio fails where PIL's image has no palette or seek
PARTIAL = {"spider-pil": _PIL_ONLY, "spider-little": _PIL_ONLY, "im-type-b2": _PIL_ONLY, "im-type-b4": _PIL_ONLY,
           "im-type-plain-p": _PIL_ONLY, "icns-png-p": {"texture", "texture-file"}}
# A refusal of the port's where the JAX package's array is memory nobody
# wrote (np.asarray past PIL's buffer): no reader can give the same.
_OVERREAD = "np.asarray reads past PIL's buffer"


def _failures(result: dict) -> list:
    return [v for k, v in result.items() if k != "_jax" and v and _OVERREAD not in v]


@pytest.mark.parametrize("name", NAMES)
def test_case_equals_jax(tmp_path, name):
    """One file on the texture path (from memory and from a file),
    load_png and load_hdr under each of its format's extensions: equal, or
    refused by both; and the JAX package reads it where it should, so no
    equality is vacuous."""
    result = chk.compare(pc.case_bytes(name), str(tmp_path), pc.EXTENSIONS[name.split("-")[0]])
    assert _failures(result) == []
    keys = {k for k in result if k != "_jax"}
    want = set() if name in REFUSED else {k for k in keys if k.split(".")[0] in PARTIAL[name]} if name in PARTIAL \
        else keys
    assert set(result["_jax"]) == want


@pytest.mark.parametrize("seed", range(24))
def test_corrupt_files_equal_jax(tmp_path, seed):
    """Corrupt copies (a byte changed, the file cut, a byte put in; 12 per
    seed, each of another case): each decodes as the JAX package decodes it
    on every path, or raises a ValueError where it raises."""
    for k in range(12):
        name = NAMES[(seed * 12 + k) * 7 % len(NAMES)]
        data = pc.mutants(name, seed, 1)[0]
        result = chk.compare(data, str(tmp_path), pc.EXTENSIONS[name.split("-")[0]])
        assert _failures(result) == [], name


_NEVER_EXTENSIONS = {"bufr": ".bufr", "grib": ".grib", "hdf5": ".h5", "eps": ".eps", "mpeg": ".mpg", "wmf": ".wmf"}
_NEVER_NAMES = {"bufr": "BUFR", "grib": "GRIB", "hdf5": "HDF5", "eps": "EPS (PostScript)", "mpeg": "MPEG",
                "wmf": "WMF / EMF"}


@pytest.mark.parametrize("fmt", sorted(_NEVER_EXTENSIONS))
def test_never_decodable_plugins_raise_in_both(tmp_path, fmt):
    """A file PIL's BUFR, GRIB, HDF5, EPS, MPEG or WMF plugin claims: PIL
    has no handler, Ghostscript, decoder or Windows for it here (nor on the
    card's machine), so the JAX package raises on its three paths; the
    port raises too, naming the format."""
    data = pc.case_bytes(f"never-{fmt}")
    path = tmp_path / f"img{_NEVER_EXTENSIONS[fmt]}"
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert Image.open(io.BytesIO(data)).format in ("BUFR", "GRIB", "HDF5", "EPS", "MPEG", "WMF")
    memory, by_file = chk._docs(data, path.name)
    for call in (lambda: jgltf._load_image(memory, [], str(tmp_path), 0),
                 lambda: jgltf._load_image(by_file, [], str(tmp_path), 0), lambda: jimage.load_png(str(path)),
                 lambda: jenvmap.load_hdr(str(path))):
        assert chk.outcome(call)[1] is not None
    kind = re.escape(_NEVER_NAMES[fmt])
    for call in (lambda: timage.decode_rgba(data, "wall"), lambda: timage.load_png(str(path))):
        with pytest.raises(ValueError, match=f"{kind} images are not read"):
            call()
    with pytest.raises(ValueError):
        tenvmap.load_hdr(str(path))


def _manifest() -> dict:
    with open(os.path.join(gltf_scenes.PIL_RARE_DIR, "manifest.json")) as f:
        return json.load(f)


def _entry(fn):
    got, err = chk.outcome(fn)
    if err is not None:
        assert isinstance(err, ValueError), err
        return None
    return [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()]


def _port_entries(data: bytes, path: str) -> dict:
    name = os.path.basename(path)
    return {"rgba": _entry(lambda: timage.decode_rgba(data, name)),
            "rgba_file": _entry(lambda: timage.decode_rgba(data, name, from_file=True)),
            "load_png": _entry(lambda: timage.load_png(path)), "load_hdr": _entry(lambda: tenvmap.load_hdr(path))}


def test_pil_rare_fixtures_fit_their_budget():
    names = gltf_scenes.pil_rare_fixtures()
    assert set(_manifest()) == set(names) | set(pw.generated_names())
    assert sum(os.path.getsize(os.path.join(gltf_scenes.PIL_RARE_DIR, n)) for n in names) < 400_000


@pytest.mark.parametrize("name", gltf_scenes.pil_rare_fixtures())
def test_pil_rare_fixture_matches_its_manifest(name):
    """The four decodes of each committed fixture: the manifest's entries
    (the JAX package's decodes when tests/make_torch_pil_rare.py wrote it),
    which chip_smoke.py phase 17a holds the port to on the card's machine."""
    path = os.path.join(gltf_scenes.PIL_RARE_DIR, name)
    with open(path, "rb") as f:
        data = f.read()
    assert _port_entries(data, path) == _manifest()[name]


@functools.lru_cache(maxsize=1)
def _generated() -> dict:
    return pw.generated()


@pytest.mark.parametrize("name", pw.generated_names())
def test_generated_files_match_the_manifest(tmp_path, name):
    """The PhotoCD cases, the 2048x2048 timing textures and the 4096x2048
    FITS sky, from their seeds: the manifest's entries."""
    path = tmp_path / name
    path.write_bytes(_generated()[name])
    assert _port_entries(_generated()[name], str(path)) == _manifest()[name]


@pytest.mark.parametrize("pair", [f"{m}/{r}" for m, rs in raw.PAIRS.items() for r in rs])
def test_raw_unpackers_equal_pil(pair):
    """Every unpacker the port has, on random bytes at an odd width: PIL's
    `frombytes(mode, size, data, "raw", rawmode)` array."""
    mode, rawmode = pair.split("/")
    rng = np.random.default_rng(len(pair))
    w, h = 13, 5
    data = rng.integers(0, 256, (w * raw.bits(rawmode) + 7) // 8 * h, np.uint8).tobytes()
    want = np.asarray(Image.frombytes(mode, (w, h), data, "raw", rawmode))
    got = raw.set_as_raw(data, w, h, mode, "x", rawmode)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _all_triples() -> np.ndarray:
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8)


def test_photoycc_equals_pil_on_every_input():
    """PhotoCD's PhotoYCC -> RGB (io/pcd.py) on all 2**24 inputs: PIL's
    "YCC;P" unpacker."""
    ycc = _all_triples()
    want = np.asarray(Image.frombytes("RGB", (4096, 4096), ycc.tobytes(), "raw", "YCC;P")).reshape(-1, 3)
    np.testing.assert_array_equal(pcd.ycc_to_rgb(ycc), want)


def test_ycbcr_equals_pil_on_every_input():
    """An IM "YCC image" through convert("RGBA") (io/image.py): PIL's
    YCbCr -> RGB conversion on all 2**24 inputs."""
    ycc = _all_triples()
    want = np.asarray(Image.frombytes("YCbCr", (4096, 4096), ycc.tobytes()).convert("RGB")).reshape(-1, 3)
    np.testing.assert_array_equal(timage._ycbcr_to_rgb(ycc), want)


@pytest.mark.parametrize("name, fmt", [("pixar-other-mode", None), ("dcx-no-page", None), ("imt-basic", "IMT"),
                                       ("iptc-raw-l", "IPTC"), ("spider-pil", "SPIDER"), ("pcd-orientation1", "PCD")])
def test_plugin_order(name, fmt):
    """Files of the plugins PIL tries on every file (IM Tools, IPTC,
    SPIDER, PhotoCD) or that pass a file on (a PIXAR layout without a mode,
    a DCX directory without a page): PIL's `Image.open` gives them the
    format the port reads them as, or refuses them as the port does."""
    data = pc.case_bytes(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = chk.outcome(lambda: Image.open(io.BytesIO(data)).format)[0]
    assert got == fmt
    if fmt is None:
        with pytest.raises(ValueError):
            timage.decode_rgba(data, name)
    else:
        assert timage._open(data, name)[0] == fmt
