"""The committed fixtures of tests/torch_pil_formats/ (TGA, DDS, Netpbm /
PFM, QOI, SGI, PCX, ICO / CUR, PSD) against their manifest, which
chip_smoke.py phase 17a holds the port to on a machine without PIL: each
decodes, through the texture path and load_hdr, to its entry (the JAX
package's decode when tests/make_torch_pil_formats.py wrote it) and to the
JAX package's decode here; the three 2048x2048 timing textures, made from a
seed by tests/pil_format_writers.py and not committed, decode to theirs;
and the folder stays small.
"""

import functools
import hashlib
import json
import os

import pytest

import gltf_scenes
import pil_format_checks as chk
import pil_format_writers as pw
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import envmap as tenvmap

DIR = gltf_scenes.PIL_FORMAT_DIR


def manifest() -> dict:
    with open(os.path.join(DIR, "manifest.json")) as f:
        return json.load(f)


@functools.lru_cache(maxsize=1)
def timing() -> dict:
    return pw.timing_textures()


def entry_of(fn):
    got, err = chk.outcome(fn)
    if err is not None:
        assert isinstance(err, ValueError), err
        return None
    return [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()]


def test_pil_format_fixtures_fit_their_budget():
    names = sorted(os.listdir(DIR))
    assert set(names) == set(gltf_scenes.PIL_FORMAT_FIXTURES) | {"manifest.json"}
    assert sorted(manifest()) == sorted(gltf_scenes.PIL_FORMAT_FIXTURES + gltf_scenes.PIL_FORMAT_TIMING)
    assert sum(os.path.getsize(os.path.join(DIR, n)) for n in names) < 100_000


@pytest.mark.parametrize("name", gltf_scenes.PIL_FORMAT_FIXTURES)
def test_pil_format_fixture_matches_its_manifest(name):
    """The texture decode of the bytes and load_hdr of the file: the
    manifest's entry, and the JAX package's decode here."""
    entry = manifest()[name]
    path = os.path.join(DIR, name)
    with open(path, "rb") as f:
        data = f.read()
    memory, _ = chk._docs(data, name)
    for key, port, jax in (("rgba", lambda: timage.decode_rgba(data, name),
                            lambda: jgltf._load_image(memory, [], DIR, 0)),
                           ("load_hdr", lambda: tenvmap.load_hdr(path), lambda: jenvmap.load_hdr(path))):
        assert entry_of(port) == entry[key], (name, key)
        want, err = chk.outcome(jax)
        assert (err is None) == (entry[key] is not None), (name, key)


@pytest.mark.parametrize("name", gltf_scenes.PIL_FORMAT_TIMING)
def test_timing_textures_match_the_manifest(tmp_path, name):
    """The 2048x2048 BC7 DDS, RLE TGA and QOI textures from their seed decode
    to the manifest's entries (the JAX package's decodes of the same bytes)."""
    data = timing()[name]
    path = tmp_path / name
    path.write_bytes(data)
    entry = manifest()[name]
    assert entry_of(lambda: timage.decode_rgba(data, name)) == entry["rgba"]
    assert entry_of(lambda: tenvmap.load_hdr(str(path))) == entry["load_hdr"]
