"""The port's WebP decoding (io/webp.py: the RIFF container, the first
frame, the mode; csrc/webpdec.c through io/codec.py: VP8L, VP8 key frames,
ALPH planes) against the JAX package, which reads WebP with PIL 12.1's
libwebp (`gltf._load_image`: `convert("RGBA")`; `envmap.load_hdr`:
imageio, frame 0 as uint8; `io.image.load_png`: PIL's array / 255).

Every case of tests/webp_cases.py must give the same shape, dtype and
values on the three paths, bit for bit, or, where the JAX package raises,
make the port raise a ValueError naming the file.  Also: the cases PIL
refuses (so no equality is vacuous), a sweep of seeded byte flips,
truncations and insertions over lossless, lossy and multi-partition files
(where PIL refuses the port refuses, where PIL decodes the arrays are
equal), the decoders writing into a strided canvas, and the committed
fixtures of tests/torch_webp/ (encoder settings PIL does not expose) against
their manifest and the JAX package.
"""

import base64
import hashlib
import json
import os
import struct
import warnings

import numpy as np
import pytest

import gltf_scenes
import webp_cases
from vpt_tpu.io import image as jimage
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.io import webp
from vpt_tpu_torch.scene import envmap as tenvmap
from vpt_tpu_torch.scene import gltf as tgltf

CASES = sorted(webp_cases.CASES)


def gltf_doc(data: bytes) -> dict:
    return {"images": [{"uri": "data:image/webp;base64," + base64.b64encode(data).decode(), "name": "wall"}]}


def outcome(fn):
    """(value, None) or (None, the exception) of fn()."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return fn(), None
    except Exception as e:  # noqa: BLE001  (PIL and imageio raise many kinds)
        return None, e


def assert_same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


PATHS = {  # path -> (the JAX package's reader, the port's)
    "texture": (lambda data, path: jgltf._load_image(gltf_doc(data), [], os.path.dirname(path), 0),
                lambda data, path: tgltf._load_image(gltf_doc(data), [], os.path.dirname(path), 0)),
    "load_hdr": (lambda data, path: jenvmap.load_hdr(path), lambda data, path: tenvmap.load_hdr(path)),
    "load_png": (lambda data, path: jimage.load_png(path), lambda data, path: timage.load_png(path)),
}


def held_to_jax(data: bytes, path: str) -> dict:
    """Each path of the port on the file (also written at `path`) against
    the JAX package's: equal arrays, or a ValueError naming the file where
    the JAX package raises.  Returns whether the JAX package read it, per
    path."""
    with open(path, "wb") as f:
        f.write(data)
    read = {}
    for key, (jax_read, port_read) in PATHS.items():
        want, err = outcome(lambda: jax_read(data, path))
        read[key] = err is None
        if err is None:
            assert_same(port_read(data, path), want)
            if key == "texture":
                assert_same(timage.decode_rgba(data, "wall"), want)
        else:
            with pytest.raises(ValueError, match="wall" if key == "texture" else "sky"):
                port_read(data, path)
    return read


@pytest.mark.parametrize("name", CASES)
def test_webp_case_equals_jax(tmp_path, name):
    """The texture decode, load_hdr and load_png of one file: bitwise the
    JAX package's, or a ValueError naming the file where it raises."""
    read = held_to_jax(webp_cases.case_bytes(name), str(tmp_path / "sky.webp"))
    assert set(read.values()) == {name not in webp_cases.REFUSED}, read


def test_modes_follow_libwebps_sniff():
    """The mode is what WebPGetFeatures says of the whole file, not what
    the pixels hold: an opaque RGBA image saved lossless is "RGB"; a VP8X
    file whose alpha flag is set over a VP8L image without alpha is "RGB";
    one whose flag is clear over an ALPH chunk is "RGBA" with alpha 255 (the
    demuxer drops the chunk)."""
    rgba = webp_cases.field(np.random.default_rng(0), 9, 11, 4)
    rgba[..., 3] = 255
    modes = {"opaque": webp.read_pil(webp_cases.pil_webp(rgba, lossless=True))[1]}
    for name in ("vp8x-alpha-flag-vp8l-without-alpha", "vp8x-alph-without-alpha-flag", "vp8x-no-flag-vp8l-with-alpha",
                 "animation-without-alpha-flag"):
        arr, modes[name] = webp.read_pil(webp_cases.case_bytes(name), name)
        if name == "vp8x-alph-without-alpha-flag":
            assert (arr[..., 3] == 255).all()
    assert modes == {"opaque": "RGB", "vp8x-alpha-flag-vp8l-without-alpha": "RGB", "vp8x-alph-without-alpha-flag":
                     "RGBA", "vp8x-no-flag-vp8l-with-alpha": "RGBA", "animation-without-alpha-flag": "RGB"}


def test_animation_first_frame_sits_on_a_cleared_canvas():
    """The first frame of an animation at an offset: pixels outside it are
    (0, 0, 0, 0), whatever the ANIM background colour."""
    arr, mode = webp.read_pil(webp_cases.case_bytes("animation-first-frame-lossy-alpha-12x9-at-6-4"))
    assert mode == "RGBA" and arr.shape == (30, 40, 4)
    outside = np.ones((30, 40), bool)
    outside[4:13, 6:18] = False
    assert (arr[outside] == 0).all() and arr[~outside, 3].any()


# ------------------------------------------------------------ corrupt files

SWEEP = {
    "lossless": ["lossless-rgba-m4-q50", "lossless-palette-4-colours-rgba", "lossless-rgb-m0", "size-lossless-2x2"],
    "lossy": ["lossy-rgb-q75-m4", "lossy-rgba-alpha-q50", "lossy-rgba-alpha-q100", "size-lossy-alpha-17x33",
              "alph-raw-filter-3", "animation-first-frame-lossless-11x7-at-28-22"],
    "fixtures": ["vp8-partitions-8.webp", "vp8-filter-simple-sharpness-4.webp", "vp8-alph-lossless-filter-best.webp",
                 "vp8-segments-4.webp"],
}


def seed_bytes(name: str) -> bytes:
    if name.endswith(".webp"):
        with open(os.path.join(gltf_scenes.WEBP_DIR, name), "rb") as f:
            return f.read()
    return webp_cases.case_bytes(name)


def corrupt(rng, data: bytes) -> bytes:
    """Flipped bits, changed, cut or inserted bytes inside one chunk (its
    size and the RIFF size kept true, so the bitstream decoders meet the
    damage), or anywhere in the file (sizes left as they were)."""
    parts = webp_cases.chunks(data)
    if rng.integers(0, 4) == 0 or not parts:  # anywhere, the sizes as they were
        data = bytearray(data)
        data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        return bytes(data[: int(rng.integers(len(data) // 2, len(data) + 1))])
    i = int(rng.integers(0, len(parts)))
    kind, body = parts[i]
    body = bytearray(body)
    action = int(rng.integers(0, 3))
    if action == 0 and body:
        for _ in range(int(rng.integers(1, 4))):
            body[int(rng.integers(0, len(body)))] ^= 1 << int(rng.integers(0, 8))
    elif action == 1:
        body = body[: int(rng.integers(0, len(body) + 1))]
    else:
        at = int(rng.integers(0, len(body) + 1))
        body[at:at] = rng.integers(0, 256, int(rng.integers(1, 6))).astype(np.uint8).tobytes()
    parts[i] = (kind, bytes(body))
    return webp_cases.riff(parts)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", sorted(SWEEP))
def test_corrupt_files_match_pil(kind, seed):
    """Seeded damage to each kind's seed files: the port refuses (a
    ValueError) where PIL refuses, and decodes to PIL's array where PIL
    decodes."""
    rng = np.random.default_rng(1000 * seed + len(kind))
    names = SWEEP[kind]
    counts = {"equal": 0, "refused": 0}
    for i in range(150):
        data = corrupt(rng, seed_bytes(names[i % len(names)]))
        want, err = outcome(lambda: jgltf._load_image(gltf_doc(data), [], ".", 0))
        if err is None:
            assert_same(timage.decode_rgba(data, "wall"), want)
            counts["equal"] += 1
        else:
            with pytest.raises(ValueError, match="wall"):
                timage.decode_rgba(data, "wall")
            counts["refused"] += 1
    assert counts["equal"] > 10 and counts["refused"] > 10, counts


# ---------------------------------------------------------------- codec


def test_decoders_write_into_a_canvas_view():
    """vp8l_decode and vp8_decode write a frame into a strided view of a
    larger canvas and touch nothing around it; webp_alpha gives the plane;
    a bitstream whose header disagrees with the size asked for, or a
    target of another shape, raises."""
    rgba = webp_cases.field(np.random.default_rng(5), 13, 17, 4)
    for lossless, decode in ((True, codec.vp8l_decode), (False, codec.vp8_decode)):
        parts = dict(webp_cases.image_chunks(rgba, lossless=lossless, quality=80))
        payload = parts[b"VP8L" if lossless else b"VP8 "]
        alone = np.empty((13, 17, 4), np.uint8)
        decode(payload, 17, 13, alone)
        canvas = np.full((20, 30, 4), 7, np.uint8)
        decode(payload, 17, 13, canvas[4:17, 6:23])
        assert_same(canvas[4:17, 6:23], alone)
        canvas[4:17, 6:23] = 7
        assert (canvas == 7).all()
        with pytest.raises(ValueError, match="header|size"):
            decode(payload, 16, 13, np.empty((13, 16, 4), np.uint8))
        with pytest.raises(ValueError, match="output"):
            decode(payload, 17, 13, np.empty((13, 17, 3), np.uint8))
        if not lossless:
            plane = codec.webp_alpha(parts[b"ALPH"], 17, 13)
            assert plane.shape == (13, 17) and plane.dtype == np.uint8
            assert_same(np.dstack([alone[..., :3], plane]), webp.read_pil(webp_cases.pil_webp(rgba, quality=80))[0])


# -------------------------------------------------------------- fixtures


def test_webp_fixtures_fit_their_budget():
    names = sorted(os.listdir(gltf_scenes.WEBP_DIR))
    assert set(names) == set(gltf_scenes.WEBP_FIXTURES) | {"manifest.json"}
    assert sum(os.path.getsize(os.path.join(gltf_scenes.WEBP_DIR, n)) for n in names) <= 600_000


@pytest.mark.parametrize("name", gltf_scenes.WEBP_FIXTURES)
def test_webp_fixture_matches_its_manifest(tmp_path, name):
    """Each committed fixture decodes, through the texture path and
    load_hdr, to its manifest entry (the JAX package's decode when it was
    written) and to the JAX package's decode here; load_png too."""
    with open(os.path.join(gltf_scenes.WEBP_DIR, "manifest.json")) as f:
        entry = json.load(f)[name]
    data = seed_bytes(name)
    path = str(tmp_path / "sky.webp")
    assert all(held_to_jax(data, path).values())
    for key, got in (("rgba", timage.decode_rgba(data, name)), ("load_hdr", tenvmap.load_hdr(path))):
        assert [list(got.shape), str(got.dtype), hashlib.sha256(got.tobytes()).hexdigest()] == entry[key]


def test_fixtures_hold_what_pil_cannot_write():
    """The fixtures reach the decoder paths PIL's encoder settings do not:
    the simple filter, sharpness 1-7, 2 / 4 / 8 token partitions, segments
    off and on, raw and lossless ALPH chunks under each filter (the VP8
    frame header's bits and the ALPH header byte, read here)."""
    seen = {"simple": set(), "sharpness": set(), "partitions": set(), "segments": set(), "alph": set()}
    for name in gltf_scenes.WEBP_FIXTURES:
        for kind, body in webp_cases.chunks(seed_bytes(name)):
            if kind == b"ALPH":
                seen["alph"].add((body[0] & 3, (body[0] >> 2) & 3))
            if kind == b"VP8 ":
                segments, simple, sharpness, partitions = frame_header(body)
                seen["simple"].add(simple)
                seen["sharpness"].add(sharpness)
                seen["partitions"].add(partitions)
                seen["segments"].add(segments)
    assert seen["simple"] == {0, 1} and seen["sharpness"] == set(range(8)) and seen["segments"] == {0, 1}
    assert seen["partitions"] == {1, 2, 4, 8}
    assert seen["alph"] == {(c, f) for c in (0, 1) for f in range(4)}


def frame_header(payload: bytes) -> tuple:
    """(segmentation on, simple filter, sharpness, token partitions) of a
    VP8 key frame, read with a plain boolean decoder (RFC 6386 7.3, 9.3-9.5)."""
    data, value, rng, bits, pos = payload[10:], 0, 255, 0, 0

    def bit(p=128):
        nonlocal value, rng, bits, pos
        split = 1 + (((rng - 1) * p) >> 8)
        while bits < 8:
            value = (value << 8) | (data[pos] if pos < len(data) else 0)
            pos, bits = pos + 1, bits + 8
        if value >> (bits - 8) >= split:
            b, rng, value = 1, rng - split, value - (split << (bits - 8))
        else:
            b, rng = 0, split
        while rng < 128:
            rng, bits = rng << 1, bits - 1
        return b

    def get(n):
        return sum(bit() << (n - 1 - i) for i in range(n))

    get(2)
    segments = get(1)
    if segments:
        update_map = get(1)
        if get(1):
            get(1)
            for n in (7,) * 4 + (6,) * 4:
                if get(1):
                    get(n + 1)
        if update_map:
            for _ in range(3):
                if get(1):
                    get(8)
    simple, _, sharpness = get(1), get(6), get(3)
    if get(1) and get(1):
        for _ in range(8):
            if get(1):
                get(7)
    return segments, simple, sharpness, 1 << get(2)


def test_riff_writer_sizes():
    """The RIFF writer of tests/webp_cases.py pads odd chunks and sizes the
    RIFF chunk as PIL's files are sized."""
    data = webp_cases.pil_webp(webp_cases.field(np.random.default_rng(1), 5, 7, 3), lossless=True)
    assert webp_cases.riff(webp_cases.chunks(data)) == data
    assert struct.unpack_from("<I", data, 4)[0] == len(data) - 8
