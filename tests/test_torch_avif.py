"""The port's AVIF decoding (io/avif.py: the ISOBMFF container, the alpha
item or track, libavif's YUV -> RGB(A) as PIL asks for it; io/av1.py: the
OBU, sequence and frame headers, tiles; csrc/av1dec.c: the lossless and
lossy key-frame decode, the deblocking filter) against the JAX package,
which reads AVIF with PIL 12.1's libavif 1.3.0 / dav1d 1.5.1
(`gltf._load_image` of the bytes and of the file, `io.image.load_png`,
`envmap.load_hdr` through imageio's pillow plugin).

Every fixture of tests/torch_avif/ (tests/make_torch_avif.py, cases in
tests/avif_cases.py) must give the same shape, dtype and values on the
four paths, bit for bit; a file the port refuses by name (loop
restoration, CDEF, quantizer matrices, intra block copy, a matrix it does
not convert, a frame libavif scales to its ispe) is one the JAX package
reads, and the port's ValueError names the feature.  Also: the manifest
(what chip_smoke.py holds the port to on the card's machine), the matrix
coefficients libavif converts, edited into a file's `colr` box, seeded
random lossless and lossy files under random settings, the inverse
transforms against their real-valued definitions, and one-byte mutants of
tile data, which the port refuses where dav1d does (a symbol decoder more
than 14 bits past its tile's end, a vertical split of a 4:2:2 block).
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


@pytest.mark.parametrize("seed", range(3))
def test_random_lossy_files_equal_pil(seed):
    """Seeded random images under random lossy settings (quality 0-99, the
    default aom speed or 5-10, subsampling, range, alpha and its
    premultiplication, tiles, size, content): the port's texture decode
    equals the JAX package's, or the port refuses intra block copy by name."""
    rng = np.random.default_rng(200 + seed)
    counts = {"equal": 0, "intrabc": 0}
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(1, 130, 2))
        ch = int(rng.choice([3, 4]))
        kind = str(rng.choice(["noise", "smooth", "soft", "flat"]))
        kw = {"subsampling": str(rng.choice(["4:2:0", "4:2:2", "4:4:4", "4:0:0"])),
              "range": str(rng.choice(["full", "limited"])), "quality": int(rng.integers(0, 100)),
              "alpha_premultiplied": bool(rng.integers(0, 2))}
        speed = int(rng.choice([-1, 5, 6, 7, 8, 9, 10]))
        if speed >= 0:
            kw["speed"] = speed
        if rng.integers(0, 4) == 0:
            kw.update(tile_rows=1, tile_cols=1)
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


@pytest.mark.parametrize("kind", ["dct", "adst", "identity"])
def test_inverse_transforms_against_their_definitions(kind):
    """Each 1D inverse transform of csrc/av1dec.c (DCT 4-64, ADST 4-16,
    identity 4-32) against its real-valued definition at the integer
    transforms' scale, within the rounding of its butterflies."""
    import ctypes

    from vpt_tpu_torch.io import codec

    lib = codec.av1_library()
    rng = np.random.default_rng(7)
    sizes = {"dct": range(2, 7), "adst": range(2, 5), "identity": range(2, 6)}[kind]
    for n in sizes:
        size = 1 << n
        j, k = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")  # output j, input k
        if kind == "dct":
            m = np.where(k == 0, np.sqrt(0.5), 1.0) * np.cos(np.pi * (2 * j + 1) * k / (2 * size))
        elif kind == "adst" and size == 4:
            m = 2 * np.sqrt(2) / 3 * np.sin(np.pi * (2 * k + 1) * (j + 1) / 9)
        elif kind == "adst":
            m = np.sin(np.pi * (2 * j + 1) * (2 * k + 1) / (4 * size))
        else:
            m = np.eye(size) * {4: np.sqrt(2), 8: 2, 16: 2 * np.sqrt(2), 32: 4}[size]
        worst = 0.0
        for _ in range(20):
            x = rng.integers(-2000, 2000, size).astype(np.int32)
            got = x.copy()
            lib.vpt_av1_itx1d(ctypes.c_void_p(got.ctypes.data), n, {"dct": 0, "adst": 1, "identity": 2}[kind])
            worst = max(worst, float(np.abs(got - m @ x).max()))
        assert worst <= size / 4 + 1, (kind, size, worst)


def _tile_ranges(data: bytes) -> list:
    """(start, end) in the file of each tile of the colour item."""
    color = avif._parse(data)["color"]
    base, seq, hdr, out = data.find(color), None, None, []
    for kind, tid, sid, start, end in av1.obus(color):
        if kind == 1:
            seq = av1.sequence_header(color[start:end])
        elif kind == 6:
            b = av1.Bits(color[:end], start)
            hdr = av1.frame_header(b, seq, tid, sid, "x")
            b.byte_align()
            out += [(base + t[0], base + t[0] + t[1]) for t in av1._tile_group(color, b.bit >> 3, end, hdr, "x")]
    return out


@pytest.mark.parametrize("name", ["lossy-q75-default.avif", "lossy-q75-422-smooth-65x33.avif",
                                  "lossy-q60-tiles-2x2-192x256.avif", "rgba-422-smooth-65x33.avif",
                                  "size-65x33-flat-422.avif"])
def test_corrupt_tile_data_refused_where_dav1d_refuses_it(name):
    """One-byte mutants of a file's tile data, near each tile's end and
    anywhere in it: the port's texture decode and the JAX package's both
    refuse, or give equal arrays (dav1d refuses a tile whose symbol decoder
    has read more than 14 bits past its end, and a vertical split of a
    4:2:2 frame's block; the port refuses them by the same rules)."""
    data = _data(name)
    rng = np.random.default_rng(len(name))
    spots = []
    for start, end in _tile_ranges(data):
        spots += [(at, int(v)) for at in range(max(start, end - 3), end) for v in rng.integers(0, 256, 3)]
        spots += [(int(at), int(v)) for at, v in zip(rng.integers(start, end, 12), rng.integers(0, 256, 12))]
    counts = {"equal": 0, "both refuse": 0}
    for at, v in spots:
        m = bytearray(data)
        m[at] = v
        m = bytes(m)
        want, err = outcome(lambda: jgltf._load_image(_memory(m), [], ".", 0))
        got, mine = outcome(lambda: timage.decode_rgba(m, "wall"))
        assert (err is None) == (mine is None), (at, v, err, mine)
        if err is None:
            np.testing.assert_array_equal(got, want, err_msg=str((at, v)))
        counts["equal" if err is None else "both refuse"] += 1
    assert counts["both refuse"] >= 3, counts


def _at(data: bytes, box: bytes, offset: int, value: int, nth: int = 0) -> bytes:
    """The file with the byte `offset` bytes into its `nth` box of type
    `box` (counted from the box's size field) set to `value`."""
    at = -1
    for _ in range(nth + 1):
        at = data.find(box, at + 1)
    m = bytearray(data)
    m[at - 4 + offset] = value
    return bytes(m)


CONTAINER_MUTANTS = {  # libavif's and dav1d's checks outside the tile data, one mutant each
    "ftyp-major-brand": ("lossy-q75-default.avif", lambda d: _at(d, b"ftyp", 9, 0x62)),
    "hdlr-pre-defined": ("lossy-q75-default.avif", lambda d: _at(d, b"hdlr", 14, 1)),
    "hdlr-name-unterminated": ("lossy-q75-default.avif", lambda d: _at(d, b"hdlr", 32, 0x41)),
    "meta-version": ("lossy-q75-default.avif", lambda d: _at(d, b"meta", 8, 1)),
    "iinf-count": ("lossy-q75-default.avif", lambda d: _at(d, b"iinf", 12, 7)),
    "infe-type": ("lossy-q75-default.avif", lambda d: _at(d, b"infe", 4, 0x6a)),
    "infe-name-unterminated": ("lossy-q75-default.avif", lambda d: _at(d, b"infe", 25, 0x41)),
    "pixi-no-planes": ("lossy-q75-default.avif", lambda d: _at(d, b"pixi", 12, 0)),
    "pixi-five-planes": ("lossy-q75-default.avif", lambda d: _at(d, b"pixi", 12, 5)),
    "pixi-depths-differ": ("lossy-q75-default.avif", lambda d: _at(d, b"pixi", 13, 10)),
    "pixi-version": ("lossy-q75-default.avif", lambda d: _at(d, b"pixi", 8, 1)),
    "av1c-marker": ("lossy-q75-default.avif", lambda d: _at(d, b"av1C", 8, 0x82)),
    "av1c-depth-not-pixi": ("lossy-q75-default.avif", lambda d: _at(d, b"av1C", 10, 0x4c)),
    "ispe-version": ("lossy-q75-default.avif", lambda d: _at(d, b"ispe", 8, 1)),
    "nclx-reserved-bits": ("lossy-q75-default.avif", lambda d: _at(d, b"colr", 18, 0x81)),
    "matrix-above-15": ("lossy-q75-400-smooth-65x33.avif", lambda d: avif_cases._matrix(d, 16)),
    "mdat-size-past-the-file": ("lossy-q75-default.avif", lambda d: _at(d, b"mdat", 0, 0x7f)),
    "obu-forbidden-bit": ("lossy-q75-default.avif", lambda d: _at(d, b"mdat", 8, d[d.find(b"mdat") + 4] | 0x80)),
    "profile-7": ("lossy-q75-default.avif", lambda d: _at(d, b"mdat", 12, d[d.find(b"mdat") + 8] | 0xe0)),
    "auxc-version": ("lossy-q75-rgba-420-smooth-65x33.avif", lambda d: _at(d, b"auxC", 8, 1)),
    "iref-version-2": ("lossy-q75-rgba-420-smooth-65x33.avif", lambda d: _at(d, b"iref", 8, 2)),
    "alpha-item-type": ("lossy-q75-rgba-420-smooth-65x33.avif", lambda d: _at(d, b"infe", 17, 0x62, nth=1)),
    "alpha-av1c-missing": ("lossy-q75-rgba-420-smooth-65x33.avif", lambda d: _at(d, b"av1C", 6, 0x35, nth=1)),
    "sequence-alpha-auxi": ("avis-2-frames-rgba.avif", lambda d: _at(d, b"auxi", 20, 0x41)),
    "sequence-stsz-count": ("avis-2-frames.avif", lambda d: _at(d, b"stsz", 17, 0x40)),
    "sequence-elst-count": ("avis-2-frames.avif", lambda d: _at(d, b"elst", 15, 2)),
    "sequence-stts-count": ("avis-2-frames-rgba.avif", lambda d: _at(d, b"stts", 12, 88)),
    "xmp-data-past-the-file": ("xmp.avif", lambda d: _at(d, b"iloc", 36, 81)),
    "xmp-content-type-unterminated": ("xmp.avif", lambda d: _at(d, b"infe", 43, 1, nth=1)),
    "alpha-item-without-properties": ("rgba-420-noise-13x7.avif", lambda d: _at(d, b"ipma", 24, 3)),
    "alpha-item-without-auxc": ("rgba-420-noise-13x7.avif", lambda d: _at(d, b"auxC", 7, 0x44)),
    "alpha-limited-range": ("lossy-q75-rgba-420-smooth-65x33.avif", lambda d: _at(d, b"mdat", 17, 98)),
    "ipma-size-0": ("lossy-q75-limited-420-smooth-65x33.avif", lambda d: _at(d, b"ipma", 3, 0)),
    "sequence-primary-item-without-ispe": ("avis-2-frames.avif", lambda d: _at(d, b"ispe", 6, ord("q"))),
    "sequence-primary-ispe-too-large": ("avis-2-frames.avif", lambda d: _at(d, b"ispe", 12, 10)),
    "sequence-without-stsc": ("avis-2-frames-rgba.avif", lambda d: _at(d, b"stsc", 7, 239)),
    "sequence-stsc-past-stsz": ("avis-2-frames.avif", lambda d: _at(d, b"stsc", 22, 117)),
    "sequence-without-mdhd": ("avis-2-frames.avif", lambda d: _at(d, b"mdhd", 4, 163)),
    "sequence-stsd-count": ("avis-2-frames-rgba.avif", lambda d: _at(d, b"stsd", 12, 221)),
    "sequence-sample-entry-nclx-reserved": ("avis-2-frames.avif", lambda d: _at(d, b"stsd", 132, 125)),
    "sequence-track-handler-not-pict": ("avis-2-frames.avif", lambda d: _at(d, b"hdlr", 17, 191, nth=1)),
    "sequence-sample-entry-not-av01": ("avis-2-frames.avif", lambda d: _at(d, b"stsd", 21, 198)),
    "sequence-tkhd-width-scaled": ("avis-2-frames.avif", lambda d: _at(d, b"tkhd", 97, 208)),
    "primary-unknown-essential-property": ("exif-orientation-6.avif", lambda d: _at(d, b"irot", 6, 140)),
    "metadata-obu-empty": ("lossy-q30-soft-256.avif", lambda d: _at(d, b"mdat", 8, 0x2a)),
    "tile-group-before-frame-header": ("lossy-q30-soft-256.avif", lambda d: _at(d, b"mdat", 8, 0x22)),
    "sequence-header-reduced-not-still": ("rgba-420-noise-13x7.avif", lambda d: _at(d, b"mdat", 196, 46)),
}


@pytest.mark.parametrize("case", sorted(CONTAINER_MUTANTS))
def test_container_mutants_as_libavif_reads_them(case):
    """One-byte edits of the container and the OBU headers that libavif or
    dav1d check (or pass over): the port's texture decode and the JAX
    package's both refuse, or give equal arrays; where libavif scales the
    frame to another size the container gives, the port refuses by name."""
    name, edit = CONTAINER_MUTANTS[case]
    data = edit(_data(name))
    assert data != _data(name)
    want, err = outcome(lambda: jgltf._load_image(_memory(data), [], ".", 0))
    got, mine = outcome(lambda: timage.decode_rgba(data, "wall"))
    if case.endswith("-scaled"):  # libavif scales the frame to the size the container says: refused by name
        assert err is None and isinstance(mine, av1.Refused) and "libavif scales the frame" in str(mine), mine
        return
    assert (err is None) == (mine is None), (err, mine)
    if err is None:
        np.testing.assert_array_equal(got, want)


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
