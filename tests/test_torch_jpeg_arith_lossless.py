"""The port's arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG
decoding (io/jpeg.py; csrc/imgcodec.c `vpt_jpeg_arith_scan` and
`vpt_jpeg_lossless_scan` through io/codec.py) against the JAX package,
which reads them with PIL 12.1's libjpeg-turbo (`gltf._load_image`:
`convert("RGBA")`; `envmap.load_hdr`: imageio's PIL route;
`io.image.load_png`: PIL's array / 255).

- Every fixture of tests/torch_jpeg/ (tests/make_torch_jpeg.py: libjpeg-turbo's
  encoder at settings PIL cannot write) against its manifest and against the
  JAX package's three paths here, shapes and dtypes included; where the JAX
  package raises, the port raises a ValueError naming the file.
- A sweep of seeded byte flips, cuts and inserted markers over those files:
  each mutant decodes to PIL's pixels bit for bit, or raises a ValueError
  where PIL raises.  It covers what libjpeg does with corrupt data that PIL
  lets through: a marker inside entropy data (zeros from there on), a code an
  arithmetic coder cannot have (the rest of the restart interval left
  zero), restart markers out of place (jpeg_resync_to_restart), segments cut
  short after a single scan (jpeg_finish_decompress running out of data),
  and coefficients that overflow the SIMD IDCT's 16-bit lanes.
- PIL's 65536-byte feed: an arithmetic-coded scan that runs past the block
  PIL has handed libjpeg is refused by both.
- Hand-made files for what libjpeg-turbo's encoder never writes: lossless
  difference category 16 (32768) and DAC segments libjpeg refuses.
- The Qe table of T.81 Table D.2 equals libjpeg-turbo's `jpeg_aritab`.
"""

import base64
import ctypes
import glob
import hashlib
import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

import gltf_scenes
from vpt_tpu.io import image as jimage
from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu.scene import gltf as jgltf
from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.io import jpeg
from vpt_tpu_torch.scene import envmap as tenvmap
from vpt_tpu_torch.scene import gltf as tgltf


def fixture_bytes(name: str) -> bytes:
    with open(os.path.join(gltf_scenes.JPEG_DIR, name), "rb") as f:
        return f.read()


def gltf_doc(data: bytes) -> dict:
    return {"images": [{"uri": "data:image/jpeg;base64," + base64.b64encode(data).decode(), "name": "wall"}]}


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


def digest(arr: np.ndarray) -> list:
    return [list(arr.shape), str(arr.dtype), hashlib.sha256(arr.tobytes()).hexdigest()]


PATHS = {  # path -> (the JAX package's reader, the port's)
    "texture": (lambda data, path: jgltf._load_image(gltf_doc(data), [], os.path.dirname(path), 0),
                lambda data, path: tgltf._load_image(gltf_doc(data), [], os.path.dirname(path), 0)),
    "load_hdr": (lambda data, path: jenvmap.load_hdr(path), lambda data, path: tenvmap.load_hdr(path)),
    "load_png": (lambda data, path: jimage.load_png(path), lambda data, path: timage.load_png(path)),
}


# ------------------------------------------------------------- fixtures


def test_fixtures_fit_their_budget():
    """The files and the manifest stay under 1 MB, and the manifest names
    every fixture."""
    names = sorted(os.listdir(gltf_scenes.JPEG_DIR))
    assert names == sorted([*gltf_scenes.JPEG_FIXTURES, "manifest.json"])
    assert sum(os.path.getsize(os.path.join(gltf_scenes.JPEG_DIR, n)) for n in names) < 1_000_000


@pytest.mark.parametrize("name", gltf_scenes.JPEG_FIXTURES)
def test_fixture_matches_its_manifest(name):
    """decode_rgba and load_hdr against the manifest's digests of the JAX
    package's decodes (what chip_smoke.py phase 17a checks on the card's
    machine), or a ValueError naming the file where the entry is null."""
    with open(os.path.join(gltf_scenes.JPEG_DIR, "manifest.json")) as f:
        want = json.load(f)[name]
    path = os.path.join(gltf_scenes.JPEG_DIR, name)
    for key, read in (("rgba", lambda: timage.decode_rgba(fixture_bytes(name), name)),
                      ("load_hdr", lambda: tenvmap.load_hdr(path))):
        if want[key] is None:
            with pytest.raises(ValueError, match=name if key == "rgba" else "JPEG"):
                read()
        else:
            assert digest(read()) == want[key], key


@pytest.mark.parametrize("name", gltf_scenes.JPEG_FIXTURES)
def test_fixture_equals_jax(tmp_path, name):
    """The texture decode, load_hdr and load_png of one fixture: bitwise the
    JAX package's, or a ValueError naming the file where it raises."""
    data = fixture_bytes(name)
    path = str(tmp_path / "sky.jpg")
    with open(path, "wb") as f:
        f.write(data)
    refused = "refused" in name
    for key, (jax_read, port_read) in PATHS.items():
        want, err = outcome(lambda: jax_read(data, path))
        assert (err is not None) == refused, (key, err)
        if err is None:
            assert_same(port_read(data, path), want)
        else:
            with pytest.raises(ValueError, match="wall" if key == "texture" else "sky"):
                port_read(data, path)


def test_fixtures_cover_the_codings():
    """The fixtures hold what the slice reads: SOF9, SOF10 (one of them
    block-smoothed) and SOF3 at predictors 1-7 and point transforms 0, 1 and
    3, DAC segments other than the default and restart intervals."""
    seen = {"frames": set(), "predictors": set(), "point_transforms": set(), "dac": set(), "restart": 0, "smoothed": 0}
    for name in gltf_scenes.JPEG_FIXTURES:
        data = fixture_bytes(name)
        seen["frames"] |= {m for m in (0xC3, 0xC9, 0xCA) if bytes([0xFF, m]) in data}
        seen["restart"] += b"\xff\xdd" in data
        at = 0
        while (at := data.find(b"\xff\xcc", at) + 1) > 0:
            seen["dac"].add(data[at + 3 : at + 1 + ((data[at + 1] << 8) | data[at + 2])])
        if b"\xff\xc3" in data:
            sos = data.index(b"\xff\xda")
            n = data[sos + 4]
            seen["predictors"].add(data[sos + 5 + 2 * n])
            seen["point_transforms"].add(data[sos + 7 + 2 * n] & 15)
        if "smoothed" in name:
            comps = parsed_components(data)
            seen["smoothed"] += jpeg._smoothing_ok(comps)
    assert seen["frames"] == {0xC3, 0xC9, 0xCA}
    assert seen["predictors"] == set(range(1, 8)) and {0, 1, 3} <= seen["point_transforms"]
    assert len(seen["dac"]) > 3 and seen["restart"] >= 8 and seen["smoothed"] == 2


def parsed_components(data: bytes) -> list:
    """The frame components of a progressive file after its scans, as
    decode_jpeg leaves them (their coefficient bits)."""
    comps = []
    real = jpeg._frame

    def keep(seg, name):
        frame = real(seg, name)
        comps.extend(frame["comps"])
        return frame

    jpeg._frame = keep
    try:
        jpeg.decode_jpeg(data)
    finally:
        jpeg._frame = real
    return comps


# ------------------------------------------------------- PIL's 65536-byte feed


def without_padding(data: bytes) -> bytes:
    """A JPEG with its COM segments taken out."""
    out, pos = bytearray(data[:2]), 2
    while pos < len(data):
        if data[pos + 1] == 0xD9:
            out += data[pos:]
            break
        end = pos + 2 + ((data[pos + 2] << 8) | data[pos + 3])
        if data[pos + 1] == 0xDA:  # the scan's data, restart markers included
            end = jpeg._next_marker(data, end)
            while end < len(data) and 0xD0 <= data[end + 1] <= 0xD7:
                end = jpeg._next_marker(data, end + 2)
        if data[pos + 1] != 0xFE:
            out += data[pos:end]
        pos = end
    return bytes(out)


@pytest.mark.parametrize("padding", ["as-written", "removed"])
def test_arithmetic_scans_past_pils_block_are_refused_as_pil_refuses_them(padding):
    """The 2048x2048 SOF10 timing texture reads, in PIL and in the port,
    because COM segments start its long scans in a fresh 65536-byte block;
    without them PIL's libjpeg meets the end of a block inside an arithmetic
    scan (which cannot suspend) and both refuse the file, the port naming
    the reason."""
    data = fixture_bytes(gltf_scenes.JPEG_TIMING[0])
    if padding == "removed":
        data = without_padding(data)
        assert b"\xff\xfe" not in data
    want, err = outcome(lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0)
    if padding == "as-written":
        assert err is None
        assert_same(timage.decode_rgba(data, "wall"), want)
    else:
        assert isinstance(err, OSError)
        with pytest.raises(ValueError, match="wall: .*65536-byte block"):
            timage.decode_rgba(data, "wall")


# --------------------------------------------------------- corrupt files


SWEEP = tuple(n for n in gltf_scenes.JPEG_FIXTURES if "timing" not in n and "refused" not in n)
MARKERS = (0xD0, 0xD1, 0xD3, 0xD7, 0xD9, 0xFE, 0xE1, 0xC4, 0xDD, 0xDA, 0xDB, 0xCC, 0xC0, 0x01, 0x05, 0xC8)


def scan_spans(data: bytes) -> list:
    """(start, end) of the entropy-coded data of each scan."""
    spans, pos = [], 2
    while pos + 4 <= len(data) and data[pos + 1] != 0xD9:
        nxt = pos + 2 + ((data[pos + 2] << 8) | data[pos + 3])
        if data[pos + 1] == 0xDA:
            end = jpeg._next_marker(data, nxt)
            while end < len(data) and 0xD0 <= data[end + 1] <= 0xD7:
                end = jpeg._next_marker(data, end + 2)
            spans.append((nxt, end))
            nxt = end
        pos = nxt
    return spans


def mutant(rng, data: bytes, kind: int) -> bytes:
    """A byte flipped, the file cut (an EOI put back half the time) or a
    marker put in, half the time inside a scan's data, else anywhere."""
    out = bytearray(data)
    spans = scan_spans(data)
    if rng.random() < 0.5 and spans:
        a, b = spans[int(rng.integers(len(spans)))]
        at = int(rng.integers(a, max(b, a + 1)))
    else:
        at = int(rng.integers(2, len(data)))
    if kind == 0:
        out[at] ^= 1 << int(rng.integers(8)) if rng.random() < 0.5 else int(rng.integers(1, 256))
    elif kind == 1:
        out = out[:at] + (b"\xff\xd9" if rng.random() < 0.5 else b"")
    else:
        code = int(rng.choice(MARKERS))
        out[at:at] = bytes([0xFF, code]) + (b"\x00\x04ab" if code in (0xFE, 0xE1) else b"")
    return bytes(out)


@pytest.mark.parametrize("seed", range(8))
def test_corrupt_files_match_pil(seed):
    """60 mutants of the arithmetic-coded and lossless fixtures per seed:
    where PIL decodes one the port gives the same pixels, bit for bit; where
    PIL raises the port raises a ValueError."""
    rng = np.random.default_rng(seed)
    read = refused = 0
    for i in range(60):
        name = SWEEP[int(rng.integers(len(SWEEP)))]
        data = mutant(rng, fixture_bytes(name), i % 3)
        want, err = outcome(lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0)
        if err is None:
            got = timage.decode_rgba(data, name)
            assert got.shape == want.shape and np.array_equal(got, want), (name, i)
            read += 1
        else:
            with pytest.raises(ValueError):
                timage.decode_rgba(data, name)
            refused += 1
    assert read > 20 and refused > 5


# ------------------------------------------------------ hand-made files


def bits_to_bytes(bits: str) -> bytes:
    """Entropy-coded bytes of a bit string: padded with 1s, each FF stuffed."""
    bits += "1" * (-len(bits) % 8)
    out = bytearray()
    for i in range(0, len(bits), 8):
        out.append(int(bits[i : i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return bytes(out)


def lossless_gray(diffs, width: int, psv: int = 1, pt: int = 0) -> bytes:
    """An 8-bit gray lossless JPEG of one row of `width` samples whose
    differences are `diffs`, coded with a Huffman table that gives every
    category 0-16 a 5-bit code (libjpeg-turbo's encoder never writes
    category 16, a difference of 32768)."""
    bits = ""
    for d in diffs:
        s = 16 if d == 32768 else int(abs(d)).bit_length()
        bits += format(s, "05b")
        if 0 < s < 16:
            bits += format(d if d > 0 else d + (1 << s) - 1, f"0{s}b")
    counts = [0] * 16
    counts[4] = 17
    dht = bytes([0x00] + counts + list(range(17)))
    sof = bytes([8, 0, 1, width >> 8, width & 255, 1, 1, 0x11, 0])
    sos = bytes([1, 1, 0x00, psv, 0, pt])
    seg = lambda m, body: bytes([0xFF, m]) + (len(body) + 2).to_bytes(2, "big") + body  # noqa: E731
    return b"\xff\xd8" + seg(0xC4, dht) + seg(0xC3, sof) + seg(0xDA, sos) + bits_to_bytes(bits) + b"\xff\xd9"


@pytest.mark.parametrize("case", ["category-16", "wrapping-sums", "point-transform-2"])
def test_hand_made_lossless_files_equal_pil(case):
    """Differences of 32768 (category 16, no extra bits) and sums that wrap
    at 16 bits before the shift by the point transform: the samples PIL
    gives, the low 8 bits of (prediction + difference) mod 2^16 << Pt."""
    diffs, pt = {"category-16": ([32768, 5, 32768, -3, 0, 32768], 0),
                 "wrapping-sums": ([30000, 30000, 30000, -200, 7000, 32768, 1], 0),
                 "point-transform-2": ([12, 32768, -5, 40, 32768, 63], 2)}[case]
    data = lossless_gray(diffs, len(diffs), pt=pt)
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = jpeg.decode_jpeg(data)
    assert_same(got, want)
    samples, x = [], 1 << (7 - pt)
    for d in diffs:
        x = (x + d) & 0xFFFF
        samples.append((x << pt) & 0xFF)
    np.testing.assert_array_equal(got[0], samples)


def with_dac(data: bytes, body: bytes) -> bytes:
    """`data` with the body of its first DAC segment replaced."""
    at = data.index(b"\xff\xcc")
    old = (data[at + 2] << 8) | data[at + 3]
    return data[:at] + b"\xff\xcc" + (len(body) + 2).to_bytes(2, "big") + body + data[at + 2 + old :]


@pytest.mark.parametrize("case", ["L-above-U", "table-32", "odd-length", "K-0", "L-U-15", "empty"])
def test_dac_segments_as_libjpeg_reads_them(case):
    """What get_dac refuses (L above U, a table index past 31, an odd
    length) both refuse; any K and L = U = 15 both read, bit for bit."""
    data = fixture_bytes("arith-ycc420-q50-37x29.jpg")
    body = {"L-above-U": b"\x00\x23", "table-32": b"\x20\x05", "odd-length": b"\x00\x10\x10",
            "K-0": b"\x10\x00\x11\x00", "L-U-15": b"\x00\xff\x01\xff", "empty": b""}[case]
    data = with_dac(data, body)
    want, err = outcome(lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0)
    assert (err is None) == (case in ("K-0", "L-U-15", "empty"))
    if err is None:
        assert_same(timage.decode_rgba(data, "wall"), want)
    else:
        with pytest.raises(ValueError, match="wall: .*DAC"):
            timage.decode_rgba(data, "wall")


# ------------------------------------------------------------ the Qe table


def test_qe_table_equals_libjpeg_turbos():
    """The C codec's copy of T.81 Table D.2 (113 states: Qe, Next_Index_LPS,
    Next_Index_MPS, Switch_MPS) and of libjpeg's fixed 1/2 state equals
    `jpeg_aritab` of the libjpeg-turbo PIL bundles, read through ctypes."""
    import PIL

    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs", "libjpeg-*.so.62*"))
    if not found:
        pytest.skip("PIL's bundled libjpeg-turbo (pillow.libs/libjpeg-*.so.62.*) is not installed here")
    lib = ctypes.CDLL(found[0])
    aritab = np.array((ctypes.c_long * 114).in_dll(lib, "jpeg_aritab")[:], np.int64)
    ours = codec.qe_table().astype(np.int64)
    np.testing.assert_array_equal(ours, aritab)
    assert ours[0] >> 16 == 0x5A1D and ours[112] >> 16 == 0x59EB and ours[113] == (0x5A1D << 16) | (113 << 8) | 113
