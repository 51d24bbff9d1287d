"""The port's OpenCV route (vpt_tpu_torch/io/opencv.py and its decoders)
against the JAX package's `load_hdr`, which reaches OpenCV 5.0 through
imageio 2.37's `opencv` plugin.

Every file of tests/torch_opencv/ (tests/make_torch_opencv.py) is loaded by
both packages, live, under each extension group that reaches OpenCV:
`.HDR`, `.pic` and `.exr` (OpenCV before Pillow), `.sr`, `.dip` and `.pxm`
(OpenCV first, then every plugin), and, for the files PIL cannot identify
(so that imageio's Pillow plugin passes them on), `.rgbe` and no extension
(every plugin, Pillow first) and `.png` (OpenCV last).
The port's array equals the JAX package's bitwise (dtype, shape, values),
or both raise; a file named "port-refuses" the port refuses by name while
OpenCV reads it (ROADMAP "Not ported, by decision").  The files named
"sweep-*" are corrupt copies on which the port once differed from `cv2`
(tests/opencv_sweep.py).  The manifest holds
the JAX package's decode under `.exr`, which `chip_smoke.py` holds the port
to on the card's machine, where there is no JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings

import numpy as np
import pytest

from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu_torch.io import cv_hdr, exif, opencv
from vpt_tpu_torch.scene import envmap as tenvmap

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_opencv")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
NAMES = sorted(MANIFEST)
OPENCV_FIRST = (".HDR", ".pic", ".exr", ".sr", ".dip", ".pxm")
PIL_FIRST = (".rgbe", "", ".png")
# Why the port refuses a file OpenCV reads, by the words its message holds.
REFUSALS = {"avif": "AVIF", "pam": "unwritten", "cielab": "CIE Lab", "apng": "unwritten"}


def _data(name: str) -> bytes:
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _write(tmp_path, name: str, ext: str) -> str:
    path = str(tmp_path / f"sky{ext}")
    with open(path, "wb") as f:
        f.write(_data(name))
    return path


def _refusal(name: str) -> str:
    return next(words for key, words in REFUSALS.items() if key in name)


def _pil_identifies(name: str) -> bool:
    from PIL import Image, UnidentifiedImageError

    try:
        Image.open(os.path.join(FIXTURES, name)).close()
    except UnidentifiedImageError:
        return False
    except Exception:  # noqa: BLE001  (identified, then refused)
        return True
    return True


CASES = [(n, e) for n in NAMES for e in OPENCV_FIRST] + [(n, e) for n in NAMES if not _pil_identifies(n)
                                                         for e in PIL_FIRST]


@pytest.mark.parametrize("name,ext", CASES)
def test_load_hdr_equals_jax(tmp_path, name, ext):
    path = _write(tmp_path, name, ext)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            want = jenvmap.load_hdr(path)
        except Exception:  # noqa: BLE001  (imageio and OpenCV raise many kinds)
            want = None
    if "port-refuses" in name and opencv.decoder(_data(name)) and want is not None:
        with pytest.raises(ValueError, match=_refusal(name)):
            tenvmap.load_hdr(path)
        return
    if want is None:
        with pytest.raises(ValueError):
            tenvmap.load_hdr(path)
        return
    got = tenvmap.load_hdr(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_manifest(tmp_path, name):
    """The port's `load_hdr` under `.exr` against the manifest (the JAX
    package's decode when the fixtures were made)."""
    path = _write(tmp_path, name, ".exr")
    entry = MANIFEST[name]
    if entry is None or entry.get("port_refuses"):
        with pytest.raises(ValueError):
            tenvmap.load_hdr(path)
        return
    got = tenvmap.load_hdr(path)
    assert list(got.shape) == entry["shape"]
    assert hashlib.sha256(np.ascontiguousarray(got, np.float32).tobytes()).hexdigest() == entry["sha256"]


def test_radiance_sky_under_other_names(tmp_path):
    """A sky the port writes, named .HDR / .pic / without extension, reads as
    OpenCV's 8-bit decode in both packages, and as floats under .hdr."""
    from vpt_tpu_torch.io.image import save_radiance_hdr

    sky = tenvmap.default_sky((16, 32))
    save_radiance_hdr(str(tmp_path / "sky.hdr"), sky)
    floats = tenvmap.load_hdr(str(tmp_path / "sky.hdr"))
    for name in ("sky.HDR", "sky.Hdr", "sky.pic", "sky"):
        (tmp_path / name).write_bytes((tmp_path / "sky.hdr").read_bytes())
        got = tenvmap.load_hdr(str(tmp_path / name))
        np.testing.assert_array_equal(got, jenvmap.load_hdr(str(tmp_path / name)))
        assert got.max() == 255 and floats.max() < 255


def test_rgbe_rounding_table():
    """OpenCV's bytes of every (exponent, mantissa): rint(m x 255 x 2^(e-136)),
    ties to even, 0 where the rounding reaches 2^31 (cvRound's overflow)."""
    lut = cv_hdr._lut()
    assert lut[0].max() == 0 and lut[136, 1] == 255 and lut[128, 1] == 1  # 255 / 256 rounds to 1
    assert lut[129, 1] == 2 and lut[130, 3] == 12  # 510 / 256 = 1.99 -> 2; 3 x 255 / 64 = 11.95 -> 12
    assert lut[255].max() == 0 and lut[160, 255] == 0  # past 2^31: 0, not 255


@pytest.mark.parametrize("line,want", [(b"-Y 4 +X 8\n", [4, 8]), (b"-Y4+X8", [4, 8]), (b"-Y  -3 +X 9", [-3, 9]),
                                       (b"+Y 4 +X 8\n", []), (b"-Y 4 -X 8\n", [4]), (b"-Y x", []),
                                       (b"-Y 99999999999 +X 2", [1215752191, 2]), (b"-Y 4294967303 +X 2", [7, 2]),
                                       (b"-Y 99999999999999999999999 +X 2", [-1, 2])])
def test_radiance_size_line(line, want):
    """glibc's sscanf("-Y %d +X %d"): literals, white space, strtol's value
    kept to 32 bits."""
    assert cv_hdr._size(line) == want


def _tiff_ifd(order: str, entries: list) -> bytes:
    import struct

    e = b"".join(struct.pack(order + "HHI", tag, kind, count) + value.ljust(4, b"\0") for tag, kind, count, value
                 in entries)
    mark = b"II" if order == "<" else b"MM"
    return mark + struct.pack(order + "HI", 42, 8) + struct.pack(order + "H", len(entries)) + e + b"\0" * 4


@pytest.mark.parametrize("order", "<>")
def test_exif_orientation(order):
    import struct

    short = lambda v: struct.pack(order + "H", v)  # noqa: E731
    assert exif.orientation(_tiff_ifd(order, [(0x0112, 3, 1, short(6))])) == 6
    assert exif.orientation(_tiff_ifd(order, [(0x0112, 4, 1, short(3))])) == 3  # any type: the first 16 bits
    first = _tiff_ifd(order, [(0x0112, 3, 1, short(5)), (0x0112, 3, 1, short(7))])
    assert exif.orientation(first) == 5  # the first entry of a tag counts
    cut = _tiff_ifd(order, [(0x0112, 3, 1, short(8)), (0x010F, 2, 40, struct.pack(order + "I", 9999))])
    assert exif.orientation(cut) == 8  # a string past the data stops the reading after it
    assert exif.orientation(_tiff_ifd(order, [(0x010F, 2, 40, struct.pack(order + "I", 9999)),
                                              (0x0112, 3, 1, short(8))])) is None
    assert exif.orientation(b"XY" + _tiff_ifd(">", [(0x0112, 3, 1, struct.pack(">H", 2))])[2:]) == 2  # not II: MM


def test_exif_apply_orientation():
    img = np.arange(2 * 3 * 3).reshape(2, 3, 3)
    t = img.swapaxes(0, 1)
    expected = {1: img, 2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1], 5: t, 6: t[:, ::-1], 7: t[::-1, ::-1],
                8: t[::-1], 9: img, None: img}
    for o, want in expected.items():
        np.testing.assert_array_equal(exif.apply_orientation(img, o), want)


def test_claims_match_opencv(tmp_path):
    """opencv.decoder against cv2.haveImageReader on every fixture and on
    prefixes that test each signature's edge."""
    import cv2

    files = [_data(n) for n in NAMES]
    files += [b"GIF", b"GIFxx", b"#?RGBE", b"#?RADIANCE", b"#?RADIANC", b"P7\n", b"P7x", b"P3 ", b"P3x", b"Pf\t",
              b"II*\0", b"MM\0+", b"BM", b"B", b"\xff\xd8\xff", b"\xff\xd8", b"\x59\xa6\x6a\x95",
              b"RIFF\x24\0\0\0WEBPVP8 " + bytes(20), b"\0\0\0\x1cftypavif\0\0\0\0avifmif1miaf",
              b"\0\0\0\x1cftypavif\0\0\0\0avifmif1miaf" + bytes(16)]
    for i, data in enumerate(files):
        path = tmp_path / f"f{i}"
        path.write_bytes(data)
        assert (opencv.decoder(data) is not None) == cv2.haveImageReader(str(path)), (i, data[:16])
