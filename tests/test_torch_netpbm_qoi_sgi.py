"""The port's Netpbm, QOI and SGI readers (io/netpbm.py, io/qoi.py,
io/sgi.py and the QOI and SGI RLE loops of csrc/imgcodec.c) against the JAX
package: PIL for the glTF texture decode and `load_png`, imageio for
`load_hdr`, which reads .ppm, .pgm, .pnm, .qoi, .sgi, .rgb, .rgba and .bw
through PIL and .pbm and .pfm through OpenCV (and any file PIL cannot
identify through OpenCV too).  Every case of tests/pil_format_cases.py
(PIL's PPM, QOI and SGI files; ASCII Netpbm with comments, every maxval
PIL rescales, 16-bit samples, gray and colour PFM; QOI with every op; SGI
RLE at 8 and 16 bits) and a seeded sweep of corrupt copies give the same
arrays on every path, or a ValueError where the JAX package raises.  Also
the repair of the PFM reading: gray "Pf" on all three paths, colour "PF"
through load_hdr and refused as a texture, as the JAX package gives them.
"""

import numpy as np
import pytest

import pil_format_cases as pc
import pil_format_checks as chk
from vpt_tpu_torch.io import codec, netpbm
from vpt_tpu_torch.io import image as timage
from vpt_tpu_torch.scene import envmap as tenvmap

NAMES = pc.names(("ppm", "qoi", "sgi"))
REFUSED = {"qoi-truncated", "sgi-rle-offset-past-end"}
# What the JAX package reads of the rest, where it is not every path.
_OPENCV = {"load_hdr.pbm", "load_hdr.pfm"}
PARTIAL = {"ppm-p2-value-too-large": _OPENCV,
           **{n: _OPENCV | {"load_hdr.ppm", "load_hdr.pgm", "load_hdr.pnm"} for n in NAMES if "-pfm-PF-" in n}}


@pytest.mark.parametrize("name", NAMES)
def test_case_equals_jax(tmp_path, name):
    """One file on the three pairs (texture from memory and from a file,
    load_png, load_hdr under each of its format's extensions): equal, or
    refused by both; and the JAX package reads it where it should."""
    exts = pc.EXTENSIONS[name.split("-")[0]]
    result = chk.compare(pc.case_bytes(name), str(tmp_path), exts)
    assert [v for k, v in result.items() if k != "_jax" and v] == []
    keys = {k for k in result if k != "_jax"}
    assert set(result["_jax"]) == (set() if name in REFUSED else PARTIAL.get(name, keys))


@pytest.mark.parametrize("seed", range(16))
def test_corrupt_files_equal_jax(tmp_path, seed):
    """Corrupt copies (a byte changed, the file cut, a byte put in; 12 per
    seed, each of another case): each decodes as the JAX package decodes it
    on every path, or raises a ValueError where it raises."""
    for k in range(12):
        name = NAMES[(seed * 12 + k) * 7 % len(NAMES)]
        assert chk.failures(pc.mutants(name, seed, 1)[0], str(tmp_path), pc.EXTENSIONS[name.split("-")[0]]) == [], \
            name


def test_pfm_as_the_jax_package_reads_it(tmp_path):
    """The repair: gray "Pf" decodes on the texture path (PIL's mode "F",
    truncated to 8 bits), in load_png (F / 255) and in load_hdr (.pfm:
    OpenCV, rounded and saturated to 8 bits, rows bottom-up); colour "PF"
    decodes in load_hdr under .pfm and .ppm (OpenCV) and is refused as a
    texture by both, as PIL refuses it."""
    gray = np.array([[1.6, 231.96, 6.73, 300.0], [-5.0, 0.5, 1.5, 2.5], [254.5, 255.5, 0.0, 7.0]], "<f4")
    data = b"Pf\n4 3\n-1.0\n" + gray[::-1].tobytes()
    result = chk.compare(data, str(tmp_path), (".pfm", ".ppm"))
    assert [v for k, v in result.items() if k != "_jax" and v] == []
    assert set(result["_jax"]) == {"texture", "texture-file", "load_png", "load_hdr.pfm", "load_hdr.ppm"}
    np.testing.assert_array_equal(timage.decode_rgba(data, "g")[..., 0] * 255, np.clip(np.trunc(gray), 0, 255))
    np.testing.assert_array_equal(tenvmap.load_hdr(chk.paths(data, str(tmp_path), (".pfm",))[".pfm"])[..., 0],
                                  [[2, 232, 7, 255], [0, 0, 2, 2], [254, 255, 0, 7]])
    colour = np.random.default_rng(1).uniform(-3, 290, (2, 3, 3)).astype(">f4")
    data = b"PF\n3 2\n1.0\n" + colour.tobytes()
    result = chk.compare(data, str(tmp_path), (".pfm", ".ppm"))
    assert [v for k, v in result.items() if k != "_jax" and v] == []
    assert set(result["_jax"]) == {"load_hdr.pfm", "load_hdr.ppm"}
    with pytest.raises(ValueError, match="PFM"):
        timage.decode_rgba(data, "c")


def test_opencv_reads_what_pil_rescales_otherwise(tmp_path):
    """imageio gives .pbm files to OpenCV, which keeps binary 8-bit samples
    as they are, scales ASCII ones by 255 / maxval, shifts 16-bit ones down
    8 bits and gives three channels; PIL, under .pgm, rescales them all."""
    data = b"P5\n2 1\n100\n\x10\x64"
    files = chk.paths(data, str(tmp_path), (".pbm", ".pgm"))
    np.testing.assert_array_equal(tenvmap.load_hdr(files[".pbm"])[0], [[16] * 3, [100] * 3])
    np.testing.assert_array_equal(tenvmap.load_hdr(files[".pgm"])[0], [[41] * 3, [255] * 3])
    assert netpbm.read_cv2(b"P2\n3 1\n100\n0 50 200\n").tolist() == [[[0] * 3, [127] * 3, [255] * 3]]
    assert netpbm.read_cv2(b"P5\n2 1\n1000\n\x03\xe8\x01\x00")[..., 0].tolist() == [[3, 1]]


def test_qoi_decoder_runs_every_op():
    """The C QOI loop on its own: RGBA, RGB, INDEX, DIFF, LUMA and RUN ops,
    a run past the last pixel cut, and data that ends early raises."""
    ops = bytes([0xFF, 10, 20, 30, 40, 0x40 | (3 << 4) | (2 << 2) | 1, 0x80 | 40, 0x88, 0xC1, 0xFE, 1, 2, 3,
                 (10 * 3 + 20 * 5 + 30 * 7 + 40 * 11) % 64, 0xFD])
    px = codec.qoi_decode(ops, 9, 4)
    assert px.tolist() == [[10, 20, 30, 40], [11, 20, 29, 40], [11 + 8, 28, 29 + 8, 40], [19, 28, 37, 40],
                           [19, 28, 37, 40], [1, 2, 3, 40], [10, 20, 30, 40], [10, 20, 30, 40], [10, 20, 30, 40]]
    with pytest.raises(ValueError, match="truncated"):
        codec.qoi_decode(ops[:-3], 9, 4)
