"""The port's TGA and PCX readers (io/tga.py, io/pcx.py and the RLE loops of
csrc/imgcodec.c) against the JAX package, which reads them with PIL (the
glTF texture decode, `load_png`) and imageio's PIL plugin (`load_hdr` under
.tga, .icb, .vda, .vst and .pcx): every case of tests/pil_format_cases.py
and a seeded sweep of corrupt copies give the same arrays on every path, or
a ValueError where the JAX package raises.  Also the order in which PIL
tries its plugins on a file without magic bytes: a TGA that CUR's or PCX's
magic reaches first, and one that IPTC's fields reach, resolve as in PIL;
and a short 8-bit PCX that PIL opens from memory but not from a file.
"""

import io

import numpy as np
import pytest
from PIL import Image

import pil_format_cases as pc
import pil_format_checks as chk
from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io import image as timage

NAMES = pc.names(("tga", "pcx"))
# Cases the JAX package refuses on every path (the rest it reads on every path but those of PARTIAL).
REFUSED = {"tga-colour-map-15-start-0", "tga-colour-map-32-start-0", "tga-pcx-magic-claimed", "tga-pil-1-rle-bottom",
           "tga-pil-1-rle-top", "tga-rle-run-across", "tga-type1-no-map", "tga-type3-24-bit", "pcx-run-over-line",
           "pcx-version-3"}
PARTIAL = {"pcx-8-bit-short": {"texture"}}


@pytest.mark.parametrize("name", NAMES)
def test_case_equals_jax(tmp_path, name):
    """One file on the three pairs (texture from memory and from a file,
    load_png, load_hdr under each extension): equal, or refused by both;
    and the JAX package reads it where it should, so no equality is vacuous."""
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
        data = pc.mutants(name, seed, 1)[0]
        assert chk.failures(data, str(tmp_path), pc.EXTENSIONS[name.split("-")[0]]) == [], name


@pytest.mark.parametrize("name, fmt", [("tga-cur-magic", "TGA"), ("tga-pcx-magic", "TGA"), ("tga-iptc-magic", "TGA"),
                                       ("tga-pcx-magic-claimed", "PCX"), ("tga-pil-RGB-raw-top", "TGA")])
def test_plugin_order(name, fmt):
    """A file PIL's CUR, PCX or IPTC plugin looks at before TGA's: CUR finds
    no cursor and PCX a size of none, so TGA reads it; IPTC's second field
    is none; PCX reads a 1x1 size from one and refuses its mode, so PIL
    refuses it and so does the port.  A plain TGA no plugin claims before."""
    data = pc.case_bytes(name)
    im = Image.open(io.BytesIO(data)) if fmt == "TGA" else None
    if im is not None:
        assert im.format == "TGA"
        want = np.asarray(im.convert("RGBA"), np.float32) / np.float32(255.0)
        np.testing.assert_array_equal(timage.decode_rgba(data, name), want)
        return
    with pytest.raises(OSError, match="unknown PCX mode"):
        Image.open(io.BytesIO(data))
    with pytest.raises(ValueError, match="unknown PCX mode"):
        timage.decode_rgba(data, name)


def test_short_pcx_opens_from_memory_not_from_a_file(tmp_path):
    """PIL seeks 769 bytes before the end of an 8-bit PCX for its palette:
    in memory a shorter file opens (as gray), from a file the seek fails.
    The port follows both: the texture decode of the bytes reads it, the
    file's glTF image, load_png and load_hdr refuse it."""
    data = pc.case_bytes("pcx-8-bit-short")
    assert len(data) < 769
    result = chk.compare(data, str(tmp_path), (".pcx",))
    assert result["_jax"] == ["texture"] and [v for k, v in result.items() if k != "_jax" and v] == []
    assert timage.decode_rgba(data, "short").shape[:2] == (3, 6)
    with pytest.raises(ValueError, match="769"):
        timage.decode_rgba(data, "short", from_file=True)


def test_rle_decoders_report_where_the_data_ends():
    """The C loops on their own: a TGA run across a scanline is an error, a
    raw packet runs on over scanlines; a PCX run past a scanline is an
    error; each reports data that ends early."""
    rows, status = codec.tga_rle(bytes([0x06]) + bytes(range(21)), 3, 6, 4)
    assert status == 1 and rows[:2].tolist() == [list(range(6)), list(range(6, 12))]
    rows, status = codec.tga_rle(bytes([0x00, 1, 2, 3, 0x81, 9, 9, 9]), 3, 6, 2)
    assert status == -1
    rows, status = codec.pcx_rle(bytes([0xC3, 5, 7]), 4, 4, 8, 1)
    assert status == 0 and rows.tolist() == [[5, 5, 5, 7]]
    rows, status = codec.pcx_rle(bytes([0xC5, 5]), 4, 4, 8, 2)
    assert status == -1
    assert codec.pcx_rle(bytes([1, 2]), 4, 4, 8, 1)[1] == 1
