"""The port's ICO, CUR and PSD readers (io/ico.py, io/psd.py, with io/bmp.py
for bitmap entries and the PSD PackBits loop of csrc/imgcodec.c) against
the JAX package: PIL for the glTF texture decode and `load_png`, imageio's
PIL plugin for `load_hdr` (.ico, .cur, .psd; it reads no PSD: its plugin
cannot seek a PSD's first frame).  Every case of tests/pil_format_cases.py
(PIL's ICO files with PNG and BMP entries, bitmap entries at every depth
with their AND masks, the entry PIL picks among ties, CUR at every depth,
PSD raw and PackBits in every colour mode PIL opens) and a seeded sweep of
corrupt copies give the same arrays on every path, or a ValueError where the
JAX package raises; a Lab PSD's texture too, which PIL converts through
LittleCMS and the port through io/lab.py.
"""

import numpy as np
import pytest

import pil_format_cases as pc
import pil_format_checks as chk
from vpt_tpu_torch.io import codec
from vpt_tpu_torch.io import image as timage

NAMES = pc.names(("ico", "cur", "psd"))
REFUSED = {"psd-16-bit", "psd-rgb5-packbits", "psd-too-few-channels"}
LAB = ("psd-lab-raw", "psd-lab-packbits")


@pytest.mark.parametrize("name", NAMES)
def test_case_equals_jax(tmp_path, name):
    """One file on the three pairs (texture from memory and from a file,
    load_png, load_hdr): equal, or refused by both (the Lab texture too:
    test_lab_texture_is_the_known_difference); and the JAX package reads
    every ICO and CUR case on every path, every PSD case but REFUSED on
    every path but load_hdr."""
    exts = pc.EXTENSIONS[name.split("-")[0]]
    result = chk.compare(pc.case_bytes(name), str(tmp_path), exts)
    bad = [v for k, v in result.items() if k != "_jax" and v]
    assert bad == [], bad
    keys = {k for k in result if k != "_jax"}
    want = set() if name in REFUSED else ({"texture", "texture-file", "load_png"} if name.startswith("psd") else keys)
    assert set(result["_jax"]) == want


@pytest.mark.parametrize("seed", range(16))
def test_corrupt_files_equal_jax(tmp_path, seed):
    """Corrupt copies (a byte changed, the file cut, a byte put in; 12 per
    seed, each of another case): each decodes as the JAX package decodes it
    on every path, or raises a ValueError where it raises."""
    for k in range(12):
        name = NAMES[(seed * 12 + k) * 7 % len(NAMES)]
        data = pc.mutants(name, seed, 1)[0]
        assert chk.failures(data, str(tmp_path), pc.EXTENSIONS[name.split("-")[0]]) == [], name


@pytest.mark.parametrize("name", LAB)
def test_lab_texture_is_the_known_difference(tmp_path, name):
    """A Lab PSD, once the known difference (the port refused it): load_png
    gives PIL's array (L, and a and b as PIL's unpackers store them, each
    XOR 0x80); as a texture the JAX package converts it through LittleCMS
    to sRGB, and the port gives the same RGBA (io/lab.py)."""
    data = pc.case_bytes(name)
    result = chk.compare(data, str(tmp_path), (".psd",))
    assert [k for k, v in result.items() if k != "_jax" and v] == []
    assert {"texture", "texture-file", "load_png"} <= set(result["_jax"])


def test_packbits_rows_cut_packets_at_the_row_end():
    """PSD PackBits as PIL reads it: a run or literal that runs past its
    scanline is cut there; -128 is a no-op; data that ends early reports it."""
    rows, status = codec.packbits_rows(bytes([0xFD, 7, 0x80, 0x02, 1, 2, 3]), 3, 2)
    assert status == 0 and rows.tolist() == [[7, 7, 7], [1, 2, 3]]
    rows, status = codec.packbits_rows(bytes([0x03, 1, 2, 3, 4, 0xFF, 9, 0x00, 5]), 3, 2)
    assert status == 0 and rows.tolist() == [[1, 2, 3], [9, 9, 5]]
    assert codec.packbits_rows(bytes([0xFD, 7]), 3, 2)[1] == 1


def _png_with(mutate) -> bytes:
    import io
    import struct

    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(np.random.default_rng(4).integers(0, 256, (5, 6, 3), np.uint8)).save(out, format="PNG")
    data = bytearray(out.getvalue())
    at = data.find(b"IDAT") - 4
    (length,) = struct.unpack(">I", data[at : at + 4])
    mutate(data, at, at + 12 + length)
    return bytes(data)


@pytest.mark.parametrize("fault", ["idat-crc", "adler-in-its-own-idat", "chunk-after-idat", "adler"])
def test_png_reads_past_its_image_data_as_pil(fault):
    """An ICO's PNG entries showed it: PIL checks the CRCs of the chunks
    before IDAT only, feeds its inflater an IDAT chunk at a time and stops
    once the last row is out (an Adler-32 in a later IDAT is never read),
    and stops at a chunk header after the image data that names no chunk.
    The port once refused all three; it reads them as PIL does (ROADMAP
    Queue 3, PR 20).  An Adler-32 fed with the last row is checked: both
    refuse it."""
    import io
    import struct
    import zlib

    from PIL import Image

    def mutate(data, at, end):
        if fault == "idat-crc":
            data[end - 1] ^= 0xFF
        elif fault == "adler":
            data[end - 5] ^= 0xFF
        elif fault == "adler-in-its-own-idat":
            body = bytes(data[at + 8 : end - 4])
            data[at:end] = b"".join(struct.pack(">I", len(b)) + b"IDAT" + b + struct.pack(">I", zlib.crc32(b"IDAT" + b))
                                    for b in (body[:-4], bytes(x ^ 0xFF for x in body[-4:])))
        else:
            data[end + 4] = 0

    data = _png_with(mutate)
    if fault == "adler":
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).convert("RGBA")
        with pytest.raises(ValueError, match="incorrect data check"):
            timage.decode_rgba(data, "png")
        return
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(timage.decode_rgba(data, "png"), want)


def test_bmp_without_pixel_offset_reads_after_its_palette():
    """A BMP whose bfOffBits is 0: PIL reads the pixels where the header and
    palette end (the port once read them from the palette's start)."""
    import io
    import struct

    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (5, 7, 3), np.uint8)).quantize(6).save(out, format="BMP")
    data = bytearray(out.getvalue())
    struct.pack_into("<I", data, 10, 0)
    want = np.asarray(Image.open(io.BytesIO(bytes(data))).convert("RGBA"), np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(timage.decode_rgba(bytes(data), "bmp"), want)
