"""The formats PIL 12.1 opens that the port once refused by name: a file of
each, as PIL writes it or built here, is one the JAX package decodes, and
the port's texture decode now gives PIL's expansion of it bitwise (JPEG
2000 since it was ported, PIL's rarer plugins since they were: BLP, ICNS,
IM, MSP, SPIDER, XBM, DCX, GBR, SUN, XPM, FITS, XVThumb, FTEX), not a file
of another format's reading (a TGA).  AVIF with quantizer matrices (aom's
`enable-qm`) alone is still refused, naming the format and `using_qmatrix`
(io/probe.py tells which plugin PIL gives a file to).  A
headerless DIB, which PIL opens in its `preinit` set, the port reads as PIL
does.  The formats' own tests are tests/test_torch_pil_rare.py.
"""

import io
import re
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from vpt_tpu_torch.io import image as timage


def _pil(fmt: str, mode: str = "RGB", size=(8, 6), **kw) -> bytes:
    rng = np.random.default_rng(len(fmt))
    im = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8))
    im = im.quantize(8) if mode == "P" else im.convert(mode)
    out = io.BytesIO()
    im.save(out, format=fmt, **kw)
    return out.getvalue()


def _fits() -> bytes:
    cards = ("SIMPLE  =                    T", "BITPIX  =                    8", "NAXIS   =                    2",
             "NAXIS1  =                    4", "NAXIS2  =                    3", "END")
    return b"".join(c.encode().ljust(80) for c in cards).ljust(2880) + bytes(range(12)).ljust(2880, b"\0")


UNPORTED = {  # case -> (the file, PIL's format, the name in the port's refusal, or None: read)
    "blp": (lambda: _pil("BLP", "P"), "BLP", None),
    "icns": (lambda: _pil("ICNS", size=(16, 16)), "ICNS", None),
    "im": (lambda: _pil("IM"), "IM", None),
    "msp": (lambda: _pil("MSP", "1"), "MSP", None),
    "spider": (lambda: _pil("SPIDER", "F"), "SPIDER", None),
    "xbm": (lambda: _pil("XBM", "1"), "XBM", None),
    "dcx": (lambda: struct.pack("<III", 0x3ADE68B1, 12, 0) + _pil("PCX"), "DCX", None),
    "gbr": (lambda: struct.pack(">5I", 28, 2, 8, 6, 1) + b"GIMP" + struct.pack(">I", 10) + b"x\0" + bytes(48), "GBR",
            None),
    "sun": (lambda: struct.pack(">8I", 0x59A66A95, 8, 6, 8, 48, 1, 0, 0) + bytes(48), "SUN", None),
    "xpm": (lambda: b'/* XPM */\nstatic char *x[] = {\n"2 1 2 1",\n"a c #ff0000",\n"b c #00ff00",\n"ab"\n};\n', "XPM",
            None),
    "fits": (_fits, "FITS", None),
    "xvthumb": (lambda: b"P7 332\n#END_OF_COMMENTS\n4 3 255\n" + bytes(range(12)), "XVThumb", None),
    "ftex": (lambda: b"FTEX" + struct.pack("<9I", 1, 4, 4, 1, 1, 0, 1, 0, 48) + bytes(48), "FTEX", None),
    "jpeg2000": (lambda: _pil("JPEG2000"), "JPEG2000", None),
    "avif": (lambda: _pil("AVIF", size=(64, 48), quality=60, advanced={"enable-qm": "1"}), "AVIF", "AVIF"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_formats_are_refused_by_name(case):
    make, fmt, kind = UNPORTED[case]
    data = make()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
        assert im.format == fmt
        want = np.asarray(im.convert("RGBA"))
        assert want.ndim == 3
    if kind is None:  # a format the port reads: PIL's expansion, bitwise
        np.testing.assert_array_equal(timage.decode_rgba(data, "wall"), want.astype(np.float32) / np.float32(255.0))
        return
    with pytest.raises(ValueError, match=re.escape(f"wall: {kind} images are not read yet (PIL opens them")) as err:
        timage.decode_rgba(data, "wall")
    if case == "avif":  # saved with quantizer matrices, which the port refuses by name
        assert "using_qmatrix" in str(err.value)


@pytest.mark.parametrize("bits", [8, 24])
def test_dib_reads_as_pil_opens_it(bits):
    """A BITMAPINFOHEADER bitmap without its file header (PIL's DIB)."""
    bmp = _pil("BMP", "P" if bits == 8 else "RGB")
    dib = bmp[14:]
    want = np.asarray(Image.open(io.BytesIO(dib)).convert("RGBA"), np.float32) / np.float32(255.0)
    assert Image.open(io.BytesIO(dib)).format == "DIB"
    np.testing.assert_array_equal(timage.decode_rgba(dib, "dib"), want)
