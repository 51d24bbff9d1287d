"""`load_hdr` of the port against the JAX package's (imageio 2.37's plugin
order: each extension's plugins, then all of them; io/imageio_order.py).

Every extension the JAX package reads image data under, with PNG data of
8 and 16 bits, gray, gray+alpha, RGB, RGBA and palette, JPEG, DIB and JPEG
2000 data: the port gives the JAX package's array bitwise, also where
imageio hands the data to OpenCV before Pillow (`.exr`: `EXR-FI`, `pyav`,
`opencv`; `.HDR`), or raises a ValueError where the JAX package raises.
"""

from __future__ import annotations

import io
import warnings

import numpy as np
import pytest
from PIL import Image

from vpt_tpu.scene import envmap as jenvmap
from vpt_tpu_torch.io import imageio_order
from vpt_tpu_torch.scene import envmap as tenvmap

RNG = np.random.default_rng(21)


def _pil(arr, fmt: str, mode: str | None = None, **kw) -> bytes:
    im = Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)
    out = io.BytesIO()
    im.save(out, format=fmt, **kw)
    return out.getvalue()


def _png16(c: int) -> bytes:
    import gltf_scenes

    return gltf_scenes.encode_png(RNG.integers(0, 65536, (7, 9, c), np.uint16))


DATA = {
    "png-rgb8": lambda: _pil(RNG.integers(0, 256, (7, 9, 3), np.uint8), "PNG"),
    "png-rgba8": lambda: _pil(RNG.integers(0, 256, (7, 9, 4), np.uint8), "PNG"),
    "png-gray8": lambda: _pil(RNG.integers(0, 256, (7, 9), np.uint8), "PNG"),
    "png-gray-alpha8": lambda: _pil(RNG.integers(0, 256, (7, 9, 2), np.uint8), "PNG", "LA"),
    "png-palette": lambda: _pil_palette(),
    "png-rgb16": lambda: _png16(3),
    "png-rgba16": lambda: _png16(4),
    "png-gray16": lambda: _png16(1),
    "png-gray-alpha16": lambda: _png16(2),
    "jpeg": lambda: _pil(RNG.integers(0, 256, (7, 9, 3), np.uint8), "JPEG"),
    "dib": lambda: _pil(RNG.integers(0, 256, (7, 9, 3), np.uint8), "DIB"),
    "jp2": lambda: _pil(RNG.integers(0, 256, (7, 9, 3), np.uint8), "JPEG2000"),
    "j2k": lambda: _pil(RNG.integers(0, 256, (7, 9), np.uint8), "JPEG2000", no_jp2=True),
}


def _pil_palette() -> bytes:
    im = Image.fromarray(RNG.integers(0, 256, (7, 9, 3), np.uint8)).convert("P")
    out = io.BytesIO()
    im.save(out, format="PNG")
    return out.getvalue()


# The extensions the JAX package reads each kind of data under (ROADMAP
# Queue 3), and those of their own format.
PNG_EXTS = (".png", ".apng", ".foo", "", ".exr", ".jxl", ".avif", ".heic", ".ps", ".emf", ".wmf", ".dcm", ".fits",
            ".mp4", ".HDR", ".PNG")
JPEG_EXTS = (".jpg", ".jpe", ".jfif", ".jif", ".mpo", ".exr")
DIB_EXTS = (".dib", ".bmp", ".exr")
JP2_EXTS = (".jp2", ".j2k", ".j2c", ".jpc", ".jpf", ".jpx", ".exr", ".png")
CASES = [(kind, ext) for kind in DATA for ext in (
    PNG_EXTS if kind.startswith("png") else JPEG_EXTS if kind == "jpeg" else DIB_EXTS if kind == "dib" else JP2_EXTS)]


@pytest.mark.parametrize("kind,ext", CASES)
def test_load_hdr_follows_imageio_order(tmp_path, kind, ext):
    path = str(tmp_path / f"sky{ext}")
    with open(path, "wb") as f:
        f.write(DATA[kind]())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            want, want_err = jenvmap.load_hdr(path), None
        except Exception as e:  # noqa: BLE001  (imageio and its plugins raise many kinds)
            want, want_err = None, e
    if want_err is not None:
        with pytest.raises(ValueError):
            tenvmap.load_hdr(path)
        return
    got = tenvmap.load_hdr(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_imageio_order_is_imageio_s():
    """The port's copy of imageio's order (io/imageio_order.py) equals
    imageio's own for every extension it lists, and its fallback order."""
    from imageio.config.extensions import known_extensions
    from imageio.config.plugins import known_plugins

    assert imageio_order.KNOWN == tuple(known_plugins)
    for ext, formats in known_extensions.items():
        assert imageio_order.EXTENSIONS[ext] == tuple(p for f in formats for p in f.priority), ext
    assert set(imageio_order.EXTENSIONS) == set(known_extensions)


@pytest.mark.parametrize("kind", [k for k in DATA if k.startswith("png")])
def test_png_data_under_exr_is_opencv_s(tmp_path, kind):
    """`.exr` gives imageio's OpenCV plugin the file before Pillow: both
    packages read PNG data there through OpenCV (libpng's 8-bit BGR: the
    high byte of 16-bit samples, alpha dropped, palette expanded), bitwise
    alike."""
    path = str(tmp_path / "sky.exr")
    with open(path, "wb") as f:
        f.write(DATA[kind]())
    want = jenvmap.load_hdr(path)
    assert want.shape[-1] == 3
    got = tenvmap.load_hdr(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
