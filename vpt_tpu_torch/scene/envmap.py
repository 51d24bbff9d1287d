"""Environment map preprocessing (jax-free copy of vpt_tpu/scene/envmap.py).

Per-texel importance = texel solid angle x max(R, G, B); a Walker alias map
over texels with mean importance 1; alpha stores max(R, G, B) / sum of
importance, the quantity the MIS weights read as the PDF.  Leaves are numpy.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import imageio_order, opencv, tiff
from vpt_tpu_torch.io.image import _PLUGINS, Unidentified, decode_samples, load_radiance_hdr
from vpt_tpu_torch.io.raw import FILE_OBJECT
from vpt_tpu_torch.io.probe import ACCEPT
from vpt_tpu_torch.scene.types import EnvMapData

# PIL's `_accept` of each format by name (imageio's legacy "<format>-PIL"
# plugins claim a file PIL's plugin accepts, and none where PIL registers no
# `_accept`; MPO opens as a JPEG).
_PIL_ACCEPT = {**{fmt: accept for fmt, accept, read in _PLUGINS if accept is not None and read is not None}, **ACCEPT}
_PIL_ACCEPT["MPO"] = _PIL_ACCEPT["JPEG"]


def _imageio_read(data: bytes, path: str) -> np.ndarray:
    """imageio's `imread` of the file as the JAX package calls it: the
    plugins of its extension in imageio's order, then all of them
    (io/imageio_order.py), the first that claims the file reading it.  The
    ones the port has: Pillow (the data PIL opens; io/image.decode_samples),
    OpenCV (the data one of its decoders claims; io/opencv.py), the bundled
    tifffile (TIFF data, tiff.read_array) and the legacy "<format>-PIL"
    plugins, which claim a file PIL's plugin accepts and then fail where
    Pillow failed; every other plugin (FreeImage, pyav, ITK, ...) is not
    installed or claims no image data here."""
    pil_failed = False
    for plugin in imageio_order.plugins(path):
        if plugin == "pillow":
            try:
                return decode_samples(data, path, from_file=FILE_OBJECT)
            except Unidentified:
                pil_failed = True
        elif plugin == "opencv":
            if opencv.decoder(data):
                return opencv.read(data, path)
        elif plugin == "TIFF":
            if data[:4] in tiff.MAGIC:
                return tiff.read_array(data, path)
        elif plugin.endswith("-PIL") and pil_failed:
            accept = _PIL_ACCEPT.get(plugin[:-4])
            if accept is not None and accept(data):
                raise ValueError(f"{path}: PIL's {plugin[:-4]} plugin claims the file but cannot open it")
    raise ValueError(f"{path}: no plugin of imageio's reads this file")


def load_hdr(path: str) -> np.ndarray:
    """An environment image as float32 (H, W, 3), as the JAX package's
    `load_hdr` gives it: a `.npy` array, a Radiance file named `.hdr` (the
    port's own decoder, floats), or any other file as imageio reads it
    (`_imageio_read`): by its extension's plugin order, so a TIFF through
    tifffile (float16 / 32 / 64 and integer samples as they are), the data
    PIL opens (PNG, JPEG, JPEG 2000, BMP, GIF, WebP, TGA, DDS, ...) through
    PIL (palette images as their colours, a CMYK JPEG's first three of its
    four channels, a WebP animation's first frame; no PSD, which imageio's
    plugin cannot read), and the data OpenCV claims where OpenCV comes
    first (`.HDR`, `.pic`, `.exr`, `.sr`, `.dip`, `.pxm`, `.pbm`, `.pfm`, a
    name without an extension, ...) through OpenCV: 8-bit RGB, so a
    Radiance sky named `sky.HDR` or `sky.pic` reads as OpenCV's rounding of
    its radiance times 255 (io/cv_hdr.py), not as floats.  The samples are
    not divided by 255; gray is repeated to three channels.  What neither
    package reads raises a ValueError; AVIF through OpenCV is refused by
    name (io/opencv.py)."""
    if path.endswith(".npy"):
        img = np.load(path)
    elif path.endswith(".hdr"):
        img = load_radiance_hdr(path)
    else:
        with open(path, "rb") as f:
            img = _imageio_read(f.read(), path)
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3]


def build_alias_map(importance: np.ndarray):
    """Walker alias map (Vose construction): (alias, normalised importance)."""
    n = importance.shape[0]
    total = float(importance.sum())
    if total <= 0.0:
        return np.arange(n, dtype=np.int32), np.zeros(n, np.float32)
    norm = (importance * (n / total)).astype(np.float64)
    alias = np.arange(n, dtype=np.int32)
    small = list(np.nonzero(norm < 1.0)[0][::-1])
    large = list(np.nonzero(norm >= 1.0)[0][::-1])
    norm = norm.copy()
    while small and large:
        s = small.pop()
        l = large.pop()
        alias[s] = l
        norm[l] -= 1.0 - norm[s]
        if norm[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    return alias.astype(np.int32), norm.astype(np.float32)


def prepare_environment(image: np.ndarray) -> EnvMapData:
    """Solid-angle importance, alias map, PDF alpha and 2x2 neighbourhoods."""
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    rgb = image[..., :3]
    step_phi = 2.0 * np.pi / w
    cos_theta = np.cos(np.pi * np.arange(h + 1) / h)
    area = (cos_theta[:-1] - cos_theta[1:]) * step_phi
    brightness = rgb.max(axis=-1)
    importance = (area[:, None] * brightness).reshape(-1)
    alias, imp = build_alias_map(importance)
    total = float(importance.sum())
    pdf = brightness / total if total > 0 else np.zeros_like(brightness)
    out = np.concatenate([rgb, pdf[..., None]], axis=-1).astype(np.float32)
    if h * w <= 2 * 1024 * 1024:
        xr = np.concatenate([out[:, 1:], out[:, :1]], axis=1)  # x+1 wrapped
        yd = np.concatenate([out[1:], out[-1:]], axis=0)  # y+1 clamped
        ydxr = np.concatenate([yd[:, 1:], yd[:, :1]], axis=1)
        quad = np.concatenate([out, xr, yd, ydxr], axis=-1).astype(np.float32)
    else:
        quad = np.zeros((1, 1, 16), np.float32)
    return EnvMapData(
        image=out, alias=np.stack([imp, alias.astype(np.float32)], axis=-1), quad=quad,
    )


def constant_environment(color=(0.0, 0.0, 0.0), size=(8, 16)) -> EnvMapData:
    h, w = size
    img = np.zeros((h, w, 3), np.float32)
    img[..., :] = np.asarray(color, np.float32)
    return prepare_environment(img)


def default_sky(size=(64, 128), sun_azimuth=0.35, sun_altitude=0.35, sun_radiance=150.0) -> np.ndarray:
    """Procedural gradient sky with a sun hotspot, for scenes with no lights."""
    h, w = size
    ys = np.linspace(-1.0, 1.0, h)[:, None]
    up = np.clip(-ys, 0.0, 1.0)
    horizon = 1.0 - np.abs(ys)
    sky = np.zeros((h, w, 3), np.float32)
    sky[..., 0] = 0.25 + 0.35 * horizon + 0.05 * up
    sky[..., 1] = 0.35 + 0.35 * horizon + 0.15 * up
    sky[..., 2] = 0.55 + 0.30 * horizon + 0.35 * up
    ground = ys[:, 0] > 0
    sky[ground] *= np.array([0.45, 0.38, 0.30], np.float32)
    sy = int((0.5 - sun_altitude / 2) * h)
    sx = int((0.5 + sun_azimuth / 2) * w) % w
    sky[max(sy - 1, 0) : sy + 2, max(sx - 1, 0) : sx + 2] = sun_radiance
    return sky
