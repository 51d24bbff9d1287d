"""Environment map preprocessing (jax-free copy of vpt_tpu/scene/envmap.py).

Per-texel importance = texel solid angle x max(R, G, B); a Walker alias map
over texels with mean importance 1; alpha stores max(R, G, B) / sum of
importance, the quantity the MIS weights read as the PDF.  Leaves are numpy.
"""

from __future__ import annotations

import os

import numpy as np

from vpt_tpu_torch.io import netpbm, tiff
from vpt_tpu_torch.io.image import Unidentified, decode_samples, load_radiance_hdr
from vpt_tpu_torch.scene.types import EnvMapData

# Extensions imageio reads for the JAX package, and how: a TIFF by its
# bundled tifffile (the samples in their own dtype); a .pbm or .pfm file
# that OpenCV claims (Netpbm or PFM data) by its OpenCV plugin; the rest,
# and a .tif file that is no TIFF, by PIL, which opens a file by its
# content, and a file PIL cannot identify by the plugins after PIL's, of
# which OpenCV reads colour PFM.  The samples are not divided by 255.
_TIFF_EXTENSIONS = (".tif", ".tiff")
_OPENCV_EXTENSIONS = (".pbm", ".pfm")
_PIL_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp", ".tga", ".icb", ".vda", ".vst", ".dds", ".ppm",
                   ".pgm", ".pnm", ".qoi", ".sgi", ".rgb", ".rgba", ".bw", ".pcx", ".ico", ".cur", ".psd")
# Leading bytes of the formats OpenCV reads besides Netpbm and PFM, which
# the port does not read through OpenCV's decoders.
_OPENCV_OTHERS = (b"BM", b"\xff\xd8\xff", b"\x89PNG\r\n\x1a\n", b"II*\0", b"MM\0*", b"RIFF", b"\x59\xa6\x6a\x95",
                  b"#?RADIANCE", b"#?RGBE", b"\x76\x2f\x31\x01", b"\x00\x00\x00\x0cjP  ", b"\xff\x4f\xff\x51",
                  b"P7")


def load_hdr(path: str) -> np.ndarray:
    """An environment image as float32 (H, W, 3) from a `.npy` array, a
    Radiance `.hdr` file, a `.tif` / `.tiff` file (its first series as
    imageio's tifffile reads it: float16 / 32 / 64 and integer samples as
    they are, strips or tiles, none / LZW / Deflate / PackBits compression),
    a `.pbm` / `.pfm` file of Netpbm or PFM data as imageio's OpenCV plugin
    reads it (8-bit RGB; a PFM's floats divided by its scale's magnitude and
    rounded to 8 bits, a gray one repeated), or a file of one of PIL's
    extensions (`.png`, `.jpg`, `.jpeg`, `.bmp`, `.gif`, `.webp`, `.tga`,
    `.dds`, `.ppm`, `.pgm`, `.pnm`, `.qoi`, `.sgi`, `.rgb`, `.rgba`, `.bw`,
    `.pcx`, `.ico`, `.cur` and the rest of _PIL_EXTENSIONS) read by its
    content as imageio reads it through PIL (palette images as their
    colours, a CMYK JPEG's first three of its four channels, a WebP
    animation's first frame; no PSD, which imageio's plugin cannot read),
    or through OpenCV where PIL cannot identify the data (colour PFM).
    Gray is repeated to three channels.  Other extensions (EXR and the rest
    of imageio's) raise a ValueError that names the extension."""
    lower = path.lower()
    if path.endswith(".npy"):
        img = np.load(path)
    elif path.endswith(".hdr"):
        img = load_radiance_hdr(path)
    elif lower.endswith(_TIFF_EXTENSIONS + _OPENCV_EXTENSIONS + _PIL_EXTENSIONS):
        with open(path, "rb") as f:
            data = f.read()
        if lower.endswith(_TIFF_EXTENSIONS) and data[:4] in tiff.MAGIC:
            img = tiff.read_array(data, path)
        elif lower.endswith(_OPENCV_EXTENSIONS) and netpbm.cv2_claims(data):
            img = netpbm.read_cv2(data, path)
        elif lower.endswith(_OPENCV_EXTENSIONS) and data.startswith(_OPENCV_OTHERS):
            raise ValueError(f"{path}: OpenCV reads this {os.path.splitext(path)[1]} file's data (another format "
                             f"than Netpbm or PFM), which the port does not read through OpenCV")
        else:
            try:
                img = decode_samples(data, path, from_file=True)
            except Unidentified:
                if not netpbm.cv2_claims(data):
                    raise
                img = netpbm.read_cv2(data, path)
    else:
        ext = os.path.splitext(path)[1] or "extensionless"
        raise ValueError(f"{path}: {ext} files are not read as environment maps (only .npy, .hdr, .tif, .tiff, "
                         f".pbm, .pfm and {', '.join(_PIL_EXTENSIONS)})")
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
