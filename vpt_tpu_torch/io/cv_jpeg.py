"""JPEG files as OpenCV 5.0's JpegDecoder (grfmt_jpeg.cpp, over
libjpeg-turbo) reads them with `IMREAD_COLOR`.

OpenCV asks libjpeg for BGR output of one- and three-component files, so
the samples are libjpeg-turbo's, as PIL's are (io/jpeg.decode_jpeg: the
same islow IDCT, fancy upsampling and YCbCr conversion), gray repeated to
three channels.  A four-component file is read as libjpeg's CMYK (YCCK
converted to it) and turned into BGR by OpenCV's own arithmetic,
`icvCvt_CMYK2BGR_8u_C4C3R`: each of C, M, Y becomes
K - ((255 - C) x K >> 8), which is not PIL's conversion.  The EXIF
orientation comes from the first APP1 segment before the first scan that
begins "Exif\\0\\0", its bytes from the seventh on (exif.py).

libjpeg reads the file through its stdio source (`decode_jpeg(stdio=True)`):
a cut file reads on as if it ended in EOI.  A lossless gray file fails:
libjpeg-turbo converts no colour space of a lossless image, and OpenCV
asks for BGR.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io.jpeg import decode_jpeg

SIGNATURE = b"\xff\xd8\xff"


def claims(sig: bytes) -> bool:
    return sig[:3] == SIGNATURE


def _app1(data: bytes) -> bytes | None:
    """The payload of the first APP1 segment before the first SOS that
    begins "Exif\\0\\0", from its seventh byte; None without one."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)) or marker == 0x00:
            pos += 2
            continue
        if marker in (0xD9, 0xDA):
            return None
        length = (data[pos + 2] << 8) | data[pos + 3]
        if marker == 0xE1 and data[pos + 4 : pos + 10] == b"Exif\0\0":
            body = data[pos + 4 : pos + 2 + length]
            return body[6:] if len(body) > 6 else None
        pos += 2 + length
    return None


def _lossless_gray(data: bytes) -> bool:
    """A lossless (SOF3) frame of one component."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF or data[pos + 1] in (0xFF, 0x00, 0x01, *range(0xD0, 0xD8)):
            pos += 1 if data[pos] != 0xFF or data[pos + 1] == 0xFF else 2
            continue
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):
            return False
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return marker == 0xC3 and pos + 9 < len(data) and data[pos + 9] == 1
        pos += 2 + ((data[pos + 2] << 8) | data[pos + 3])
    return False


def read(data: bytes, name: str) -> tuple:
    """The image as (H, W, 3) uint8 RGB, and its EXIF bytes."""
    if _lossless_gray(data):
        raise ValueError(f"{name}: a lossless gray JPEG, which libjpeg-turbo does not turn into the BGR OpenCV "
                         f"asks for (it converts no colour space of a lossless image)")
    img = decode_jpeg(data, name, stdio=True)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 4:
        cmyk = 255 - img.astype(np.int32)  # libjpeg's CMYK (decode_jpeg gives PIL's inverted samples)
        k = cmyk[..., 3:]
        img = (k - (((255 - cmyk[..., :3]) * k) >> 8)).astype(np.uint8)
    return img, _app1(data)
