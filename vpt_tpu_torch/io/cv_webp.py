"""WebP files as OpenCV 5.0's WebPDecoder (grfmt_webp.cpp, over libwebp)
reads them with `IMREAD_COLOR`.

OpenCV claims a file whose first 32 bytes libwebp's WebPGetFeatures finds
no error in (`claims`).  It decodes a still image with WebPDecodeBGR
(`_still`: libwebp's own parse of the whole file and its colour
conversion, the alpha dropped) and an animation's first frame as libwebp's
animation decoder composes it, on a canvas of zeros, alpha dropped (the
demuxer's reading, io/webp.py).  The EXIF orientation comes from the
`EXIF` chunk.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec, webp


_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1


def _features_error(d: bytes) -> bool:
    """Whether libwebp's WebPGetFeatures finds a bitstream error in `d`
    (running out of data is no error; ParseHeadersInternal)."""
    le32 = lambda at: struct.unpack_from("<I", d, at)[0]  # noqa: E731
    n, pos, riff_size = len(d), 0, 0
    if n >= 12 and d[:4] == b"RIFF":
        if d[8:12] != b"WEBP":
            return True
        riff_size = le32(4)
        if riff_size < 12 or riff_size > _MAX_PAYLOAD:
            return True
        pos = 12
    vp8x = None
    if n - pos >= 8 and d[pos : pos + 4] == b"VP8X":
        if le32(pos + 4) != 10:
            return True
        if n - pos < 18:
            return False
        flags = le32(pos + 8)
        vp8x = (1 + int.from_bytes(d[pos + 12 : pos + 15], "little"), 1 + int.from_bytes(d[pos + 15 : pos + 18], "little"))
        if vp8x[0] * vp8x[1] >= 1 << 32:
            return True
        pos += 18
        if flags & webp.ANIMATION_FLAG:
            return False
    if n - pos < 4:
        return False
    if vp8x or (not riff_size and d[pos : pos + 4] == b"ALPH"):
        total = 4 + 8 + 10
        while True:
            if n - pos < 8:
                return False
            if d[pos : pos + 4] in (b"VP8 ", b"VP8L"):
                break
            size = le32(pos + 4)
            if size > _MAX_PAYLOAD:
                return True
            disk = (8 + size + 1) & ~1
            total += disk
            if riff_size and total > riff_size:
                return True
            if n - pos < disk:
                return False
            pos += disk
    if n - pos < 8:
        return False
    kind = d[pos : pos + 4]
    declared = None
    if kind in (b"VP8 ", b"VP8L"):
        declared = le32(pos + 4)
        if riff_size >= 12 and declared > riff_size - 12:
            return True
        pos += 8
    else:
        kind = b"VP8L" if d[pos : pos + 1] == b"\x2f" and len(d) - pos >= 5 and not d[pos + 4] >> 5 else b"VP8 "
    try:
        w, h, _ = webp._image_header(kind, d[pos:], declared if declared is not None else n - pos)
    except webp._Short:
        return False
    except webp._Refused:
        return True
    return vp8x is not None and (w, h) != vp8x


def claims(sig: bytes) -> bool:
    """WebPDecoder::checkSignature: 32 bytes or more (WEBP_HEADER_SIZE), in
    which WebPGetFeatures finds no bitstream error."""
    return len(sig) >= 32 and not _features_error(sig[:32])


def _exif(data: bytes) -> bytes | None:
    pos = 12
    while pos + 8 <= len(data):
        kind, (size,) = data[pos : pos + 4], struct.unpack("<I", data[pos + 4 : pos + 8])
        if kind == b"EXIF":
            return data[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)
    return None


def _still(data: bytes, name: str) -> np.ndarray | None:
    """A still image as WebPDecodeBGR reads the whole file
    (ParseHeadersInternal with all the data, then the first VP8 / VP8L
    chunk, the last ALPH chunk before it decoded too); None for an
    animation.  Chunks after the image, reserved flags and a VP8X file's
    later images are not looked at."""
    def fail(why: str):
        raise ValueError(f"{name}: WebP that libwebp does not decode ({why})")

    le32 = lambda at: struct.unpack_from("<I", data, at)[0]  # noqa: E731
    n, pos, riff_size = len(data), 12, le32(4)
    if riff_size < 12 or riff_size > _MAX_PAYLOAD or riff_size > n - 8:
        fail(f"RIFF size {riff_size} of a file of {n} bytes")
    vp8x, alpha = None, None
    if data[12:16] == b"VP8X":
        if n < 30 or le32(16) != 10:
            fail("a VP8X chunk not of 10 bytes")
        if le32(20) & webp.ANIMATION_FLAG:
            return None
        vp8x = (1 + int.from_bytes(data[24:27], "little"), 1 + int.from_bytes(data[27:30], "little"))
        if vp8x[0] * vp8x[1] >= 1 << 32:
            fail("a canvas of 2^32 pixels or more")
        pos, total = 30, 22
        while True:
            if n - pos < 8:
                fail("no image chunk")
            if data[pos : pos + 4] in (b"VP8 ", b"VP8L"):
                break
            size = le32(pos + 4)
            disk = (8 + size + 1) & ~1
            total += disk
            if size > _MAX_PAYLOAD or total > riff_size or n - pos < disk:
                fail("a chunk past the RIFF data")
            if data[pos : pos + 4] == b"ALPH":
                alpha = (pos + 8, size)
            pos += disk
    if n - pos < 8 or data[pos : pos + 4] not in (b"VP8 ", b"VP8L"):
        fail("no image chunk")
    kind, size = data[pos : pos + 4], le32(pos + 4)
    if size > riff_size - 12 or size > n - pos - 8:
        fail(f"an image chunk of {size} bytes past the data")
    body = memoryview(data)[pos + 8 :]
    try:
        w, h, _ = webp._image_header(kind, bytes(body[:10]), size)
    except webp._Refused as e:
        fail(str(e))
    if vp8x is not None and (w, h) != vp8x:
        fail(f"an image of {w}x{h} on a canvas of {vp8x[0]}x{vp8x[1]}")
    codec.check_cv_size(w, h, name)
    out = np.zeros((h, w, 4), np.uint8)
    try:
        if kind == b"VP8L":
            codec.vp8l_decode(body, w, h, out)
        else:
            codec.vp8_decode(body, w, h, out)
            if alpha is not None:
                codec.webp_alpha(data[alpha[0] : alpha[0] + alpha[1]], w, h)
    except ValueError as e:
        fail(str(e))
    return out[..., :3]


def read(data: bytes, name: str) -> tuple:
    """The first frame as (H, W, 3) uint8 RGB, and its EXIF bytes."""
    img = _still(data, name)
    if img is None:  # an animation: OpenCV checks its canvas first (validateInputImageSize)
        codec.check_cv_size(1 + int.from_bytes(data[24:27], "little"), 1 + int.from_bytes(data[27:30], "little"), name)
        img, _ = webp.read_pil(data, name)
    return np.ascontiguousarray(img[..., :3]), _exif(data)
