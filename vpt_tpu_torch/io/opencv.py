"""imageio 2.37's `opencv` plugin over OpenCV 5.0's imgcodecs, as the JAX
package's `load_hdr` reaches it: `cv2.imreadmulti(path, 0, 1,
IMREAD_COLOR)`, then BGR -> RGB.

OpenCV's `findDecoder` reads the file's first bytes and asks each
registered decoder's `checkSignature` in registration order (`DECODERS`);
imageio hands OpenCV the file only where one claims it (`claims`).  The
decoder's header and page 0 are then read as an 8-bit, 3-channel image
(gray repeated, alpha dropped, each decoder's own conversion), the EXIF
orientation the decoder found is applied (`exif.apply_orientation`), and a
file OpenCV reads nothing from raises imageio's ValueError.  An image
larger than `validateInputImageSize` allows raises too.

AVIF (an AV1 decoder, ROADMAP "Not ported, by decision") is refused by
name.  OpenCV here is built without OpenEXR, so no decoder claims an EXR
file, in either package.
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import (cv_bmp, cv_gif, cv_hdr, cv_jp2, cv_jpeg, cv_pam, cv_png, cv_sunras, cv_tiff, cv_webp,
                              exif, netpbm)

SIGNATURE_BYTES = 500  # the longest signature a decoder asks for (AVIF's)


def _avif(sig: bytes) -> bool:
    """AvifDecoder::checkSignature, libavif's avifDecoderParse of the
    signature bytes succeeding or running out of data: an ISO BMFF `ftyp`
    box naming an AVIF brand (or cut by the end of the bytes), then whole box headers up to the end of the
    bytes (a box cut by their end is the data running out; the contents of
    boxes that fit are not checked)."""
    if len(sig) < 16 or sig[4:8] != b"ftyp":
        return False
    size = int.from_bytes(sig[:4], "big")
    if size > len(sig):  # the ftyp box itself cut: libavif runs out of data before it reads a brand
        return True
    if size < 16:
        return False
    brands = [sig[8:12]] + [sig[i : i + 4] for i in range(16, size - 3, 4)]
    if not any(b in (b"avif", b"avis") for b in brands):
        return False
    pos = size
    while pos < len(sig):
        if len(sig) - pos < 8:
            return False
        size, hlen = int.from_bytes(sig[pos : pos + 4], "big"), 8
        if size == 1:
            if len(sig) - pos < 16:
                return False
            size, hlen = int.from_bytes(sig[pos + 8 : pos + 16], "big"), 16
        if size < hlen:
            return False
        pos += size
    return True


def _refuse_avif(data: bytes, name: str):
    raise ValueError(f"{name}: imageio reads this file's AVIF data through OpenCV's AVIF decoder (libavif, an AV1 "
                     f"decoder), which the port does not read (ROADMAP \"Not ported, by decision\")")


def _pxm(data: bytes, name: str) -> tuple:
    return netpbm.read_cv2(data, name), None


# (name, checkSignature, reader) in the order OpenCV 5.0's
# ImageCodecInitializer registers the decoders of this build.  A reader
# returns (RGB image, EXIF bytes or None).
DECODERS = (
    ("AVIF", _avif, _refuse_avif),
    ("BMP", cv_bmp.claims, cv_bmp.read),
    ("GIF", cv_gif.claims, cv_gif.read),
    ("Radiance HDR", cv_hdr.claims, cv_hdr.read),
    ("JPEG", cv_jpeg.claims, cv_jpeg.read),
    ("WebP", cv_webp.claims, cv_webp.read),
    ("Sun raster", cv_sunras.claims, cv_sunras.read),
    ("PxM", lambda sig: netpbm.cv2_claims(sig) and sig[1] in b"123456", _pxm),
    ("PAM", cv_pam.claims, cv_pam.read),
    ("PFM", lambda sig: netpbm.cv2_claims(sig) and sig[1] in b"fF", _pxm),
    ("TIFF", cv_tiff.claims, cv_tiff.read),
    ("PNG", cv_png.claims, cv_png.read),
    ("JPEG 2000", cv_jp2.claims_jp2, cv_jp2.read),
    ("JPEG 2000 codestream", cv_jp2.claims_j2k, cv_jp2.read),
)


def decoder(data: bytes) -> str | None:
    """findDecoder: the name of the first decoder that claims the file."""
    sig = data[:SIGNATURE_BYTES]
    return next((name for name, claim, _ in DECODERS if claim(sig)), None)


def read(data: bytes, name: str = "image") -> np.ndarray:
    """imageio's OpenCV read of the file: (H, W, 3) uint8 RGB (a gray PFM
    (H, W)); a ValueError where OpenCV reads no image."""
    sig = data[:SIGNATURE_BYTES]
    for _, claim, reader in DECODERS:
        if claim(sig):
            img, tags = reader(data, name)
            return exif.apply_orientation(img, exif.orientation(tags)) if tags is not None else img
    raise ValueError(f"{name}: no decoder of OpenCV's claims the file")
