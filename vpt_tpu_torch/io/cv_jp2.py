"""JPEG 2000 files as OpenCV 5.0's Jpeg2KOpjDecoder
(grfmt_jpeg2000_openjpeg.cpp, over OpenJPEG 2.5) reads them with
`IMREAD_COLOR`.

The codestream is the port's decoder's (csrc/j2kdec.c, OpenJPEG's decode),
its components read whole (`codec.J2kCodestream.decode`, kind 9), and a JP2
file's boxes OpenJPEG's reader's (io/jpeg2000._Jp2).  Then, as
opj_jp2_decode does, a palette (pclr with cmap) maps its index component to
the palette's columns, and a channel definition (cdef) swaps colour
channels into their places.  OpenCV refuses more than 4 components, a
signed one, a largest precision under 8, and components that are
subsampled or offset.  Each sample is shifted right by the largest
header precision less 8 and kept to its low 8 bits (no saturation); then,
by the colour space: sRGB, or none given (a raw codestream, an ICC
profile), needs 3 components or more and takes the first three; gray
repeats the first; sYCC goes through OpenCV's YUV -> BGR conversion; CMYK
and e-YCC fail.
"""

from __future__ import annotations

import struct

import numpy as np

from vpt_tpu_torch.io import codec, jpeg2000

_YUV = (18678, -9519, -6472, 33292)  # OpenCV's YUV -> RGB coefficients, 14 fraction bits (V->R, V->G, U->G, U->B)


def claims_jp2(sig: bytes) -> bool:
    return sig[:12] == jpeg2000.JP2_SIGNATURE


def claims_j2k(sig: bytes) -> bool:
    return sig[:4] == jpeg2000.CODESTREAM


def _pclr(comps: list, jp2) -> list:
    """opj_jp2_apply_pclr: the index component through the palette."""
    body, cmap = jp2.bodies[b"pclr"], jp2.bodies[b"cmap"]
    entries, channels = struct.unpack_from(">HB", body)
    sizes = [((b & 0x7F) + 1 + 7) >> 3 for b in body[3 : 3 + channels]]
    table = np.zeros((entries, channels), np.int64)
    pos = 3 + channels
    for e in range(entries):
        for c in range(channels):
            n = min(sizes[c], 4)
            table[e, c] = int.from_bytes(body[pos : pos + n], "big")
            pos += n
    out = []
    for i in range(channels):
        cmp, mtyp, pcol = struct.unpack_from(">HBB", cmap, 4 * i)
        if cmp >= len(comps) or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol >= channels):
            raise ValueError("a cmap entry OpenJPEG refuses")
        src = comps[cmp]
        out.append(src if mtyp == 0 else table[np.clip(src, 0, entries - 1), pcol])
    return out


def _cdef(comps: list, jp2) -> list:
    """opj_jp2_apply_cdef: each colour channel swapped to its association."""
    body = jp2.bodies[b"cdef"]
    (n,) = struct.unpack_from(">H", body)
    info = [list(struct.unpack_from(">HHH", body, 2 + 6 * i)) for i in range(n)]
    comps = list(comps)
    for i in range(n):
        cn, typ, asoc = info[i]
        if cn >= len(comps) or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= len(comps):
            continue
        if cn != acn and typ == 0:
            comps[cn], comps[acn] = comps[acn], comps[cn]
            for j in range(i + 1, n):
                if info[j][0] == cn:
                    info[j][0] = acn
                elif info[j][0] == acn:
                    info[j][0] = cn
    return comps


def read(data: bytes, name: str) -> tuple:
    """The image as (H, W, 3) uint8 RGB, and no EXIF."""
    try:
        return _read(data, name), None
    except ValueError as e:
        raise ValueError(f"{name}: JPEG 2000 that OpenCV does not read ({e})") from None


def _read(data: bytes, name: str) -> np.ndarray:
    jp2, start = None, 0
    if claims_jp2(data):
        jp2 = jpeg2000._Jp2()
        start = jp2.read_boxes(data, 0)
        if "header" not in jp2.state or jp2.ihdr is None:
            raise ValueError("no JP2 header")
    cs = codec.J2kCodestream(memoryview(data)[start:], (jp2.ihdr[1], jp2.ihdr[0]) if jp2 else (0, 0))
    try:
        x0, y0, x1, y1, nc = cs.image
        if not 1 <= nc <= 4:
            raise ValueError(f"{nc} components")
        prec = cs.comps[:, 0]
        if cs.comps[:, 1].any():
            raise ValueError("a signed component")
        maxprec = int(prec.max())
        if maxprec < 8 or maxprec > 64:
            raise ValueError(f"precision {maxprec}")
        w, h = x1 - x0, y1 - y0
        codec.check_cv_size(w, h, name)
        raw = np.zeros((h, w, nc), np.uint32)
        cs.decode(9, raw, w, h, jpeg2000._ycc_tables())
        if x0 or y0 or (cs.comps[:, 2:] != 1).any():
            raise ValueError("components offset or subsampled ('tiles are not supported')")
    finally:
        cs.close()
    comps = [raw[..., c].astype(np.int64) for c in range(nc)]
    space = 0
    if jp2 is not None:
        if jp2.pclr_channels is not None and b"cmap" in jp2.bodies:
            comps = _pclr(comps, jp2)
        if b"cdef" in jp2.bodies:
            comps = _cdef(comps, jp2)
        space = jp2.enumcs if jp2.meth == 1 else 0
    shift = maxprec - 8
    px = [((c >> shift) & 0xFF) for c in comps]
    if space in (16, 0) or space not in (17, 18, 24, 12):
        if len(px) < 3:
            raise ValueError(f"{len(px)} components for sRGB")
        return np.stack(px[:3], -1).astype(np.uint8)
    if space == 17:
        return np.repeat(px[0][..., None], 3, -1).astype(np.uint8)
    if space == 18:
        if len(px) < 3:
            raise ValueError(f"{len(px)} components for YUV")
        y, u, v = px[0], px[1] - 128, px[2] - 128
        d = lambda x: (x + (1 << 13)) >> 14  # noqa: E731  (CV_DESCALE)
        rgb = np.stack([y + d(v * _YUV[0]), y + d(v * _YUV[1] + u * _YUV[2]), y + d(u * _YUV[3])], -1)
        return np.clip(rgb, 0, 255).astype(np.uint8)
    raise ValueError({12: "CMYK", 24: "e-YCC"}[space] + " -> BGR")
