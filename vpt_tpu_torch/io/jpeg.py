"""JPEG decoding (ITU-T T.81) to the samples PIL gives.

The markers are parsed here; each scan's entropy-coded data goes to the C
codec (io/codec.py), which fills the quantised coefficients of every
component and then dequantises and inverse-transforms them with the
fixed-point "islow" IDCT.  Upsampling and colour conversion follow
libjpeg-turbo's default decompression (the library behind PIL), in integer
numpy arithmetic, so the samples equal PIL's:

- a component at half the frame's width (h2v1), half its height (h1v2) or
  both (h2v2) is upsampled with the triangle ("fancy") filters: 3/4 of the
  nearer sample and 1/4 of the farther one in each halved dimension, the
  results rounded with biases 1 and 2 (of 4) in one dimension, and 8 and 7
  (of 16) in two; the sample beyond each edge of the component's own size
  repeats the edge sample.  An h2v1 or h2v2 component 1 or 2 samples wide,
  and a component at any other integral ratio (4:1:1, 4:1:0, mixed factors),
  is replicated instead; a ratio that is no integer raises, as in libjpeg;
- YCbCr becomes RGB with 16-bit fixed-point factors 1.402, 0.34414,
  0.71414 and 1.772, rounded half up, then clamped to 0..255;
- four components are CMYK, or YCCK under an Adobe APP14 marker whose
  transform is not 0 (libjpeg's guess): YCCK's first three become C, M, Y as
  255 - the RGB of its YCbCr, K passes through; PIL reads the result as
  Adobe's inverted CMYK ("CMYK;I"), so the array holds 255 - each sample;
- a progressive file whose first 9 AC coefficients are not all complete is
  block-smoothed as libjpeg-turbo smooths it (codec.jpeg_smooth, the C
  `vpt_jpeg_smooth`: each still-zero one of those coefficients estimated
  from the 5x5 neighbourhood of DC values).

Read: baseline and extended sequential Huffman frames (SOF0, SOF1) and
progressive Huffman frames (SOF2) of 8-bit samples; 1 component (gray), 3
(YCbCr, or RGB by an Adobe APP14 transform 0 or component ids 'R', 'G', 'B',
as libjpeg decides) or 4 (CMYK, YCCK); any sampling factors 1-4 whose
ratios to the largest are integers, with at most 10 blocks in an MCU; 8-
and 16-bit quantisation tables; restart intervals; any image size.
Arithmetic coding, 12-bit samples, lossless and hierarchical frames, 2
components and sampling ratios that are no integers raise a ValueError that
names the format and the image, as does a truncated file (PIL raises on one
too).
"""

from __future__ import annotations

import numpy as np

from vpt_tpu_torch.io import codec

# Zigzag position -> natural (row-major) position within an 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {
    0xC3: "lossless", 0xC5: "hierarchical (differential sequential)", 0xC6: "hierarchical (differential progressive)",
    0xC7: "hierarchical (differential lossless)", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical",
    0xCF: "arithmetic-coded hierarchical",
}

# jdcolor.c's YCbCr -> RGB tables: 16 fraction bits, the products rounded
# half up (the green terms are summed first and carry the rounding half).
_X = np.arange(256, dtype=np.int64) - 128
_ONE_HALF = 1 << 15
_CR_R = (91881 * _X + _ONE_HALF) >> 16  # FIX(1.40200)
_CB_B = (116130 * _X + _ONE_HALF) >> 16  # FIX(1.77200)
_CR_G = -46802 * _X  # FIX(0.71414)
_CB_G = -22554 * _X + _ONE_HALF  # FIX(0.34414)


class _Component:
    """A frame component: its sampling factors and, once _frame sizes it,
    its samples (dw x dh), its blocks in a scan of it alone (nbx x nby)
    and in interleaved MCUs (bw x bh)."""

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.dw = self.dh = self.nbx = self.nby = self.bw = self.bh = 0
        self.qt = None  # latched at the component's first scan, as libjpeg does
        self.coefs = None
        self.bits = np.full(10, -1)  # successive-approximation state of coefficients 0..9 (progressive)


def _segment(data: bytes, pos: int, name: str) -> bytes:
    if pos + 4 > len(data):
        raise ValueError(f"{name}: JPEG file is truncated")
    length = (data[pos + 2] << 8) | data[pos + 3]
    if length < 2 or pos + 2 + length > len(data):
        raise ValueError(f"{name}: JPEG file is truncated")
    return data[pos + 4 : pos + 2 + length]


def _dqt(seg: bytes, tables: dict, name: str) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        n = 64 * (2 if pq else 1)
        if pq > 1 or tq > 3 or i + 1 + n > len(seg):
            raise ValueError(f"{name}: JPEG has a bad quantisation table")
        vals = np.frombuffer(seg[i + 1 : i + 1 + n], ">u2" if pq else np.uint8).astype(np.int32)
        qt = np.zeros(64, np.int32)
        qt[ZIGZAG] = vals
        tables[tq] = qt
        i += 1 + n


def _dht(seg: bytes, tables: dict, name: str) -> None:
    i = 0
    while i < len(seg):
        tc, th = seg[i] >> 4, seg[i] & 15
        if tc > 1 or th > 3 or i + 17 > len(seg):
            raise ValueError(f"{name}: JPEG has a bad Huffman table")
        counts = np.frombuffer(seg[i + 1 : i + 17], np.uint8).astype(np.int32)
        n = int(counts.sum())
        if n > 256 or i + 17 + n > len(seg):
            raise ValueError(f"{name}: JPEG has a bad Huffman table")
        table = np.zeros(codec.HUFF_WORDS, np.int32)
        table[:16] = counts
        table[16 : 16 + n] = np.frombuffer(seg[i + 17 : i + 17 + n], np.uint8)
        tables[(tc, th)] = table
        i += 17 + n


def _fancy(p: np.ndarray, axis: int) -> tuple:
    """The two triangle-filter taps of each sample along `axis` (the edge
    samples repeated): (3 p + previous, 3 p + next)."""
    first = np.take(p, [0], axis=axis)
    last = np.take(p, [-1], axis=axis)
    n = p.shape[axis]
    prev = np.concatenate([first, np.take(p, np.arange(n - 1), axis=axis)], axis=axis)
    nxt = np.concatenate([np.take(p, np.arange(1, n), axis=axis), last], axis=axis)
    return 3 * p + prev, 3 * p + nxt


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(a.shape[:axis] + (2 * a.shape[axis],) + a.shape[axis + 1 :])


def _upsample(plane: np.ndarray, fx: int, fy: int, w: int) -> np.ndarray:
    """A component's (dh, dw) samples at fx times its width and fy times its
    height, by the method libjpeg-turbo's jdsample.c picks with fancy
    upsampling on: the h2v1 / h2v2 triangle filters (replication for a
    component 1 or 2 samples wide), the h1v2 triangle filter, or
    replication for any other integral ratio."""
    if fx == fy == 1:
        return plane
    p = plane.astype(np.int32)
    if (fx, fy) == (1, 2):
        up, down = _fancy(p, 0)
        return _interleave((up + 1) >> 2, (down + 2) >> 2, 0)
    if (fx, fy) not in ((2, 1), (2, 2)) or w <= 2:
        return np.repeat(np.repeat(p, fx, axis=1), fy, axis=0)
    if fy == 2:  # vertical taps first, kept at 4x
        up, down = _fancy(p, 0)
        rows = _interleave(up, down, 0)
        shift, bias = 4, (8, 7)
    else:
        rows = p
        shift, bias = 2, (1, 2)
    left, right = _fancy(rows, 1)
    return _interleave((left + bias[0]) >> shift, (right + bias[1]) >> shift, 1)


def decode_jpeg(data: bytes, name: str = "image") -> np.ndarray:
    """A JPEG file's bytes as PIL decodes them: (H, W) uint8 for a gray
    image, (H, W, 3) uint8 RGB, or (H, W, 4) uint8 for a CMYK or YCCK one
    (PIL's "CMYK" array: 255 - the CMYK samples)."""
    buf = np.frombuffer(data, np.uint8)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name} is not a JPEG file")
    qtables, htables, comps, frame = {}, {}, [], None
    restart, jfif, adobe, progressive, eoi = 0, False, None, False, False
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: JPEG is corrupt (no marker at byte {pos})")
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:  # fill bytes
            pos += 1
        if pos + 1 >= len(data):
            break
        marker = data[pos + 1]
        if marker == 0xD9:
            eoi = True
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:  # stray RSTn, TEM: no segment
            pos += 2
            continue
        seg = _segment(data, pos, name)
        nxt = pos + 4 + len(seg)
        if 0xE0 <= marker <= 0xEF or marker == 0xFE:  # APPn, COM
            if marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
                jfif = True
            elif marker == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
                adobe = seg[11]
        elif marker == 0xDB:
            _dqt(seg, qtables, name)
        elif marker == 0xC4:
            _dht(seg, htables, name)
        elif marker == 0xDD:
            if len(seg) < 2:
                raise ValueError(f"{name}: JPEG has a bad restart interval")
            restart = (seg[0] << 8) | seg[1]
        elif marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError(f"{name}: JPEG has two frames")
            frame = _frame(seg, name)
            comps = frame["comps"]
            progressive = marker == 0xC2
        elif marker in _SOF_NAMES or marker == 0xCC:
            kind = _SOF_NAMES.get(marker, "arithmetic-coded")
            raise ValueError(f"{name}: {kind} JPEG images are not read (only Huffman-coded baseline, extended and "
                             f"progressive ones)")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            nxt = _scan(seg, buf, nxt, frame, qtables, htables, progressive, restart, name)
        elif marker == 0xDC:
            raise ValueError(f"{name}: JPEG images with a DNL marker are not read")
        else:
            raise ValueError(f"{name}: JPEG has an unknown marker 0x{marker:02X}")
        pos = nxt
    if frame is None:
        raise ValueError(f"{name}: JPEG file is truncated (no frame header)")
    if not eoi or any(c.coefs is None for c in comps):
        raise ValueError(f"{name}: JPEG file is truncated")
    smooth = progressive and _smoothing_ok(comps)
    planes = []
    for c in comps:
        coefs = c.coefs
        if smooth:
            coefs = codec.jpeg_smooth(coefs, c.nbx, c.nby, c.v, frame["mcuy"], c.qt, c.bits)
        plane = codec.jpeg_idct(coefs, c.qt)[: c.dh, : c.dw]
        planes.append(_upsample(plane, frame["hmax"] // c.h, frame["vmax"] // c.v, c.dw)[: frame["y"], : frame["x"]])
    if len(comps) == 1:
        return planes[0].astype(np.uint8)
    if len(comps) == 4:
        if adobe is None or adobe == 0:  # CMYK as it is stored
            cmyk = np.stack(planes, axis=-1)
        else:  # YCCK: C, M, Y = 255 - the RGB of the YCbCr; K as it is
            y = planes[0].astype(np.int64)
            cb, cr = planes[1], planes[2]
            rgb = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], axis=-1)
            cmyk = np.concatenate([np.clip(255 - rgb, 0, 255), planes[3][..., None]], axis=-1)
        return (255 - cmyk).astype(np.uint8)  # PIL's "CMYK;I": Adobe's inverted samples
    if jfif:  # libjpeg's guess of the colour space of 3 components
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = [c.id for c in comps] == [82, 71, 66]  # 'R', 'G', 'B'
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    y = planes[0].astype(np.int64)
    cb, cr = planes[1], planes[2]
    out = np.stack([y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16), y + _CB_B[cb]], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _frame(seg: bytes, name: str) -> dict:
    if len(seg) < 6:
        raise ValueError(f"{name}: JPEG frame header is truncated")
    precision, y, x, n = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG images are not read, only 8-bit")
    if n not in (1, 3, 4):
        raise ValueError(f"{name}: JPEG images with {n} components are not read (only 1, 3 or 4)")
    if y == 0 or x == 0:
        raise ValueError(f"{name}: JPEG images with a height from a DNL marker, or of zero size, are not read")
    if len(seg) < 6 + 3 * n:
        raise ValueError(f"{name}: JPEG frame header is truncated")
    comps = []
    for i in range(n):
        cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
            raise ValueError(f"{name}: JPEG has bad sampling factors or table index")
        comps.append(_Component(cid, h, v, tq))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    if n > 1 and any(hmax % c.h or vmax % c.v for c in comps):
        factors = ", ".join(f"{c.h}x{c.v}" for c in comps)
        raise ValueError(f"{name}: JPEG sampling factors {factors} are not read (ratios that are no integers; "
                         f"libjpeg refuses them too)")
    if n == 1:  # one component: its own size, whatever its factors say
        comps[0].h = comps[0].v = hmax = vmax = 1
    mcux, mcuy = -(-x // (8 * hmax)), -(-y // (8 * vmax))
    for c in comps:
        c.dw, c.dh = -(-x * c.h // hmax), -(-y * c.v // vmax)  # the component's samples
        c.nbx, c.nby = -(-c.dw // 8), -(-c.dh // 8)  # its blocks in a scan of it alone
        c.bw, c.bh = mcux * c.h, mcuy * c.v  # its blocks in interleaved MCUs
    return {"x": x, "y": y, "comps": comps, "hmax": hmax, "vmax": vmax, "mcux": mcux, "mcuy": mcuy}


def _scan(seg: bytes, buf: np.ndarray, start: int, frame: dict, qtables: dict, htables: dict, progressive: bool,
          restart: int, name: str) -> int:
    """Decode the scan whose header is `seg` and whose data begins at
    buf[start]; returns the position of the marker after it."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) < 4 + 2 * ns:
        raise ValueError(f"{name}: JPEG scan header is bad")
    by_id = {c.id: c for c in frame["comps"]}
    members, dc, ac = [], [], []
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1)) or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"{name}: progressive JPEG has a bad scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise ValueError(f"{name}: JPEG scan names component {cid}, which the frame lacks")
        c = by_id[cid]
        members.append(c)
        for tables, key, out, needed in ((htables, (0, t >> 4), dc, ss == 0 and ah == 0 or not progressive),
                                         (htables, (1, t & 15), ac, ss > 0 or not progressive)):
            if needed and key not in tables:
                raise ValueError(f"{name}: JPEG scan uses a Huffman table it never defines")
            out.append(tables.get(key, np.zeros(codec.HUFF_WORDS, np.int32)))
        if c.qt is None:
            if c.tq not in qtables:
                raise ValueError(f"{name}: JPEG component {cid} uses a quantisation table it never defines")
            c.qt = qtables[c.tq].copy()
            c.coefs = np.zeros((c.bh, c.bw, 64), np.int16)
        if progressive:
            lo, hi = ss, min(se, 9)
            if lo <= hi:
                c.bits[lo : hi + 1] = al
    if ns > 1 and sum(c.h * c.v for c in members) > 10:
        raise ValueError(f"{name}: JPEG scan has more than 10 blocks in an MCU (libjpeg refuses it too)")
    geom = np.array([[c.h, c.v, c.bw, c.nbx, c.nby] for c in members], np.int32)
    try:
        end = codec.jpeg_scan(buf[start:], [c.coefs for c in members], geom, np.stack(dc), np.stack(ac),
                              frame["mcux"], frame["mcuy"], ss, se, ah, al, progressive, restart)
    except ValueError as e:
        raise ValueError(f"{name}: JPEG file is {e}") from None
    return start + end


def _smoothing_ok(comps) -> bool:
    """libjpeg-turbo's smoothing_ok: every component's DC known and the
    quantisers of coefficients 0..9 nonzero, and some component's first 9 AC
    coefficients not all complete."""
    natural = ZIGZAG[:10]
    return all(c.bits[0] >= 0 and (c.qt[natural] != 0).all() for c in comps) and any((c.bits[1:] != 0).any()
                                                                                      for c in comps)
