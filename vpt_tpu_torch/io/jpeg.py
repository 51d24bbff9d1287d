"""JPEG decoding (ITU-T T.81) to the samples PIL gives.

The markers are parsed here; each scan's entropy-coded data goes to the C
codec (io/codec.py), which fills the quantised coefficients of every
component (or, for a lossless frame, its samples) and then dequantises
and inverse-transforms them with the fixed-point "islow" IDCT as
libjpeg-turbo's SIMD code computes it.  Upsampling and colour conversion follow
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

Read: baseline and extended sequential Huffman frames (SOF0, SOF1),
progressive Huffman frames (SOF2), sequential and progressive arithmetic-coded
frames (SOF9, SOF10, with the DAC conditioning) and lossless Huffman frames
(SOF3: predictors 1-7, point transforms 0-7), all of 8-bit samples; 1
component (gray), 3 (YCbCr, or RGB by an Adobe APP14 transform 0 or
component ids 'R', 'G', 'B', as libjpeg decides) or 4 (CMYK, YCCK); any
sampling factors 1-4 whose ratios to the largest are integers, with at most
10 blocks in an MCU; 8- and 16-bit quantisation tables; restart intervals;
any image size; a sequential Huffman file without DHT segments (a
Motion-JPEG frame) with T.81's standard tables, as libjpeg-turbo reads it.
A lossless frame's samples are upsampled by replication, as libjpeg-turbo
upsamples them (its triangle filters need 8x8 blocks).  Where libjpeg
decodes corrupt data on through warnings (a marker inside the data, a bit
string that is no Huffman code, a code an arithmetic coder cannot have,
restart markers out of place, bytes between segments, a single-scan file
cut after its scan), the port decodes as it does.  An arithmetic-coded scan
that runs past a 65536-byte block of the file raises, as PIL raises on it
(see `_arith_limit`).  Arithmetic-coded lossless (SOF11), hierarchical
(SOF5-7, SOF13-15) frames, lossless ones in YCbCr or YCCK, 12-bit samples,
2 components and sampling ratios that are no integers raise a ValueError
that names the format and the image, as does a truncated file (PIL raises
on one too).
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

# The frames read: their entropy coding and whether they are progressive.
_FRAMES = {0xC0: ("huffman", False), 0xC1: ("huffman", False), 0xC2: ("huffman", True), 0xC3: ("lossless", False),
           0xC9: ("arithmetic", False), 0xCA: ("arithmetic", True)}
# The frames refused, as libjpeg-turbo refuses them.
_SOF_NAMES = {
    0xC5: "hierarchical (differential sequential)", 0xC6: "hierarchical (differential progressive)",
    0xC7: "hierarchical (differential lossless)", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical",
}
# T.81 K.3's Huffman tables (class, slot) -> (counts of codes of length
# 1..16, symbols), which libjpeg-turbo's sequential Huffman decoder puts in
# the slots a file leaves undefined by its first scan (Motion-JPEG frames
# carry no DHT); its progressive and lossless decoders do not.
_STD_HUFFMAN = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a2526272829"
             "2a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a92"
             "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5"
             "e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a2627"
             "28292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a8283848586878889"
             "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4"
             "e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}
# The DAC conditioning of the 16 arithmetic statistics tables before any DAC
# marker: L 0 and U 1 for DC, K 5 for AC (T.81 F.1.4.4).
_DEFAULT_CONDITIONING = np.array([0] * 16 + [1] * 16 + [5] * 16, np.int32)

# jdcolor.c's YCbCr -> RGB tables: 16 fraction bits, the products rounded
# half up (the green terms are summed first and carry the rounding half).
_X = np.arange(256, dtype=np.int32) - 128
_ONE_HALF = 1 << 15
_CR_R = (91881 * _X + _ONE_HALF) >> 16  # FIX(1.40200)
_CB_B = (116130 * _X + _ONE_HALF) >> 16  # FIX(1.77200)
_CR_G = -46802 * _X  # FIX(0.71414)
_CB_G = -22554 * _X + _ONE_HALF  # FIX(0.34414)
_LIMIT = np.clip(np.arange(-384, 640), 0, 255).astype(np.uint8)  # jdcolor.c's range limit, offset by 384


def _ycc_rgb(planes: list) -> np.ndarray:
    """(H, W, 3) uint8 RGB of Y, Cb, Cr sample planes, as jdcolor.c
    converts them (each sum clamped to 0..255)."""
    y = planes[0].astype(np.int32) + 384
    cb, cr = planes[1], planes[2]
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _LIMIT[y + _CR_R[cr]]
    out[..., 1] = _LIMIT[y + ((_CB_G[cb] + _CR_G[cr]) >> 16)]
    out[..., 2] = _LIMIT[y + _CB_B[cb]]
    return out


class _Component:
    """A frame component: its sampling factors and, once _frame sizes it,
    its samples (dw x dh), its blocks in a scan of it alone (nbx x nby)
    and in interleaved MCUs (bw x bh)."""

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.v0 = v  # as the frame declares it (a lossless scan of it alone walks rows of v0 samples)
        self.dw = self.dh = self.nbx = self.nby = self.bw = self.bh = 0
        self.qt = None  # latched at the component's first scan, as libjpeg does
        self.coefs = None
        self.samples = None  # a lossless frame's (dh, dw) uint8 samples
        self.bits = np.full(10, -1)  # successive-approximation state of coefficients 0..9 (progressive)
        self.prev_bits = np.full(10, -1)  # the same before the component's last scan (jdphuff's prev_coef_bits)


def _next_marker(data: bytes, pos: int) -> int:
    """The offset of the last FF before the next marker code at or after
    `pos` (FF 00 is data, FFs pad), or len(data) if none follows."""
    while True:
        i = data.find(b"\xff", pos)
        if i < 0:
            return len(data)
        j = i + 1
        while j < len(data) and data[j] == 0xFF:
            j += 1
        if j >= len(data):
            return len(data)
        if data[j]:
            return j - 1
        pos = j + 1


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
        n = 64 * (2 if pq else 1)  # any precision but 0 is 16-bit, as libjpeg and PIL read it
        if tq > 3 or i + 1 + n > len(seg):
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


def _dac(seg: bytes, conditioning: np.ndarray, name: str) -> None:
    """T.81 B.2.4.3: set the conditioning of the tables a DAC segment names,
    refusing what libjpeg refuses (a table index past 31, L above U, an odd
    length)."""
    if len(seg) % 2:
        raise ValueError(f"{name}: JPEG has a bad DAC marker (odd length)")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]
        if index >= 32:
            raise ValueError(f"{name}: JPEG DAC names arithmetic table {index} (there are 16 each for DC and AC)")
        if index >= 16:
            conditioning[32 + index - 16] = val
        elif (val & 15) > (val >> 4):
            raise ValueError(f"{name}: JPEG DAC gives DC table {index} L {val & 15} above U {val >> 4}")
        else:
            conditioning[index], conditioning[16 + index] = val & 15, val >> 4


def _check_cut_segment(marker: int, rest: bytes, frame: dict, name: str) -> None:
    """Raise where libjpeg's read_markers, reading a segment that the end of
    the data cuts short (`rest`: the bytes after its marker code), meets an
    error before it runs out of data; return where it runs out first."""
    if marker in _FRAMES or marker in _SOF_NAMES or marker in (0xC8, 0xD8) or 0x02 <= marker < 0xC0 or \
            marker in (0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
        raise ValueError(f"{name}: JPEG has a marker 0x{marker:02X} after its last scan that libjpeg refuses")
    if len(rest) < 2:
        return
    left, body = ((rest[0] << 8) | rest[1]) - 2, rest[2:]
    if marker == 0xDD and left != 2:
        raise ValueError(f"{name}: JPEG has a bad restart interval")
    if marker == 0xC4:  # get_dht
        i = 0
        while left > 16 and i + 17 <= len(body):
            count = sum(body[i + 1 : i + 17])
            left -= 17
            if count > 256 or count > left:
                raise ValueError(f"{name}: JPEG has a bad Huffman table")
            if i + 17 + count > len(body):
                return
            if (body[i] & ~0x10) >= 4:
                raise ValueError(f"{name}: JPEG has a bad Huffman table")
            left -= count
            i += 17 + count
    elif marker == 0xDB:  # get_dqt
        i = 0
        while left > 0 and i < len(body):
            if body[i] & 15 > 3:
                raise ValueError(f"{name}: JPEG has a bad quantisation table")
            size = 128 if body[i] >> 4 else 64
            left -= 1 + size
            i += 1 + size
    elif marker == 0xCC:  # get_dac
        for i in range(0, min(left, len(body)) - 1, 2):
            if body[i] >= 32 or (body[i] < 16 and (body[i + 1] & 15) > (body[i + 1] >> 4)):
                raise ValueError(f"{name}: JPEG has a bad DAC marker")
    elif marker == 0xDA and body:  # get_sos, then a second scan where libjpeg expects the end
        n, ids = body[0], [c.id for c in frame["comps"]]
        if left != 2 * n + 4 or not 1 <= n <= 4:
            raise ValueError(f"{name}: JPEG scan header is bad")
        for k in range(n):
            if 2 + 2 * k < len(body) and body[1 + 2 * k] not in ids:
                raise ValueError(f"{name}: JPEG scan names component {body[1 + 2 * k]}, which the frame lacks")
        if len(body) >= 2 * n + 4:
            raise ValueError(f"{name}: JPEG has a second scan after a scan of every component")


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


def _upsample(plane: np.ndarray, fx: int, fy: int, w: int, fancy: bool = True) -> np.ndarray:
    """A component's (dh, dw) samples at fx times its width and fy times its
    height, by the method libjpeg-turbo's jdsample.c picks with fancy
    upsampling on: the h2v1 / h2v2 triangle filters (replication for a
    component 1 or 2 samples wide), the h1v2 triangle filter, or
    replication for any other integral ratio.  Without `fancy` (a lossless
    frame, whose blocks are single samples) every ratio is replicated."""
    if fx == fy == 1:
        return plane
    p = plane.astype(np.int32)
    if not fancy:
        return np.repeat(np.repeat(p, fx, axis=1), fy, axis=0)
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


def decode_jpeg(data: bytes, name: str = "image", stdio: bool = False, color: str | None = None) -> np.ndarray:
    """A JPEG file's bytes as PIL decodes them: (H, W) uint8 for a gray
    image, (H, W, 3) uint8 RGB, or (H, W, 4) uint8 for a CMYK or YCCK one
    (PIL's "CMYK" array: 255 - the CMYK samples).

    stdio: as libjpeg reads the file through its stdio source instead, as
    OpenCV reads it: past its end the file reads as EOI markers, FF D9
    repeated (so a cut segment is filled with them, a cut scan ends as at a
    marker, and a cut multi-scan file is output with the scans it has,
    components never scanned 0; a file that ends before its first scan
    fails), an arithmetic-coded scan may run to the end of the file, and a
    single-scan file ends at its scan (OpenCV lets jpeg_finish_decompress
    fail on what follows).

    color: the colour space libjpeg is told the file holds instead of its
    guess: "ycc" (YCbCr, converted to RGB) or "raw" (no conversion), as
    libtiff's JPEG codec sets it."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name} is not a JPEG file")
    if stdio:  # past its end the file reads as EOI markers, as many as a segment may take
        data = data + b"\xff\xd9" * 32769
    buf = np.frombuffer(data, np.uint8)
    qtables, htables, comps, frame = {}, {}, [], None
    conditioning = _DEFAULT_CONDITIONING.copy()
    restart, jfif, adobe, eoi = 0, False, None, False
    pos = 2
    while True:
        pos = _next_marker(data, pos)  # bytes that are no marker are skipped, as libjpeg's next_marker skips them
        if pos >= len(data):
            break
        marker = data[pos + 1]
        if marker == 0xD9:
            eoi = True
            break
        if 0xD0 <= marker <= 0xD7 or (marker == 0x01 and frame is not None and frame["scans"]):
            pos += 2  # stray RSTn, TEM: no segment (PIL's own header parser refuses a TEM before the first scan)
            continue
        if frame is not None and frame["scans"] and not frame["multi"] and (
                pos + 4 > len(data) or pos + 2 + ((data[pos + 2] << 8) | data[pos + 3]) > len(data)):
            # After the one scan of a single-scan file, libjpeg reads on to
            # EOI only in jpeg_finish_decompress, which PIL lets fail by
            # running out of data, though not by an error in what is there.
            _check_cut_segment(marker, data[pos + 2 :], frame, name)
            break
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
        elif marker == 0xCC:
            _dac(seg, conditioning, name)
        elif marker == 0xDD:
            if len(seg) != 2:
                raise ValueError(f"{name}: JPEG has a bad restart interval")
            restart = (seg[0] << 8) | seg[1]
        elif marker in _FRAMES:
            if frame is not None:
                raise ValueError(f"{name}: JPEG has two frames")
            frame = _frame(seg, name)
            frame["coding"], frame["progressive"] = _FRAMES[marker]
            frame["stdio"] = stdio
            comps = frame["comps"]
        elif marker in _SOF_NAMES:
            raise ValueError(f"{name}: {_SOF_NAMES[marker]} JPEG images are not read (only Huffman-coded "
                             f"baseline, extended, progressive and lossless ones and arithmetic-coded sequential "
                             f"and progressive ones; libjpeg refuses them too)")
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            if frame["scans"] and not frame["multi"]:
                raise ValueError(f"{name}: JPEG has a second scan after a scan of every component (libjpeg "
                                 f"expects its end there)")
            nxt = _scan(seg, buf, nxt, frame, qtables, htables, conditioning, restart, name)
            if stdio and not frame["multi"]:
                eoi = True
                break
        elif marker == 0xDC:
            pass  # DNL: libjpeg ignores it (the frame's height is never 0 here)
        else:
            raise ValueError(f"{name}: JPEG has an unknown marker 0x{marker:02X}")
        pos = nxt
    if frame is None:
        raise ValueError(f"{name}: JPEG file is truncated (no frame header)")
    lossless = frame["coding"] == "lossless"
    if stdio and not frame["scans"]:
        raise ValueError(f"{name}: JPEG file has no scan before its end (libjpeg: JERR_NO_IMAGE)")
    for c in comps if stdio else ():
        if lossless and c.samples is None:
            c.samples = np.zeros((c.dh, c.dw), np.uint8)
        elif not lossless and c.coefs is None:
            c.coefs, c.qt = np.zeros((c.bh, c.bw, 64), np.int16), np.zeros(64, np.int32)
    if any((c.samples if lossless else c.coefs) is None for c in comps):
        raise ValueError(f"{name}: JPEG file is truncated")
    if not eoi and frame["multi"]:  # (libjpeg reads a multi-scan file to its end before any output)
        raise ValueError(f"{name}: JPEG file is truncated")
    # libjpeg's guess of the colour space: 3 components are RGB by an Adobe
    # transform 0 or the ids 'R', 'G', 'B' (no JFIF marker), else YCbCr; 4
    # are YCCK by an Adobe transform other than 0, else CMYK.
    if len(comps) == 3:
        convert = jfif or (adobe != 0 if adobe is not None else [c.id for c in comps] != [82, 71, 66])
    else:
        convert = len(comps) == 4 and adobe not in (None, 0)
    if color is not None:
        convert = color == "ycc"
    if lossless and convert:
        raise ValueError(f"{name}: lossless JPEG images in {'YCbCr' if len(comps) == 3 else 'YCCK'} are not read "
                         f"(libjpeg-turbo converts no colour space of a lossless image)")
    smooth = frame["progressive"] and _smoothing_ok(comps)
    planes = []
    for c in comps:
        if lossless:
            plane = c.samples
        else:
            coefs = c.coefs
            if smooth:  # (libjpeg latches the bits from before the last scan only in a file of two scans or more)
                prev = c.prev_bits if frame["scans"] > 1 else np.full(10, -1)
                coefs = codec.jpeg_smooth(coefs, c.nbx, c.nby, c.v, frame["mcuy"], c.qt, c.bits, prev,
                                          frame["last_good"])
            plane = codec.jpeg_idct(coefs, c.qt)[: c.dh, : c.dw]
        planes.append(_upsample(plane, frame["hmax"] // c.h, frame["vmax"] // c.v, c.dw,
                                fancy=not lossless)[: frame["y"], : frame["x"]])
    if len(comps) == 1:
        return planes[0].astype(np.uint8)
    if len(comps) == 4:
        if not convert:  # CMYK as it is stored
            cmyk = np.stack(planes, axis=-1)
        else:  # YCCK: C, M, Y = 255 - the RGB of its YCbCr; K as it is
            cmyk = np.concatenate([255 - _ycc_rgb(planes[:3]), planes[3][..., None].astype(np.uint8)], axis=-1)
        return (255 - cmyk).astype(np.uint8)  # PIL's "CMYK;I": Adobe's inverted samples
    if not convert:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_rgb(planes)


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
    if len(seg) != 6 + 3 * n:
        raise ValueError(f"{name}: JPEG frame header is bad (its length is not that of {n} components)")
    codec.check_size(x, y, name)
    comps = []
    for i in range(n):
        cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
        h, v = hv >> 4, hv & 15
        if not (1 <= h <= 4 and 1 <= v <= 4):
            raise ValueError(f"{name}: JPEG has bad sampling factors")
        comps.append(_Component(cid, h, v, tq))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    vmax0 = vmax
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
    return {"x": x, "y": y, "comps": comps, "hmax": hmax, "vmax": vmax, "mcux": mcux, "mcuy": mcuy, "vmax0": vmax0,
            "scans": 0, "multi": False, "last_good": -1}


def _scan(seg: bytes, buf: np.ndarray, start: int, frame: dict, qtables: dict, htables: dict,
          conditioning: np.ndarray, restart: int, name: str) -> int:
    """Decode the scan whose header is `seg` and whose data begins at
    buf[start]; returns the position of the marker after it (the end of the
    data if none follows)."""
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        raise ValueError(f"{name}: JPEG scan header is bad")
    by_id = {c.id: c for c in frame["comps"]}
    members, tables = [], []
    ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    coding, progressive = frame["coding"], frame["progressive"]
    if coding == "lossless":
        if not 1 <= ss <= 7 or se != 0 or ah != 0 or al > 7:
            raise ValueError(f"{name}: lossless JPEG has a bad scan (predictor {ss}, Se {se}, Ah {ah}, point "
                             f"transform {al})")
    elif not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1)) or (ah and al != ah - 1) or al > 13:
        raise ValueError(f"{name}: progressive JPEG has a bad scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id or by_id[cid] in members:
            raise ValueError(f"{name}: JPEG scan names component {cid}, which the frame lacks")
        members.append(by_id[cid])
        tables.append(t)
    if not frame["scans"]:  # libjpeg decides at the first scan whether the image is held whole until EOI
        frame["multi"] = progressive or ns < len(frame["comps"])
    frame["scans"] += 1
    if ns > 1 and sum(c.h * c.v for c in members) > 10:
        raise ValueError(f"{name}: JPEG scan has more than 10 blocks in an MCU (libjpeg refuses it too)")
    if coding == "lossless":
        return _lossless_scan(members, tables, buf, start, frame, htables, ss, al, restart, name)
    if coding == "huffman" and not progressive and frame["scans"] == 1:
        for key, (counts, symbols) in _STD_HUFFMAN.items():
            if key not in htables:
                table = np.zeros(codec.HUFF_WORDS, np.int32)
                table[:16] = np.frombuffer(bytes.fromhex(counts), np.uint8)
                table[16 : 16 + len(symbols) // 2] = np.frombuffer(bytes.fromhex(symbols), np.uint8)
                htables[key] = table
    dc, ac = [], []
    for c, t in zip(members, tables):
        if coding == "huffman":
            for key, out, needed, top in (((0, t >> 4), dc, ss == 0 and ah == 0 or not progressive, 15),
                                          ((1, t & 15), ac, ss > 0 or not progressive, 255)):
                out.append(_derived_table(htables, key, top, name) if needed else
                           np.zeros(codec.HUFF_WORDS, np.int32))
        if c.qt is None:
            if c.tq not in qtables:
                raise ValueError(f"{name}: JPEG component {c.id} uses a quantisation table it never defines")
            c.qt = qtables[c.tq].copy()
            c.coefs = np.zeros((c.bh, c.bw, 64), np.int16)
        if progressive:  # jdphuff.c / jdarith.c start_pass: the bits before this scan, then its own
            c.prev_bits[min(ss, 1) :] = c.bits[min(ss, 1) :] if frame["scans"] > 1 else 0
            lo, hi = ss, min(se, 9)
            if lo <= hi:
                c.bits[lo : hi + 1] = al
    geom = np.array([[c.h, c.v, c.bw, c.nbx, c.nby] for c in members], np.int32)
    coefs = [c.coefs for c in members]
    try:
        if coding == "arithmetic":
            tbl = np.array([[t >> 4, t & 15] for t in tables], np.int32)
            limit = len(buf) if frame["stdio"] else _arith_limit(start, len(buf))
            end, frame["last_good"] = codec.jpeg_arith_scan(buf[start:], limit - start,
                                                            coefs, geom, tbl, conditioning, frame["mcux"],
                                                            frame["mcuy"], ss, se, ah, al, progressive, restart)
        else:
            end, frame["last_good"] = codec.jpeg_scan(buf[start:], coefs, geom, np.stack(dc), np.stack(ac),
                                                      frame["mcux"], frame["mcuy"], ss, se, ah, al, progressive,
                                                      restart)
    except ValueError as e:
        raise ValueError(f"{name}: JPEG file is {e}") from None
    return start + end


def _arith_limit(start: int, size: int) -> int:
    """The end of the data an arithmetic-coded scan whose data begins at
    `start` may read when PIL decodes the file.  PIL's ImageFile.load hands
    libjpeg the file PIL_BLOCK bytes at a time, and libjpeg reads each next
    block only when its marker reader suspends for want of data; its
    arithmetic decoder cannot suspend, so it fails on a byte past the blocks
    handed over when the scan's header had been read (libjpeg-turbo's
    JERR_CANT_SUSPEND; PIL: "broken data stream")."""
    block = codec.PIL_BLOCK
    return min(size, block * max(1, -(-start // block)))


def _derived_table(htables: dict, key: tuple, max_symbol: int, name: str) -> np.ndarray:
    """The Huffman table a scan selects, held to libjpeg's
    jpeg_make_d_derived_tbl: defined, no code of all 1 bits, and a DC table's
    symbols at most `max_symbol` (15; 16 in a lossless frame)."""
    if key not in htables:
        raise ValueError(f"{name}: JPEG scan uses a Huffman table it never defines")
    table = htables[key]
    counts = table[:16]
    if (table[16 : 16 + int(counts.sum())] > max_symbol).any():
        raise ValueError(f"{name}: JPEG has a DC Huffman table with a symbol above {max_symbol}")
    code, last = 0, max((i + 1 for i in range(16) if counts[i]), default=0)
    for length in range(1, last + 1):
        code += int(counts[length - 1])
        if code >= 1 << length:
            raise ValueError(f"{name}: JPEG file is corrupt (a Huffman table that is no prefix code)")
        code <<= 1
    return table


def _lossless_scan(members: list, tables: list, buf: np.ndarray, start: int, frame: dict, htables: dict, psv: int,
                   pt: int, restart: int, name: str) -> int:
    """Decode a lossless scan into its components' samples (libjpeg-turbo's
    jdlhuff.c / jddiffct.c / jdlossls.c: H.1.2 with the rows of MCUs and
    restarts as libjpeg walks them); returns the position of the marker
    after it."""
    huff = np.stack([_derived_table(htables, (0, t >> 4), 16, name) for t in tables])
    x, y = frame["x"], frame["y"]
    hmax = max(c.h for c in frame["comps"])
    if len(members) == 1:
        c = members[0]
        geom = np.array([[1, c.v0, c.dw, c.dh]], np.int32)
        mcux = c.dw
    else:
        geom = np.array([[c.h, c.v, c.dw, c.dh] for c in members], np.int32)
        mcux = -(-x // hmax)
    if restart % mcux:
        raise ValueError(f"{name}: lossless JPEG has a restart interval of {restart} MCUs, not a whole number of its "
                         f"rows of {mcux} (libjpeg refuses it too)")
    planes = [np.zeros((c.dh, c.dw), np.uint16) for c in members]
    try:
        end = codec.jpeg_lossless_scan(buf[start:], planes, geom, huff, mcux, -(-y // frame["vmax0"]), psv, pt,
                                       restart)
    except ValueError as e:
        raise ValueError(f"{name}: JPEG file is {e}") from None
    for c, plane in zip(members, planes):
        c.samples = ((plane.astype(np.uint32) << pt) & 0xFF).astype(np.uint8)  # (JSAMPLE)(sample << Pt)
    return start + end


def _smoothing_ok(comps) -> bool:
    """libjpeg-turbo's smoothing_ok: every component's DC known and the
    quantisers of coefficients 0..9 nonzero, and some component's first 9 AC
    coefficients not all complete."""
    natural = ZIGZAG[:10]
    return all(c.bits[0] >= 0 and (c.qt[natural] != 0).all() for c in comps) and any((c.bits[1:] != 0).any()
                                                                                      for c in comps)
