"""AV1's OBU layer, as far as a still AVIF image needs it: the OBUs of a
temporal unit, the sequence header and the frame header of a key frame
(or an intra-only frame), tile info and tile groups, written from the AV1
bitstream specification (sections 5.3-5.11).

`decode(data, name)` decodes one AV1 temporal unit (an AVIF item or
sample) to its planes.  This slice of the port decodes 8-bit key frames,
lossless and lossy: every transform size and type, dequantization with
delta q and the deblocking filter with delta lf; what lies outside it
(CDEF, loop restoration, quantizer matrices, segment qindex and
loop-filter features, delta_lf_multi, superres, 10 / 12 bits, intra
block copy, film grain) is refused by name, each with its ROADMAP Queue 1
item.  The tiles themselves are decoded in C (csrc/av1dec.c, through
io/codec.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from vpt_tpu_torch.io import codec

SECOND_HALF = "ROADMAP Queue 1, the lossy AVIF slice, second half"
CDEF = f"CDEF, a nonzero strength or cdef_bits above 0 ({SECOND_HALF})"
RESTORATION = f"loop restoration ({SECOND_HALF})"
SEG_FEATURES = f"a segment qindex or loop filter feature (no writer here makes it; {SECOND_HALF})"
DELTA_LF_MULTI = f"delta_lf_multi (no writer here makes it; {SECOND_HALF})"
QMATRIX = f"quantizer matrices, using_qmatrix ({SECOND_HALF})"
DEEP = "bit depth {} (10- and 12-bit AV1; ROADMAP Queue 1, the intrabc / 10 / 12-bit / film grain slice)"
INTRABC = "allow_intrabc (intra block copy; ROADMAP Queue 1, the intrabc / 10 / 12-bit / film grain slice)"
GRAIN = "film grain (ROADMAP Queue 1, the intrabc / 10 / 12-bit / film grain slice)"
NOT_KEY = "a frame that is not a key frame (AV1 inter frames are not decoded; frame 0 of an AVIF is a key frame)"
SUPERRES = "superres (ROADMAP Queue 1, the lossy AVIF slice)"


class Refused(ValueError):
    """An AV1 feature this slice of the port does not decode."""

    def __init__(self, name: str, feature: str):
        self.feature = feature
        super().__init__(f"{name}: AVIF images are not read yet (PIL opens them; this one holds {feature})")


class Bits:
    """The specification's f(n), su(n), ns(n), uvlc() and leb128() over bytes."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.bit = data, pos * 8

    def f(self, n: int) -> int:
        x = 0
        for _ in range(n):
            byte = self.bit >> 3
            if byte >= len(self.data):
                raise ValueError("AV1 header ends early")
            x = (x << 1) | ((self.data[byte] >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        zeros = 0
        while not self.f(1):
            zeros += 1
            if zeros >= 32:
                return (1 << 32) - 1
        return self.f(zeros) + (1 << zeros) - 1

    def byte_align(self) -> None:
        self.bit = (self.bit + 7) & ~7


def leb128(data: bytes, pos: int) -> tuple:
    value = 0
    for i in range(8):
        if pos + i >= len(data):
            raise ValueError("AV1 OBU size ends early")
        b = data[pos + i]
        value |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return value, pos + i + 1
    return value, pos + 8


def obus(data: bytes) -> list:
    """(type, temporal_id, spatial_id, payload start, payload end) of each OBU."""
    out, pos = [], 0
    while pos < len(data):
        h = data[pos]  # dav1d reads past obu_forbidden_bit (it checks it in strict mode alone)
        kind, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        pos += 1
        tid = sid = 0
        if ext:
            if pos >= len(data):
                raise ValueError("AV1 OBU header ends early")
            tid, sid = data[pos] >> 5, (data[pos] >> 3) & 3
            pos += 1
        if has_size:
            size, pos = leb128(data, pos)
        else:
            size = len(data) - pos
        if pos + size > len(data):
            raise ValueError("AV1 OBU runs past its data")
        out.append((kind, tid, sid, pos, pos + size))
        pos += size
    return out


def sequence_header(data: bytes) -> dict:
    b, s = Bits(data), {}
    s["profile"] = b.f(3)
    if s["profile"] > 2:
        raise ValueError(f"AV1 sequence header of profile {s['profile']} (dav1d refuses it)")
    s["still"] = b.f(1)
    s["reduced"] = b.f(1)
    if s["reduced"] and not s["still"]:
        raise ValueError("AV1 sequence header with a reduced still-picture header but no still picture (dav1d "
                         "refuses it)")
    s["timing"] = s["decoder_model"] = s["equal_picture_interval"] = 0
    s["op_idc"], s["op_decoder_model"] = [0], [0]
    if s["reduced"]:
        s["level"] = b.f(5)
    else:
        s["timing"] = b.f(1)
        if s["timing"]:
            b.f(32)
            b.f(32)
            s["equal_picture_interval"] = b.f(1)
            if s["equal_picture_interval"]:
                b.uvlc()
            s["decoder_model"] = b.f(1)
            if s["decoder_model"]:
                s["buffer_delay_length"] = b.f(5) + 1
                b.f(32)
                s["removal_length"] = b.f(5) + 1
                s["presentation_length"] = b.f(5) + 1
        initial_display = b.f(1)
        count = b.f(5) + 1
        s["op_idc"], s["op_decoder_model"] = [], []
        for _ in range(count):
            s["op_idc"].append(b.f(12))
            level = b.f(5)
            if level > 7:
                b.f(1)
            model = 0
            if s["decoder_model"]:
                model = b.f(1)
                if model:
                    n = s["buffer_delay_length"]
                    b.f(n)
                    b.f(n)
                    b.f(1)
            s["op_decoder_model"].append(model)
            if initial_display and b.f(1):
                b.f(4)
    wbits, hbits = b.f(4) + 1, b.f(4) + 1
    s["wbits"], s["hbits"] = wbits, hbits
    s["max_w"], s["max_h"] = b.f(wbits) + 1, b.f(hbits) + 1
    s["frame_ids"] = 0 if s["reduced"] else b.f(1)
    if s["frame_ids"]:
        delta = b.f(4) + 2
        s["id_len"] = b.f(3) + 1 + delta
    s["sb128"], s["filter_intra"], s["edge_filter"] = b.f(1), b.f(1), b.f(1)
    s["order_hint_bits"] = 0
    s["force_screen"], s["force_integer_mv"] = 2, 2
    s["order_hint"] = 0
    if not s["reduced"]:
        b.f(1)  # enable_interintra_compound
        b.f(1)  # enable_masked_compound
        b.f(1)  # enable_warped_motion
        b.f(1)  # enable_dual_filter
        s["order_hint"] = b.f(1)
        if s["order_hint"]:
            b.f(1)  # enable_jnt_comp
            b.f(1)  # enable_ref_frame_mvs
        s["force_screen"] = 2 if b.f(1) else b.f(1)
        if s["force_screen"] > 0:
            s["force_integer_mv"] = 2 if b.f(1) else b.f(1)
        else:
            s["force_integer_mv"] = 2
        if s["order_hint"]:
            s["order_hint_bits"] = b.f(3) + 1
    s["superres"], s["cdef"], s["restoration"] = b.f(1), b.f(1), b.f(1)
    high = b.f(1)
    depth = 8
    if s["profile"] == 2 and high:
        depth = 12 if b.f(1) else 10
    elif high:
        depth = 10
    s["depth"] = depth
    s["mono"] = 0 if s["profile"] == 1 else b.f(1)
    s["cp"] = s["tc"] = s["mc"] = 2
    if b.f(1):
        s["cp"], s["tc"], s["mc"] = b.f(8), b.f(8), b.f(8)
    if s["mono"]:
        s["full_range"] = b.f(1)
        s["ssx"] = s["ssy"] = 1
        s["csp"] = 0
        s["separate_uv_delta_q"] = 0
    else:
        if s["cp"] == 1 and s["tc"] == 13 and s["mc"] == 0:
            s["full_range"], s["ssx"], s["ssy"] = 1, 0, 0
        else:
            s["full_range"] = b.f(1)
            if s["profile"] == 0:
                s["ssx"] = s["ssy"] = 1
            elif s["profile"] == 1:
                s["ssx"] = s["ssy"] = 0
            elif depth == 12:
                s["ssx"] = b.f(1)
                s["ssy"] = b.f(1) if s["ssx"] else 0
            else:
                s["ssx"], s["ssy"] = 1, 0
            s["csp"] = b.f(2) if s["ssx"] and s["ssy"] else 0
        s["separate_uv_delta_q"] = b.f(1)
    s["film_grain"] = b.f(1)
    return s


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def frame_header(b: Bits, s: dict, tid: int, sid: int, name: str) -> dict:
    """The uncompressed header of a key frame (or intra-only frame), read
    to its end; `Refused` for what this slice does not decode."""
    h = {}
    showable = 0
    if s["reduced"]:
        frame_type, show = 0, 1
    else:
        if b.f(1):
            raise Refused(name, f"show_existing_frame ({NOT_KEY})")
        frame_type = b.f(2)
        show = b.f(1)
        if frame_type not in (0, 2):
            raise Refused(name, NOT_KEY)
        if show and s["decoder_model"] and not s["equal_picture_interval"]:
            b.f(s["presentation_length"])
        showable = 0 if show else b.f(1)
        error_resilient = 1 if frame_type == 0 and show else b.f(1)
    h["show"] = show
    h["disable_cdf_update"] = b.f(1)
    screen = b.f(1) if s["force_screen"] == 2 else s["force_screen"]
    h["screen"] = screen
    if screen and s["force_integer_mv"] == 2:
        b.f(1)
    if s["frame_ids"]:
        b.f(s["id_len"])
    size_override = 0 if s["reduced"] else b.f(1)
    b.f(s["order_hint_bits"])
    if not s["reduced"] and s["decoder_model"]:
        if b.f(1):
            for op, idc in enumerate(s["op_idc"]):
                if s["op_decoder_model"][op]:
                    in_t, in_s = (idc >> tid) & 1, (idc >> (sid + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        b.f(s["removal_length"])
    if not (frame_type == 0 and show):
        refresh = b.f(8)
        if refresh != 0xFF and not s["reduced"] and error_resilient and s["order_hint"]:
            for _ in range(8):
                b.f(s["order_hint_bits"])
    if size_override:
        w, hh = b.f(s["wbits"]) + 1, b.f(s["hbits"]) + 1
    else:
        w, hh = s["max_w"], s["max_h"]
    if s["superres"] and b.f(1):
        raise Refused(name, SUPERRES)
    h["width"], h["height"] = w, hh
    if b.f(1):  # render_and_frame_size_different
        b.f(16)
        b.f(16)
    if screen and b.f(1):
        raise Refused(name, INTRABC)
    h["disable_frame_end_update_cdf"] = 1 if s["reduced"] or h["disable_cdf_update"] else b.f(1)
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((hh + 7) >> 3)
    h["mi_cols"], h["mi_rows"] = mi_cols, mi_rows
    # tile_info
    sb128 = s["sb128"]
    sb_cols = (mi_cols + 31) >> 5 if sb128 else (mi_cols + 15) >> 4
    sb_rows = (mi_rows + 31) >> 5 if sb128 else (mi_rows + 15) >> 4
    sb_shift = 5 if sb128 else 4
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    col_starts, row_starts = [], []
    if b.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_log2_cols
        while cols_log2 < max_log2_cols and b.f(1):
            cols_log2 += 1
        width_sb = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
        col_starts = [i << sb_shift for i in range(0, sb_cols, width_sb)]
        rows_log2 = max(min_log2_tiles - cols_log2, 0)
        while rows_log2 < max_log2_rows and b.f(1):
            rows_log2 += 1
        height_sb = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
        row_starts = [i << sb_shift for i in range(0, sb_rows, height_sb)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            col_starts.append(start << sb_shift)
            size = b.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        cols_log2 = _tile_log2(1, len(col_starts))
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles > 0 else sb_rows * sb_cols
        max_height = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            row_starts.append(start << sb_shift)
            start += b.ns(min(sb_rows - start, max_height)) + 1
        rows_log2 = _tile_log2(1, len(row_starts))
    h["col_starts"], h["row_starts"] = col_starts + [mi_cols], row_starts + [mi_rows]
    h["cols_log2"], h["rows_log2"] = cols_log2, rows_log2
    h["tile_size_bytes"] = 4
    if cols_log2 > 0 or rows_log2 > 0:
        b.f(cols_log2 + rows_log2)  # context_update_tile_id
        h["tile_size_bytes"] = b.f(2) + 1
    # quantization_params
    planes = 1 if s["mono"] else 3
    base_q = b.f(8)

    def delta_q() -> int:
        return b.su(7) if b.f(1) else 0
    deltas = [delta_q()]
    if planes > 1:
        diff = b.f(1) if s["separate_uv_delta_q"] else 0
        deltas += [delta_q(), delta_q()]
        deltas += [delta_q(), delta_q()] if diff else deltas[1:3]
    else:
        deltas += [0, 0, 0, 0]
    if b.f(1):  # using_qmatrix
        raise Refused(name, QMATRIX)
    # segmentation_params (a key frame: update_map 1, update_data 1)
    features = [[None] * 8 for _ in range(8)]
    h["seg_enabled"] = b.f(1)
    if h["seg_enabled"]:
        bits_ = (8, 6, 6, 6, 6, 3, 0, 0)
        signed = (1, 1, 1, 1, 1, 0, 0, 0)
        limit = (255, 63, 63, 63, 63, 7, 0, 0)
        for i in range(8):
            for j in range(8):
                if b.f(1):
                    v = b.su(1 + bits_[j]) if signed[j] else b.f(bits_[j])
                    features[i][j] = max(-limit[j], min(limit[j], v)) if signed[j] else max(0, min(limit[j], v))
    h["seg_pre_skip"] = int(any(features[i][j] is not None for i in range(8) for j in range(5, 8)))
    h["last_active_seg"] = max([i for i in range(8) if any(f is not None for f in features[i])], default=0)
    h["seg_skip"] = [int(features[i][6] is not None) for i in range(8)]
    if any(features[i][j] is not None for i in range(8) for j in range(5)):
        raise Refused(name, SEG_FEATURES)
    # delta_q_params / delta_lf_params
    h["base_q"], h["deltas"] = base_q, deltas
    h["delta_q"] = [0, 0, 0, 0]  # delta_q_present, delta_q_res, delta_lf_present, delta_lf_res
    if base_q > 0 and b.f(1):
        h["delta_q"][:2] = [1, b.f(2)]
        if b.f(1):
            h["delta_q"][2:] = [1, b.f(2)]
            if b.f(1):
                raise Refused(name, DELTA_LF_MULTI)
    coded_lossless = base_q == 0 and not any(deltas)
    # loop_filter_params: the reference deltas of a key frame start at their
    # defaults (INTRA_FRAME 1), which an update may change
    h["lf_level"], h["lf_sharpness"], h["lf_delta_enabled"], h["lf_ref_delta"] = [0, 0, 0, 0], 0, 0, 1
    if not coded_lossless:
        lvl = [b.f(6), b.f(6), 0, 0]
        if planes > 1 and (lvl[0] or lvl[1]):
            lvl[2], lvl[3] = b.f(6), b.f(6)
        h["lf_level"], h["lf_sharpness"] = lvl, b.f(3)
        h["lf_delta_enabled"] = b.f(1)
        if h["lf_delta_enabled"] and b.f(1):  # loop_filter_delta_update
            for i in range(8):
                if b.f(1):
                    v = b.su(7)
                    if i == 0:
                        h["lf_ref_delta"] = v
            for _ in range(2):
                if b.f(1):
                    b.su(7)
    # cdef_params: one strength set of 0 filters nothing and reads no cdef_idx
    if not coded_lossless and s["cdef"]:
        b.f(2)  # cdef_damping_minus_3
        cdef_bits = b.f(2)
        for _ in range(1 << cdef_bits):
            if any([b.f(4), b.f(2)] + ([b.f(4), b.f(2)] if planes > 1 else [])) or cdef_bits:
                raise Refused(name, CDEF)
    # lr_params
    if not coded_lossless and s["restoration"]:
        if any(b.f(2) for _ in range(planes)):
            raise Refused(name, RESTORATION)
    # read_tx_mode
    h["tx_mode_select"] = 0 if coded_lossless else b.f(1)
    h["reduced_tx_set"] = b.f(1)
    if s["film_grain"] and (show or showable) and b.f(1):
        raise Refused(name, GRAIN)
    h["planes"] = planes
    return h


def decode(data: bytes, name: str) -> tuple:
    """One AV1 temporal unit (an AVIF item's or sample's data) decoded:
    (sequence header, frame header, [Y, U, V] planes cropped to the frame,
    U and V None for a monochrome stream)."""
    seq = hdr = None
    tiles, ntiles = [], 0
    for kind, tid, sid, start, end in obus(data):
        if kind == 5:  # metadata: dav1d reads its type and the fixed fields of the types it knows
            mtype, pos = leb128(data[:end], start)
            if pos + {1: 4, 2: 24}.get(mtype, 0) > end:
                raise ValueError(f"{name}: AV1 metadata OBU cut short")
        if kind in (4, 7) and hdr is None:
            raise ValueError(f"{name}: AV1 tile group or redundant frame header before a frame header")
        if kind == 1:
            seq = sequence_header(data[start:end])
            if seq["depth"] != 8:
                raise Refused(name, DEEP.format(seq["depth"]))
        elif kind in (3, 6) and hdr is None:
            if seq is None:
                raise ValueError(f"{name}: AV1 frame before its sequence header")
            b = Bits(data[:end], start)
            hdr = frame_header(b, seq, tid, sid, name)
            ntiles = (len(hdr["col_starts"]) - 1) * (len(hdr["row_starts"]) - 1)
            if kind == 6:
                b.byte_align()
                tiles += _tile_group(data, b.bit >> 3, end, hdr, name)
        elif kind == 4 and hdr is not None:
            tiles += _tile_group(data, start, end, hdr, name)
        if hdr is not None and len(tiles) == ntiles:
            break
    if hdr is None:
        raise ValueError(f"{name}: AV1 data without a frame")
    if len(tiles) != ntiles:
        raise ValueError(f"{name}: AV1 frame without all its tiles")
    codec.check_size(hdr["width"], hdr["height"], name)
    mi_rows, mi_cols = hdr["mi_rows"], hdr["mi_cols"]
    ssx, ssy = seq["ssx"], seq["ssy"]
    y = np.zeros((mi_rows * 4, mi_cols * 4), np.uint8)
    u = np.zeros(((mi_rows * 4) >> ssy, (mi_cols * 4) >> ssx), np.uint8)
    v = np.zeros_like(u)
    prm = np.array([mi_rows, mi_cols, ssx, ssy, hdr["planes"], seq["sb128"], seq["filter_intra"],
                    seq["edge_filter"], hdr["screen"], hdr["disable_cdf_update"], hdr["seg_enabled"],
                    hdr["seg_pre_skip"], hdr["last_active_seg"], *hdr["seg_skip"], hdr["width"], hdr["height"],
                    hdr["base_q"], hdr["tx_mode_select"], hdr["reduced_tx_set"], *hdr["deltas"], *hdr["lf_level"],
                    hdr["lf_sharpness"], hdr["lf_delta_enabled"], hdr["lf_ref_delta"], *hdr["delta_q"]], np.int32)
    tile_arr = np.array(tiles, np.int64).reshape(-1, 6)
    buf = np.frombuffer(data, np.uint8)
    p = ctypes.c_void_p
    rc = codec.av1_library().vpt_av1_decode(p(buf.ctypes.data), p(prm.ctypes.data), p(tile_arr.ctypes.data),
                                            ctypes.c_int(ntiles), p(y.ctypes.data), p(u.ctypes.data),
                                            p(v.ctypes.data))
    codec.av1_check(rc, name)
    w, h = hdr["width"], hdr["height"]
    planes = [y[:h, :w]]
    if hdr["planes"] > 1:
        planes += [u[: (h + ssy) >> ssy, : (w + ssx) >> ssx], v[: (h + ssy) >> ssy, : (w + ssx) >> ssx]]
    else:
        planes += [None, None]
    return seq, hdr, planes


def _tile_group(data: bytes, start: int, end: int, hdr: dict, name: str) -> list:
    """The tiles of a tile group OBU: (offset, size, mi row start, end, mi
    col start, end) each."""
    cols, rows = len(hdr["col_starts"]) - 1, len(hdr["row_starts"]) - 1
    n = cols * rows
    b = Bits(data[:end], start)
    first, last = 0, n - 1
    if n > 1 and b.f(1):
        bits = hdr["cols_log2"] + hdr["rows_log2"]
        first, last = b.f(bits), b.f(bits)
        if first > last or last >= n:
            raise ValueError(f"{name}: AV1 tile group names tiles the frame does not have")
    b.byte_align()
    pos = b.bit >> 3
    out = []
    for t in range(first, last + 1):
        if t == last:
            size = end - pos
        else:
            tsb = hdr["tile_size_bytes"]
            if pos + tsb > end:
                raise ValueError(f"{name}: AV1 tile size runs past its OBU")
            size = int.from_bytes(data[pos : pos + tsb], "little") + 1
            pos += tsb
        if size <= 0 or pos + size > end:
            raise ValueError(f"{name}: AV1 tile runs past its OBU")
        r, c = t // cols, t % cols
        out.append((pos, size, hdr["row_starts"][r], hdr["row_starts"][r + 1], hdr["col_starts"][c],
                    hdr["col_starts"][c + 1]))
        pos += size
    return out
