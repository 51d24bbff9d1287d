/* AV1 key-frame tile decoding for 8-bit frames, written from the AV1
 * bitstream specification (sections 5.9-5.11 syntax, 8.2 symbol decoding,
 * 7.11.2 intra prediction, 7.12-7.13 reconstruction, 7.14 the loop filter).
 *
 * Coded: partitions, skip and segment ids, intra y / uv modes with angle
 * deltas, CfL, palette (colour cache, delta-coded colours, wavefront
 * colour-index contexts), filter intra, the directional predictor with its
 * edge filter and upsampling, DC / smooth / Paeth, at every transform size;
 * the transform size (tx_depth) and the intra transform types of both
 * sets; the coefficients of every transform size and class under the four
 * coefficient-CDF sets (qctx); dequantization with the per-plane DC / AC
 * deltas and delta q; the inverse DCT (4-64), ADST (4-16), identity (4-32)
 * and, in a lossless frame, the 4x4 Walsh-Hadamard transform; and the
 * deblocking filter with delta lf.  CDEF, loop restoration,
 * quantizer matrices, segment features other than skip, delta_lf_multi and
 * superres are refused by io/av1.py before this file is reached.
 *
 * The frame and tile headers are parsed by vpt_tpu_torch/io/av1.py, which
 * hands this file the parameters below and each tile's bytes.
 *
 * Entry point:
 *   int vpt_av1_decode(const uint8_t *data, const int32_t *prm,
 *                      const int64_t *tiles, int ntiles,
 *                      uint8_t *y, uint8_t *u, uint8_t *v)
 * returns 0, or a negative error code (io/codec.py AV1_ERRORS). */

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "av1dec_cdf.h"

/* ------------------------------------------------------------ constants */

enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED,
       SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
       PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32,
       BLOCK_32X16, BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64,
       BLOCK_128X128, BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
       BLOCK_SIZES };
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16,
       TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16, TX_SIZES_ALL };
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX = 9, V_DCT, H_DCT };
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
enum { T_DCT, T_ADST, T_IDENTITY };

/* log2 of width and height in 4-sample units, by block size */
static const uint8_t BW_LOG2[BLOCK_SIZES] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
static const uint8_t BH_LOG2[BLOCK_SIZES] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
/* log2 of width and height in samples, by transform size */
static const uint8_t TXW_LOG2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
static const uint8_t TXH_LOG2[TX_SIZES_ALL] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
static const uint8_t TX_ROW_SHIFT[TX_SIZES_ALL] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

static const uint8_t INTRA_MODE_CONTEXT[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
static const int MODE_TO_ANGLE[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
static const uint8_t MODE_TO_TXFM[14] = {DCT_DCT,   ADST_DCT,  DCT_ADST,  DCT_DCT,   ADST_ADST, ADST_DCT, DCT_ADST,
                                         DCT_ADST,  ADST_DCT,  ADST_ADST, ADST_DCT,  DCT_ADST,  ADST_ADST, DCT_DCT};
static const uint8_t FILTER_INTRA_DIR[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
static const uint8_t TX_INV_SET1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
static const uint8_t TX_INV_SET2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
static const int EDGE_KERNEL[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
static const int8_t SIG_REF_DIFF[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                                             {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                                             {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
static const int8_t MAG_REF[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
static const int PALETTE_COLOR_CONTEXT[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
static const int PALETTE_HASH_MUL[3] = {1, 2, 2};
static const int8_t FILTER_TAPS[5][8][7] = {
    {{-6, 10, 0, 0, 0, 12, 0}, {-5, 2, 10, 0, 0, 9, 0}, {-3, 1, 1, 10, 0, 7, 0}, {-3, 1, 1, 2, 10, 5, 0},
     {-4, 6, 0, 0, 0, 2, 12}, {-3, 2, 6, 0, 0, 2, 9}, {-3, 2, 2, 6, 0, 2, 7}, {-3, 1, 2, 2, 6, 3, 5}},
    {{-10, 16, 0, 0, 0, 10, 0}, {-6, 0, 16, 0, 0, 6, 0}, {-4, 0, 0, 16, 0, 4, 0}, {-2, 0, 0, 0, 16, 2, 0},
     {-10, 16, 0, 0, 0, 0, 10}, {-6, 0, 16, 0, 0, 0, 6}, {-4, 0, 0, 16, 0, 0, 4}, {-2, 0, 0, 0, 16, 0, 2}},
    {{-8, 8, 0, 0, 0, 16, 0}, {-8, 0, 8, 0, 0, 16, 0}, {-8, 0, 0, 8, 0, 16, 0}, {-8, 0, 0, 0, 8, 16, 0},
     {-4, 4, 0, 0, 0, 0, 16}, {-4, 0, 4, 0, 0, 0, 16}, {-4, 0, 0, 4, 0, 0, 16}, {-4, 0, 0, 0, 4, 0, 16}},
    {{-2, 8, 0, 0, 0, 10, 0}, {-1, 3, 8, 0, 0, 6, 0}, {-1, 2, 3, 8, 0, 4, 0}, {0, 1, 2, 3, 8, 2, 0},
     {-1, 4, 0, 0, 0, 3, 10}, {-1, 3, 4, 0, 0, 4, 6}, {-1, 2, 3, 4, 0, 4, 4}, {-1, 2, 2, 3, 4, 3, 3}},
    {{-12, 14, 0, 0, 0, 14, 0}, {-10, 0, 14, 0, 0, 12, 0}, {-9, 0, 0, 14, 0, 11, 0}, {-8, 0, 0, 0, 14, 10, 0},
     {-10, 12, 0, 0, 0, 0, 14}, {-9, 1, 12, 0, 0, 0, 12}, {-8, 0, 0, 12, 0, 1, 11}, {-7, 0, 0, 1, 12, 1, 9}}};
/* Cos128: 4096 cos(i pi / 128) */
static const int COS128[65] = {
    4096, 4095, 4091, 4085, 4076, 4065, 4052, 4036, 4017, 3996, 3973, 3948, 3920, 3889, 3857, 3822, 3784,
    3745, 3703, 3659, 3612, 3564, 3513, 3461, 3406, 3349, 3290, 3229, 3166, 3102, 3035, 2967, 2896, 2824,
    2751, 2675, 2598, 2520, 2440, 2359, 2276, 2191, 2106, 2019, 1931, 1842, 1751, 1660, 1567, 1474, 1380,
    1285, 1189, 1092, 995,  897,  799,  700,  601,  501,  401,  301,  201,  101,  0};
#define SINPI_1_9 1321
#define SINPI_2_9 2482
#define SINPI_3_9 3344
#define SINPI_4_9 3803

/* Dr_Intra_Derivative, by angle (the angles a prediction can take) */
static int dr_derivative(int a) {
    switch (a) {
    case 3: return 1023; case 6: return 547; case 9: return 372; case 14: return 273; case 17: return 215;
    case 20: return 178; case 23: return 151; case 26: return 132; case 29: return 116; case 32: return 102;
    case 36: return 90; case 39: return 80; case 42: return 71; case 45: return 64; case 48: return 57;
    case 51: return 51; case 54: return 45; case 58: return 40; case 61: return 35; case 64: return 31;
    case 67: return 27; case 70: return 23; case 73: return 19; case 76: return 15; case 81: return 11;
    case 84: return 7; case 87: return 3;
    default: return 0;
    }
}

/* ------------------------------------------------------------ errors */

#define E_DATA -1      /* the tile data is corrupt */
#define E_MEMORY -2
#define E_PARAMS -3    /* parameters outside what this decoder takes */
#define E_TILE -4      /* a tile outside the data */
#define E_OVERREAD -5  /* the symbol decoder read more than 14 bits past its tile's end */
#define E_RANGE -6     /* a transform's intermediate values leave 16 bits (not a conforming stream) */

/* ------------------------------------------------------------ symbol decoder (8.2) */

typedef struct {
    const uint8_t *data;
    int64_t nbits, pos;
    uint32_t rng, val;
    int64_t maxbits;
    int no_update;
} Sym;

static inline uint32_t sym_bits(Sym *s, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
        int64_t p = s->pos++;
        uint32_t bit = p < s->nbits ? (s->data[p >> 3] >> (7 - (p & 7))) & 1 : 0;
        v = (v << 1) | bit;
    }
    return v;
}

static void sym_init(Sym *s, const uint8_t *data, int64_t sz, int no_update) {
    s->data = data;
    s->nbits = sz * 8;
    s->pos = 0;
    int numbits = sz * 8 < 15 ? (int)(sz * 8) : 15;
    uint32_t buf = sym_bits(s, numbits);
    uint32_t padded = buf << (15 - numbits);
    s->val = ((1u << 15) - 1) ^ padded;
    s->rng = 1u << 15;
    s->maxbits = 8 * sz - 15;
    s->no_update = no_update;
}

static inline int floor_log2(uint32_t x) { return 31 - __builtin_clz(x); }

static inline void sym_renorm(Sym *s) {
    int bits = 15 - floor_log2(s->rng);
    s->rng <<= bits;
    int64_t avail = s->maxbits > 0 ? s->maxbits : 0;
    int numbits = bits < avail ? bits : (int)avail;
    uint32_t newdata = sym_bits(s, numbits);
    uint32_t padded = newdata << (bits - numbits);
    s->val = padded ^ (((s->val + 1) << bits) - 1);
    s->maxbits -= bits;
}

/* read_symbol with an N-symbol CDF (N values, the last 32768, then the counter) */
static int sym_read(Sym *s, uint16_t *cdf, int n) {
    uint32_t cur = s->rng, prev;
    int symbol = -1;
    do {
        symbol++;
        prev = cur;
        uint32_t f = (1u << 15) - cdf[symbol];
        cur = ((s->rng >> 8) * (f >> 6)) >> 1;
        cur += 4 * (uint32_t)(n - symbol - 1);
    } while (s->val < cur);
    s->rng = prev - cur;
    s->val -= cur;
    sym_renorm(s);
    if (!s->no_update) {
        int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + (n >= 4 ? 2 : floor_log2(n));
        uint32_t tmp = 0;
        for (int i = 0; i < n - 1; i++) {
            if (i == symbol) tmp = 1u << 15;
            if (tmp < cdf[i])
                cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
            else
                cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
        }
        cdf[n] += cdf[n] < 32;
    }
    return symbol;
}

/* a symbol of a CDF that does not adapt */
static int sym_read_fixed(Sym *s, const uint16_t *cdf, int n) {
    uint16_t tmp[17];
    memcpy(tmp, cdf, sizeof(uint16_t) * (n + 1));
    int no_update = s->no_update;
    s->no_update = 1;
    int v = sym_read(s, tmp, n);
    s->no_update = no_update;
    return v;
}

static int sym_bool(Sym *s) {
    static const uint16_t half[3] = {1 << 14, 1 << 15, 0};
    return sym_read_fixed(s, half, 2);
}

static int sym_literal(Sym *s, int n) {
    int x = 0;
    for (int i = 0; i < n; i++) x = 2 * x + sym_bool(s);
    return x;
}

static int sym_ns(Sym *s, int n) {
    int w = 0, x = n;
    while (x) { w++; x >>= 1; }
    int m = (1 << w) - n;
    int v = sym_literal(s, w - 1);
    if (v < m) return v;
    int extra = sym_literal(s, 1);
    return (v << 1) - m + extra;
}

/* ------------------------------------------------------------ CDF context */

typedef struct {
    uint16_t kf_y_mode[5][5][14];
    uint16_t uv_mode_cfl_not_allowed[13][14];
    uint16_t uv_mode_cfl_allowed[13][15];
    uint16_t angle_delta[8][8];
    uint16_t partition[20][11];
    uint16_t use_filter_intra[22][3];
    uint16_t filter_intra_mode[6];
    uint16_t cfl_sign[9];
    uint16_t cfl_alpha[6][17];
    uint16_t segment_id[3][9];
    uint16_t skip[3][3];
    uint16_t palette_y_mode[7][3][3];
    uint16_t palette_uv_mode[2][3];
    uint16_t palette_y_size[7][8];
    uint16_t palette_uv_size[7][8];
    uint16_t color_index[2][7][5][9];
    uint16_t tx_8x8[3][3];
    uint16_t tx_16x16[3][4];
    uint16_t tx_32x32[3][4];
    uint16_t tx_64x64[3][4];
    uint16_t intra_tx_set1[2][13][8];
    uint16_t intra_tx_set2[3][13][6];
    uint16_t delta_q[5];
    uint16_t delta_lf[5];
    /* the coefficient CDFs of the frame's qctx */
    uint16_t txb_skip[5][13][3];
    uint16_t eob_pt[7][2][2][13]; /* by eobMultisize: 16 .. 1024, the symbols' CDF then its counter */
    uint16_t eob_extra[5][2][9][3];
    uint16_t dc_sign[2][3][3];
    uint16_t coeff_base_eob[5][2][4][4];
    uint16_t coeff_base[5][2][42][5];
    uint16_t coeff_br[5][2][21][5];
} Cdfs;

static void cdfs_default(Cdfs *c, int qctx) {
#define CP(dst, src) memcpy(c->dst, src, sizeof(c->dst))
    CP(kf_y_mode, DEF_KF_Y_MODE);
    CP(uv_mode_cfl_not_allowed, DEF_UV_MODE_CFL_NOT_ALLOWED);
    CP(uv_mode_cfl_allowed, DEF_UV_MODE_CFL_ALLOWED);
    CP(angle_delta, DEF_ANGLE_DELTA);
    CP(partition, DEF_PARTITION);
    CP(use_filter_intra, DEF_USE_FILTER_INTRA);
    CP(filter_intra_mode, DEF_FILTER_INTRA_MODE);
    CP(cfl_sign, DEF_CFL_SIGN);
    CP(cfl_alpha, DEF_CFL_ALPHA);
    CP(segment_id, DEF_SEGMENT_ID);
    CP(skip, DEF_SKIP);
    CP(palette_y_mode, DEF_PALETTE_Y_MODE);
    CP(palette_uv_mode, DEF_PALETTE_UV_MODE);
    CP(palette_y_size, DEF_PALETTE_Y_SIZE);
    CP(palette_uv_size, DEF_PALETTE_UV_SIZE);
    CP(color_index, DEF_COLOR_INDEX);
    CP(tx_8x8, DEF_TX_8X8);
    CP(tx_16x16, DEF_TX_16X16);
    CP(tx_32x32, DEF_TX_32X32);
    CP(tx_64x64, DEF_TX_64X64);
    CP(intra_tx_set1, DEF_INTRA_TX_SET1);
    CP(intra_tx_set2, DEF_INTRA_TX_SET2);
    CP(delta_q, DEF_DELTA_Q);
    CP(delta_lf, DEF_DELTA_Q);
    CP(txb_skip, DEF_TXB_SKIP[qctx]);
    CP(eob_extra, DEF_EOB_EXTRA[qctx]);
    CP(dc_sign, DEF_DC_SIGN);
    CP(coeff_base_eob, DEF_COEFF_BASE_EOB[qctx]);
    CP(coeff_base, DEF_COEFF_BASE[qctx]);
    CP(coeff_br, DEF_COEFF_BR[qctx]);
#undef CP
    memset(c->eob_pt, 0, sizeof(c->eob_pt));
    for (int p = 0; p < 2; p++)
        for (int k = 0; k < 2; k++) {
            memcpy(c->eob_pt[0][p][k], DEF_EOB_PT_16[qctx][p][k], sizeof(DEF_EOB_PT_16[0][0][0]));
            memcpy(c->eob_pt[1][p][k], DEF_EOB_PT_32[qctx][p][k], sizeof(DEF_EOB_PT_32[0][0][0]));
            memcpy(c->eob_pt[2][p][k], DEF_EOB_PT_64[qctx][p][k], sizeof(DEF_EOB_PT_64[0][0][0]));
            memcpy(c->eob_pt[3][p][k], DEF_EOB_PT_128[qctx][p][k], sizeof(DEF_EOB_PT_128[0][0][0]));
            memcpy(c->eob_pt[4][p][k], DEF_EOB_PT_256[qctx][p][k], sizeof(DEF_EOB_PT_256[0][0][0]));
        }
    for (int p = 0; p < 2; p++) {
        memcpy(c->eob_pt[5][p][0], DEF_EOB_PT_512[qctx][p], sizeof(DEF_EOB_PT_512[0][0]));
        memcpy(c->eob_pt[6][p][0], DEF_EOB_PT_1024[qctx][p], sizeof(DEF_EOB_PT_1024[0][0]));
    }
}

/* ------------------------------------------------------------ decoder state */

typedef struct {
    /* frame */
    int mi_rows, mi_cols, ssx, ssy, planes, sb128, filter_intra, edge_filter, screen_content;
    int width, height;
    int seg_enabled, seg_pre_skip, last_active_seg, seg_skip[8];
    int lossless, tx_mode_select, reduced_tx_set, qctx, base_q, dl[5];
    int delta_q_present, delta_q_res, delta_lf_present, delta_lf_res;
    int lf_level[4], lf_sharpness, lf_delta_enabled, lf_ref_delta_intra;
    uint8_t *plane[3];
    int stride[3];
    /* per 4x4 (MI) of the frame */
    int mi_stride;
    uint8_t *y_mode, *uv_mode, *seg_id, *skip, *pal_size[2], *mi_sizes, *tx_size;
    uint8_t *pal_colors[2]; /* 8 per MI */
    uint8_t *lf_tx[3];      /* LoopfilterTxSizes, per 4x4 of each plane (stride mi_stride) */
    int8_t *delta_lfs;      /* DeltaLFs[0], per MI */
    /* contexts, per 4x4 column / row of each plane */
    uint8_t *above_level[3], *above_dc[3], *left_level[3], *left_dc[3];
    /* tile */
    int row_start, row_end, col_start, col_end;
    Sym sym;
    Cdfs cdf;
    uint8_t decoded[3][35][35]; /* BlockDecoded, offset by 1 */
    int read_deltas, cur_qidx, delta_lf;
    /* default scans by (log2 w - 2, log2 h - 2) of the coded (at most 32x32) area */
    uint16_t *scans[4][4];
    /* block */
    int mi_row, mi_col, mi_size, has_chroma, avail_u, avail_l, avail_u_chroma, avail_l_chroma;
    int skip_flag, segment, y_mode_b, uv_mode_b, angle_y, angle_uv, cfl_u, cfl_v, tx_size_b;
    int use_filter, filter_mode, pal_y, pal_uv;
    uint8_t colors_y[8], colors_u[8], colors_v[8];
    uint8_t map_y[64][64], map_uv[64][64];
    int max_luma_w, max_luma_h;
    int dq_b[3][2]; /* the block's dc / ac quantizers by plane */
    int quant[1024];
    int err;
} Dec;

static inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
static inline int clip1(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
static inline int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }
static inline int round2s(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }

static inline int is_inside(const Dec *d, int r, int c) {
    return c >= d->col_start && c < d->col_end && r >= d->row_start && r < d->row_end;
}

static inline int mi_idx(const Dec *d, int r, int c) { return r * d->mi_stride + c; }

static int bsize_of(int wlog2, int hlog2) {
    for (int b = 0; b < BLOCK_SIZES; b++)
        if (BW_LOG2[b] == wlog2 && BH_LOG2[b] == hlog2) return b;
    return -1;
}

static int tx_of(int wlog2, int hlog2) {
    for (int t = 0; t < TX_SIZES_ALL; t++)
        if (TXW_LOG2[t] == wlog2 && TXH_LOG2[t] == hlog2) return t;
    return -1;
}

/* Split_Tx_Size */
static int split_tx(int t) {
    int w = TXW_LOG2[t], h = TXH_LOG2[t];
    if (w == 2 && h == 2) return t;
    if (w == h) return tx_of(w - 1, h - 1);
    return w > h ? tx_of(w - 1, h) : tx_of(w, h - 1);
}

/* Max_Tx_Size_Rect */
static int max_tx_rect(int bsize) { return tx_of(imin(BW_LOG2[bsize] + 2, 6), imin(BH_LOG2[bsize] + 2, 6)); }

/* get_plane_residual_size */
static int plane_size(const Dec *d, int bsize, int plane) {
    if (!plane) return bsize;
    int w = BW_LOG2[bsize] - d->ssx, h = BH_LOG2[bsize] - d->ssy;
    return bsize_of(w < 0 ? 0 : w, h < 0 ? 0 : h);
}

/* get_tx_size */
static int plane_tx_size(const Dec *d, int plane) {
    if (d->lossless) return TX_4X4;
    if (!plane) return d->tx_size_b;
    int t = max_tx_rect(plane_size(d, d->mi_size, plane)), w = TXW_LOG2[t], h = TXH_LOG2[t];
    if (w == 6 || h == 6) {
        if (w == 4) return TX_16X32;
        if (h == 4) return TX_32X16;
        return TX_32X32;
    }
    return t;
}

/* get_tx_set for an intra block: 0 DCT only, 1 TX_SET_INTRA_1, 2 TX_SET_INTRA_2 */
static int tx_set(const Dec *d, int t) {
    int sqr = imin(TXW_LOG2[t], TXH_LOG2[t]), up = imax(TXW_LOG2[t], TXH_LOG2[t]);
    if (up >= 5) return 0;
    if (d->reduced_tx_set || sqr == 4) return 2;
    return 1;
}

static void make_scans(Dec *d, uint16_t *mem) {
    for (int wl = 0; wl < 4; wl++)
        for (int hl = 0; hl < 4; hl++) {
            d->scans[wl][hl] = NULL;
            if (abs(wl - hl) > 2) continue;
            int w = 4 << wl, h = 4 << hl, n = 0;
            uint16_t *s = d->scans[wl][hl] = mem;
            mem += w * h;
            for (int dg = 0; dg < w + h - 1; dg++) {
                /* down: the row rising along the diagonal; up: falling */
                int down = w < h ? 1 : w > h ? 0 : (dg & 1);
                int rlo = imax(0, dg - (w - 1)), rhi = imin(dg, h - 1);
                for (int k = 0; k <= rhi - rlo; k++) {
                    int r = down ? rlo + k : rhi - k;
                    s[n++] = (uint16_t)(r * w + dg - r);
                }
            }
        }
}

/* ------------------------------------------------------------ intra prediction (7.11.2) */

static int is_smooth(const Dec *d, int r, int c, int plane) {
    int m = plane ? d->uv_mode[mi_idx(d, r, c)] : d->y_mode[mi_idx(d, r, c)];
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
}

static int filter_type(const Dec *d, int plane) {
    int above = 0, left = 0;
    if (plane ? d->avail_u_chroma : d->avail_u) {
        int r = d->mi_row - 1, c = d->mi_col;
        if (plane) {
            if (d->ssx && !(d->mi_col & 1)) c++;
            if (d->ssy && (d->mi_row & 1)) r--;
        }
        above = is_smooth(d, r, c, plane);
    }
    if (plane ? d->avail_l_chroma : d->avail_l) {
        int r = d->mi_row, c = d->mi_col - 1;
        if (plane) {
            if (d->ssx && (d->mi_col & 1)) c--;
            if (d->ssy && !(d->mi_row & 1)) r++;
        }
        left = is_smooth(d, r, c, plane);
    }
    return above || left;
}

static int edge_strength(int w, int h, int ftype, int delta) {
    int dd = delta < 0 ? -delta : delta, wh = w + h, s = 0;
    if (!ftype) {
        if (wh <= 8) { if (dd >= 56) s = 1; }
        else if (wh <= 12) { if (dd >= 40) s = 1; }
        else if (wh <= 16) { if (dd >= 40) s = 1; }
        else if (wh <= 24) { if (dd >= 8) s = 1; if (dd >= 16) s = 2; if (dd >= 32) s = 3; }
        else if (wh <= 32) { if (dd >= 1) s = 1; if (dd >= 4) s = 2; if (dd >= 32) s = 3; }
        else { if (dd >= 1) s = 3; }
    } else {
        if (wh <= 8) { if (dd >= 40) s = 1; if (dd >= 64) s = 2; }
        else if (wh <= 16) { if (dd >= 20) s = 1; if (dd >= 48) s = 2; }
        else if (wh <= 24) { if (dd >= 4) s = 3; }
        else { if (dd >= 1) s = 3; }
    }
    return s;
}

static int use_upsample(int w, int h, int ftype, int delta) {
    int dd = delta < 0 ? -delta : delta, wh = w + h;
    if (dd <= 0 || dd >= 40) return 0;
    return ftype ? wh <= 8 : wh <= 16;
}

/* edge[] is indexed from -1 (offset by 16 in the buffers below) */
static void edge_filter(int *buf, int sz, int strength) {
    if (!strength) return;
    int edge[160];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
        int s = 0;
        for (int j = 0; j < 5; j++) {
            int k = clip3(0, sz - 1, i - 2 + j);
            s += EDGE_KERNEL[strength - 1][j] * edge[k];
        }
        buf[i - 1] = (s + 8) >> 4;
    }
}

static void edge_upsample(int *buf, int numpx) {
    int dup[64];
    dup[0] = buf[-1];
    for (int i = -1; i < numpx; i++) dup[i + 2] = buf[i];
    dup[numpx + 2] = buf[numpx - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < numpx; i++) {
        int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        s = clip1(round2(s, 4));
        buf[2 * i - 1] = s;
        buf[2 * i] = dup[i + 2];
    }
}

/* predict_intra for a (1 << wl) x (1 << hl) block at (x, y) of `plane` */
static void predict_intra(Dec *d, int plane, int x, int y, int have_left, int have_above, int have_above_rt,
                          int have_below_lt, int mode, int wl, int hl) {
    const int w = 1 << wl, h = 1 << hl;
    uint8_t *p = d->plane[plane];
    int st = d->stride[plane];
    int maxx = (d->mi_cols * 4) - 1, maxy = (d->mi_rows * 4) - 1;
    if (plane) {
        maxx = ((d->mi_cols * 4) >> d->ssx) - 1;
        maxy = ((d->mi_rows * 4) >> d->ssy) - 1;
    }
    int abuf[320], lbuf[320];
    int *above = abuf + 16, *left = lbuf + 16;
    if (!have_above && have_left) {
        for (int i = 0; i < w + h; i++) above[i] = p[y * st + x - 1];
    } else if (!have_above && !have_left) {
        for (int i = 0; i < w + h; i++) above[i] = 127;
    } else {
        int lim = x + (have_above_rt ? 2 * w : w) - 1;
        if (lim > maxx) lim = maxx;
        for (int i = 0; i < w + h; i++) above[i] = p[(y - 1) * st + (x + i < lim ? x + i : lim)];
    }
    if (!have_left && have_above) {
        for (int i = 0; i < w + h; i++) left[i] = p[(y - 1) * st + x];
    } else if (!have_left && !have_above) {
        for (int i = 0; i < w + h; i++) left[i] = 129;
    } else {
        int lim = y + (have_below_lt ? 2 * h : h) - 1;
        if (lim > maxy) lim = maxy;
        for (int i = 0; i < w + h; i++) left[i] = p[(y + i < lim ? y + i : lim) * st + x - 1];
    }
    if (have_above && have_left) above[-1] = p[(y - 1) * st + x - 1];
    else if (have_above) above[-1] = p[(y - 1) * st + x];
    else if (have_left) above[-1] = p[y * st + x - 1];
    else above[-1] = 128;
    left[-1] = above[-1];

    static __thread uint8_t pred[64][64];
    if (plane == 0 && d->use_filter) {
        for (int i2 = 0; i2 < (h >> 1); i2++)
            for (int j4 = 0; j4 < (w >> 2); j4++) {
                int pv[7];
                for (int i = 0; i < 7; i++) {
                    if (i < 5) {
                        if (i2 == 0) pv[i] = above[(j4 << 2) + i - 1];
                        else if (j4 == 0 && i == 0) pv[i] = left[(i2 << 1) - 1];
                        else pv[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                    } else {
                        if (j4 == 0) pv[i] = left[(i2 << 1) + i - 5];
                        else pv[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                    }
                }
                for (int i = 0; i < 8; i++) {
                    int pr = 0;
                    for (int j = 0; j < 7; j++) pr += FILTER_TAPS[d->filter_mode][i][j] * pv[j];
                    pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = (uint8_t)clip1(round2s(pr, 4));
                }
            }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
        int pangle = MODE_TO_ANGLE[mode] + (plane ? d->angle_uv : d->angle_y) * 3;
        int up_above = 0, up_left = 0;
        if (d->edge_filter) {
            int ftype = 0;
            if (pangle != 90 && pangle != 180) {
                if (pangle > 90 && pangle < 180 && w + h >= 24) {
                    int corner = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                    left[-1] = above[-1] = corner;
                }
                ftype = filter_type(d, plane);
                if (have_above) {
                    int strength = edge_strength(w, h, ftype, pangle - 90);
                    int n = (w < maxx - x + 1 ? w : maxx - x + 1) + (pangle < 90 ? h : 0) + 1;
                    edge_filter(above, n, strength);
                }
                if (have_left) {
                    int strength = edge_strength(w, h, ftype, pangle - 180);
                    int n = (h < maxy - y + 1 ? h : maxy - y + 1) + (pangle > 180 ? w : 0) + 1;
                    edge_filter(left, n, strength);
                }
            }
            up_above = use_upsample(w, h, ftype, pangle - 90);
            if (up_above) edge_upsample(above, w + (pangle < 90 ? h : 0));
            up_left = use_upsample(w, h, ftype, pangle - 180);
            if (up_left) edge_upsample(left, h + (pangle > 180 ? w : 0));
        }
        int dx = 0, dy = 0;
        if (pangle < 90) dx = dr_derivative(pangle);
        else if (pangle > 90 && pangle < 180) dx = dr_derivative(180 - pangle);
        if (pangle > 90 && pangle < 180) dy = dr_derivative(pangle - 90);
        else if (pangle > 180) dy = dr_derivative(270 - pangle);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int v;
                if (pangle < 90) {
                    int idx = (i + 1) * dx;
                    int base = (idx >> (6 - up_above)) + (j << up_above);
                    int shift = ((idx << up_above) >> 1) & 0x1F;
                    int maxbase = (w + h - 1) << up_above;
                    if (base < maxbase)
                        v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                    else
                        v = above[maxbase];
                } else if (pangle > 90 && pangle < 180) {
                    int idx = (j << 6) - (i + 1) * dx;
                    int base = idx >> (6 - up_above);
                    if (base >= -(1 << up_above)) {
                        int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
                        v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                    } else {
                        idx = (i << 6) - (j + 1) * dy;
                        base = idx >> (6 - up_left);
                        int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
                        v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                    }
                } else if (pangle > 180) {
                    int idx = (j + 1) * dy;
                    int base = (idx >> (6 - up_left)) + (i << up_left);
                    int shift = ((idx << up_left) >> 1) & 0x1F;
                    v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                } else if (pangle == 90) {
                    v = above[j];
                } else {
                    v = left[i];
                }
                pred[i][j] = (uint8_t)v;
            }
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
        const uint8_t *wx = SM_WEIGHTS + w - 4, *wy = SM_WEIGHTS + h - 4;
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int v;
                if (mode == SMOOTH_PRED)
                    v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                                   (256 - wx[j]) * above[w - 1], 9);
                else if (mode == SMOOTH_V_PRED)
                    v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
                else
                    v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
                pred[i][j] = (uint8_t)v;
            }
    } else if (mode == DC_PRED) {
        int avg;
        if (have_above && have_left) {
            int sum = 0;
            for (int k = 0; k < w; k++) sum += above[k];
            for (int k = 0; k < h; k++) sum += left[k];
            avg = (sum + ((w + h) >> 1)) / (w + h);
        } else if (have_above) {
            int sum = 0;
            for (int k = 0; k < w; k++) sum += above[k];
            avg = (sum + (w >> 1)) >> wl;
        } else if (have_left) {
            int sum = 0;
            for (int k = 0; k < h; k++) sum += left[k];
            avg = (sum + (h >> 1)) >> hl;
        } else {
            avg = 128;
        }
        for (int i = 0; i < h; i++) memset(pred[i], avg, (size_t)w);
    } else { /* PAETH */
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int base = above[j] + left[i] - above[-1];
                int pl = abs(base - left[i]), pt = abs(base - above[j]), ptl = abs(base - above[-1]);
                pred[i][j] = (uint8_t)((pl <= pt && pl <= ptl) ? left[i] : (pt <= ptl) ? above[j] : above[-1]);
            }
    }
    for (int i = 0; i < h; i++) memcpy(p + (size_t)(y + i) * st + x, pred[i], (size_t)w);
}

static void predict_cfl(Dec *d, int plane, int sx, int sy, int wl, int hl) {
    const int w = 1 << wl, h = 1 << hl;
    int alpha = plane == 1 ? d->cfl_u : d->cfl_v;
    static __thread int lv[32][32];
    int avg = 0;
    uint8_t *luma = d->plane[0];
    int lst = d->stride[0];
    for (int i = 0; i < h; i++) {
        int ly = (sy + i) << d->ssy;
        if (ly > d->max_luma_h - (1 << d->ssy)) ly = d->max_luma_h - (1 << d->ssy);
        for (int j = 0; j < w; j++) {
            int lx = (sx + j) << d->ssx;
            if (lx > d->max_luma_w - (1 << d->ssx)) lx = d->max_luma_w - (1 << d->ssx);
            int t = 0;
            for (int dy = 0; dy <= d->ssy; dy++)
                for (int dx = 0; dx <= d->ssx; dx++) t += luma[(ly + dy) * lst + lx + dx];
            int v = t << (3 - d->ssx - d->ssy);
            lv[i][j] = v;
            avg += v;
        }
    }
    avg = round2(avg, wl + hl);
    uint8_t *p = d->plane[plane];
    int st = d->stride[plane];
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
            int dc = p[(sy + i) * st + sx + j];
            int scaled = round2s(alpha * (lv[i][j] - avg), 6);
            p[(sy + i) * st + sx + j] = (uint8_t)clip1(dc + scaled);
        }
}

/* ------------------------------------------------------------ coefficients (5.11.39) */

static int get_tx_class(int t) {
    if (t == V_DCT) return TX_CLASS_VERT;
    if (t == H_DCT) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
}

/* Coeff_Base_Ctx_Offset[txSz][min(row, 4)][min(col, 4)] */
static int base_ctx_offset(int wl, int hl, int row, int col) {
    if (wl < hl && row < 2) return 11;
    if (wl > hl && col < 2) return 16;
    if (row + col < 2) return 1;
    if (row + col < 4) return 6;
    return 21;
}

/* dav1d's read_golomb: at most 32 leading zeros, the value modulo 2^32 */
static uint32_t read_golomb(Sym *s) {
    int len = 0;
    uint32_t val = 1;
    while (!sym_literal(s, 1) && len < 32) len++;
    while (len--) val = (val << 1) + (uint32_t)sym_literal(s, 1);
    return val - 1;
}

/* the coefficients of one transform block, dequantized into d->quant
 * (row-major, min(w, 32) wide); returns eob and the block's transform type */
static int coeffs(Dec *d, int plane, int sx, int sy, int txsz, int *type_out) {
    int wl = TXW_LOG2[txsz], hl = TXH_LOG2[txsz];
    int w4 = 1 << (wl - 2), h4 = 1 << (hl - 2);
    int x4 = sx >> 2, y4 = sy >> 2;
    int ptype = plane > 0;
    int maxx4 = d->mi_cols, maxy4 = d->mi_rows;
    if (plane) { maxx4 >>= d->ssx; maxy4 >>= d->ssy; }
    int sqr = imin(wl, hl) - 2, sqrup = imax(wl, hl) - 2;
    int szctx = (sqr + sqrup + 1) >> 1;
    int awl = imin(wl, 5), ahl = imin(hl, 5), tw = 1 << awl, th = 1 << ahl;
    int *q = d->quant;
    memset(q, 0, sizeof(int) * (size_t)(tw * th));
    int ctx;
    int bsize = plane_size(d, d->mi_size, plane);
    int bwl = BW_LOG2[bsize] + 2, bhl = BH_LOG2[bsize] + 2;
    if (plane == 0) {
        int top = 0, left = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < maxx4) top = imax(top, d->above_level[0][x4 + k]);
        for (int k = 0; k < h4; k++)
            if (y4 + k < maxy4) left = imax(left, d->left_level[0][y4 + k]);
        if (bwl == wl && bhl == hl) ctx = 0;
        else if (top == 0 && left == 0) ctx = 1;
        else if (top == 0 || left == 0) ctx = 2 + (imax(top, left) > 3);
        else if (imax(top, left) <= 3) ctx = 4;
        else if (imin(top, left) <= 3) ctx = 5;
        else ctx = 6;
    } else {
        int above = 0, left = 0;
        for (int k = 0; k < w4; k++)
            if (x4 + k < maxx4) above |= d->above_level[plane][x4 + k] | d->above_dc[plane][x4 + k];
        for (int k = 0; k < h4; k++)
            if (y4 + k < maxy4) left |= d->left_level[plane][y4 + k] | d->left_dc[plane][y4 + k];
        ctx = 7 + (above != 0) + (left != 0);
        if (bwl + bhl > wl + hl) ctx += 3;
    }
    int all_zero = sym_read(&d->sym, d->cdf.txb_skip[szctx][ctx], 2);
    int eob = 0, cul = 0, dccat = 0;
    if (!all_zero) {
        /* the transform type */
        int type = DCT_DCT, set = tx_set(d, txsz);
        if (d->lossless) {
            type = DCT_DCT;
        } else if (plane == 0) {
            if (set) {
                int dir = d->use_filter ? FILTER_INTRA_DIR[d->filter_mode] : d->y_mode_b;
                if (set == 1) type = TX_INV_SET1[sym_read(&d->sym, d->cdf.intra_tx_set1[sqr][dir], 7)];
                else type = TX_INV_SET2[sym_read(&d->sym, d->cdf.intra_tx_set2[sqr][dir], 5)];
            }
        } else {
            type = set ? MODE_TO_TXFM[d->uv_mode_b] : DCT_DCT;
        }
        *type_out = type;
        int cls = get_tx_class(type);
        const uint16_t *scan = d->scans[awl - 2][ahl - 2];
        int one_d = cls != TX_CLASS_2D && !(wl == 6 || hl == 6);
        /* eob */
        int ems = awl + ahl - 4;
        int eobpt = sym_read(&d->sym, d->cdf.eob_pt[ems][ptype][cls == TX_CLASS_2D ? 0 : 1], ems + 5) + 1;
        eob = eobpt < 2 ? eobpt : (1 << (eobpt - 2)) + 1;
        int shift = eobpt - 3;
        if (shift >= 0) {
            if (sym_read(&d->sym, d->cdf.eob_extra[szctx][ptype][eobpt - 3], 2)) eob += 1 << shift;
            int n = eobpt - 2 > 0 ? eobpt - 2 : 0;
            for (int i = 1; i < n; i++) {
                shift = n - 1 - i;
                if (sym_literal(&d->sym, 1)) eob += 1 << shift;
            }
        }
        int brctx_sz = imin(szctx, 3);
        for (int c = eob - 1; c >= 0; c--) {
            int pos;
            if (!one_d) pos = scan[c];
            else if (cls == TX_CLASS_VERT) pos = c; /* mrow */
            else pos = (c % th) * tw + c / th;    /* mcol */
            int row = pos >> awl, col = pos - (row << awl);
            int level;
            if (c == eob - 1) {
                int area = tw * th;
                int ectx = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
                level = sym_read(&d->sym, d->cdf.coeff_base_eob[szctx][ptype][ectx], 3) + 1;
            } else {
                int mag = 0;
                for (int k = 0; k < 5; k++) {
                    int rr = row + SIG_REF_DIFF[cls][k][0], cc = col + SIG_REF_DIFF[cls][k][1];
                    if (rr < th && cc < tw) mag += imin(abs(q[(rr << awl) + cc]), 3);
                }
                int bctx = imin((mag + 1) >> 1, 4);
                if (cls == TX_CLASS_2D)
                    bctx = (row == 0 && col == 0) ? 0 : bctx + base_ctx_offset(wl, hl, imin(row, 4), imin(col, 4));
                else
                    bctx += 26 + 5 * imin(cls == TX_CLASS_VERT ? row : col, 2);
                level = sym_read(&d->sym, d->cdf.coeff_base[szctx][ptype][bctx], 4);
            }
            if (level > 2) {
                int mag = 0;
                for (int k = 0; k < 3; k++) {
                    int rr = row + MAG_REF[cls][k][0], cc = col + MAG_REF[cls][k][1];
                    if (rr < th && cc < tw) mag += imin(q[(rr << awl) + cc], 15);
                }
                mag = imin((mag + 1) >> 1, 6);
                int brctx;
                if (pos == 0) brctx = mag;
                else if (cls == TX_CLASS_2D) brctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
                else if (cls == TX_CLASS_HORIZ) brctx = col == 0 ? mag + 7 : mag + 14;
                else brctx = row == 0 ? mag + 7 : mag + 14;
                for (int idx = 0; idx < 4; idx++) {
                    int br = sym_read(&d->sym, d->cdf.coeff_br[brctx_sz][ptype][brctx], 4);
                    level += br;
                    if (br < 3) break;
                }
            }
            q[pos] = level;
        }
        /* signs, Golomb remainders and dequantization (7.12.3) */
        int pl = plane;
        int dqdenom = (wl + hl >= 11) ? 2 : (wl + hl >= 9 && wl >= 4 && hl >= 4) ? 1 : 0;
        for (int c = 0; c < eob; c++) {
            int pos;
            if (!one_d) pos = scan[c];
            else if (cls == TX_CLASS_VERT) pos = c;
            else pos = (c % th) * tw + c / th;
            int sign = 0;
            if (q[pos]) {
                if (c == 0) {
                    int dcs = 0;
                    for (int k = 0; k < w4; k++)
                        if (x4 + k < maxx4) {
                            int s = d->above_dc[plane][x4 + k];
                            dcs += s == 1 ? -1 : s == 2 ? 1 : 0;
                        }
                    for (int k = 0; k < h4; k++)
                        if (y4 + k < maxy4) {
                            int s = d->left_dc[plane][y4 + k];
                            dcs += s == 1 ? -1 : s == 2 ? 1 : 0;
                        }
                    int sctx = dcs < 0 ? 1 : dcs > 0 ? 2 : 0;
                    sign = sym_read(&d->sym, d->cdf.dc_sign[ptype][sctx], 2);
                } else {
                    sign = sym_literal(&d->sym, 1);
                }
            } else {
                continue;
            }
            uint32_t level = (uint32_t)q[pos];
            if (level > 14) level = read_golomb(&d->sym) + 15;
            if (pos == 0) dccat = sign ? 1 : 2;
            level &= 0xFFFFF;
            cul += (int)level;
            uint32_t dq = (level * (uint32_t)d->dq_b[pl][pos == 0 ? 0 : 1]) & 0xFFFFFF;
            dq >>= dqdenom;
            int v = sign ? -(int)(dq > 32768 ? 32768 : dq) : (int)(dq > 32767 ? 32767 : dq);
            q[pos] = v;
        }
        if (cul > 63) cul = 63;
    }
    for (int k = 0; k < w4; k++)
        if (x4 + k < maxx4 + 32) { d->above_level[plane][x4 + k] = (uint8_t)cul; d->above_dc[plane][x4 + k] = (uint8_t)dccat; }
    for (int k = 0; k < h4; k++)
        if (y4 + k < maxy4 + 32) { d->left_level[plane][y4 + k] = (uint8_t)cul; d->left_dc[plane][y4 + k] = (uint8_t)dccat; }
    return eob;
}

/* ------------------------------------------------------------ inverse transforms (7.13.2) */

/* A conforming stream keeps every intermediate value of the 1D transforms
 * within 16 bits (spec 7.13.2.1, r = 16 at 8 bits); dav1d saturates those
 * that leave it at points of its own SIMD code.  The port clamps them as
 * dav1d's C code does and counts them: a tile that leaves the range is
 * refused (E_RANGE). */
static __thread int tx_overflow;

static inline int clamp16(int v) {
    if (v < -32768 || v > 32767) {
        tx_overflow = 1;
        return v < 0 ? -32768 : 32767;
    }
    return v;
}
#define CLAMP16(v) clamp16(v)

static inline int btf(int w0, int in0, int w1, int in1) {
    int64_t v = ((int64_t)w0 * in0 + (int64_t)w1 * in1 + 2048) >> 12;
    if (v < -32768 || v > 32767) tx_overflow = 1;
    return (int)v;
}

static inline int cos128(int a) { return COS128[a]; }
static inline int sin128(int a) { return COS128[64 - a]; }

static int bitrev(int v, int bits) {
    int r = 0;
    for (int i = 0; i < bits; i++) r |= ((v >> i) & 1) << (bits - 1 - i);
    return r;
}

/* the inverse DCT of N = 1 << n points, in place, as the butterfly network
 * of the specification (libaom's av1_idctN): the even half is the DCT of
 * N / 2 points, the odd half a rotation of each input pair, then for each
 * group size g Hadamard butterflies and the rotations of the group's middle */
static void idct(int *x, int n) {
    int N = 1 << n, M = N >> 1;
    if (N == 2) {
        int a = x[0], b = x[1];
        x[0] = btf(2896, a, 2896, b);
        x[1] = btf(2896, a, -2896, b);
        return;
    }
    int e[32], o[32];
    for (int i = 0; i < M; i++) e[i] = x[2 * i];
    idct(e, n - 1);
    for (int k = 0; k < M; k++) o[k] = x[bitrev(M + k, n)];
    for (int k = 0; k < M / 2; k++) {
        int a = k, b = M - 1 - k;
        int ang = 64 - (64 / N) * bitrev(M + k, n);
        int xa = o[a], xb = o[b];
        o[a] = btf(cos128(ang), xa, -sin128(ang), xb);
        o[b] = btf(sin128(ang), xa, cos128(ang), xb);
    }
    for (int g = 2; g <= M / 2; g <<= 1) {
        for (int j = 0; j < M / g; j++)
            for (int t = 0; t < g / 2; t++) {
                int a = j * g + t, b = j * g + g - 1 - t;
                int xa = o[a], xb = o[b];
                if (j & 1) { o[a] = CLAMP16(xb - xa); o[b] = CLAMP16(xa + xb); }
                else { o[a] = CLAMP16(xa + xb); o[b] = CLAMP16(xa - xb); }
            }
        int G = 2 * g, groups = (M / 2) / G, gbits = 0;
        while ((1 << gbits) < groups) gbits++;
        for (int k = 0; k < M / 2; k++) {
            int r = k % G, j = k / G;
            if (r < G / 4 || r >= 3 * G / 4) continue;
            int th = (128 * g / N) * (1 + 4 * (gbits ? bitrev(j, gbits) : 0));
            int m = M - 1 - k, xk = o[k], xm = o[m];
            if (r < G / 2) {
                o[k] = btf(-cos128(th), xk, sin128(th), xm);
                o[m] = btf(sin128(th), xk, cos128(th), xm);
            } else {
                o[k] = btf(-sin128(th), xk, -cos128(th), xm);
                o[m] = btf(-cos128(th), xk, sin128(th), xm);
            }
        }
    }
    for (int i = 0; i < M; i++) {
        x[i] = CLAMP16(e[i] + o[M - 1 - i]);
        x[N - 1 - i] = CLAMP16(e[i] - o[M - 1 - i]);
    }
}

static void iadst4(int *t) {
    int s0 = SINPI_1_9 * t[0], s1 = SINPI_2_9 * t[0], s2 = SINPI_3_9 * t[1], s3 = SINPI_4_9 * t[2];
    int s4 = SINPI_1_9 * t[2], s5 = SINPI_2_9 * t[3], s6 = SINPI_4_9 * t[3];
    int a7 = t[0] - t[2], b7 = a7 + t[3];
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = SINPI_3_9 * b7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    int x0 = s0 + s3, x1 = s1 + s3, x2 = s2, x3 = s0 + s1 - s3;
    t[0] = clamp16(round2(x0, 12));
    t[1] = clamp16(round2(x1, 12));
    t[2] = clamp16(round2(x2, 12));
    t[3] = clamp16(round2(x3, 12));
}

#define C(a) cos128(a)

/* the inverse ADST of 8 points (libaom's av1_iadst8) */
static void iadst8(int *x) {
    int b[8], c[8];
    b[0] = x[7]; b[1] = x[0]; b[2] = x[5]; b[3] = x[2]; b[4] = x[3]; b[5] = x[4]; b[6] = x[1]; b[7] = x[6];
    for (int k = 0; k < 4; k++) {
        int a = 4 + 16 * k;
        c[2 * k] = btf(C(a), b[2 * k], C(64 - a), b[2 * k + 1]);
        c[2 * k + 1] = btf(C(64 - a), b[2 * k], -C(a), b[2 * k + 1]);
    }
    for (int i = 0; i < 4; i++) { b[i] = CLAMP16(c[i] + c[i + 4]); b[i + 4] = CLAMP16(c[i] - c[i + 4]); }
    c[0] = b[0]; c[1] = b[1]; c[2] = b[2]; c[3] = b[3];
    c[4] = btf(C(16), b[4], C(48), b[5]);
    c[5] = btf(C(48), b[4], -C(16), b[5]);
    c[6] = btf(-C(48), b[6], C(16), b[7]);
    c[7] = btf(C(16), b[6], C(48), b[7]);
    b[0] = CLAMP16(c[0] + c[2]); b[1] = CLAMP16(c[1] + c[3]); b[2] = CLAMP16(c[0] - c[2]); b[3] = CLAMP16(c[1] - c[3]);
    b[4] = CLAMP16(c[4] + c[6]); b[5] = CLAMP16(c[5] + c[7]); b[6] = CLAMP16(c[4] - c[6]); b[7] = CLAMP16(c[5] - c[7]);
    c[0] = b[0]; c[1] = b[1]; c[4] = b[4]; c[5] = b[5];
    c[2] = btf(C(32), b[2], C(32), b[3]);
    c[3] = btf(C(32), b[2], -C(32), b[3]);
    c[6] = btf(C(32), b[6], C(32), b[7]);
    c[7] = btf(C(32), b[6], -C(32), b[7]);
    x[0] = c[0]; x[1] = -c[4]; x[2] = c[6]; x[3] = -c[2]; x[4] = c[3]; x[5] = -c[7]; x[6] = c[5]; x[7] = -c[1];
}

/* the inverse ADST of 16 points (libaom's av1_iadst16) */
static void iadst16(int *x) {
    int b[16], c[16];
    for (int k = 0; k < 8; k++) { b[2 * k] = x[15 - 2 * k]; b[2 * k + 1] = x[2 * k]; }
    for (int k = 0; k < 8; k++) {
        int a = 2 + 8 * k;
        c[2 * k] = btf(C(a), b[2 * k], C(64 - a), b[2 * k + 1]);
        c[2 * k + 1] = btf(C(64 - a), b[2 * k], -C(a), b[2 * k + 1]);
    }
    for (int i = 0; i < 8; i++) { b[i] = CLAMP16(c[i] + c[i + 8]); b[i + 8] = CLAMP16(c[i] - c[i + 8]); }
    for (int i = 0; i < 8; i++) c[i] = b[i];
    c[8] = btf(C(8), b[8], C(56), b[9]);
    c[9] = btf(C(56), b[8], -C(8), b[9]);
    c[10] = btf(C(40), b[10], C(24), b[11]);
    c[11] = btf(C(24), b[10], -C(40), b[11]);
    c[12] = btf(-C(56), b[12], C(8), b[13]);
    c[13] = btf(C(8), b[12], C(56), b[13]);
    c[14] = btf(-C(24), b[14], C(40), b[15]);
    c[15] = btf(C(40), b[14], C(24), b[15]);
    for (int h = 0; h < 16; h += 8)
        for (int i = 0; i < 4; i++) { b[h + i] = CLAMP16(c[h + i] + c[h + i + 4]); b[h + i + 4] = CLAMP16(c[h + i] - c[h + i + 4]); }
    for (int h = 0; h < 16; h += 8) {
        c[h + 0] = b[h + 0]; c[h + 1] = b[h + 1]; c[h + 2] = b[h + 2]; c[h + 3] = b[h + 3];
        c[h + 4] = btf(C(16), b[h + 4], C(48), b[h + 5]);
        c[h + 5] = btf(C(48), b[h + 4], -C(16), b[h + 5]);
        c[h + 6] = btf(-C(48), b[h + 6], C(16), b[h + 7]);
        c[h + 7] = btf(C(16), b[h + 6], C(48), b[h + 7]);
    }
    for (int h = 0; h < 16; h += 4) {
        b[h + 0] = CLAMP16(c[h + 0] + c[h + 2]); b[h + 1] = CLAMP16(c[h + 1] + c[h + 3]);
        b[h + 2] = CLAMP16(c[h + 0] - c[h + 2]); b[h + 3] = CLAMP16(c[h + 1] - c[h + 3]);
    }
    for (int h = 0; h < 16; h += 4) {
        c[h + 0] = b[h + 0]; c[h + 1] = b[h + 1];
        c[h + 2] = btf(C(32), b[h + 2], C(32), b[h + 3]);
        c[h + 3] = btf(C(32), b[h + 2], -C(32), b[h + 3]);
    }
    x[0] = c[0]; x[1] = -c[8]; x[2] = c[12]; x[3] = -c[4]; x[4] = c[6]; x[5] = -c[14]; x[6] = c[10]; x[7] = -c[2];
    x[8] = c[3]; x[9] = -c[11]; x[10] = c[15]; x[11] = -c[7]; x[12] = c[5]; x[13] = -c[13]; x[14] = c[9]; x[15] = -c[1];
}

static void iidentity(int *x, int n) {
    int N = 1 << n;
    for (int i = 0; i < N; i++) {
        if (n == 2) x[i] = clamp16(round2(x[i] * 5793, 12));
        else if (n == 3) x[i] = clamp16(x[i] * 2);
        else if (n == 4) x[i] = clamp16(round2(x[i] * 11586, 12));
        else x[i] = clamp16(x[i] * 4);
    }
}

static void itx1d(int *x, int n, int kind) {
    if (kind == T_IDENTITY) iidentity(x, n);
    else if (kind == T_ADST) { if (n == 2) iadst4(x); else if (n == 3) iadst8(x); else iadst16(x); }
    else idct(x, n);
}

/* exported for the tests: one 1D inverse transform of 1 << n points */
int vpt_av1_itx1d(int32_t *x, int n, int kind) {
    int t[64];
    for (int i = 0; i < (1 << n); i++) t[i] = x[i];
    itx1d(t, n, kind);
    for (int i = 0; i < (1 << n); i++) x[i] = t[i];
    return 0;
}

/* the inverse 4x4 Walsh-Hadamard transform of a lossless block (7.13.2.10) */
static void inverse_wht(int r[4][4]) {
    for (int pass = 0; pass < 2; pass++)
        for (int k = 0; k < 4; k++) {
            int t[4];
            for (int m = 0; m < 4; m++) t[m] = pass ? r[m][k] : r[k][m];
            int sh = pass ? 0 : 2;
            int a = t[0] >> sh, c = t[1] >> sh, dd = t[2] >> sh, b = t[3] >> sh;
            a += c;
            dd -= b;
            int e = (a - dd) >> 1;
            b = e - b;
            c = e - c;
            a -= b;
            dd += c;
            t[0] = a; t[1] = b; t[2] = c; t[3] = dd;
            for (int m = 0; m < 4; m++) {
                if (pass) r[m][k] = t[m];
                else r[k][m] = t[m];
            }
        }
}

/* the 2D inverse transform of d->quant (7.13.3) added to the prediction */
static void reconstruct(Dec *d, int plane, int sx, int sy, int txsz, int type) {
    uint8_t *p = d->plane[plane];
    int st = d->stride[plane];
    if (d->lossless) {
        int r[4][4];
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) r[i][j] = d->quant[i * 4 + j];
        inverse_wht(r);
        for (int i = 0; i < 4; i++)
            for (int j = 0; j < 4; j++) p[(sy + i) * st + sx + j] = (uint8_t)clip1(p[(sy + i) * st + sx + j] + r[i][j]);
        return;
    }
    int wl = TXW_LOG2[txsz], hl = TXH_LOG2[txsz], w = 1 << wl, h = 1 << hl;
    int tw = imin(w, 32), th = imin(h, 32);
    int row_kind = (type == IDTX || type == V_DCT) ? T_IDENTITY : (type == DCT_ADST || type == ADST_ADST) ? T_ADST : T_DCT;
    int col_kind = (type == IDTX || type == H_DCT) ? T_IDENTITY : (type == ADST_DCT || type == ADST_ADST) ? T_ADST : T_DCT;
    int rect = abs(wl - hl) == 1, shift = TX_ROW_SHIFT[txsz];
    static __thread int res[64 * 64];
    int t[64];
    tx_overflow = 0;
    for (int i = 0; i < h; i++) {
        if (i >= th) {
            memset(res + i * w, 0, sizeof(int) * (size_t)w);
            continue;
        }
        for (int j = 0; j < w; j++) {
            int v = j < tw ? d->quant[i * tw + j] : 0;
            if (rect) v = round2(v * 2896, 12);
            t[j] = v;
        }
        itx1d(t, wl, row_kind);
        for (int j = 0; j < w; j++) res[i * w + j] = clip3(-32768, 32767, round2(t[j], shift));
    }
    for (int j = 0; j < w; j++) {
        for (int i = 0; i < h; i++) t[i] = res[i * w + j];
        itx1d(t, hl, col_kind);
        for (int i = 0; i < h; i++) res[i * w + j] = round2(t[i], 4);
    }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) p[(sy + i) * st + sx + j] = (uint8_t)clip1(p[(sy + i) * st + sx + j] + res[i * w + j]);
    if (tx_overflow) d->err = E_RANGE;
}

/* ------------------------------------------------------------ blocks (5.11.5 on) */

static void transform_block(Dec *d, int plane, int basex, int basey, int txsz, int x, int y) {
    int sx = basex + 4 * x, sy = basey + 4 * y;
    int subx = plane ? d->ssx : 0, suby = plane ? d->ssy : 0;
    int row = (sy << suby) >> 2, col = (sx << subx) >> 2;
    int mask = d->sb128 ? 31 : 15;
    int sbr = row & mask, sbc = col & mask;
    int wl = TXW_LOG2[txsz], hl = TXH_LOG2[txsz], stepx = 1 << (wl - 2), stepy = 1 << (hl - 2);
    int maxx = (d->mi_cols * 4) >> subx, maxy = (d->mi_rows * 4) >> suby;
    if (sx >= maxx || sy >= maxy) return;
    int pal = plane == 0 ? d->pal_y : d->pal_uv;
    if (pal) {
        const uint8_t *colors = plane == 0 ? d->colors_y : plane == 1 ? d->colors_u : d->colors_v;
        uint8_t (*map)[64] = plane == 0 ? d->map_y : d->map_uv;
        for (int i = 0; i < (1 << hl); i++)
            for (int j = 0; j < (1 << wl); j++)
                d->plane[plane][(sy + i) * d->stride[plane] + sx + j] = colors[map[y * 4 + i][x * 4 + j]];
    } else {
        int cfl = plane > 0 && d->uv_mode_b == UV_CFL_PRED;
        int mode = plane == 0 ? d->y_mode_b : cfl ? DC_PRED : d->uv_mode_b;
        int have_left = (plane == 0 ? d->avail_l : d->avail_l_chroma) || x > 0;
        int have_above = (plane == 0 ? d->avail_u : d->avail_u_chroma) || y > 0;
        int have_above_rt = d->decoded[plane][(sbr >> suby) - 1 + 1][(sbc >> subx) + stepx + 1];
        int have_below_lt = d->decoded[plane][(sbr >> suby) + stepy + 1][(sbc >> subx) - 1 + 1];
        predict_intra(d, plane, sx, sy, have_left, have_above, have_above_rt, have_below_lt, mode, wl, hl);
        if (cfl) predict_cfl(d, plane, sx, sy, wl, hl);
    }
    if (plane == 0) {
        d->max_luma_w = sx + stepx * 4;
        d->max_luma_h = sy + stepy * 4;
    }
    if (!d->skip_flag) {
        int type = DCT_DCT;
        int eob = coeffs(d, plane, sx, sy, txsz, &type);
        if (d->err) return;
        if (eob > 0) reconstruct(d, plane, sx, sy, txsz, type);
    }
    for (int i = 0; i < stepy; i++)
        for (int j = 0; j < stepx; j++) {
            d->lf_tx[plane][((row >> suby) + i) * d->mi_stride + (col >> subx) + j] = (uint8_t)txsz;
            d->decoded[plane][(sbr >> suby) + i + 1][(sbc >> subx) + j + 1] = 1;
        }
}

static void residual(Dec *d) {
    int bw = 4 << BW_LOG2[d->mi_size], bh = 4 << BH_LOG2[d->mi_size];
    int wchunks = bw >> 6 > 1 ? bw >> 6 : 1, hchunks = bh >> 6 > 1 ? bh >> 6 : 1;
    for (int cy = 0; cy < hchunks; cy++)
        for (int cx = 0; cx < wchunks; cx++)
            for (int plane = 0; plane < 1 + d->has_chroma * 2; plane++) {
                int subx = plane ? d->ssx : 0, suby = plane ? d->ssy : 0;
                int txsz = plane_tx_size(d, plane);
                int stepx = 1 << (TXW_LOG2[txsz] - 2), stepy = 1 << (TXH_LOG2[txsz] - 2);
                int psz = plane_size(d, d->mi_size, plane);
                int n4w = 1 << BW_LOG2[psz], n4h = 1 << BH_LOG2[psz];
                int basex = (d->mi_col >> subx) * 4, basey = (d->mi_row >> suby) * 4;
                int lim_h = n4h < (16 >> suby) ? n4h : (16 >> suby);
                int lim_w = n4w < (16 >> subx) ? n4w : (16 >> subx);
                for (int y = 0; y < lim_h; y += stepy)
                    for (int x = 0; x < lim_w; x += stepx) {
                        transform_block(d, plane, basex, basey, txsz, x + ((cx << 4) >> subx), y + ((cy << 4) >> suby));
                        if (d->err) return;
                    }
            }
}

static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
        if (diff <= 2 * ref) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
        return diff;
    }
    if (diff <= 2 * (max - ref - 1)) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return max - (diff + 1);
}

static void read_segment_id(Dec *d) {
    int r = d->mi_row, c = d->mi_col;
    int ul = (d->avail_u && d->avail_l) ? d->seg_id[mi_idx(d, r - 1, c - 1)] : -1;
    int u = d->avail_u ? d->seg_id[mi_idx(d, r - 1, c)] : -1;
    int l = d->avail_l ? d->seg_id[mi_idx(d, r, c - 1)] : -1;
    int pred = u == -1 ? (l == -1 ? 0 : l) : l == -1 ? u : (ul == u ? u : l);
    if (d->skip_flag) {
        d->segment = pred;
        return;
    }
    int ctx = (ul < 0 || u < 0 || l < 0) ? 0 : (ul == u && ul == l) ? 2 : (ul == u || ul == l || u == l) ? 1 : 0;
    int v = sym_read(&d->sym, d->cdf.segment_id[ctx], 8);
    d->segment = clip3(0, d->last_active_seg, neg_deinterleave(v, pred, d->last_active_seg + 1));
}

static void intra_segment_id(Dec *d) {
    if (d->seg_enabled) read_segment_id(d);
    else d->segment = 0;
}

static int ceil_log2(int x) {
    if (x < 2) return 0;
    int i = 1, p = 2;
    while (p < x) { i++; p <<= 1; }
    return i;
}

static int palette_cache(Dec *d, int plane, uint8_t *cache) {
    int r = d->mi_row, c = d->mi_col, an = 0, ln = 0;
    if (((r * 4) % 64) && d->avail_u) an = d->pal_size[plane][mi_idx(d, r - 1, c)];
    if (d->avail_l) ln = d->pal_size[plane][mi_idx(d, r, c - 1)];
    const uint8_t *ac = an ? d->pal_colors[plane] + 8 * mi_idx(d, r - 1, c) : NULL;
    const uint8_t *lc = ln ? d->pal_colors[plane] + 8 * mi_idx(d, r, c - 1) : NULL;
    int ai = 0, li = 0, n = 0;
    while (ai < an && li < ln) {
        int a = ac[ai], l = lc[li];
        if (l < a) {
            if (n == 0 || l != cache[n - 1]) cache[n++] = (uint8_t)l;
            li++;
        } else {
            if (n == 0 || a != cache[n - 1]) cache[n++] = (uint8_t)a;
            ai++;
            if (l == a) li++;
        }
    }
    while (ai < an) {
        int v = ac[ai++];
        if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v;
    }
    while (li < ln) {
        int v = lc[li++];
        if (n == 0 || v != cache[n - 1]) cache[n++] = (uint8_t)v;
    }
    return n;
}

static void sort_colors(uint8_t *c, int n) {
    for (int i = 1; i < n; i++)
        for (int j = i; j > 0 && c[j - 1] > c[j]; j--) {
            uint8_t t = c[j];
            c[j] = c[j - 1];
            c[j - 1] = t;
        }
}

static void palette_mode_info(Dec *d) {
    int r = d->mi_row, c = d->mi_col;
    int bctx = BW_LOG2[d->mi_size] + BH_LOG2[d->mi_size] - 2;
    uint8_t cache[16];
    if (d->y_mode_b == DC_PRED) {
        int ctx = (d->avail_u && d->pal_size[0][mi_idx(d, r - 1, c)] > 0) +
                  (d->avail_l && d->pal_size[0][mi_idx(d, r, c - 1)] > 0);
        if (sym_read(&d->sym, d->cdf.palette_y_mode[bctx][ctx], 2)) {
            d->pal_y = sym_read(&d->sym, d->cdf.palette_y_size[bctx], 7) + 2;
            int n = palette_cache(d, 0, cache), idx = 0;
            for (int i = 0; i < n && idx < d->pal_y; i++)
                if (sym_literal(&d->sym, 1)) d->colors_y[idx++] = cache[i];
            if (idx < d->pal_y) d->colors_y[idx++] = (uint8_t)sym_literal(&d->sym, 8);
            int bits = 0;
            if (idx < d->pal_y) bits = 8 - 3 + sym_literal(&d->sym, 2);
            while (idx < d->pal_y) {
                int delta = sym_literal(&d->sym, bits) + 1;
                d->colors_y[idx] = (uint8_t)clip1(d->colors_y[idx - 1] + delta);
                int range = 256 - d->colors_y[idx] - 1;
                int cl = ceil_log2(range);
                bits = bits < cl ? bits : cl;
                idx++;
            }
            sort_colors(d->colors_y, d->pal_y);
        }
    }
    if (d->has_chroma && d->uv_mode_b == DC_PRED) {
        if (sym_read(&d->sym, d->cdf.palette_uv_mode[d->pal_y > 0], 2)) {
            d->pal_uv = sym_read(&d->sym, d->cdf.palette_uv_size[bctx], 7) + 2;
            int n = palette_cache(d, 1, cache), idx = 0;
            for (int i = 0; i < n && idx < d->pal_uv; i++)
                if (sym_literal(&d->sym, 1)) d->colors_u[idx++] = cache[i];
            if (idx < d->pal_uv) d->colors_u[idx++] = (uint8_t)sym_literal(&d->sym, 8);
            int bits = 0;
            if (idx < d->pal_uv) bits = 8 - 3 + sym_literal(&d->sym, 2);
            while (idx < d->pal_uv) {
                int delta = sym_literal(&d->sym, bits);
                d->colors_u[idx] = (uint8_t)clip1(d->colors_u[idx - 1] + delta);
                int range = 256 - d->colors_u[idx];
                int cl = ceil_log2(range);
                bits = bits < cl ? bits : cl;
                idx++;
            }
            sort_colors(d->colors_u, d->pal_uv);
            if (sym_literal(&d->sym, 1)) {
                int minbits = 8 - 4, maxval = 256;
                int vbits = minbits + sym_literal(&d->sym, 2);
                d->colors_v[0] = (uint8_t)sym_literal(&d->sym, 8);
                for (idx = 1; idx < d->pal_uv; idx++) {
                    int delta = sym_literal(&d->sym, vbits);
                    if (delta && sym_literal(&d->sym, 1)) delta = -delta;
                    int val = d->colors_v[idx - 1] + delta;
                    if (val < 0) val += maxval;
                    if (val >= maxval) val -= maxval;
                    d->colors_v[idx] = (uint8_t)clip1(val);
                }
            } else {
                for (idx = 0; idx < d->pal_uv; idx++) d->colors_v[idx] = (uint8_t)sym_literal(&d->sym, 8);
            }
        }
    }
}

static void color_map(Dec *d, uint8_t (*map)[64], int n, int plane, int bw, int bh, int onw, int onh) {
    map[0][0] = (uint8_t)sym_ns(&d->sym, n);
    for (int i = 1; i < onh + onw - 1; i++) {
        int jmax = i < onw - 1 ? i : onw - 1, jmin = i - onh + 1 > 0 ? i - onh + 1 : 0;
        for (int j = jmax; j >= jmin; j--) {
            int r = i - j, c = j;
            int scores[8] = {0}, order[8];
            for (int k = 0; k < 8; k++) order[k] = k;
            if (c > 0) scores[map[r][c - 1]] += 2;
            if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
            if (r > 0) scores[map[r - 1][c]] += 2;
            for (int k = 0; k < 3; k++) {
                int maxs = scores[k], maxi = k;
                for (int l = k + 1; l < n; l++)
                    if (scores[l] > maxs) { maxs = scores[l]; maxi = l; }
                if (maxi != k) {
                    maxs = scores[maxi];
                    int mo = order[maxi];
                    for (int l = maxi; l > k; l--) { scores[l] = scores[l - 1]; order[l] = order[l - 1]; }
                    scores[k] = maxs;
                    order[k] = mo;
                }
            }
            int hash = 0;
            for (int k = 0; k < 3; k++) hash += scores[k] * PALETTE_HASH_MUL[k];
            int ctx = PALETTE_COLOR_CONTEXT[hash];
            int idx = sym_read(&d->sym, d->cdf.color_index[plane][n - 2][ctx], n);
            map[r][c] = (uint8_t)order[idx];
        }
    }
    for (int i = 0; i < onh; i++)
        for (int j = onw; j < bw; j++) map[i][j] = map[i][onw - 1];
    for (int i = onh; i < bh; i++)
        for (int j = 0; j < bw; j++) map[i][j] = map[onh - 1][j];
}

static void palette_tokens(Dec *d) {
    int bw = 4 << BW_LOG2[d->mi_size], bh = 4 << BH_LOG2[d->mi_size];
    int onh = (d->mi_rows - d->mi_row) * 4, onw = (d->mi_cols - d->mi_col) * 4;
    if (onh > bh) onh = bh;
    if (onw > bw) onw = bw;
    if (d->pal_y) color_map(d, d->map_y, d->pal_y, 0, bw, bh, onw, onh);
    if (d->pal_uv) {
        bw >>= d->ssx; bh >>= d->ssy; onw >>= d->ssx; onh >>= d->ssy;
        if (bw < 4) { bw += 2; onw += 2; }
        if (bh < 4) { bh += 2; onh += 2; }
        color_map(d, d->map_uv, d->pal_uv, 1, bw, bh, onw, onh);
    }
}


/* read_block_tx_size for an intra block */
static void read_tx_size(Dec *d) {
    int bsize = d->mi_size;
    if (d->lossless) {
        d->tx_size_b = TX_4X4;
        return;
    }
    int t = max_tx_rect(bsize);
    d->tx_size_b = t;
    if (bsize == BLOCK_4X4 || !d->tx_mode_select) return;
    int depth = 0;
    for (int s = t; s != TX_4X4; s = split_tx(s)) depth++;
    int maxw = 1 << TXW_LOG2[t], maxh = 1 << TXH_LOG2[t];
    int r = d->mi_row, c = d->mi_col;
    int above_w = d->avail_u ? 1 << TXW_LOG2[d->tx_size[mi_idx(d, r - 1, c)]] : 0;
    int left_h = d->avail_l ? 1 << TXH_LOG2[d->tx_size[mi_idx(d, r, c - 1)]] : 0;
    int ctx = (above_w >= maxw) + (left_h >= maxh);
    int v;
    if (depth >= 4) v = sym_read(&d->sym, d->cdf.tx_64x64[ctx], 3);
    else if (depth == 3) v = sym_read(&d->sym, d->cdf.tx_32x32[ctx], 3);
    else if (depth == 2) v = sym_read(&d->sym, d->cdf.tx_16x16[ctx], 3);
    else v = sym_read(&d->sym, d->cdf.tx_8x8[ctx], 2);
    for (int i = 0; i < v; i++) d->tx_size_b = split_tx(d->tx_size_b);
}

/* a delta_q_abs / delta_lf_abs and its remainder, sign and all */
static int read_delta(Dec *d, uint16_t *cdf) {
    int a = sym_read(&d->sym, cdf, 4);
    if (a == 3) {
        int n = sym_literal(&d->sym, 3) + 1;
        a = sym_literal(&d->sym, n) + (1 << n) + 1;
    }
    if (a && sym_literal(&d->sym, 1)) a = -a;
    return a;
}

/* read_delta_qindex, read_delta_lf, then the block's quantizers (get_qidx) */
static void read_deltas(Dec *d) {
    int sbsize = d->sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (d->read_deltas && !(d->mi_size == sbsize && d->skip_flag)) {
        int v = read_delta(d, d->cdf.delta_q);
        if (v) d->cur_qidx = clip3(1, 255, d->cur_qidx + v * (1 << d->delta_q_res));
        if (d->delta_lf_present) {
            v = read_delta(d, d->cdf.delta_lf);
            if (v) d->delta_lf = clip3(-63, 63, d->delta_lf + v * (1 << d->delta_lf_res));
        }
    }
    d->read_deltas = 0;
    int q = d->delta_q_present ? d->cur_qidx : d->base_q;
    const int *dl = d->dl;
    d->dq_b[0][0] = DC_QLOOKUP[clip3(0, 255, q + dl[0])];
    d->dq_b[0][1] = AC_QLOOKUP[q];
    d->dq_b[1][0] = DC_QLOOKUP[clip3(0, 255, q + dl[1])];
    d->dq_b[1][1] = AC_QLOOKUP[clip3(0, 255, q + dl[2])];
    d->dq_b[2][0] = DC_QLOOKUP[clip3(0, 255, q + dl[3])];
    d->dq_b[2][1] = AC_QLOOKUP[clip3(0, 255, q + dl[4])];
}

static void decode_block(Dec *d, int r, int c, int bsize) {
    d->mi_row = r;
    d->mi_col = c;
    d->mi_size = bsize;
    int bw4 = 1 << BW_LOG2[bsize], bh4 = 1 << BH_LOG2[bsize];
    if (bh4 == 1 && d->ssy && (r & 1) == 0) d->has_chroma = 0;
    else if (bw4 == 1 && d->ssx && (c & 1) == 0) d->has_chroma = 0;
    else d->has_chroma = d->planes > 1;
    d->avail_u = is_inside(d, r - 1, c);
    d->avail_l = is_inside(d, r, c - 1);
    d->avail_u_chroma = d->avail_u;
    d->avail_l_chroma = d->avail_l;
    if (d->has_chroma) {
        if (d->ssy && bh4 == 1) d->avail_u_chroma = is_inside(d, r - 2, c);
        if (d->ssx && bw4 == 1) d->avail_l_chroma = is_inside(d, r, c - 2);
    } else {
        d->avail_u_chroma = d->avail_l_chroma = 0;
    }
    /* intra_frame_mode_info */
    if (d->seg_pre_skip) intra_segment_id(d);
    if (d->seg_pre_skip && d->seg_skip[d->segment]) {
        d->skip_flag = 1;
    } else {
        int ctx = (d->avail_u ? d->skip[mi_idx(d, r - 1, c)] : 0) + (d->avail_l ? d->skip[mi_idx(d, r, c - 1)] : 0);
        d->skip_flag = sym_read(&d->sym, d->cdf.skip[ctx], 2);
    }
    if (!d->seg_pre_skip) intra_segment_id(d);
    read_deltas(d);
    int above = d->avail_u ? d->y_mode[mi_idx(d, r - 1, c)] : DC_PRED;
    int left = d->avail_l ? d->y_mode[mi_idx(d, r, c - 1)] : DC_PRED;
    d->y_mode_b = sym_read(&d->sym, d->cdf.kf_y_mode[INTRA_MODE_CONTEXT[above]][INTRA_MODE_CONTEXT[left]], 13);
    d->angle_y = 0;
    if (bsize >= BLOCK_8X8 && d->y_mode_b >= V_PRED && d->y_mode_b <= D67_PRED)
        d->angle_y = sym_read(&d->sym, d->cdf.angle_delta[d->y_mode_b - V_PRED], 7) - 3;
    d->uv_mode_b = DC_PRED;
    d->angle_uv = 0;
    d->cfl_u = d->cfl_v = 0;
    if (d->has_chroma) {
        int csz = plane_size(d, bsize, 1);
        int cfl_allowed = d->lossless ? (csz == BLOCK_4X4)
                                        : (BW_LOG2[bsize] <= 3 && BH_LOG2[bsize] <= 3);
        if (cfl_allowed)
            d->uv_mode_b = sym_read(&d->sym, d->cdf.uv_mode_cfl_allowed[d->y_mode_b], 14);
        else
            d->uv_mode_b = sym_read(&d->sym, d->cdf.uv_mode_cfl_not_allowed[d->y_mode_b], 13);
        if (d->uv_mode_b == UV_CFL_PRED) {
            int signs = sym_read(&d->sym, d->cdf.cfl_sign, 8);
            int su = (signs + 1) / 3, sv = (signs + 1) % 3;
            if (su) {
                d->cfl_u = 1 + sym_read(&d->sym, d->cdf.cfl_alpha[(su - 1) * 3 + sv], 16);
                if (su == 1) d->cfl_u = -d->cfl_u;
            }
            if (sv) {
                d->cfl_v = 1 + sym_read(&d->sym, d->cdf.cfl_alpha[(sv - 1) * 3 + su], 16);
                if (sv == 1) d->cfl_v = -d->cfl_v;
            }
        }
        if (bsize >= BLOCK_8X8 && d->uv_mode_b >= V_PRED && d->uv_mode_b <= D67_PRED)
            d->angle_uv = sym_read(&d->sym, d->cdf.angle_delta[d->uv_mode_b - V_PRED], 7) - 3;
    }
    d->pal_y = d->pal_uv = 0;
    if (bsize >= BLOCK_8X8 && BW_LOG2[bsize] <= 4 && BH_LOG2[bsize] <= 4 && d->screen_content) palette_mode_info(d);
    d->use_filter = 0;
    if (d->filter_intra && d->y_mode_b == DC_PRED && d->pal_y == 0 && BW_LOG2[bsize] <= 3 && BH_LOG2[bsize] <= 3) {
        d->use_filter = sym_read(&d->sym, d->cdf.use_filter_intra[bsize], 2);
        if (d->use_filter) d->filter_mode = sym_read(&d->sym, d->cdf.filter_intra_mode, 5);
    }
    palette_tokens(d);
    read_tx_size(d);
    if (d->skip_flag) {
        for (int plane = 0; plane < 1 + 2 * d->has_chroma; plane++) {
            int subx = plane ? d->ssx : 0, suby = plane ? d->ssy : 0;
            for (int i = c >> subx; i < ((c + bw4 - 1) >> subx) + 1; i++) d->above_level[plane][i] = d->above_dc[plane][i] = 0;
            for (int i = r >> suby; i < ((r + bh4 - 1) >> suby) + 1; i++) d->left_level[plane][i] = d->left_dc[plane][i] = 0;
        }
    }
    for (int y = 0; y < bh4; y++)
        for (int x = 0; x < bw4; x++) {
            int k = mi_idx(d, r + y, c + x);
            d->y_mode[k] = (uint8_t)d->y_mode_b;
            if (d->has_chroma) d->uv_mode[k] = (uint8_t)d->uv_mode_b;
            d->seg_id[k] = (uint8_t)d->segment;
            d->mi_sizes[k] = (uint8_t)bsize;
            d->tx_size[k] = (uint8_t)d->tx_size_b;
            d->delta_lfs[k] = (int8_t)d->delta_lf;
            d->skip[k] = (uint8_t)d->skip_flag;
            d->pal_size[0][k] = (uint8_t)d->pal_y;
            d->pal_size[1][k] = (uint8_t)d->pal_uv;
            memcpy(d->pal_colors[0] + 8 * k, d->colors_y, 8);
            memcpy(d->pal_colors[1] + 8 * k, d->colors_u, 8);
        }
    residual(d);
}

static int subsize(int partition, int bsize) {
    int w = BW_LOG2[bsize], h = BH_LOG2[bsize];
    switch (partition) {
    case PARTITION_NONE: return bsize;
    case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B: return bsize_of(w, h - 1);
    case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B: return bsize_of(w - 1, h);
    case PARTITION_SPLIT: return bsize_of(w - 1, h - 1);
    case PARTITION_HORZ_4: return bsize_of(w, h - 2);
    default: return bsize_of(w - 2, h);
    }
}

static void decode_partition(Dec *d, int r, int c, int bsize) {
    if (r >= d->mi_rows || c >= d->mi_cols || d->err) return;
    int avail_u = is_inside(d, r - 1, c), avail_l = is_inside(d, r, c - 1);
    int n4 = 1 << BW_LOG2[bsize], half = n4 >> 1, quarter = half >> 1;
    int has_rows = (r + half) < d->mi_rows, has_cols = (c + half) < d->mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
        partition = PARTITION_NONE;
    } else {
        int bsl = BW_LOG2[bsize];
        int above = avail_u && BW_LOG2[d->mi_sizes[mi_idx(d, r - 1, c)]] < bsl;
        int left = avail_l && BH_LOG2[d->mi_sizes[mi_idx(d, r, c - 1)]] < bsl;
        uint16_t *cdf = d->cdf.partition[(bsl - 1) * 4 + left * 2 + above];
        int n = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
        if (has_rows && has_cols) {
            partition = sym_read(&d->sym, cdf, n);
        } else if (has_cols || has_rows) {
            /* split_or_horz / split_or_vert: the probability of the partitions that split that way */
            static const int horz[6] = {PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_VERT_A,
                                        PARTITION_VERT_B, PARTITION_VERT_4};
            static const int vert[6] = {PARTITION_HORZ, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B,
                                        PARTITION_VERT_A, PARTITION_HORZ_4};
            const int *set = has_cols ? horz : vert;
            int psum = 0;
            for (int k = 0; k < 6; k++) {
                int p = set[k];
                if (p >= n || (p >= PARTITION_HORZ_4 && bsize == BLOCK_128X128)) continue;
                psum += cdf[p] - (p > 0 ? cdf[p - 1] : 0);
            }
            uint16_t bcdf[3] = {(uint16_t)((1 << 15) - psum), 1 << 15, 0};
            int split = sym_read_fixed(&d->sym, bcdf, 2);
            partition = split ? PARTITION_SPLIT : has_cols ? PARTITION_HORZ : PARTITION_VERT;
        } else {
            partition = PARTITION_SPLIT;
        }
    }
    int sub = subsize(partition, bsize), split = subsize(PARTITION_SPLIT, bsize);
    if (d->planes > 1 && d->ssx && !d->ssy &&
        (partition == PARTITION_VERT || partition == PARTITION_VERT_A || partition == PARTITION_VERT_B ||
         partition == PARTITION_VERT_4)) {
        d->err = E_DATA; /* dav1d refuses a vertical split of a 4:2:2 frame's block */
        return;
    }
    switch (partition) {
    case PARTITION_NONE: decode_block(d, r, c, sub); break;
    case PARTITION_HORZ:
        decode_block(d, r, c, sub);
        if (has_rows && !d->err) decode_block(d, r + half, c, sub);
        break;
    case PARTITION_VERT:
        decode_block(d, r, c, sub);
        if (has_cols && !d->err) decode_block(d, r, c + half, sub);
        break;
    case PARTITION_SPLIT:
        decode_partition(d, r, c, sub);
        decode_partition(d, r, c + half, sub);
        decode_partition(d, r + half, c, sub);
        decode_partition(d, r + half, c + half, sub);
        break;
    case PARTITION_HORZ_A:
        decode_block(d, r, c, split);
        decode_block(d, r, c + half, split);
        decode_block(d, r + half, c, sub);
        break;
    case PARTITION_HORZ_B:
        decode_block(d, r, c, sub);
        decode_block(d, r + half, c, split);
        decode_block(d, r + half, c + half, split);
        break;
    case PARTITION_VERT_A:
        decode_block(d, r, c, split);
        decode_block(d, r + half, c, split);
        decode_block(d, r, c + half, sub);
        break;
    case PARTITION_VERT_B:
        decode_block(d, r, c, sub);
        decode_block(d, r, c + half, split);
        decode_block(d, r + half, c + half, split);
        break;
    case PARTITION_HORZ_4:
        for (int k = 0; k < 4; k++)
            if (k < 3 || r + quarter * 3 < d->mi_rows) decode_block(d, r + quarter * k, c, sub);
        break;
    default:
        for (int k = 0; k < 4; k++)
            if (k < 3 || c + quarter * 3 < d->mi_cols) decode_block(d, r, c + quarter * k, sub);
        break;
    }
}

static void clear_decoded(Dec *d, int r, int c, int sb4) {
    for (int plane = 0; plane < d->planes; plane++) {
        int subx = plane ? d->ssx : 0, suby = plane ? d->ssy : 0;
        int sbw4 = (d->col_end - c) >> subx, sbh4 = (d->row_end - r) >> suby;
        for (int y = -1; y <= (sb4 >> suby); y++)
            for (int x = -1; x <= (sb4 >> subx); x++) {
                int v;
                if (y < 0 && x < sbw4) v = 1;
                else if (x < 0 && y < sbh4) v = 1;
                else v = 0;
                d->decoded[plane][y + 1][x + 1] = (uint8_t)v;
            }
        d->decoded[plane][(sb4 >> suby) + 1][0] = 0;
    }
}


/* ------------------------------------------------------------ the deblocking filter (7.14) */

/* the filter level of the block at MI (row, col) for loop_filter_level[i] */
static int lf_level(const Dec *d, int row, int col, int i) {
    int lvl = clip3(0, 63, d->delta_lfs[mi_idx(d, row, col)] + d->lf_level[i]);
    if (d->lf_delta_enabled) lvl = clip3(0, 63, lvl + (d->lf_ref_delta_intra * (1 << (lvl >> 5))));
    return lvl;
}

static inline int sclamp(int t) { return t < -128 ? -128 : t > 127 ? 127 : t; }

/* filter4 of libaom / the specification's narrow filter */
static void filter4(uint8_t *s, ptrdiff_t step, int hev) {
    int ps1 = s[-2 * step] - 128, ps0 = s[-step] - 128, qs0 = s[0] - 128, qs1 = s[step] - 128;
    int f = hev ? sclamp(ps1 - qs1) : 0;
    f = sclamp(f + 3 * (qs0 - ps0));
    int f1 = sclamp(f + 4) >> 3, f2 = sclamp(f + 3) >> 3;
    s[0] = (uint8_t)(sclamp(qs0 - f1) + 128);
    s[-step] = (uint8_t)(sclamp(ps0 + f2) + 128);
    if (!hev) {
        f = (f1 + 1) >> 1;
        s[step] = (uint8_t)(sclamp(qs1 - f) + 128);
        s[-2 * step] = (uint8_t)(sclamp(ps1 + f) + 128);
    }
}

/* the wide filter of log2Size 3 (n = 3 luma, 2 chroma) or 4 (n = 6) */
static void wide_filter(uint8_t *s, ptrdiff_t step, int n, int log2size, int n2) {
    int f[14], out[12];
    for (int k = -(n + 1); k <= n; k++) f[k + 7] = s[k * step];
    for (int i = -n; i < n; i++) {
        int t = 0;
        for (int j = -n; j <= n; j++) {
            int p = clip3(-(n + 1), n, i + j);
            t += f[p + 7] * (abs(j) <= n2 ? 2 : 1);
        }
        out[i + 6] = round2(t, log2size);
    }
    for (int i = -n; i < n; i++) s[i * step] = (uint8_t)out[i + 6];
}

/* one sample position across an edge: s points at q0, step crosses the edge */
static void sample_filter(uint8_t *s, ptrdiff_t step, int size, int plane, int limit, int blimit, int thresh) {
#define P(k) ((int)s[-((k) + 1) * step])
#define Q(k) ((int)s[(k) * step])
    int hev = abs(P(1) - P(0)) > thresh || abs(Q(1) - Q(0)) > thresh;
    int mask = abs(P(1) - P(0)) <= limit && abs(Q(1) - Q(0)) <= limit &&
               abs(P(0) - Q(0)) * 2 + abs(P(1) - Q(1)) / 2 <= blimit;
    if (size == 4) {
        if (mask) filter4(s, step, hev);
        return;
    }
    if (plane) { /* 6 taps */
        mask = mask && abs(P(2) - P(1)) <= limit && abs(Q(2) - Q(1)) <= limit;
        if (!mask) return;
        int flat = abs(P(1) - P(0)) <= 1 && abs(Q(1) - Q(0)) <= 1 && abs(P(2) - P(0)) <= 1 && abs(Q(2) - Q(0)) <= 1;
        if (flat) wide_filter(s, step, 2, 3, 1);
        else filter4(s, step, hev);
        return;
    }
    mask = mask && abs(P(3) - P(2)) <= limit && abs(P(2) - P(1)) <= limit && abs(Q(2) - Q(1)) <= limit &&
           abs(Q(3) - Q(2)) <= limit;
    if (!mask) return;
    int flat = abs(P(1) - P(0)) <= 1 && abs(Q(1) - Q(0)) <= 1 && abs(P(2) - P(0)) <= 1 && abs(Q(2) - Q(0)) <= 1 &&
               abs(P(3) - P(0)) <= 1 && abs(Q(3) - Q(0)) <= 1;
    if (size == 16 && flat) {
        int flat2 = abs(P(4) - P(0)) <= 1 && abs(Q(4) - Q(0)) <= 1 && abs(P(5) - P(0)) <= 1 &&
                    abs(Q(5) - Q(0)) <= 1 && abs(P(6) - P(0)) <= 1 && abs(Q(6) - Q(0)) <= 1;
        if (flat2) {
            wide_filter(s, step, 6, 4, 1);
            return;
        }
    }
    if (flat) wide_filter(s, step, 3, 3, 0);
    else filter4(s, step, hev);
#undef P
#undef Q
}

static void edge_loop_filter(Dec *d, int plane, int pass, int row, int col) {
    int subx = plane ? d->ssx : 0, suby = plane ? d->ssy : 0;
    int dx = pass == 0, dy = pass == 1;
    int x = col * 4, y = row * 4;
    row |= suby;
    col |= subx;
    if (x >= d->width || y >= d->height || (pass == 0 && x == 0) || (pass == 1 && y == 0)) return;
    int xp = x >> subx, yp = y >> suby;
    int prow = row - (dy << suby), pcol = col - (dx << subx);
    int tx = d->lf_tx[plane][(row >> suby) * d->mi_stride + (col >> subx)];
    int ptx = d->lf_tx[plane][(prow >> suby) * d->mi_stride + (pcol >> subx)];
    /* every block of a key frame is intra: a transform edge is filtered */
    if (pass == 0 ? xp % (1 << TXW_LOG2[tx]) : yp % (1 << TXH_LOG2[tx])) return;
    int base = pass == 0 ? imin(1 << TXW_LOG2[ptx], 1 << TXW_LOG2[tx]) : imin(1 << TXH_LOG2[ptx], 1 << TXH_LOG2[tx]);
    int size = plane == 0 ? imin(16, base) : imin(8, base);
    int i = plane == 0 ? pass : plane + 1;
    int lvl = lf_level(d, row, col, i);
    if (!lvl) lvl = lf_level(d, prow, pcol, i);
    if (!lvl) return;
    int shift = d->lf_sharpness > 4 ? 2 : d->lf_sharpness > 0 ? 1 : 0;
    int limit = d->lf_sharpness > 0 ? clip3(1, 9 - d->lf_sharpness, lvl >> shift) : imax(1, lvl >> shift);
    int blimit = 2 * (lvl + 2) + limit, thresh = lvl >> 4;
    uint8_t *p = d->plane[plane];
    int st = d->stride[plane];
    for (int k = 0; k < 4; k++) {
        int sx = xp + dy * k, sy = yp + dx * k;
        sample_filter(p + (size_t)sy * st + sx, pass == 0 ? 1 : st, size, plane, limit, blimit, thresh);
    }
}

static void loop_filter(Dec *d) {
    if (!d->lf_level[0] && !d->lf_level[1]) return;
    for (int plane = 0; plane < d->planes; plane++) {
        if (plane && !d->lf_level[1 + plane]) continue;
        int rs = plane ? 1 << d->ssy : 1, cs = plane ? 1 << d->ssx : 1;
        for (int pass = 0; pass < 2; pass++)
            for (int row = 0; row < d->mi_rows; row += rs)
                for (int col = 0; col < d->mi_cols; col += cs) edge_loop_filter(d, plane, pass, row, col);
    }
}

/* prm: mi_rows, mi_cols, ssx, ssy, planes, sb128, enable_filter_intra,
 *      enable_intra_edge_filter, allow_screen_content_tools, disable_cdf_update,
 *      segmentation_enabled, seg_id_pre_skip, last_active_seg_id, then 8 SEG_LVL_SKIP flags (13-20);
 *      21 FrameWidth, 22 FrameHeight, 23 base_q_idx, 24 tx_mode_select, 25 reduced_tx_set,
 *      26-30 DeltaQYDc, DeltaQUDc, DeltaQUAc, DeltaQVDc, DeltaQVAc, 31-34 loop_filter_level[0..3],
 *      35 loop_filter_sharpness, 36 loop_filter_delta_enabled, 37 loop_filter_ref_deltas[INTRA_FRAME],
 *      38 delta_q_present, 39 delta_q_res, 40 delta_lf_present, 41 delta_lf_res;
 * tiles: per tile its byte offset and size in `data`, mi_row_start, mi_row_end,
 *        mi_col_start, mi_col_end;
 * y / u / v: planes of (mi_rows * 4) x (mi_cols * 4) samples, chroma subsampled. */
int vpt_av1_decode(const uint8_t *data, const int32_t *prm, const int64_t *tiles, int ntiles, uint8_t *y,
                   uint8_t *u, uint8_t *v) {
    Dec *d = calloc(1, sizeof(Dec));
    if (!d) return E_MEMORY;
    d->mi_rows = prm[0];
    d->mi_cols = prm[1];
    d->ssx = prm[2];
    d->ssy = prm[3];
    d->planes = prm[4];
    d->sb128 = prm[5];
    d->filter_intra = prm[6];
    d->edge_filter = prm[7];
    d->screen_content = prm[8];
    int no_update = prm[9];
    d->seg_enabled = prm[10];
    d->seg_pre_skip = prm[11];
    d->last_active_seg = prm[12];
    for (int k = 0; k < 8; k++) d->seg_skip[k] = prm[13 + k];
    d->width = prm[21];
    d->height = prm[22];
    int base_q = prm[23];
    d->qctx = base_q <= 20 ? 0 : base_q <= 60 ? 1 : base_q <= 120 ? 2 : 3;
    d->tx_mode_select = prm[24];
    d->reduced_tx_set = prm[25];
    d->base_q = base_q;
    for (int i = 0; i < 5; i++) d->dl[i] = prm[26 + i];
    d->lossless = base_q == 0 && !d->dl[0] && !d->dl[1] && !d->dl[2] && !d->dl[3] && !d->dl[4];
    for (int i = 0; i < 4; i++) d->lf_level[i] = prm[31 + i];
    d->lf_sharpness = prm[35];
    d->lf_delta_enabled = prm[36];
    d->lf_ref_delta_intra = prm[37];
    d->delta_q_present = prm[38];
    d->delta_q_res = prm[39];
    d->delta_lf_present = prm[40];
    d->delta_lf_res = prm[41];
    if (d->mi_rows <= 0 || d->mi_cols <= 0 || d->ssx < 0 || d->ssx > 1 || d->ssy < 0 || d->ssy > 1) {
        free(d);
        return E_PARAMS;
    }
    /* the planes as decoded, with room for the transform blocks that reach
     * past the last 4x4 column and row; copied to y / u / v at the end */
    int pw[3], ph[3];
    size_t psize = 0;
    for (int p = 0; p < 3; p++) {
        pw[p] = (d->mi_cols * 4) >> (p ? d->ssx : 0);
        ph[p] = (d->mi_rows * 4) >> (p ? d->ssy : 0);
        d->stride[p] = pw[p] + 80;
        psize += (size_t)d->stride[p] * (size_t)(ph[p] + 80);
    }
    uint8_t *pix = calloc(psize, 1);
    if (!pix) {
        free(d);
        return E_MEMORY;
    }
    d->plane[0] = pix;
    d->plane[1] = d->plane[0] + (size_t)d->stride[0] * (size_t)(ph[0] + 80);
    d->plane[2] = d->plane[1] + (size_t)d->stride[1] * (size_t)(ph[1] + 80);
    d->mi_stride = d->mi_cols + 32;
    int64_t nmi = (int64_t)(d->mi_rows + 32) * d->mi_stride;
    uint8_t *mem = calloc((size_t)nmi * (6 + 16 + 5 + 1) + (size_t)(d->mi_cols + d->mi_rows + 64) * 12, 1);
    uint16_t *scan_mem = malloc(sizeof(uint16_t) * 3344);
    if (!mem || !scan_mem) {
        free(mem);
        free(scan_mem);
        free(pix);
        free(d);
        return E_MEMORY;
    }
    make_scans(d, scan_mem);
    uint8_t *m = mem;
    d->y_mode = m; m += nmi;
    d->uv_mode = m; m += nmi;
    d->seg_id = m; m += nmi;
    d->skip = m; m += nmi;
    d->pal_size[0] = m; m += nmi;
    d->pal_size[1] = m; m += nmi;
    d->pal_colors[0] = m; m += nmi * 8;
    d->pal_colors[1] = m; m += nmi * 8;
    d->mi_sizes = m; m += nmi;
    d->tx_size = m; m += nmi;
    for (int p = 0; p < 3; p++) { d->lf_tx[p] = m; m += nmi; }
    d->delta_lfs = (int8_t *)m; m += nmi;
    for (int p = 0; p < 3; p++) {
        d->above_level[p] = m; m += d->mi_cols + 32;
        d->above_dc[p] = m; m += d->mi_cols + 32;
        d->left_level[p] = m; m += d->mi_rows + 32;
        d->left_dc[p] = m; m += d->mi_rows + 32;
    }
    int sb4 = d->sb128 ? 32 : 16, sbsize = d->sb128 ? BLOCK_128X128 : BLOCK_64X64;
    for (int t = 0; t < ntiles && !d->err; t++) {
        const int64_t *ti = tiles + 6 * t;
        d->row_start = (int)ti[2];
        d->row_end = (int)ti[3];
        d->col_start = (int)ti[4];
        d->col_end = (int)ti[5];
        if (ti[1] <= 0) {
            d->err = E_TILE;
            break;
        }
        sym_init(&d->sym, data + ti[0], ti[1], no_update);
        cdfs_default(&d->cdf, d->qctx);
        d->cur_qidx = base_q;
        d->delta_lf = 0;
        for (int p = 0; p < 3; p++) {
            memset(d->above_level[p], 0, d->mi_cols + 32);
            memset(d->above_dc[p], 0, d->mi_cols + 32);
        }
        for (int r = d->row_start; r < d->row_end && !d->err; r += sb4) {
            for (int p = 0; p < 3; p++) {
                memset(d->left_level[p], 0, d->mi_rows + 32);
                memset(d->left_dc[p], 0, d->mi_rows + 32);
            }
            for (int c = d->col_start; c < d->col_end && !d->err; c += sb4) {
                clear_decoded(d, r, c, sb4);
                d->read_deltas = d->delta_q_present;
                decode_partition(d, r, c, sbsize);
            }
            /* dav1d refuses a tile whose symbol decoder has read more than 14 bits past its end */
            if (!d->err && d->sym.maxbits < -14) d->err = E_OVERREAD;
        }
    }
    if (!d->err) loop_filter(d);
    uint8_t *out[3] = {y, u, v};
    for (int p = 0; p < d->planes; p++)
        for (int r = 0; r < ph[p]; r++) memcpy(out[p] + (size_t)r * pw[p], d->plane[p] + (size_t)r * d->stride[p], (size_t)pw[p]);
    int err = d->err;
    free(pix);
    free(scan_mem);
    free(mem);
    free(d);
    return err;
}

/* ------------------------------------------------------------ YUV -> RGB(A) as libavif converts for PIL */


/* libyuv's YuvConstants: UB, UG, VG, VR, YG, YB by kind (JPEG, I601, F709, H709, V2020) */
static const int YUV_K[5][6] = {
    {113, 22, 46, 90, 16320, 32},   {128, 25, 52, 102, 18997, -1160}, {119, 12, 30, 101, 16320, 32},
    {128, 14, 34, 115, 18997, -1160}, {120, 11, 37, 94, 16320, 32}};

static inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

/* libyuv's 2x chroma upsampling of one output row: `s` the nearer source
 * row, `t` the farther (equal to `s` where there is one row only, which
 * gives the horizontal 3:1 filter alone); the first and last output columns
 * take their source column alone. */
static void up_row(const uint8_t *s, const uint8_t *t, int w, int *out) {
    int n2 = (w - 1) & ~1;
    out[0] = (3 * s[0] + t[0] + 2) >> 2;
    for (int k = 0; 2 * k + 1 <= n2; k++) {
        out[2 * k + 1] = (9 * s[k] + 3 * s[k + 1] + 3 * t[k] + t[k + 1] + 8) >> 4;
        if (2 * k + 2 <= n2) out[2 * k + 2] = (3 * s[k] + 9 * s[k + 1] + t[k] + 3 * t[k + 1] + 8) >> 4;
    }
    int l = (w - 1) / 2;
    out[w - 1] = (3 * s[l] + t[l] + 2) >> 2;
}

static void copy_row(const uint8_t *s, int w, int *out) {
    for (int x = 0; x < w; x++) out[x] = s[x];
}

/* prm: width, height, chroma stride, ssx, ssy, mono, kind (0-5 libyuv's constants,
 * 6 identity, 7 gray), full range, channels (3 or 4), alpha premultiplied */
int vpt_avif_rgb(const uint8_t *y, const uint8_t *u, const uint8_t *v, const uint8_t *a, const int32_t *prm,
                 uint8_t *out) {
    int w = prm[0], h = prm[1], cs = prm[2], ssx = prm[3], ssy = prm[4], mono = prm[5], kind = prm[6];
    int full = prm[7], ch = prm[8], premul = prm[9];
    int *ur = malloc(sizeof(int) * (size_t)w * 2);
    if (!ur) return E_MEMORY;
    int *vr = ur + w;
    int ch_h = (h + ssy) >> ssy;
    for (int row = 0; row < h; row++) {
        /* the chroma of this row, upsampled as libyuv's I4xxToARGBMatrixFilter does */
        if (!mono) {
            if (!ssx && !ssy) {
                copy_row(u + (size_t)row * cs, w, ur);
                copy_row(v + (size_t)row * cs, w, vr);
            } else if (!ssy) {
                up_row(u + (size_t)row * cs, u + (size_t)row * cs, w, ur);
                up_row(v + (size_t)row * cs, v + (size_t)row * cs, w, vr);
            } else {
                int near, far;
                if (row == 0 || (row == h - 1 && !(h & 1))) {
                    near = far = row == 0 ? 0 : ch_h - 1;
                } else {
                    int j = (row - 1) >> 1;
                    near = (row & 1) ? j : j + 1;
                    far = (row & 1) ? j + 1 : j;
                }
                up_row(u + (size_t)near * cs, u + (size_t)far * cs, w, ur);
                up_row(v + (size_t)near * cs, v + (size_t)far * cs, w, vr);
            }
        }
        const uint8_t *yrow = y + (size_t)row * w;
        uint8_t *o = out + (size_t)row * w * ch;
        for (int x = 0; x < w; x++, o += ch) {
            int yy = yrow[x], uu = mono ? 128 : ur[x], vv = mono ? 128 : vr[x];
            if (kind < 5) {
                const int *k = YUV_K[kind];
                int y1 = (int)(((uint32_t)(yy * 0x0101) * (uint32_t)k[4]) >> 16);
                o[2] = clamp255((y1 + (uu - 128) * k[0] + k[5]) >> 6);
                o[1] = clamp255((y1 - (uu - 128) * k[1] - (vv - 128) * k[2] + k[5]) >> 6);
                o[0] = clamp255((y1 + (vv - 128) * k[3] + k[5]) >> 6);
            } else {
                /* libavif's own float path: gray (Y alone) or identity (G = Y, B = U, R = V) */
                float Y = full ? (float)yy / 255.0f : ((float)yy - 16.0f) / 219.0f, R = Y, G = Y, B = Y;
                if (kind == 6) {
                    B = full ? (float)uu / 255.0f : ((float)uu - 16.0f) / 219.0f;
                    R = full ? (float)vv / 255.0f : ((float)vv - 16.0f) / 219.0f;
                }
                R = R < 0.0f ? 0.0f : R > 1.0f ? 1.0f : R;
                G = G < 0.0f ? 0.0f : G > 1.0f ? 1.0f : G;
                B = B < 0.0f ? 0.0f : B > 1.0f ? 1.0f : B;
                o[0] = (uint8_t)floorf(R * 255.0f + 0.5f);
                o[1] = (uint8_t)floorf(G * 255.0f + 0.5f);
                o[2] = (uint8_t)floorf(B * 255.0f + 0.5f);
            }
            if (ch == 4) {
                int al = a[(size_t)row * w + x];
                o[3] = (uint8_t)al;
                if (premul && al != 255) {
                    /* libyuv's ARGBUnattenuate (its SIMD rows): 8.8 reciprocals (0xffff for
                     * alpha 1), the colour widened to 16 bits, the product's high word packed
                     * with signed saturation, so that a word of 32768 or more gives 0 */
                    uint32_t ia = al == 1 ? 0xffffu : al ? 0x10000u / (uint32_t)al : 0;
                    for (int c = 0; c < 3; c++) {
                        uint32_t f = o[c];
                        uint32_t r = ((f | (f << 8)) * ia) >> 16;
                        o[c] = (uint8_t)(r > 32767 ? 0 : r > 255 ? 255 : r);
                    }
                }
            }
        }
    }
    free(ur);
    return 0;
}
