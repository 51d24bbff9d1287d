/* The host hot loops of the port's image decoders: the PNG row unfilter and
 * the JPEG entropy decoder and inverse DCT.  Plain C with a C interface,
 * built with gcc into vpt_tpu_torch/build/ at first use and called through
 * ctypes (io/image.py, io/jpeg.py); the marker parsing, the PNG chunk walk,
 * upsampling and colour conversion stay in Python and numpy.
 *
 * Written from the specifications: the PNG specification (section 9, the
 * five row filters) and ITU-T T.81 (Annex C, Huffman tables; Annex F,
 * sequential decoding; Annex G, progressive decoding; A.3.3, the IDCT).  The
 * IDCT is the fixed-point "islow" algorithm whose constants and rounding
 * libjpeg-turbo's default decoder uses (13 fraction bits, 2 extra bits
 * between the passes, round-half-up descaling), so the samples equal those
 * of the libjpeg-turbo decoder behind PIL; a sample out of 0..255 saturates.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ PNG */

/* Filters 3 (average) and 4 (Paeth) need the decoded byte bpp bytes to the
 * left, so a row is a chain per byte lane.  A pixel's bpp lanes go through
 * the chain together, as 16-bit lanes of one vector (GCC vector extensions),
 * with the left and upper-left pixels in registers; Paeth picks without
 * branches, which noisy rows would mispredict.  bpp is a constant where
 * predicted_row is inlined. */
typedef int16_t lanes_t __attribute__((vector_size(16)));

static inline lanes_t load_lanes(const uint8_t *p, const int n) {
    lanes_t v = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int k = 0; k < n; k++) v[k] = p[k];
    return v;
}

static inline lanes_t abs_lanes(lanes_t v) {
    lanes_t sign = v >> 15;
    return (v ^ sign) - sign;
}

static inline void predicted_row(const uint8_t *x, const uint8_t *prev, uint8_t *cur, int64_t stride, const int bpp,
                                 const int kind) {
    lanes_t a = {0, 0, 0, 0, 0, 0, 0, 0}, c = a;
    for (int64_t i = 0; i < stride; i += bpp) {
        lanes_t b = load_lanes(prev + i, bpp), pred;
        if (kind == 3) {
            pred = (a + b) >> 1;
        } else {
            lanes_t pa = abs_lanes(b - c), pb = abs_lanes(a - c), pc = abs_lanes(a + b - c - c);
            lanes_t take_a = (pa <= pb) & (pa <= pc), take_b = pb <= pc;
            pred = (a & take_a) | (((b & take_b) | (c & ~take_b)) & ~take_a);
        }
        a = (load_lanes(x + i, bpp) + pred) & 0xFF;
        c = b;
        for (int k = 0; k < bpp; k++) cur[i + k] = (uint8_t)a[k];
    }
}

static void predicted(const uint8_t *x, const uint8_t *prev, uint8_t *cur, int64_t stride, int64_t bpp, int kind) {
#define ROW(n) \
    (kind == 3 ? predicted_row(x, prev, cur, stride, n, 3) : predicted_row(x, prev, cur, stride, n, 4))
    switch (bpp) {
    case 1: ROW(1); break;
    case 2: ROW(2); break;
    case 3: ROW(3); break;
    case 4: ROW(4); break;
    case 6: ROW(6); break;
    default: ROW(8); break;
    }
#undef ROW
}

/* Undo the row filters of h filtered scanlines of `stride` bytes each (raw:
 * h * (1 + stride) bytes, the filter type first) into out (h * stride).
 * bpp: bytes per complete pixel (1, 2, 3, 4, 6 or 8; 1 for samples under
 * 8 bits), stride a multiple of it; the bytes left of a row's first pixel
 * and the row above the first row read as zeros.  Returns 0, -(y + 1) for
 * an unknown filter type in row y, or -(h + 1) for bad arguments. */
int vpt_png_unfilter(const uint8_t *raw, uint8_t *out, int64_t h, int64_t stride, int64_t bpp) {
    if (bpp < 1 || bpp > 8 || bpp == 5 || bpp == 7 || stride % bpp) return (int)-(h + 1);
    uint8_t *zeros = (uint8_t *)calloc((size_t)stride + 1, 1);
    if (!zeros) return (int)-(h + 1);
    const uint8_t *prev = zeros;
    int ret = 0;
    for (int64_t y = 0; y < h; y++) {
        const uint8_t *x = raw + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        int64_t i;
        switch (x[-1]) {
        case 0:
            memcpy(cur, x, (size_t)stride);
            break;
        case 1:
            memcpy(cur, x, (size_t)(bpp < stride ? bpp : stride));
            for (i = bpp; i < stride; i++) cur[i] = (uint8_t)(x[i] + cur[i - bpp]);
            break;
        case 2:
            for (i = 0; i < stride; i++) cur[i] = (uint8_t)(x[i] + prev[i]);
            break;
        case 3:
        case 4:
            predicted(x, prev, cur, stride, bpp, x[-1]);
            break;
        default:
            ret = (int)-(y + 1);
            goto done;
        }
        prev = cur;
    }
done:
    free(zeros);
    return ret;
}

/* ------------------------------------------------------- JPEG: Huffman */

/* Zigzag index -> natural (row-major) index, with 16 extra entries so that a
 * run past the end of a block lands on the last coefficient. */
static const uint8_t NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOK 9

typedef struct {
    uint8_t look_len[1 << LOOK];  /* code length of a code that the next LOOK bits begin with, 0 if longer */
    uint8_t look_sym[1 << LOOK];
    int32_t maxcode[18];          /* largest code of each length, -1 if none */
    int32_t valoffset[18];        /* symbol index of a code of that length = code + valoffset */
    uint8_t vals[256];
} huff_t;

#define TABLE_WORDS (16 + 256)   /* a table as the caller passes it: counts per length 1..16, then symbols */

/* Annex C: the canonical codes of a DHT table.  Returns 0, or -1 if the
 * counts do not describe a prefix code. */
static int build_huff(huff_t *t, const int32_t *table) {
    const int32_t *counts = table, *syms = table + 16;
    int32_t code = 0, k = 0;
    memset(t->look_len, 0, sizeof(t->look_len));
    for (int len = 1; len <= 16; len++) {
        int32_t n = counts[len - 1];
        if (n < 0 || k + n > 256) return -1;
        if (code + n > (1 << len)) return -1;  /* more codes than the length has */
        t->valoffset[len] = k - code;
        for (int32_t j = 0; j < n; j++, k++, code++) {
            t->vals[k] = (uint8_t)syms[k];
            if (len <= LOOK) {
                int32_t first = code << (LOOK - len), span = 1 << (LOOK - len);
                for (int32_t e = 0; e < span; e++) {
                    t->look_len[first + e] = (uint8_t)len;
                    t->look_sym[first + e] = (uint8_t)syms[k];
                }
            }
        }
        t->maxcode[len] = n ? code - 1 : -1;
        code <<= 1;
    }
    t->maxcode[17] = 0x7fffffff;  /* a sentinel the decoder never reaches */
    return 0;
}

/* ---------------------------------------------------- JPEG: bit reader */

typedef struct {
    const uint8_t *p, *end;
    uint64_t buf;        /* the low `cnt` bits are unread, the oldest highest */
    int cnt;
    int marker;          /* a marker stopped the reader at p (p[0] == 0xFF) */
    int64_t stuffed;     /* zero bytes fed in after a marker or the end */
} bits_t;

static void fill(bits_t *b) {
    while (b->cnt <= 56) {
        uint32_t c = 0;
        if (!b->marker && b->p < b->end) {
            c = *b->p;
            if (c == 0xFF) {
                const uint8_t *q = b->p + 1;
                while (q < b->end && *q == 0xFF) q++;  /* fill bytes before a marker */
                if (q < b->end && *q == 0) {
                    b->p = q + 1;                        /* FF 00: a data byte FF */
                } else {
                    b->marker = 1;                       /* a marker, or FFs to the end */
                    b->p = q - 1;
                    c = 0;
                    b->stuffed++;
                }
            } else {
                b->p++;
            }
        } else {
            b->stuffed++;
        }
        b->buf = (b->buf << 8) | c;
        b->cnt += 8;
    }
}

/* Whether bits that were fed in as padding were consumed: the segment was
 * shorter than its MCUs need. */
static int overran(const bits_t *b) { return b->stuffed * 8 > b->cnt; }

static inline uint32_t get_bits(bits_t *b, int n) {
    if (n == 0) return 0;
    if (b->cnt < n) fill(b);
    b->cnt -= n;
    return (uint32_t)(b->buf >> b->cnt) & ((1u << n) - 1);
}

static inline int32_t extend(uint32_t v, int s) {
    return (s && v < (1u << (s - 1))) ? (int32_t)v - (1 << s) + 1 : (int32_t)v;
}

/* F.2.2.3 DECODE.  Returns the symbol, or -1 for a bit string that is no code. */
static inline int decode(bits_t *b, const huff_t *t) {
    if (b->cnt < 32) fill(b);
    uint32_t look = (uint32_t)(b->buf >> (b->cnt - LOOK)) & ((1u << LOOK) - 1);
    int len = t->look_len[look];
    if (len) {
        b->cnt -= len;
        return t->look_sym[look];
    }
    for (len = LOOK + 1; len <= 16; len++) {
        int32_t code = (int32_t)((b->buf >> (b->cnt - len)) & ((1u << len) - 1));
        if (code <= t->maxcode[len]) {
            b->cnt -= len;
            return t->vals[code + t->valoffset[len]];
        }
    }
    return -1;
}

/* ------------------------------------------------ JPEG: one scan's MCUs */

enum { ERR_TRUNCATED = -1, ERR_HUFFMAN = -2, ERR_TABLE = -3, ERR_RESTART = -4, ERR_SHORT = -5, ERR_ARGS = -6 };

typedef struct {
    int ss, se, ah, al, progressive;
    int32_t eobrun;
} scan_t;

static int block_sequential(bits_t *b, int16_t *blk, const huff_t *dc, const huff_t *ac, int32_t *pred) {
    int s = decode(b, dc);
    if (s < 0) return ERR_HUFFMAN;
    if (s > 16) return ERR_HUFFMAN;
    *pred += extend(get_bits(b, s), s);
    blk[0] = (int16_t)*pred;
    for (int k = 1; k < 64; k++) {
        int rs = decode(b, ac);
        if (rs < 0) return ERR_HUFFMAN;
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[NATURAL[k]] = (int16_t)extend(get_bits(b, s), s);
        } else if (r == 15) {
            k += 15;
        } else {
            break;
        }
    }
    return 0;
}

static int block_dc_first(bits_t *b, int16_t *blk, const huff_t *dc, int32_t *pred, int al) {
    int s = decode(b, dc);
    if (s < 0 || s > 16) return ERR_HUFFMAN;
    *pred += extend(get_bits(b, s), s);
    blk[0] = (int16_t)(int32_t)((uint32_t)*pred << al);
    return 0;
}

static int block_ac_first(bits_t *b, int16_t *blk, const huff_t *ac, scan_t *sc) {
    if (sc->eobrun > 0) {
        sc->eobrun--;
        return 0;
    }
    for (int k = sc->ss; k <= sc->se; k++) {
        int rs = decode(b, ac);
        if (rs < 0) return ERR_HUFFMAN;
        int r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            blk[NATURAL[k]] = (int16_t)(int32_t)((uint32_t)extend(get_bits(b, s), s) << sc->al);
        } else if (r == 15) {
            k += 15;
        } else {
            sc->eobrun = (1 << r) - 1;  /* this block ends the first band of the run */
            if (r) sc->eobrun += (int32_t)get_bits(b, r);
            break;
        }
    }
    return 0;
}

/* G.1.2.3: a refinement scan adds one bit to every coefficient already
 * nonzero (a correction bit) and may make zero ones nonzero (+-1 << al). */
static int block_ac_refine(bits_t *b, int16_t *blk, const huff_t *ac, scan_t *sc) {
    int p1 = 1 << sc->al, m1 = -(1 << sc->al);
    int k = sc->ss;
    if (sc->eobrun == 0) {
        for (; k <= sc->se; k++) {
            int rs = decode(b, ac);
            if (rs < 0) return ERR_HUFFMAN;
            int r = rs >> 4, s = rs & 15, value = 0;
            if (s) {  /* s is 1 in a valid stream: a new coefficient of magnitude 1 */
                value = get_bits(b, 1) ? p1 : m1;
            } else if (r != 15) {
                sc->eobrun = 1 << r;
                if (r) sc->eobrun += (int32_t)get_bits(b, r);
                break;
            }
            /* Skip r zero coefficients (and the nonzero ones between them,
             * refining each), then place the new one. */
            for (; k <= sc->se; k++) {
                int16_t *c = blk + NATURAL[k];
                if (*c) {
                    if (get_bits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
                } else {
                    if (--r < 0) break;
                }
            }
            if (value) blk[NATURAL[k]] = (int16_t)value;
        }
    }
    if (sc->eobrun > 0) {  /* inside an end-of-band run: refine the nonzero ones left */
        for (; k <= sc->se; k++) {
            int16_t *c = blk + NATURAL[k];
            if (*c && get_bits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        }
        sc->eobrun--;
    }
    return 0;
}

static int decode_block(bits_t *b, int16_t *blk, const huff_t *dc, const huff_t *ac, int32_t *pred, scan_t *sc) {
    if (!sc->progressive) return block_sequential(b, blk, dc, ac, pred);
    if (sc->ss == 0) {
        if (sc->ah == 0) return block_dc_first(b, blk, dc, pred, sc->al);
        if (get_bits(b, 1)) blk[0] = (int16_t)(blk[0] | (1 << sc->al));
        return 0;
    }
    return sc->ah == 0 ? block_ac_first(b, blk, ac, sc) : block_ac_refine(b, blk, ac, sc);
}

/* The offset of the next marker at or after p (FF followed by neither 00
 * nor FF), or -1 if the data ends first. */
static int64_t next_marker(const uint8_t *data, const uint8_t *p, const uint8_t *end) {
    for (; p + 1 < end; p++) {
        if (p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF) return p - data;
    }
    return -1;
}

/* At a restart interval's end: drop the bits left, step over the RSTn
 * marker that must follow, and clear the predictors and the EOB run. */
static int restart(bits_t *b, const uint8_t *data, int32_t *pred, int ncomp, scan_t *sc) {
    if (overran(b)) return b->p >= b->end ? ERR_TRUNCATED : ERR_SHORT;
    int64_t m = next_marker(data, b->p, b->end);
    if (m < 0) return ERR_TRUNCATED;
    if (data[m + 1] < 0xD0 || data[m + 1] > 0xD7) return ERR_RESTART;
    b->p = data + m + 2;
    b->buf = 0;
    b->cnt = 0;
    b->marker = 0;
    b->stuffed = 0;
    for (int c = 0; c < ncomp; c++) pred[c] = 0;
    sc->eobrun = 0;
    return 0;
}

/* Decode one scan whose entropy-coded data starts at data[0] into the
 * components' coefficient arrays (int16, (rows of blocks, geom bw, 64) in
 * natural order; a refinement scan adds to what earlier scans left).
 *   ncomp: components in the scan (1 = non-interleaved: one block per MCU
 *     over the component's nbx x nby blocks; else MCUs of h x v blocks each,
 *     mcux x mcuy of them);
 *   geom: per component h, v, bw (blocks per row of its array), nbx, nby;
 *   dc_tables, ac_tables: per component a table of TABLE_WORDS words
 *     (ignored where the scan does not use it);
 *   ss, se, ah, al: the spectral selection and successive approximation;
 *   progressive: 0 for a sequential frame; restart: the interval in MCUs.
 * Returns the offset of the marker that ends the scan, or a negative error. */
int64_t vpt_jpeg_scan(const uint8_t *data, int64_t len, int ncomp, int16_t *const *coefs, const int32_t *geom,
                      const int32_t *dc_tables, const int32_t *ac_tables, int mcux, int mcuy, int ss, int se, int ah,
                      int al, int progressive, int restart_interval) {
    huff_t *dc = NULL, *ac = NULL;
    int64_t ret = 0;
    if (ncomp < 1 || ncomp > 4 || ss < 0 || se > 63 || ss > se || al > 13) return ERR_ARGS;
    dc = (huff_t *)malloc(sizeof(huff_t) * ncomp);
    ac = (huff_t *)malloc(sizeof(huff_t) * ncomp);
    if (!dc || !ac) {
        ret = ERR_ARGS;
        goto done;
    }
    int need_dc = !progressive || ss == 0, need_ac = !progressive || ss > 0;
    for (int c = 0; c < ncomp; c++) {
        if ((need_dc && build_huff(&dc[c], dc_tables + c * TABLE_WORDS)) ||
            (need_ac && build_huff(&ac[c], ac_tables + c * TABLE_WORDS))) {
            ret = ERR_TABLE;
            goto done;
        }
    }
    bits_t b = {data, data + len, 0, 0, 0, 0};
    scan_t sc = {ss, se, ah, al, progressive, 0};
    int32_t pred[4] = {0, 0, 0, 0};
    int64_t n_mcu, done_mcu = 0;
    if (ncomp == 1) {
        n_mcu = (int64_t)geom[3] * geom[4];
    } else {
        n_mcu = (int64_t)mcux * mcuy;
    }
    for (int64_t m = 0; m < n_mcu; m++) {
        if (restart_interval && m && m % restart_interval == 0) {
            int err = restart(&b, data, pred, ncomp, &sc);
            if (err) {
                ret = err;
                goto done;
            }
        }
        if (ncomp == 1) {
            int64_t bw = geom[2], nbx = geom[3];
            int16_t *blk = coefs[0] + ((m / nbx) * bw + m % nbx) * 64;
            int err = decode_block(&b, blk, &dc[0], &ac[0], &pred[0], &sc);
            if (err) {
                ret = err;
                goto done;
            }
        } else {
            int64_t my = m / mcux, mx = m % mcux;
            for (int c = 0; c < ncomp; c++) {
                const int32_t *g = geom + 5 * c;
                for (int by = 0; by < g[1]; by++) {
                    for (int bx = 0; bx < g[0]; bx++) {
                        int64_t row = my * g[1] + by, col = mx * g[0] + bx;
                        int err = decode_block(&b, coefs[c] + (row * g[2] + col) * 64, &dc[c], &ac[c], &pred[c], &sc);
                        if (err) {
                            ret = err;
                            goto done;
                        }
                    }
                }
            }
        }
        done_mcu++;
    }
    if (overran(&b)) {
        ret = b.p >= b.end ? ERR_TRUNCATED : ERR_SHORT;
        goto done;
    }
    ret = b.marker ? (int64_t)(b.p - data) : next_marker(data, b.p, b.end);
    if (ret < 0) ret = ERR_TRUNCATED;
done:
    free(dc);
    free(ac);
    (void)done_mcu;
    return ret;
}

/* ---------------------------------------------------------- JPEG: IDCT */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
/* Round half up, then an arithmetic shift (floor). */
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* One 8-point inverse DCT over in[0], in[s], ..., in[7 s]; results
 * (not yet descaled) in out[0..7]. */
static inline void idct8(const int64_t *in, int s, int64_t *out) {
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = in[2 * s];
    z3 = in[6 * s];
    z1 = (z2 + z3) * FIX_0_541196100;
    t2 = z1 + z3 * -FIX_1_847759065;
    t3 = z1 + z2 * FIX_0_765366865;
    t0 = (in[0] + in[4 * s]) * ((int64_t)1 << CONST_BITS);
    t1 = (in[0] - in[4 * s]) * ((int64_t)1 << CONST_BITS);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = in[7 * s];
    t1 = in[5 * s];
    t2 = in[3 * s];
    t3 = in[1 * s];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336;
    t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026;
    t3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    out[0] = t10 + t3;
    out[7] = t10 - t3;
    out[1] = t11 + t2;
    out[6] = t11 - t2;
    out[2] = t12 + t1;
    out[5] = t12 - t1;
    out[3] = t13 + t0;
    out[4] = t13 - t0;
}

/* Dequantise (qt: 64 values in natural order) and inverse-transform the
 * blocks of one component, (nby, nbx, 64) int16 coefficients, into its
 * sample plane (nby * 8, nbx * 8) uint8. */
void vpt_jpeg_idct(const int16_t *coefs, int64_t nby, int64_t nbx, const int32_t *qt, uint8_t *plane) {
    int64_t width = nbx * 8;
    for (int64_t by = 0; by < nby; by++) {
        for (int64_t bx = 0; bx < nbx; bx++) {
            const int16_t *blk = coefs + (by * nbx + bx) * 64;
            int64_t in[64], ws[64], col[8], out[8];
            for (int i = 0; i < 64; i++) in[i] = (int64_t)blk[i] * qt[i];
            for (int x = 0; x < 8; x++) {  /* pass 1: columns, kept at 2^PASS1_BITS */
                idct8(in + x, 8, col);
                for (int y = 0; y < 8; y++) ws[y * 8 + x] = DESCALE(col[y], CONST_BITS - PASS1_BITS);
            }
            for (int y = 0; y < 8; y++) {  /* pass 2: rows, to samples */
                idct8(ws + y * 8, 1, out);
                uint8_t *dst = plane + (by * 8 + y) * width + bx * 8;
                for (int x = 0; x < 8; x++) {
                    int64_t v = DESCALE(out[x], CONST_BITS + PASS1_BITS + 3) + 128;
                    dst[x] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
                }
            }
        }
    }
}
