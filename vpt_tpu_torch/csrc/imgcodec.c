/* The host hot loops of the port's image decoders: the PNG row unfilter, the
 * JPEG entropy decoder, inverse DCT and block smoothing, the TIFF LZW and
 * PackBits decoders and predictors, the GIF LZW decoder and the BMP RLE
 * decoder.  Plain C with a C interface, built with gcc into
 * vpt_tpu_torch/build/ at first use and called through ctypes (io/codec.py);
 * the marker, chunk, tag and header parsing, upsampling and colour
 * conversion stay in Python and numpy.
 *
 * Written from the specifications: the PNG specification (section 9, the
 * five row filters), ITU-T T.81 (Annex C, Huffman tables; Annex F,
 * sequential decoding; Annex G, progressive decoding; A.3.3, the IDCT), TIFF
 * 6.0 (sections 9 and 13-14, PackBits, LZW and the horizontal predictor)
 * with Adobe's technical note 3 (the floating-point predictor), GIF89a
 * (appendix F, variable-length LZW) and the BMP RLE8 / RLE4 encodings.  The
 * IDCT is the fixed-point "islow" algorithm whose constants and rounding
 * libjpeg-turbo's default decoder uses (13 fraction bits, 2 extra bits
 * between the passes, round-half-up descaling), so the samples equal those
 * of the libjpeg-turbo decoder behind PIL; a sample out of 0..255 saturates.
 * Where a reader's behaviour goes beyond its specification (block smoothing,
 * where LZW and RLE streams end), the decoders follow what PIL and imageio
 * give, as the comments at each say.
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

/* ------------------------------------------------ JPEG: block smoothing */

/* Natural positions of zigzag coefficients 1..9 (AC01, AC10, AC20, AC11,
 * AC02, AC03, AC12, AC21, AC30). */
static const int SMOOTH_POS[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

/* An estimate of a coefficient whose quantiser is q from `num` (a weighted
 * sum of DC values times the DC quantiser), rounded to the nearest multiple
 * of q and held under 2^al when al > 0 (al: the successive-approximation bit
 * the coefficient is known to, -1 if it never was coded). */
static inline int16_t smooth_pred(int64_t num, int64_t q, int al) {
    int64_t pred;
    if (num >= 0) {
        pred = ((q << 7) + num) / (q << 8);
        if (al > 0 && pred >= ((int64_t)1 << al)) pred = ((int64_t)1 << al) - 1;
    } else {
        pred = ((q << 7) - num) / (q << 8);
        if (al > 0 && pred >= ((int64_t)1 << al)) pred = ((int64_t)1 << al) - 1;
        pred = -pred;
    }
    return (int16_t)pred;
}

/* The interblock smoothing libjpeg-turbo applies to a progressive JPEG whose
 * first 9 AC coefficients are not all complete (decompress_smooth_data in
 * its jdcoefct.c): each still-zero coefficient of those 9 that is not known
 * to full precision is estimated from the DC values of the block's 5x5
 * neighbourhood (edges replicated), and when no AC coefficient was coded at
 * all the DC value is smoothed too.  coefs: one component's (bh, bw, 64)
 * int16 coefficients (natural order, its MCU-padded array); the nby x nbx
 * blocks that hold samples go to out, (nby, nbx, 64).  The neighbourhood's
 * columns stop at the component's last block that holds samples; its rows
 * may reach into the MCU padding below.  v: its vertical
 * sampling factor; rows: the frame's iMCU rows; qt: its 64 quantisers;
 * bits: the successive-approximation bit of coefficients 0..9 after the last
 * scan (-1 never coded).  The rows are walked per iMCU row as libjpeg-turbo
 * walks them: in the last iMCU row, whose block rows may be fewer than v,
 * the test for a row above or below counts those fewer rows. */
void vpt_jpeg_smooth(const int16_t *coefs, int16_t *out, int64_t bw, int64_t nbx, int64_t nby, int v, int64_t rows,
                     const int32_t *qt, const int32_t *bits) {
    int64_t q[10];
    for (int k = 0; k < 10; k++) q[k] = qt[SMOOTH_POS[k]];
    int change_dc = 1;
    for (int k = 1; k < 10; k++) change_dc &= bits[k] == -1;
    int64_t last = nbx - 1;
    for (int64_t r = 0; r < rows; r++) {
        int64_t block_rows = v;
        if (r == rows - 1) {
            block_rows = nby % v;
            if (block_rows == 0) block_rows = v;
        }
        int64_t image_rows = block_rows * rows;
        for (int64_t b = 0; b < block_rows; b++) {
            int64_t y = r * v + b, iy = r * block_rows + b;
            if (y >= nby) continue;
            int64_t ym1 = iy > 0 ? y - 1 : y;
            int64_t ym2 = iy > 1 ? y - 2 : ym1;
            int64_t yp1 = iy < image_rows - 1 ? y + 1 : y;
            int64_t yp2 = iy < image_rows - 2 ? y + 2 : yp1;
            const int16_t *row[5] = {coefs + ym2 * bw * 64, coefs + ym1 * bw * 64, coefs + y * bw * 64,
                                     coefs + yp1 * bw * 64, coefs + yp2 * bw * 64};
            for (int64_t x = 0; x <= last; x++) {
                int dc[5][5];  /* dc[row][col]: rows y-2..y+2, columns x-2..x+2 (the edge columns repeated) */
                int16_t ws[64];
                memcpy(ws, row[2] + x * 64, sizeof(ws));
                for (int i = 0; i < 5; i++)
                    for (int j = 0; j < 5; j++) {
                        int64_t xx = x + j - 2;
                        xx = xx < 0 ? 0 : (xx > last ? last : xx);
                        dc[i][j] = row[i][xx * 64];
                    }
#define D(n) ((int64_t)dc[((n) - 1) / 5][((n) - 1) % 5])
                int64_t q00 = q[0], num;
                int al;
                if ((al = bits[1]) != 0 && ws[1] == 0) {
                    num = q00 * (change_dc ? (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) + 3 * D(10)
                                              - 3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) - 3 * D(16)
                                              + 13 * D(17) - 13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25))
                                           : (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15)));
                    ws[1] = smooth_pred(num, q[1], al);
                }
                if ((al = bits[2]) != 0 && ws[8] == 0) {
                    num = q00 * (change_dc ? (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7)
                                              + 38 * D(8) + 13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18)
                                              - 13 * D(19) + D(20) + D(21) + 3 * D(22) + 3 * D(23) + 3 * D(24) + D(25))
                                           : (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23)));
                    ws[8] = smooth_pred(num, q[2], al);
                }
                if ((al = bits[3]) != 0 && ws[16] == 0) {
                    num = q00 * (change_dc ? (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13)
                                              - 5 * D(14) + 2 * D(17) + 7 * D(18) + 2 * D(19) + D(23))
                                           : (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23)));
                    ws[16] = smooth_pred(num, q[3], al);
                }
                if ((al = bits[4]) != 0 && ws[9] == 0) {
                    num = q00 * (change_dc ? (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21)
                                              - D(25))
                                           : (D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22)
                                              - D(24) + D(4) - D(6) + 10 * D(7) - 10 * D(9)));
                    ws[9] = smooth_pred(num, q[4], al);
                }
                if ((al = bits[5]) != 0 && ws[2] == 0) {
                    num = q00 * (change_dc ? (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13)
                                              + 7 * D(14) + D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19))
                                           : (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15)));
                    ws[2] = smooth_pred(num, q[5], al);
                }
                if (change_dc) {
                    if ((al = bits[6]) != 0 && ws[3] == 0) {
                        num = q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19));
                        ws[3] = smooth_pred(num, q[6], al);
                    }
                    if ((al = bits[7]) != 0 && ws[10] == 0) {
                        num = q00 * (D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19));
                        ws[10] = smooth_pred(num, q[7], al);
                    }
                    if ((al = bits[8]) != 0 && ws[17] == 0) {
                        num = q00 * (D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19));
                        ws[17] = smooth_pred(num, q[8], al);
                    }
                    if ((al = bits[9]) != 0 && ws[24] == 0) {
                        num = q00 * (D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19));
                        ws[24] = smooth_pred(num, q[9], al);
                    }
                    num = q00 * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) - 6 * D(6) + 6 * D(7)
                                 + 42 * D(8) + 6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) + 152 * D(13)
                                 + 42 * D(14) - 8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) + 6 * D(19)
                                 - 6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) - 2 * D(25));
                    ws[0] = smooth_pred(num, q00, 0);
                }
#undef D
                memcpy(out + (y * nbx + x) * 64, ws, sizeof(ws));
            }
        }
    }
}

/* ------------------------------------------------------ TIFF: LZW, PackBits */

/* A TIFF LZW strip (MSB-first codes, 9-12 bits, the width growing one code
 * early, at 511, 1023 and 2047 entries) decoded as imageio's bundled tifffile
 * decodes it: the strip must begin with CLEAR; it ends at EOI or where a code
 * would end at or past the last bit (that code is dropped); the code one past
 * the table is the previous string plus its first byte.  The first cap bytes
 * go to out.  Returns the decoded length (all of it, not only what fit), -1
 * for a strip that does not begin with CLEAR or is under 4 bytes, -2 for a
 * code after CLEAR that is no byte or a code further past the table. */
int64_t vpt_tiff_lzw(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap) {
    static const int WIDTH_AT[4][2] = {{511, 10}, {1023, 11}, {2047, 12}, {0, 0}};
    if (n < 4) return -1;
    int32_t *prefix = (int32_t *)malloc(sizeof(int32_t) * 4096);
    uint8_t *last = (uint8_t *)malloc(4096), *first = (uint8_t *)malloc(4096);
    int32_t *length = (int32_t *)malloc(sizeof(int32_t) * 4096);
    uint8_t *stack = (uint8_t *)malloc(4096);
    int64_t total = 0, ret;
    if (!prefix || !last || !first || !length || !stack) {
        ret = -1;
        goto done;
    }
    for (int i = 0; i < 256; i++) {
        prefix[i] = -1;
        last[i] = first[i] = (uint8_t)i;
        length[i] = 1;
    }
    int64_t bitcount = 0, bitmax = n * 8;
    int width = 9, lentable = 258;
    int64_t tablen = 258;  /* entries tifffile's table would hold (it never stops growing) */
    int32_t oldcode = 0, code = 0;
#define NEXT_CODE()                                                               \
    do {                                                                          \
        int64_t start = bitcount >> 3;                                            \
        uint32_t word = 0;                                                        \
        for (int k = 0; k < 4; k++) word = (word << 8) | (start + k < n ? in[start + k] : 0); \
        code = (int32_t)(((word << (bitcount & 7)) & 0xFFFFFFFFu) >> (32 - width)); \
    } while (0)
#define EMIT(c)                                                                   \
    do {                                                                          \
        int32_t e = (c), len = length[e];                                         \
        for (int32_t k = len - 1; k >= 0; k--) {                                   \
            stack[k] = last[e];                                                   \
            e = prefix[e];                                                        \
        }                                                                         \
        for (int32_t k = 0; k < len; k++, total++) if (total < cap) out[total] = stack[k]; \
    } while (0)
    NEXT_CODE();
    if (code != 256) {
        ret = -1;
        goto done;
    }
    for (;;) {
        NEXT_CODE();
        bitcount += width;
        if (code == 257 || bitcount >= bitmax) break;
        if (code == 256) {
            width = 9;
            lentable = 258;
            tablen = 258;
            NEXT_CODE();
            bitcount += width;
            if (code == 257) break;
            if (code > 255) {
                ret = -2;
                goto done;
            }
            EMIT(code);
        } else {
            if (code > tablen) {
                ret = -2;
                goto done;
            }
            if (code < tablen) {
                EMIT(code);
            } else {
                EMIT(oldcode);
                if (total < cap) out[total] = first[oldcode];
                total++;
            }
            if (lentable < 4096) {  /* the entry appended: the old string and the first byte of this one */
                prefix[lentable] = oldcode;
                last[lentable] = code < tablen ? first[code] : first[oldcode];
                first[lentable] = first[oldcode];
                length[lentable] = length[oldcode] + 1;
                lentable++;
            }
            tablen++;
        }
        oldcode = code;
        for (int k = 0; WIDTH_AT[k][0]; k++) {
            if (tablen == WIDTH_AT[k][0]) width = WIDTH_AT[k][1];
        }
    }
#undef NEXT_CODE
#undef EMIT
    ret = total;
done:
    free(prefix);
    free(last);
    free(first);
    free(length);
    free(stack);
    return ret;
}

/* A PackBits run (TIFF compression 32773) decoded as tifffile decodes it:
 * n + 1 literal bytes for a header n < 128, the next byte 257 - n times for
 * n > 128, nothing for 128; a run cut by the end of the data gives what is
 * there.  The first cap bytes go to out; returns the decoded length. */
int64_t vpt_packbits(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap) {
    int64_t i = 0, total = 0;
    while (i < n) {
        int h = in[i++];
        if (h < 128) {
            int64_t len = h + 1;
            if (len > n - i) len = n - i;
            for (int64_t k = 0; k < len; k++, total++) if (total < cap) out[total] = in[i + k];
            i += h + 1;
        } else if (h > 128) {
            if (i >= n) break;
            for (int k = 0; k < 257 - h; k++, total++) if (total < cap) out[total] = in[i];
            i++;
        }
    }
    return total;
}

/* ------------------------------------------------------ TIFF: predictors */

/* Undo the horizontal predictor (2) on rows of native-order integer samples
 * in place: buf holds `rows` rows of `count` samples of `size` bytes (1, 2,
 * 4 or 8), each sample the difference from the one `stride` samples to its
 * left (stride: the samples per pixel), wrapping as the samples do. */
void vpt_tiff_unpredict(uint8_t *buf, int64_t rows, int64_t count, int64_t stride, int size) {
#define UNDO(T)                                                                   \
    for (int64_t r = 0; r < rows; r++) {                                          \
        T *p = (T *)buf + r * count;                                              \
        for (int64_t i = stride; i < count; i++) p[i] = (T)(p[i] + p[i - stride]); \
    }
    switch (size) {
    case 1: UNDO(uint8_t); break;
    case 2: UNDO(uint16_t); break;
    case 4: UNDO(uint32_t); break;
    default: UNDO(uint64_t); break;
    }
#undef UNDO
}

/* Undo the floating-point predictor (3): each of `rows` rows of `count`
 * samples of `size` bytes (2, 4 or 8) holds the bytes of its samples as
 * byte planes, most significant first, each byte the difference from the
 * one `stride` bytes to its left.  The samples go to out in native
 * (little-endian) order. */
void vpt_tiff_unpredict_float(uint8_t *buf, uint8_t *out, int64_t rows, int64_t count, int64_t stride, int size) {
    int64_t nbytes = count * size;
    for (int64_t r = 0; r < rows; r++) {
        uint8_t *p = buf + r * nbytes, *o = out + r * nbytes;
        for (int64_t i = stride; i < nbytes; i++) p[i] = (uint8_t)(p[i] + p[i - stride]);
        for (int64_t i = 0; i < count; i++)
            for (int b = 0; b < size; b++) o[i * size + b] = p[(int64_t)(size - 1 - b) * count + i];
    }
}

/* --------------------------------------------------------------- GIF: LZW */

/* The first frame of a GIF: LSB-first LZW codes (bits: the minimum code
 * size; the sub-blocks already joined into `in`) decoded as PIL's GIF
 * decoder decodes them into a w x h frame of palette indices (rows in the
 * interlaced order when `interlace`: every 8th from 0, from 4, every 4th from
 * 2, every 2nd from 1).  A CLEAR resets the table, the first code after it
 * is taken as is, a code one past the table is its previous string plus that
 * string's first byte; the table holds 4096 entries and stops growing when
 * full.  Returns 0 when the frame is full (later codes are not read), 1 when
 * EOI comes first, 2 when the data ends first, -1 for a code past the table
 * or a bad first code, -2 for a bad code size. */
int vpt_gif_lzw(const uint8_t *in, int64_t n, int bits, uint8_t *out, int64_t w, int64_t h, int interlace) {
    if (bits < 0 || bits > 12) return -2;
    if (w <= 0 || h <= 0) return 0;
    int32_t clear = 1 << bits, end = clear + 1, next = clear + 2, codesize = bits + 1;
    int32_t codemask = (1 << codesize) - 1, lastcode = 0, lastdata = 0;
    int state = 2;  /* 2: the next code follows a CLEAR */
    uint8_t data[4096], buffer[4096];
    int32_t link[4096];
    uint64_t bitbuf = 0;
    int bitcount = 0;
    int64_t pos = 0, x = 0, y = 0, step = interlace ? 8 : 1;
    int pass = interlace ? 1 : 0;
    for (;;) {
        while (bitcount < codesize) {
            if (pos >= n) return 2;
            bitbuf |= (uint64_t)in[pos++] << bitcount;
            bitcount += 8;
        }
        int32_t c = (int32_t)(bitbuf & (uint64_t)codemask);
        bitbuf >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
            next = clear + 2;
            codesize = bits + 1;
            codemask = (1 << codesize) - 1;
            state = 2;
            continue;
        }
        if (c == end) return 1;
        const uint8_t *p;
        int32_t len;
        if (state == 2) {
            if (c > clear) return -1;
            lastdata = lastcode = c;
            buffer[4095] = (uint8_t)c;
            p = buffer + 4095;
            len = 1;
            state = 3;
        } else {
            int32_t thiscode = c, bi = 4096;
            if (c > next) return -1;
            if (c == next) {
                buffer[--bi] = (uint8_t)lastdata;
                c = lastcode;
            }
            while (c >= clear) {
                if (bi <= 0 || c >= 4096) return -1;
                buffer[--bi] = data[c];
                c = link[c];
            }
            buffer[--bi] = (uint8_t)c;
            lastdata = c;
            if (next < 4096) {
                data[next] = (uint8_t)c;
                link[next] = lastcode;
                if (next == codemask && codesize < 12) {
                    codesize++;
                    codemask = (1 << codesize) - 1;
                }
                next++;
            }
            lastcode = thiscode;
            p = buffer + bi;
            len = 4096 - bi;
        }
        for (int32_t k = 0; k < len; k++) {
            out[y * w + x] = p[k];
            if (++x >= w) {
                x = 0;
                y += step;
                while (y >= h) {
                    if (pass == 1) {
                        y = 4;
                        pass = 2;
                    } else if (pass == 2) {
                        step = 4;
                        y = 2;
                        pass = 3;
                    } else if (pass == 3) {
                        step = 2;
                        y = 1;
                        pass = 0;
                    } else {
                        return 0;
                    }
                }
            }
        }
    }
}

/* ----------------------------------------------------------------- BMP RLE */

/* BMP RLE8 / RLE4 pixel data (one index per output byte) decoded as PIL's
 * BMP RLE decoder decodes it, row after row from the first stored row: an
 * encoded run is cut at the row's end; end of line pads the output to a
 * whole number of rows; end of bitmap stops; a delta reads two bytes and
 * then two more, and moves by the second pair (right, then up rows); an
 * absolute run of RLE4 reads count / 2 bytes (two indices each); after an
 * absolute run the reader skips a byte when its offset in the file
 * (`start`: the offset of in[0]) is odd.  Decoding stops when w * h indices
 * are out or the data ends.  Returns the number of indices out (the first
 * cap of them written), or -1 for a delta whose second pair is cut off. */
int64_t vpt_bmp_rle(const uint8_t *in, int64_t n, int64_t start, int64_t w, int64_t h, int rle4, uint8_t *out,
                    int64_t cap) {
    int64_t len = 0, x = 0, i = 0, dest = w * h;
#define PUT(v)                                 \
    do {                                       \
        if (len < cap) out[len] = (uint8_t)(v); \
        len++;                                 \
    } while (0)
    while (len < dest) {
        if (i + 2 > n) break;
        int count = in[i], byte = in[i + 1];
        i += 2;
        if (count) {
            int64_t num = count;
            if (x + num > w) num = w - x > 0 ? w - x : 0;
            for (int64_t k = 0; k < num; k++) PUT(rle4 ? ((k % 2 == 0) ? byte >> 4 : byte & 15) : byte);
            x += num;
        } else if (byte == 0) {
            while (w && len % w) PUT(0);
            x = 0;
        } else if (byte == 1) {
            break;
        } else if (byte == 2) {
            if (i + 2 > n) break;
            i += 2;
            if (i + 2 > n) return -1;
            int64_t right = in[i], up = in[i + 1];
            i += 2;
            for (int64_t k = 0; k < right + up * w; k++) PUT(0);
            x = w ? len % w : 0;
        } else {
            int64_t want = rle4 ? byte / 2 : byte, got = n - i < want ? n - i : want;
            for (int64_t k = 0; k < got; k++) {
                if (rle4) {
                    PUT(in[i + k] >> 4);
                    PUT(in[i + k] & 15);
                } else {
                    PUT(in[i + k]);
                }
            }
            i += got;
            if (got < want) break;
            x += byte;
            if ((start + i) % 2) i++;
        }
    }
#undef PUT
    return len;
}
