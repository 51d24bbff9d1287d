/* The host hot loops of the port's image decoders: the PNG row unfilter, the
 * JPEG entropy decoders (Huffman, arithmetic and lossless), inverse DCT and
 * block smoothing, the TIFF LZW and
 * PackBits decoders and predictors, the GIF LZW decoder and the BMP RLE
 * decoder.  Plain C with a C interface, built with gcc into
 * vpt_tpu_torch/build/ at first use and called through ctypes (io/codec.py);
 * the marker, chunk, tag and header parsing, upsampling and colour
 * conversion stay in Python and numpy.
 *
 * Written from the specifications: the PNG specification (section 9, the
 * five row filters), ITU-T T.81 (Annex C, Huffman tables; Annex D,
 * arithmetic coding; Annex F, sequential decoding; Annex G, progressive
 * decoding; Annex H, lossless decoding; A.3.3, the IDCT), TIFF
 * 6.0 (sections 9 and 13-14, PackBits, LZW and the horizontal predictor)
 * with Adobe's technical note 3 (the floating-point predictor), GIF89a
 * (appendix F, variable-length LZW) and the BMP RLE8 / RLE4 encodings.  The
 * IDCT is the fixed-point "islow" algorithm whose constants and rounding
 * libjpeg-turbo's default decoder uses (13 fraction bits, 2 extra bits
 * between the passes, round-half-up descaling) in the 16-bit lanes of its
 * SIMD code, so the samples equal those of the libjpeg-turbo decoder behind
 * PIL, for corrupt coefficients too.  The entropy decoders read the data as
 * libjpeg-turbo's do (jdhuff.c, jdphuff.c, jdarith.c, jdlhuff.c), down to
 * how each recovers from corrupt data.
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

/* ------------------------------------------ JPEG: the data behind a scan */

/* The scans' errors: the data ends where libjpeg wants more of it (PIL,
 * whose decoder then suspends, finds no more and raises), a Huffman table
 * that is no prefix code, bad arguments, and an arithmetic-coded scan that
 * needs a byte of a block PIL has not handed libjpeg yet (see src_t). */
enum { ERR_TRUNCATED = -1, ERR_TABLE = -3, ERR_ARGS = -6, ERR_FEED = -7 };

/* The bytes of one scan as libjpeg-turbo's arithmetic decoder and bit reader
 * fetch them when PIL drives it: one at a time from data[pos].  Only `limit`
 * bytes are there to fetch: PIL hands libjpeg the file in blocks of 65536
 * bytes, and a decoder that cannot suspend (the arithmetic one) fails when it
 * needs a byte of a block not yet handed over; the end of the file ends the
 * data too.  A fetch past it sets err and gives 0.  A marker (FF, any more
 * FFs, then a byte neither 00 nor FF) read inside the data is kept in
 * `unread` (its code) and marker_at (the offset of its last FF). */
typedef struct {
    const uint8_t *data;
    int64_t pos, limit, len, marker_at;
    int unread, err;
} src_t;

static inline int src_byte(src_t *s) {
    if (s->pos >= s->limit) {
        if (!s->err) s->err = s->limit < s->len ? ERR_FEED : ERR_TRUNCATED;
        return 0;
    }
    return s->data[s->pos++];
}

/* jdmarker.c's next_marker: skip to the next marker and keep it unread. */
static void src_next_marker(src_t *s) {
    for (;;) {
        int c = src_byte(s);
        while (c != 0xFF && !s->err) c = src_byte(s);
        do c = src_byte(s);
        while (c == 0xFF && !s->err);
        if (s->err) return;
        if (c != 0) {
            s->unread = c;
            s->marker_at = s->pos - 2;
            return;
        }
    }
}

/* jdmarker.c's read_restart_marker with jpeg_resync_to_restart (PIL's
 * choice): swallow the expected RSTn; otherwise decide as libjpeg does
 * whether to discard the marker (1), scan on to the next one (2) or leave it
 * unread, so that the interval decodes from no data (3).  next_rst counts
 * the restarts modulo 8. */
static void src_restart_marker(src_t *s, int *next_rst) {
    if (!s->unread) src_next_marker(s);
    if (s->err) return;
    int desired = *next_rst;
    *next_rst = (desired + 1) & 7;
    for (;;) {
        int m = s->unread, action;
        if (m == 0xD0 + desired) {
            action = 1;
        } else if (m < 0xC0) {
            action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
            action = 3;
        } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
            action = 3;
        } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
            action = 2;
        } else {
            action = 1;
        }
        if (action == 1) {
            s->unread = 0;
            return;
        }
        if (action == 3) return;
        s->unread = 0;
        src_next_marker(s);
        if (s->err) return;
    }
}

/* The offset of the next marker at or after p (an FF followed by neither
 * 00 nor FF, FFs before it being fill), or -1 if the data ends first. */
static int64_t next_marker(const uint8_t *data, const uint8_t *p, const uint8_t *end) {
    for (; p + 1 < end; p++) {
        if (p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF) return p - data;
    }
    return -1;
}

/* Where marker parsing goes on after a scan: the marker the scan stopped at,
 * else the next one (data the decoder left is skipped, as libjpeg skips it),
 * else the end of the data. */
static int64_t src_end(const src_t *s) {
    if (s->unread) return s->marker_at;
    int64_t m = next_marker(s->data, s->data + s->pos, s->data + s->len);
    return m < 0 ? s->len : m;
}

/* ---------------------------------------------------- JPEG: bit reader */

/* libjpeg-turbo's bit reader (jdhuff.c) over src_t: the buffer is filled to
 * 57 bits at a time; it stops at a marker, after which zero bits are fed in
 * (and `insufficient` set) once a request needs more bits than are left.
 * The end of the file where more bytes are wanted is an error: PIL's
 * decoder suspends there and PIL, having no more data, raises. */
typedef struct {
    src_t *s;
    uint64_t buf;
    int left, insufficient;
} hbits_t;

static void hfill(hbits_t *b, int nbits) {
    src_t *s = b->s;
    if (!s->unread) {
        while (b->left < 57) {
            int c = src_byte(s);
            if (s->err) return;
            if (c == 0xFF) {
                do c = src_byte(s);
                while (c == 0xFF && !s->err);
                if (s->err) return;
                if (c == 0) {
                    c = 0xFF;
                } else {
                    s->unread = c;
                    s->marker_at = s->pos - 2;
                    goto no_more;
                }
            }
            b->buf = (b->buf << 8) | (uint64_t)c;
            b->left += 8;
        }
        return;
    }
no_more:
    if (nbits > b->left) {
        b->insufficient = 1;
        b->buf <<= 57 - b->left;
        b->left = 57;
    }
}

static inline int32_t extend(uint32_t v, int s) {
    return (s && v < (1u << (s - 1))) ? (int32_t)v - (1 << s) + 1 : (int32_t)v;
}

static inline uint32_t hbits(hbits_t *b, int n) {
    if (b->left < n) {
        hfill(b, n);
        if (b->left < n) {  /* the file ended (err is set; the scan is refused) */
            b->left = 0;
            return 0;
        }
    }
    b->left -= n;
    return (uint32_t)(b->buf >> b->left) & ((1u << n) - 1);
}

/* jdhuff.c's HUFF_DECODE: an 8-bit look-ahead when 8 bits are there, else
 * (or for a longer code) a code bit by bit from min_bits on.  A bit string
 * that is no code gives 0 after 17 bits, as libjpeg gives it. */
static int hdecode(hbits_t *b, const huff_t *t) {
    int l = 1;
    if (b->left < 8) hfill(b, 0);
    if (b->left >= 9) {
        uint32_t look = (uint32_t)(b->buf >> (b->left - LOOK)) & ((1u << LOOK) - 1);
        int len = t->look_len[look];
        if (len) {
            b->left -= len;
            return t->look_sym[look];
        }
        l = LOOK;
    } else if (b->left == 8) {
        uint32_t look = (uint32_t)(b->buf & 0xFF) << 1;
        int len = t->look_len[look];
        if (len && len <= 8) {
            b->left -= len;
            return t->look_sym[look];
        }
        l = 9;
    }
    int32_t code = (int32_t)hbits(b, l);
    while (l <= 16 && code > t->maxcode[l]) {
        code = (code << 1) | (int32_t)hbits(b, 1);
        l++;
    }
    if (l > 16) return 0;
    return t->vals[code + t->valoffset[l]];
}

/* ------------------------------------------------ JPEG: one scan's MCUs */

typedef struct {
    int ss, se, ah, al, progressive;
    int32_t eobrun;
} scan_t;

/* F.2.2: a sequential block (jdhuff.c's decode_mcu_slow). */
static void block_sequential(hbits_t *b, int16_t *blk, const huff_t *dc, const huff_t *ac, int32_t *pred) {
    int s = hdecode(b, dc);
    if (s) s = extend(hbits(b, s), s);
    *pred = (int32_t)((uint32_t)*pred + (uint32_t)s);
    blk[0] = (int16_t)*pred;
    for (int k = 1; k < 64; k++) {
        int rs = hdecode(b, ac), r = rs >> 4;
        s = rs & 15;
        if (s) {
            k += r;
            blk[NATURAL[k]] = (int16_t)extend(hbits(b, s), s);
        } else if (r == 15) {
            k += 15;
        } else {
            break;
        }
    }
}

static void block_dc_first(hbits_t *b, int16_t *blk, const huff_t *dc, int32_t *pred, int al) {
    int s = hdecode(b, dc);
    if (s) s = extend(hbits(b, s), s);
    *pred = (int32_t)((uint32_t)*pred + (uint32_t)s);
    blk[0] = (int16_t)(uint16_t)((uint32_t)*pred << al);
}

static void block_ac_first(hbits_t *b, int16_t *blk, const huff_t *ac, scan_t *sc) {
    if (sc->eobrun > 0) {
        sc->eobrun--;
        return;
    }
    for (int k = sc->ss; k <= sc->se; k++) {
        int rs = hdecode(b, ac), r = rs >> 4, s = rs & 15;
        if (s) {
            k += r;
            blk[NATURAL[k]] = (int16_t)(uint16_t)((uint32_t)extend(hbits(b, s), s) << sc->al);
        } else if (r == 15) {
            k += 15;
        } else {
            sc->eobrun = (1 << r) - 1;  /* this block ends the first band of the run */
            if (r) sc->eobrun += (int32_t)hbits(b, r);
            break;
        }
    }
}

/* G.1.2.3: a refinement scan adds one bit to every coefficient already
 * nonzero (a correction bit) and may make zero ones nonzero (+-1 << al). */
static void block_ac_refine(hbits_t *b, int16_t *blk, const huff_t *ac, scan_t *sc) {
    int p1 = 1 << sc->al, m1 = -(1 << sc->al);
    int k = sc->ss;
    if (sc->eobrun == 0) {
        for (; k <= sc->se; k++) {
            int rs = hdecode(b, ac), r = rs >> 4, s = rs & 15, value = 0;
            if (s) {  /* s is 1 in a valid stream: a new coefficient of magnitude 1 */
                value = hbits(b, 1) ? p1 : m1;
            } else if (r != 15) {
                sc->eobrun = 1 << r;
                if (r) sc->eobrun += (int32_t)hbits(b, r);
                break;
            }
            /* Skip r zero coefficients (and the nonzero ones between them,
             * refining each), then place the new one. */
            for (; k <= sc->se; k++) {
                int16_t *c = blk + NATURAL[k];
                if (*c) {
                    if (hbits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
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
            if (*c && hbits(b, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        }
        sc->eobrun--;
    }
}

static void decode_block(hbits_t *b, int16_t *blk, const huff_t *dc, const huff_t *ac, int32_t *pred, scan_t *sc) {
    if (!sc->progressive) {
        block_sequential(b, blk, dc, ac, pred);
    } else if (sc->ss == 0) {
        if (sc->ah == 0)
            block_dc_first(b, blk, dc, pred, sc->al);
        else if (hbits(b, 1))
            blk[0] = (int16_t)(blk[0] | (1 << sc->al));
    } else if (sc->ah == 0) {
        block_ac_first(b, blk, ac, sc);
    } else {
        block_ac_refine(b, blk, ac, sc);
    }
}

/* The blocks of MCU m of a scan, in the order its data codes them, as
 * pointers into the components' coefficient arrays, with the index in the
 * scan of each block's component.  One component: the m-th of its nbx x nby
 * blocks; more: the h x v blocks of each component in turn, rows first, of
 * MCU (m / mcux, m % mcux).  geom: per component h, v, bw, nbx, nby.
 * Returns the number of blocks (at most 10). */
static int mcu_blocks(int64_t m, int ncomp, int16_t *const *coefs, const int32_t *geom, int mcux, int16_t **blk,
                      int *comp) {
    if (ncomp == 1) {
        int64_t bw = geom[2], nbx = geom[3];
        blk[0] = coefs[0] + ((m / nbx) * bw + m % nbx) * 64;
        comp[0] = 0;
        return 1;
    }
    int64_t my = m / mcux, mx = m % mcux;
    int n = 0;
    for (int c = 0; c < ncomp; c++) {
        const int32_t *g = geom + 5 * c;
        for (int by = 0; by < g[1]; by++) {
            for (int bx = 0; bx < g[0] && n < 10; bx++) {
                int64_t row = my * g[1] + by, col = mx * g[0] + bx;
                blk[n] = coefs[c] + (row * g[2] + col) * 64;
                comp[n++] = c;
            }
        }
    }
    return n;
}

/* The iMCU row that MCU m of a scan lies in (one component: its blocks'
 * row over the component's v block rows of an iMCU row). */
static inline int64_t imcu_row(int64_t m, int ncomp, const int32_t *geom, int mcux) {
    return ncomp == 1 ? m / geom[3] / geom[1] : m / mcux;
}

/* Decode one Huffman-coded scan whose entropy-coded data starts at data[0]
 * into the components' coefficient arrays (int16, (rows of blocks, geom bw,
 * 64) in natural order; a refinement scan adds to what earlier scans left),
 * as libjpeg-turbo's jdhuff.c (sequential) and jdphuff.c (progressive)
 * decode it, corrupt data included: a bit string that is no code decodes as
 * symbol 0; once the data has run dry (a marker in the way) the MCUs after
 * are left as they are until a restart marker is found; restart markers out
 * of place are resynchronised as jpeg_resync_to_restart does.
 *   ncomp: components in the scan (1 = non-interleaved: one block per MCU
 *     over the component's nbx x nby blocks; else MCUs of h x v blocks each,
 *     mcux x mcuy of them);
 *   geom: per component h, v, bw (blocks per row of its array), nbx, nby;
 *   dc_tables, ac_tables: per component a table of TABLE_WORDS words
 *     (ignored where the scan does not use it);
 *   ss, se, ah, al: the spectral selection and successive approximation;
 *   progressive: 0 for a sequential frame; restart: the interval in MCUs;
 *   last_good: set to the iMCU row of the last MCU begun before the data
 *     ran dry (libjpeg's last_good_iMCU_row, which block smoothing reads).
 * Returns the offset of the marker after the scan (len if there is none),
 * or a negative error. */
int64_t vpt_jpeg_scan(const uint8_t *data, int64_t len, int ncomp, int16_t *const *coefs, const int32_t *geom,
                      const int32_t *dc_tables, const int32_t *ac_tables, int mcux, int mcuy, int ss, int se, int ah,
                      int al, int progressive, int restart_interval, int64_t *last_good) {
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
    src_t s = {data, 0, len, len, 0, 0, 0};
    hbits_t b = {&s, 0, 0, 0};
    scan_t sc = {ss, se, ah, al, progressive, 0};
    int32_t pred[4] = {0, 0, 0, 0};
    int next_rst = 0, dc_refine = progressive && ss == 0 && ah != 0;
    int64_t n_mcu = ncomp == 1 ? (int64_t)geom[3] * geom[4] : (int64_t)mcux * mcuy, togo = restart_interval;
    for (int64_t m = 0; m < n_mcu; m++) {
        if (!b.insufficient) *last_good = imcu_row(m, ncomp, geom, mcux);
        if (restart_interval) {
            if (togo == 0) {
                b.left = 0;
                src_restart_marker(&s, &next_rst);
                if (s.err) break;
                for (int c = 0; c < ncomp; c++) pred[c] = 0;
                sc.eobrun = 0;
                if (!s.unread) b.insufficient = 0;
                togo = restart_interval;
            }
            togo--;
        }
        if (b.insufficient && !dc_refine) continue;  /* (a refinement bit of 0 changes nothing) */
        int16_t *blk[10];
        int comp[10];
        int nb = mcu_blocks(m, ncomp, coefs, geom, mcux, blk, comp);
        for (int k = 0; k < nb; k++) decode_block(&b, blk[k], &dc[comp[k]], &ac[comp[k]], &pred[comp[k]], &sc);
        if (s.err) break;
    }
    ret = s.err ? s.err : src_end(&s);
done:
    free(dc);
    free(ac);
    return ret;
}

/* ---------------------------------------------- JPEG: arithmetic decoding */

/* ITU-T T.81 Table D.2: per state Qe, Next_Index_LPS, Next_Index_MPS and
 * Switch_MPS, packed as libjpeg-turbo packs them (Qe << 16 | NMPS << 8 |
 * Switch << 7 | NLPS), and a 114th state of fixed probability 1/2 (Qe
 * 0x5A1D, which never moves) for the sign of an AC coefficient and the bits
 * of DC refinement. */
#define Q(qe, nlps, nmps, sw) (((uint32_t)(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
static const uint32_t QE_TABLE[114] = {
    Q(0x5a1d,   1,   1, 1), Q(0x2586,  14,   2, 0), Q(0x1114,  16,   3, 0), Q(0x080b,  18,   4, 0),
    Q(0x03d8,  20,   5, 0), Q(0x01da,  23,   6, 0), Q(0x00e5,  25,   7, 0), Q(0x006f,  28,   8, 0),
    Q(0x0036,  30,   9, 0), Q(0x001a,  33,  10, 0), Q(0x000d,  35,  11, 0), Q(0x0006,   9,  12, 0),
    Q(0x0003,  10,  13, 0), Q(0x0001,  12,  13, 0), Q(0x5a7f,  15,  15, 1), Q(0x3f25,  36,  16, 0),
    Q(0x2cf2,  38,  17, 0), Q(0x207c,  39,  18, 0), Q(0x17b9,  40,  19, 0), Q(0x1182,  42,  20, 0),
    Q(0x0cef,  43,  21, 0), Q(0x09a1,  45,  22, 0), Q(0x072f,  46,  23, 0), Q(0x055c,  48,  24, 0),
    Q(0x0406,  49,  25, 0), Q(0x0303,  51,  26, 0), Q(0x0240,  52,  27, 0), Q(0x01b1,  54,  28, 0),
    Q(0x0144,  56,  29, 0), Q(0x00f5,  57,  30, 0), Q(0x00b7,  59,  31, 0), Q(0x008a,  60,  32, 0),
    Q(0x0068,  62,  33, 0), Q(0x004e,  63,  34, 0), Q(0x003b,  32,  35, 0), Q(0x002c,  33,   9, 0),
    Q(0x5ae1,  37,  37, 1), Q(0x484c,  64,  38, 0), Q(0x3a0d,  65,  39, 0), Q(0x2ef1,  67,  40, 0),
    Q(0x261f,  68,  41, 0), Q(0x1f33,  69,  42, 0), Q(0x19a8,  70,  43, 0), Q(0x1518,  72,  44, 0),
    Q(0x1177,  73,  45, 0), Q(0x0e74,  74,  46, 0), Q(0x0bfb,  75,  47, 0), Q(0x09f8,  77,  48, 0),
    Q(0x0861,  78,  49, 0), Q(0x0706,  79,  50, 0), Q(0x05cd,  48,  51, 0), Q(0x04de,  50,  52, 0),
    Q(0x040f,  50,  53, 0), Q(0x0363,  51,  54, 0), Q(0x02d4,  52,  55, 0), Q(0x025c,  53,  56, 0),
    Q(0x01f8,  54,  57, 0), Q(0x01a4,  55,  58, 0), Q(0x0160,  56,  59, 0), Q(0x0125,  57,  60, 0),
    Q(0x00f6,  58,  61, 0), Q(0x00cb,  59,  62, 0), Q(0x00ab,  61,  63, 0), Q(0x008f,  61,  32, 0),
    Q(0x5b12,  65,  65, 1), Q(0x4d04,  80,  66, 0), Q(0x412c,  81,  67, 0), Q(0x37d8,  82,  68, 0),
    Q(0x2fe8,  83,  69, 0), Q(0x293c,  84,  70, 0), Q(0x2379,  86,  71, 0), Q(0x1edf,  87,  72, 0),
    Q(0x1aa9,  87,  73, 0), Q(0x174e,  72,  74, 0), Q(0x1424,  72,  75, 0), Q(0x119c,  74,  76, 0),
    Q(0x0f6b,  74,  77, 0), Q(0x0d51,  75,  78, 0), Q(0x0bb6,  77,  79, 0), Q(0x0a40,  77,  48, 0),
    Q(0x5832,  80,  81, 1), Q(0x4d1c,  88,  82, 0), Q(0x438e,  89,  83, 0), Q(0x3bdd,  90,  84, 0),
    Q(0x34ee,  91,  85, 0), Q(0x2eae,  92,  86, 0), Q(0x299a,  93,  87, 0), Q(0x2516,  86,  71, 0),
    Q(0x5570,  88,  89, 1), Q(0x4ca9,  95,  90, 0), Q(0x44d9,  96,  91, 0), Q(0x3e22,  97,  92, 0),
    Q(0x3824,  99,  93, 0), Q(0x32b4,  99,  94, 0), Q(0x2e17,  93,  86, 0), Q(0x56a8,  95,  96, 1),
    Q(0x4f46, 101,  97, 0), Q(0x47e5, 102,  98, 0), Q(0x41cf, 103,  99, 0), Q(0x3c3d, 104, 100, 0),
    Q(0x375e,  99,  93, 0), Q(0x5231, 105, 102, 0), Q(0x4c0f, 106, 103, 0), Q(0x4639, 107, 104, 0),
    Q(0x415e, 103,  99, 0), Q(0x5627, 105, 106, 1), Q(0x50e7, 108, 107, 0), Q(0x4b85, 109, 103, 0),
    Q(0x5597, 110, 109, 0), Q(0x504f, 111, 107, 0), Q(0x5a10, 110, 111, 1), Q(0x5522, 112, 109, 0),
    Q(0x59eb, 112, 111, 1), Q(0x5a1d, 113, 113, 0),
};
#undef Q

/* The table, for a caller to hold against another copy of it. */
const uint32_t *vpt_jpeg_qe_table(void) { return QE_TABLE; }

#define FIXED_STATE 113
#define DC_BINS 64
#define AC_BINS 256

typedef struct {
    src_t *s;
    int64_t c, a;  /* the C and A registers */
    int ct;        /* bits left in C's input byte; -16 before the first two bytes, -1 after an error */
} arith_t;

/* D.2: decode one decision with the adaptive state *st (its high bit the
 * MPS), renormalising and reading bytes as libjpeg-turbo's arith_decode
 * does; after a marker the data reads as zeros. */
static inline int arith_decode(arith_t *e, uint8_t *st) {
    while (e->a < 0x8000) {
        if (--e->ct < 0) {
            int data = 0;
            src_t *s = e->s;
            if (!s->unread) {
                data = src_byte(s);
                if (data == 0xFF) {
                    do data = src_byte(s);
                    while (data == 0xFF && !s->err);
                    if (data == 0) {
                        data = 0xFF;
                    } else {
                        s->unread = data;
                        s->marker_at = s->pos - 2;
                        data = 0;
                    }
                }
            }
            e->c = (e->c << 8) | data;
            if ((e->ct += 8) < 0 && ++e->ct == 0) e->a = 0x8000;  /* two bytes in: A becomes 0x10000 below */
        }
        e->a <<= 1;
    }
    int sv = *st;
    uint32_t q = QE_TABLE[sv & 0x7F];
    int nl = q & 0xFF, nm = (q >> 8) & 0xFF;
    int64_t qe = q >> 16, temp = e->a - qe;
    e->a = temp;
    temp <<= e->ct;
    if (e->c >= temp) {
        e->c -= temp;
        if (e->a < qe) {  /* conditional exchange: the MPS after all */
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nm);
        } else {
            e->a = qe;
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        }
    } else if (e->a < 0x8000) {
        if (e->a < qe) {
            *st = (uint8_t)((sv & 0x80) ^ nl);
            sv ^= 0x80;
        } else {
            *st = (uint8_t)((sv & 0x80) ^ nm);
        }
    }
    return sv >> 7;
}

typedef struct {
    uint8_t dc[16][DC_BINS], ac[16][AC_BINS], fixed[4];
    int dc_tbl[4], ac_tbl[4], last_dc[4], dc_ctx[4];
    int L[16], U[16], K[16];  /* the DAC conditioning of each table */
    int ss, se, ah, al, progressive;
} arith_scan_t;

/* F.1.4.4.1 / F.2.4.1: a DC difference, added to the component's
 * predictor (16-bit, as libjpeg keeps it).  Returns -1 on a magnitude past
 * 2^15 (the decoder's error state). */
static int arith_dc(arith_t *e, arith_scan_t *as, int ci) {
    int tbl = as->dc_tbl[ci];
    uint8_t *st = as->dc[tbl] + as->dc_ctx[ci];
    if (arith_decode(e, st) == 0) {
        as->dc_ctx[ci] = 0;
        return 0;
    }
    int sign = arith_decode(e, st + 1), m, v;
    st += 2 + sign;
    if ((m = arith_decode(e, st)) != 0) {
        st = as->dc[tbl] + 20;
        while (arith_decode(e, st)) {
            if ((m <<= 1) == 0x8000) return -1;
            st++;
        }
    }
    if (m < ((1 << as->L[tbl]) >> 1))
        as->dc_ctx[ci] = 0;
    else if (m > ((1 << as->U[tbl]) >> 1))
        as->dc_ctx[ci] = 12 + sign * 4;
    else
        as->dc_ctx[ci] = 4 + sign * 4;
    v = m;
    st += 14;
    while (m >>= 1)
        if (arith_decode(e, st)) v |= m;
    v += 1;
    if (sign) v = -v;
    as->last_dc[ci] = (as->last_dc[ci] + v) & 0xFFFF;
    return 0;
}

/* F.1.4.4.2 / G.1.3.3: the AC coefficients ss..se of a block (scaled by
 * 2^al) until the end-of-block decision.  Returns -1 on a run past se or a
 * magnitude past 2^15; the coefficients decoded before stay. */
static int arith_ac(arith_t *e, arith_scan_t *as, int ci, int16_t *blk, int ss, int se, int al) {
    int tbl = as->ac_tbl[ci];
    for (int k = ss; k <= se; k++) {
        uint8_t *st = as->ac[tbl] + 3 * (k - 1);
        if (arith_decode(e, st)) break;  /* end of block */
        while (arith_decode(e, st + 1) == 0) {
            st += 3;
            if (++k > se) return -1;
        }
        int sign = arith_decode(e, as->fixed), m, v;
        st += 2;
        if ((m = arith_decode(e, st)) != 0 && arith_decode(e, st)) {
            m <<= 1;
            st = as->ac[tbl] + (k <= as->K[tbl] ? 189 : 217);
            while (arith_decode(e, st)) {
                if ((m <<= 1) == 0x8000) return -1;
                st++;
            }
        }
        v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(e, st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[NATURAL[k]] = (int16_t)(uint16_t)((uint32_t)v << al);
    }
    return 0;
}

/* G.1.3.3: an AC refinement: a correction bit for each coefficient already
 * nonzero, and coefficients that become +-2^al, up to the end of block,
 * which may only come past the last coefficient nonzero before. */
static int arith_ac_refine(arith_t *e, arith_scan_t *as, int16_t *blk) {
    int tbl = as->ac_tbl[0], p1 = 1 << as->al, m1 = -(1 << as->al), kex;
    for (kex = as->se; kex > 0; kex--)
        if (blk[NATURAL[kex]]) break;
    for (int k = as->ss; k <= as->se; k++) {
        uint8_t *st = as->ac[tbl] + 3 * (k - 1);
        if (k > kex && arith_decode(e, st)) break;
        for (;;) {
            int16_t *coef = blk + NATURAL[k];
            if (*coef) {
                if (arith_decode(e, st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
                break;
            }
            if (arith_decode(e, st + 1)) {
                *coef = (int16_t)(arith_decode(e, as->fixed) ? m1 : p1);
                break;
            }
            st += 3;
            if (++k > as->se) return -1;
        }
    }
    return 0;
}

/* Clear the statistics, predictors and DC contexts a scan uses (at its
 * start and at each restart) and restart the decoder's registers. */
static void arith_reset(arith_t *e, arith_scan_t *as, int ncomp) {
    for (int ci = 0; ci < ncomp; ci++) {
        if (!as->progressive || (as->ss == 0 && as->ah == 0)) {
            memset(as->dc[as->dc_tbl[ci]], 0, DC_BINS);
            as->last_dc[ci] = as->dc_ctx[ci] = 0;
        }
        if (!as->progressive || as->ss) memset(as->ac[as->ac_tbl[ci]], 0, AC_BINS);
    }
    e->c = e->a = 0;
    e->ct = -16;
}

/* Decode one arithmetic-coded scan (Annex D, F.1.4.4 and G.1.3, as
 * libjpeg-turbo's jdarith.c decodes it) into the components' coefficient
 * arrays, in the layout vpt_jpeg_scan fills.
 *   data[0..len): the file from the scan's data on; limit: the bytes of it
 *     the decoder may fetch (see src_t);
 *   tbls: per component its DC and AC statistics table (0-15);
 *   cond: the DAC conditioning, L[16], U[16], then K[16];
 *   the rest as for vpt_jpeg_scan (last_good: the scan's last iMCU row).
 * A magnitude or run that the code cannot have (libjpeg's JWRN_ARITH_BAD_CODE)
 * leaves the rest of the restart interval's blocks as they are, as libjpeg
 * does.  Returns the offset of the marker after the scan (len if there is
 * none), or a negative error. */
int64_t vpt_jpeg_arith_scan(const uint8_t *data, int64_t len, int64_t limit, int ncomp, int16_t *const *coefs,
                            const int32_t *geom, const int32_t *tbls, const int32_t *cond, int mcux, int mcuy, int ss,
                            int se, int ah, int al, int progressive, int restart_interval, int64_t *last_good) {
    if (ncomp < 1 || ncomp > 4 || ss < 0 || se > 63 || ss > se || al > 13) return ERR_ARGS;
    arith_scan_t *as = (arith_scan_t *)calloc(1, sizeof(arith_scan_t));
    if (!as) return ERR_ARGS;
    src_t s = {data, 0, limit < len ? limit : len, len, 0, 0, 0};
    arith_t e = {&s, 0, 0, -16};
    int next_rst = 0;
    int64_t ret = 0;
    as->ss = ss, as->se = se, as->ah = ah, as->al = al, as->progressive = progressive;
    as->fixed[0] = FIXED_STATE;
    for (int t = 0; t < 16; t++) {
        as->L[t] = cond[t];
        as->U[t] = cond[16 + t];
        as->K[t] = cond[32 + t];
    }
    for (int ci = 0; ci < ncomp; ci++) {
        as->dc_tbl[ci] = tbls[2 * ci] & 15;
        as->ac_tbl[ci] = tbls[2 * ci + 1] & 15;
    }
    arith_reset(&e, as, ncomp);
    int64_t n_mcu = ncomp == 1 ? (int64_t)geom[3] * geom[4] : (int64_t)mcux * mcuy, togo = restart_interval;
    int dc_refine = progressive && ss == 0 && ah != 0;
    for (int64_t m = 0; m < n_mcu; m++) {
        *last_good = imcu_row(m, ncomp, geom, mcux);  /* (libjpeg's arithmetic decoder never runs dry) */
        if (restart_interval) {
            if (togo == 0) {
                src_restart_marker(&s, &next_rst);
                arith_reset(&e, as, ncomp);
                togo = restart_interval;
            }
            togo--;
        }
        if (s.err) break;
        if (e.ct == -1 && !dc_refine) continue;
        int16_t *blk[10];
        int comp[10];
        int nb = mcu_blocks(m, ncomp, coefs, geom, mcux, blk, comp), bad = 0;
        for (int k = 0; k < nb && !bad; k++) {
            int ci = comp[k];
            if (!progressive) {
                bad = arith_dc(&e, as, ci);
                if (!bad) {
                    blk[k][0] = (int16_t)(uint16_t)as->last_dc[ci];
                    bad = arith_ac(&e, as, ci, blk[k], 1, 63, 0);
                }
            } else if (ss == 0 && ah == 0) {
                bad = arith_dc(&e, as, ci);
                if (!bad) blk[k][0] = (int16_t)(uint16_t)((uint32_t)as->last_dc[ci] << al);
            } else if (ss == 0) {
                if (arith_decode(&e, as->fixed)) blk[k][0] = (int16_t)(blk[k][0] | (1 << al));
            } else if (ah == 0) {
                bad = arith_ac(&e, as, 0, blk[k], ss, se, al);
            } else {
                bad = arith_ac_refine(&e, as, blk[k]);
            }
        }
        if (bad) e.ct = -1;
        if (s.err) break;
    }
    ret = s.err ? s.err : src_end(&s);
    free(as);
    return ret;
}

/* ---------------------------------------------------- JPEG: lossless (SOF3) */

/* H.1.2.1: the prediction of a sample from the one to its left (ra), above
 * (rb) and above-left (rc), as libjpeg-turbo's jdlossls.c forms it. */
static inline int predict(int psv, int ra, int rb, int rc) {
    switch (psv) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;
    }
}

/* Decode one lossless Huffman-coded scan (Annex H, as libjpeg-turbo's
 * jdlhuff.c, jddiffct.c and jdlossls.c decode it) into the components'
 * sample planes: uint16 (dh, dw) each, the undifferenced values before the
 * point transform's shift.
 *   geom: per component h, v, dw, dh;
 *   tables: per component its DC Huffman table (TABLE_WORDS words);
 *   mcux: MCUs per row (ncomp 1: the component's width); imcu_rows: the
 *     frame's rows of MCUs (ceil(height / largest v)); psv: the predictor
 *     1-7; pt: the point transform; restart_interval: in MCUs, a multiple of
 *     mcux.
 * The differences are decoded a row of MCUs at a time and undifferenced an
 * iMCU row at a time, as libjpeg does: the first row of the scan, and the
 * first row undifferenced after each restart, is predicted from its left
 * neighbour alone, seeded with 2^(7 - pt); every other row starts from the
 * sample above.  Once the data has run dry (a marker in the way) the rows of
 * MCUs after are decoded as zero differences restarting from the seed, until
 * a restart marker is found.  Returns the offset of the marker after the
 * scan (len if there is none), or a negative error. */
int64_t vpt_jpeg_lossless_scan(const uint8_t *data, int64_t len, int ncomp, uint16_t *const *planes,
                               const int32_t *geom, const int32_t *tables, int mcux, int imcu_rows, int psv, int pt,
                               int restart_interval) {
    if (ncomp < 1 || ncomp > 4 || psv < 1 || psv > 7 || pt < 0 || pt > 7 || mcux < 1) return ERR_ARGS;
    huff_t *t = (huff_t *)malloc(sizeof(huff_t) * ncomp);
    int32_t *diff[4] = {NULL, NULL, NULL, NULL};
    int64_t width[4], ret = 0;
    int first[4];
    if (!t) return ERR_ARGS;
    for (int c = 0; c < ncomp; c++) {
        const int32_t *g = geom + 4 * c;
        width[c] = ncomp == 1 ? mcux : (int64_t)mcux * g[0];
        diff[c] = (int32_t *)calloc((size_t)(width[c] * g[1]), sizeof(int32_t));
        if (!diff[c] || build_huff(&t[c], tables + c * TABLE_WORDS)) {
            ret = diff[c] ? ERR_TABLE : ERR_ARGS;
            goto done;
        }
        first[c] = 1;
    }
    src_t s = {data, 0, len, len, 0, 0, 0};
    hbits_t b = {&s, 0, 0, 0};
    int next_rst = 0, seed = 1 << (8 - pt - 1);
    int64_t rows_per_interval = restart_interval / mcux, togo = rows_per_interval;
    for (int64_t r = 0; r < imcu_rows; r++) {
        int64_t mcu_rows = 1;
        if (ncomp == 1) {
            const int32_t *g = geom;
            mcu_rows = r < imcu_rows - 1 ? g[1] : g[3] - (imcu_rows - 1) * g[1];
        }
        for (int64_t yo = 0; yo < mcu_rows; yo++) {
            if (restart_interval && togo == 0) {
                b.left = 0;
                src_restart_marker(&s, &next_rst);
                if (s.err) break;
                if (!s.unread) b.insufficient = 0;
                for (int c = 0; c < ncomp; c++) first[c] = 1;
                togo = rows_per_interval;
            }
            if (b.insufficient) {
                for (int c = 0; c < ncomp; c++) {
                    const int32_t *g = geom + 4 * c;
                    int64_t rows = ncomp == 1 ? 1 : g[1];
                    int32_t *row0 = diff[c] + (ncomp == 1 ? yo : 0) * width[c];
                    memset(row0, 0, sizeof(int32_t) * (size_t)(rows * width[c]));
                    first[c] = 1;
                }
            } else {
                for (int64_t mx = 0; mx < mcux; mx++) {
                    for (int c = 0; c < ncomp; c++) {
                        const int32_t *g = geom + 4 * c;
                        int h = ncomp == 1 ? 1 : g[0], v = ncomp == 1 ? 1 : g[1];
                        for (int y = 0; y < v; y++) {
                            int32_t *row = diff[c] + (ncomp == 1 ? yo : y) * width[c] + mx * h;
                            for (int x = 0; x < h; x++) {
                                int sym = hdecode(&b, &t[c]), d = 0;
                                if (sym == 16) {
                                    d = 32768;
                                } else if (sym) {
                                    d = extend(hbits(&b, sym), sym);
                                }
                                row[x] = d;
                            }
                        }
                    }
                    if (s.err) break;
                }
            }
            if (s.err) break;
            if (restart_interval) togo--;
        }
        if (s.err) break;
        for (int c = 0; c < ncomp; c++) {  /* undifference this iMCU row's rows of each component */
            const int32_t *g = geom + 4 * c;
            int64_t v = g[1], dw = g[2], dh = g[3];
            for (int64_t y = 0; y < v && r * v + y < dh; y++) {
                const int32_t *d = diff[c] + y * width[c];
                uint16_t *out = planes[c] + (r * v + y) * dw;
                if (first[c]) {
                    int ra = (d[0] + seed) & 0xFFFF;
                    out[0] = (uint16_t)ra;
                    for (int64_t x = 1; x < dw; x++) out[x] = (uint16_t)(ra = (d[x] + ra) & 0xFFFF);
                    first[c] = 0;
                } else {
                    const uint16_t *up = out - dw;
                    int rb = up[0], ra = (d[0] + rb) & 0xFFFF, rc;
                    out[0] = (uint16_t)ra;
                    for (int64_t x = 1; x < dw; x++) {
                        rc = rb;
                        rb = up[x];
                        out[x] = (uint16_t)(ra = (d[x] + predict(psv, ra, rb, rc)) & 0xFFFF);
                    }
                }
            }
        }
    }
    ret = s.err ? s.err : src_end(&s);
done:
    for (int c = 0; c < ncomp; c++) free(diff[c]);
    free(t);
    return ret;
}

/* ---------------------------------------------------------- JPEG: IDCT */

#define CONST_BITS 13
#define PASS1_BITS 2

/* The "islow" inverse DCT as libjpeg-turbo's SIMD code (jidctint-sse2 /
 * -avx2, what PIL's decoder runs) computes it: the fixed-point algorithm of
 * jidctint.c (13 fraction bits, 2 extra bits between the passes, round-half-up
 * descaling) in 16-bit lanes.  The dequantised coefficients, the sums in0 +-
 * in4, in7 + in3 and in5 + in1 and the first pass's outputs are 16-bit
 * (the first three wrap, the outputs saturate), the products and the rest
 * 32-bit (wrapping), and a block whose rows 1-7 are all zero takes the first
 * pass's shortcut, each dequantised DC << 2 in 16 bits.  For the
 * coefficients of a valid 8-bit JPEG nothing wraps or saturates, and this is
 * the C algorithm; for corrupt data it gives what PIL gives. */
static inline int16_t wrap16(int32_t v) { return (int16_t)(uint16_t)(uint32_t)v; }
static inline int16_t sat16(int32_t v) { return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v)); }
static inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
static inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }

/* One 8-point pass over in[0], in[s], ..., in[7 s]; the sums before
 * descaling in out[0..7].  The odd part's rotations are regrouped as the
 * SIMD code groups them, two products per 32-bit sum (pmaddwd). */
static inline void idct8(const int16_t *in, int s, int32_t *out) {
    int32_t z2 = in[2 * s], z3 = in[6 * s];
    int32_t tmp3 = z2 * 10703 + z3 * 4433;    /* (F_0_541 + F_0_765, F_0_541) */
    int32_t tmp2 = z2 * 4433 + z3 * -10704;   /* (F_0_541, F_0_541 - F_1_847) */
    int32_t tmp0 = (int32_t)wrap16(in[0] + in[4 * s]) * (1 << CONST_BITS);
    int32_t tmp1 = (int32_t)wrap16(in[0] - in[4 * s]) * (1 << CONST_BITS);
    int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3), tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
    int32_t i7 = in[7 * s], i5 = in[5 * s], i3 = in[3 * s], i1 = in[1 * s];
    int32_t z3s = wrap16(i7 + i3), z4s = wrap16(i5 + i1);
    int32_t z3r = z3s * -6436 + z4s * 9633;   /* (F_1_175 - F_1_961, F_1_175) */
    int32_t z4r = z3s * 9633 + z4s * 6437;    /* (F_1_175, F_1_175 - F_0_390) */
    int32_t o0 = add32(i7 * -4927 + i1 * -7373, z3r);   /* (F_0_298 - F_0_899, -F_0_899) */
    int32_t o3 = add32(i7 * -7373 + i1 * 4926, z4r);    /* (-F_0_899, F_1_501 - F_0_899) */
    int32_t o1 = add32(i5 * -4176 + i3 * -20995, z4r);  /* (F_2_053 - F_2_562, -F_2_562) */
    int32_t o2 = add32(i5 * -20995 + i3 * 4177, z3r);   /* (-F_2_562, F_3_072 - F_2_562) */
    out[0] = add32(tmp10, o3);
    out[7] = sub32(tmp10, o3);
    out[1] = add32(tmp11, o2);
    out[6] = sub32(tmp11, o2);
    out[2] = add32(tmp12, o1);
    out[5] = sub32(tmp12, o1);
    out[3] = add32(tmp13, o0);
    out[4] = sub32(tmp13, o0);
}

/* Dequantise (qt: 64 values in natural order) and inverse-transform the
 * blocks of one component, (nby, nbx, 64) int16 coefficients, into its
 * sample plane (nby * 8, nbx * 8) uint8. */
void vpt_jpeg_idct(const int16_t *coefs, int64_t nby, int64_t nbx, const int32_t *qt, uint8_t *plane) {
    int64_t width = nbx * 8;
    const int p1 = CONST_BITS - PASS1_BITS, p2 = CONST_BITS + PASS1_BITS + 3;
    for (int64_t by = 0; by < nby; by++) {
        for (int64_t bx = 0; bx < nbx; bx++) {
            const int16_t *blk = coefs + (by * nbx + bx) * 64;
            int16_t in[64], ws[64];
            int32_t out[8];
            int ac = 0;
            for (int i = 8; i < 64; i++) ac |= blk[i];
            for (int i = 0; i < 64; i++) in[i] = wrap16(blk[i] * qt[i]);
            if (!ac) {  /* pass 1's shortcut: every column is its DC */
                for (int i = 0; i < 64; i++) ws[i] = wrap16(in[i & 7] * (1 << PASS1_BITS));
            } else {
                for (int x = 0; x < 8; x++) {  /* pass 1: columns */
                    idct8(in + x, 8, out);
                    for (int y = 0; y < 8; y++) ws[y * 8 + x] = sat16(add32(out[y], 1 << (p1 - 1)) >> p1);
                }
            }
            for (int y = 0; y < 8; y++) {  /* pass 2: rows, to samples */
                idct8(ws + y * 8, 1, out);
                uint8_t *dst = plane + (by * 8 + y) * width + bx * 8;
                for (int x = 0; x < 8; x++) {
                    int32_t v = add32(out[x], 1 << (p2 - 1)) >> p2;
                    dst[x] = (uint8_t)((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
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
 * last_bits: the successive-approximation bit of coefficients 0..9 after
 * the last scan (-1 never coded); prev_bits: the same before the last scan
 * of the component, which libjpeg-turbo uses for the iMCU rows after
 * last_good, the last one whose MCUs the last scan decoded before its data
 * ran dry.  The rows are walked per iMCU row as libjpeg-turbo walks them:
 * in the last iMCU row, whose block rows may be fewer than v, the test for
 * a row above or below counts those fewer rows. */
void vpt_jpeg_smooth(const int16_t *coefs, int16_t *out, int64_t bw, int64_t nbx, int64_t nby, int v, int64_t rows,
                     const int32_t *qt, const int32_t *last_bits, const int32_t *prev_bits, int64_t last_good) {
    int64_t q[10];
    for (int k = 0; k < 10; k++) q[k] = qt[SMOOTH_POS[k]];
    int64_t last = nbx - 1;
    for (int64_t r = 0; r < rows; r++) {
        const int32_t *bits = r > last_good ? prev_bits : last_bits;
        int change_dc = 1;
        for (int k = 1; k < 10; k++) change_dc &= bits[k] == -1;
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
 * for a strip that does not begin with CLEAR or is under 4 bytes, -2 - n for
 * a code after CLEAR that is no byte or a code further past the table, n
 * the bytes decoded before it. */
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
                ret = -2 - total;
                goto done;
            }
            EMIT(code);
        } else {
            if (code > tablen) {
                ret = -2 - total;
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

/* ---------------------------------------------------- TGA, PCX, PackBits */

/* A TGA RLE stream (Truevision TGA 2.0: a packet header byte, bit 7 run or
 * raw, bits 0-6 the pixel count less one) of `rows` scanlines of row_bytes
 * bytes, `depth` bytes per pixel, into out in stream order, as PIL's decoder
 * reads it: a raw packet may run on over any number of scanlines, a run
 * packet that crosses the end of a scanline is an error.  Returns the bytes
 * read; *status is 0 when every scanline was decoded, 1 when the data ends
 * first, -1 for a run across a scanline. */
int64_t vpt_tga_rle(const uint8_t *in, int64_t n, int depth, int64_t row_bytes, int64_t rows, uint8_t *out,
                    int *status) {
    int64_t i = 0, x = 0, y = 0;
    while (y < rows) {
        if (i >= n) break;
        int64_t count = (int64_t)depth * ((in[i] & 0x7f) + 1);
        if (in[i] & 0x80) {
            if (i + 1 + depth > n) break;
            if (x + count > row_bytes) {
                *status = -1;
                return i;
            }
            for (int64_t k = 0; k < count; k += depth) memcpy(out + y * row_bytes + x + k, in + i + 1, depth);
            i += 1 + depth;
            x += count;
            if (x >= row_bytes) {
                x = 0;
                y++;
            }
            continue;
        }
        if (i + 1 + count > n) break;
        i++;
        while (count > 0 && y < rows) { /* a raw packet, over as many scanlines as it covers */
            int64_t take = row_bytes - x < count ? row_bytes - x : count;
            memcpy(out + y * row_bytes + x, in + i, take);
            i += take;
            count -= take;
            x += take;
            if (x >= row_bytes) {
                x = 0;
                y++;
            }
        }
    }
    *status = y < rows;
    return i;
}

/* A PCX RLE stream (ZSoft PCX: a byte with both top bits set repeats the
 * next byte its low six bits' times) of `rows` scanlines of `bytes` bytes,
 * as PIL's decoder reads it: a run may not cross the end of a scanline, and
 * a scanline whose planes are padded has its planes moved together before it
 * is unpacked (plane i from i * stride to i * size; for the 2- and 4-plane
 * 1-bit layouts, bits 2 or 4, size is (xsize + 7) / 8 and stride bytes /
 * bits, else size is xsize and stride bytes / (bytes / xsize)).  Returns the
 * bytes read; *status is 0 when every scanline was decoded, 1 when the data
 * ends first, -1 for a run past a scanline's end. */
int64_t vpt_pcx_rle(const uint8_t *in, int64_t n, int64_t bytes, int64_t xsize, int bits, int64_t rows,
                    uint8_t *out, int *status) {
    int64_t i = 0, x = 0, y = 0;
    int overrun = 0;
    while (y < rows) {
        uint8_t *line = out + y * bytes;
        if (i >= n) break;
        if ((in[i] & 0xc0) == 0xc0) {
            if (i + 2 > n) break;
            for (int c = in[i] & 0x3f; c > 0; c--) {
                if (x >= bytes) {
                    overrun = 1;
                    break;
                }
                line[x++] = in[i + 1];
            }
            i += 2;
        } else {
            line[x++] = in[i++];
        }
        if (x >= bytes) {
            int64_t size = xsize, bands, stride = 0;
            if (bits == 2 || bits == 4) {
                size = (xsize + 7) / 8;
                bands = bits;
                stride = bytes / bits;
            } else {
                bands = bytes / xsize;
                if (bands) stride = bytes / bands;
            }
            if (stride > size)
                for (int64_t b = 1; b < bands; b++) memmove(line + b * size, line + b * stride, size);
            x = 0;
            y++;
        }
    }
    *status = overrun ? -1 : y < rows;
    return i;
}

/* PackBits (Apple technical note 1023; -128 a no-op) of `rows` scanlines of
 * row_bytes bytes, as PIL's decoder reads a PSD channel: a packet that runs
 * past the end of a scanline is cut there, the next packet starts the next
 * scanline.  Returns the bytes read; *status is 0 when every scanline was
 * decoded, 1 when the data ends first. */
int64_t vpt_packbits_rows(const uint8_t *in, int64_t n, int64_t row_bytes, int64_t rows, uint8_t *out, int *status) {
    int64_t i = 0, x = 0, y = 0;
    while (y < rows) {
        if (i >= n) break;
        uint8_t *line = out + y * row_bytes;
        if (in[i] & 0x80) {
            if (in[i] == 0x80) {
                i++;
                continue;
            }
            if (i + 2 > n) break;
            for (int c = 257 - in[i]; c > 0 && x < row_bytes; c--) line[x++] = in[i + 1];
            i += 2;
        } else {
            int64_t len = in[i] + 2;
            if (i + len > n) break;
            for (int64_t k = 1; k < len && x < row_bytes; k++) line[x++] = in[i + k];
            i += len;
        }
        if (x >= row_bytes) {
            x = 0;
            y++;
        }
    }
    *status = y < rows;
    return i;
}

/* ------------------------------------------------------------------ SGI */

/* One scanline channel of SGI RLE (bit 7 a literal count, bits 0-6 the
 * count, 0 the end), read as PIL reads it: `ops` (the row's length field)
 * bounds the number of packets, not bytes, and a last packet that is no
 * terminator ends the whole image.  Samples are bpc bytes, z samples apart.
 * Returns 0, 1 (the image ends here) or -1 (past the row or the data). */
static int sgi_row(uint8_t *dest, const uint8_t *buf, int64_t at, int64_t ops, int z, int64_t xsize, int bpc,
                   int64_t last) {
    int64_t x = 0, src = at;
    for (; ops > 0; ops--) {
        if (src + bpc - 1 > last) return -1;
        uint8_t pixel = buf[src + bpc - 1];
        src += bpc;
        if (ops == 1 && pixel != 0) return 1;
        int count = pixel & 0x7f;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (src + (int64_t)bpc * count > last) return -1;
            for (; count; count--, src += bpc, dest += z * bpc) memcpy(dest, buf + src, bpc);
        } else {
            if (src + (bpc == 2 ? 2 : 0) > last) return -1;
            for (; count; count--, dest += z * bpc) memcpy(dest, buf + src, bpc);
            src += bpc;
        }
    }
    return 0;
}

/* The scanlines of an RLE SGI image (the SGI image file format, version
 * 1.0): buf is the file after its 512-byte header, start and length the
 * tables of bands * ysize row offsets (file offsets) and lengths.  Each row
 * interleaves its bands' samples into one line buffer that carries over from
 * row to row, as PIL's decoder does, and is copied to out (row after row in
 * file order, xsize * bands * bpc bytes each).  Returns the rows stored
 * (fewer than ysize when a row ends the image, the rest left as they are),
 * or -1 when a row reaches outside the data. */
int64_t vpt_sgi_rle(const uint8_t *buf, int64_t size, const uint32_t *start, const uint32_t *length, int bands,
                    int64_t xsize, int64_t ysize, int bpc, uint8_t *line, uint8_t *out) {
    int64_t row_bytes = xsize * bands * bpc;
    for (int64_t row = 0; row < ysize; row++) {
        for (int c = 0; c < bands; c++) {
            int64_t offset = start[row + c * ysize], len = length[row + c * ysize];
            if (offset < 512) return -1;
            offset -= 512;
            if (offset + len > size) return -1;
            int st = sgi_row(line + c * bpc, buf, offset, len, bands, xsize, bpc, size - 1);
            if (st == -1) return -1;
            if (st == 1) return row;
        }
        memcpy(out + row * row_bytes, line, row_bytes);
    }
    return ysize;
}

/* ------------------------------------------------------------------ QOI */

/* A QOI stream (the QOI specification 1.0: RGB, RGBA, INDEX, DIFF, LUMA and
 * RUN ops, the 64-entry index of (r * 3 + g * 5 + b * 7 + a * 11) % 64) of
 * `pixels` pixels into out, `channels` (3 or 4) bytes each, as PIL's decoder
 * reads it: no end marker is looked for, a run past the last pixel is cut.
 * Returns 0, or -1 when the data ends before the last pixel. */
int vpt_qoi_decode(const uint8_t *in, int64_t n, int64_t pixels, int channels, uint8_t *out) {
    uint8_t index[64][4], px[4] = {0, 0, 0, 255};
    memset(index, 0, sizeof(index));
    int64_t i = 0, p = 0;
    while (p < pixels) {
        if (i >= n) return -1;
        int b = in[i++], run = 1, is_run = 0;
        if (b == 0xfe) {
            if (i + 3 > n) return -1;
            memcpy(px, in + i, 3);
            i += 3;
        } else if (b == 0xff) {
            if (i + 4 > n) return -1;
            memcpy(px, in + i, 4);
            i += 4;
        } else if ((b >> 6) == 0) {
            memcpy(px, index[b & 63], 4);
        } else if ((b >> 6) == 1) {
            px[0] = (uint8_t)(px[0] + ((b >> 4) & 3) - 2);
            px[1] = (uint8_t)(px[1] + ((b >> 2) & 3) - 2);
            px[2] = (uint8_t)(px[2] + (b & 3) - 2);
        } else if ((b >> 6) == 2) {
            if (i >= n) return -1;
            int b2 = in[i++], vg = (b & 63) - 32;
            px[0] = (uint8_t)(px[0] + vg + ((b2 >> 4) & 15) - 8);
            px[1] = (uint8_t)(px[1] + vg);
            px[2] = (uint8_t)(px[2] + vg + (b2 & 15) - 8);
        } else {
            run = (b & 63) + 1;
            is_run = 1;
        }
        if (!is_run) memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
        for (; run && p < pixels; run--, p++) memcpy(out + p * channels, px, channels);
    }
    return 0;
}

/* PIL's Lab -> sRGB (io/lab.py): n pixels of PIL Lab bytes (L, signed a, b)
   through LittleCMS 2.17's TetrahedralInterp16 of `grid` (33^3 nodes of 3
   16-bit samples, L outermost), then FROM_16_TO_8. */
void vpt_lab_to_rgb(const uint8_t *lab, int64_t n, const uint16_t *grid, uint8_t *out) {
    const int64_t step[3] = {33 * 33 * 3, 33 * 3, 3};
    for (int64_t i = 0; i < n; i++) {
        int64_t base = 0, r[3], d[3];
        for (int k = 0; k < 3; k++) {
            int64_t v = (int64_t)(k ? lab[3 * i + k] ^ 0x80 : lab[3 * i]) * 257;
            int64_t a = v * 32;
            int64_t fx = a + (a + 0x7fff) / 0xffff;  /* _cmsToFixedDomain */
            base += (fx >> 16) * step[k];
            r[k] = fx & 0xffff;
            d[k] = v == 0xffff ? 0 : step[k];
        }
        /* the tetrahedron: the axes by falling fraction (on a tie either
           order gives the same sum) */
        int o[3] = {0, 1, 2};
        for (int p = 0; p < 2; p++)
            for (int q = 0; q < 2 - p; q++)
                if (r[o[q]] < r[o[q + 1]]) { int t = o[q]; o[q] = o[q + 1]; o[q + 1] = t; }
        int64_t o1 = d[o[0]], o2 = o1 + d[o[1]], o3 = o2 + d[o[2]];
        for (int ch = 0; ch < 3; ch++) {
            int64_t c0 = grid[base + ch], c1 = grid[base + o1 + ch], c2 = grid[base + o2 + ch];
            int64_t c3 = grid[base + o3 + ch];
            int64_t rest = (c1 - c0) * r[o[0]] + (c2 - c1) * r[o[1]] + (c3 - c2) * r[o[2]] + 0x8001;
            int64_t v16 = (c0 + ((rest + (rest >> 16)) >> 16)) & 0xffff;
            out[3 * i + ch] = (uint8_t)((v16 * 65281 + 8388608) >> 24);
        }
    }
}

/* ------------------------------------------------------- Radiance (OpenCV) */

/* A Radiance picture's pixels as OpenCV's rgbe.cpp (RGBE_ReadPixels_RLE,
 * Bruce Walter's reader) reads them, into w * h RGBE quadruples.  Scanlines
 * of width 8..32767 may be new-style run-length coded (2, 2, then the width
 * big-endian, then four channel planes of runs: a count above 128 repeats the
 * next byte count - 128 times, else count bytes follow); the first scanline
 * that does not begin so switches the rest of the picture to flat
 * quadruples, that one's four bytes the first of them.  Other widths are
 * flat throughout.  Old-style runs (1, 1, 1, n) are not expanded.  Returns 0,
 * -1 where the data ends first, -2 for a scanline of another width and -3 for
 * a run of 0 or past the end of its channel. */
int vpt_rgbe_cv(const uint8_t *in, int64_t n, int64_t w, int64_t h, uint8_t *out) {
    int64_t i = 0, total = w * h, done = 0;
    if (w < 8 || w > 0x7fff) {
        if (n < total * 4) return -1;
        memcpy(out, in, (size_t)(total * 4));
        return 0;
    }
    uint8_t *line = (uint8_t *)malloc((size_t)(4 * w));
    if (!line) return -1;
    for (int64_t y = 0; y < h; y++) {
        if (i + 4 > n) { free(line); return -1; }
        const uint8_t *q = in + i;
        i += 4;
        if (q[0] != 2 || q[1] != 2 || (q[2] & 0x80)) {
            free(line);
            int64_t rest = total - done;
            if (n - (i - 4) < rest * 4) return -1;
            memcpy(out + done * 4, q, (size_t)(rest * 4));
            return 0;
        }
        if ((((int64_t)q[2] << 8) | q[3]) != w) { free(line); return -2; }
        int64_t p = 0;
        for (int c = 0; c < 4; c++) {
            int64_t end = (int64_t)(c + 1) * w;
            while (p < end) {
                if (i + 2 > n) { free(line); return -1; }
                int count = in[i], val = in[i + 1];
                i += 2;
                if (count > 128) {
                    count -= 128;
                    if (count > end - p) { free(line); return -3; }
                    memset(line + p, val, (size_t)count);
                    p += count;
                } else {
                    if (count == 0 || count > end - p) { free(line); return -3; }
                    line[p++] = (uint8_t)val;
                    if (--count > 0) {
                        if (i + count > n) { free(line); return -1; }
                        memcpy(line + p, in + i, (size_t)count);
                        i += count;
                        p += count;
                    }
                }
            }
        }
        for (int64_t x = 0; x < w; x++)
            for (int c = 0; c < 4; c++) out[(done + x) * 4 + c] = line[c * w + x];
        done += w;
    }
    free(line);
    return 0;
}

/* ------------------------------------------------- PIL's rarer plugins */

/* PIL's "bit" decoder as ImImagePlugin drives it for its "L*n" float
 * images (fill 3, pad 8, unsigned, no table): each byte goes in above the
 * bits still held, n-bit fields come off the low end, a line's fields start
 * afresh (the bit count reset, the bits held kept), rows bottom-up.
 * Returns 0 when every row was decoded, -1 when the data ends first. */
int vpt_bit_decode(const uint8_t *in, int64_t n, float *out, int64_t w, int64_t h, int bits) {
    uint64_t buffer = 0, mask = (uint64_t)(uint32_t)((1 << bits) - 1);
    int count = 0;
    int64_t x = 0, y = h - 1;
    for (int64_t i = 0; i < n; i++) {
        uint8_t byte = in[i];
        buffer |= (uint64_t)byte << count;
        count += 8;
        while (count >= bits) {
            uint64_t data = buffer & mask;
            if (count > 32)
                buffer = byte >> (8 - (count - bits));
            else
                buffer >>= bits;
            count -= bits;
            out[y * w + x] = (float)data;
            if (++x >= w) {
                if (--y < 0) return 0;
                x = 0;
                count = 0;
            }
        }
    }
    return -1;
}

/* PIL's Sun raster RLE decoder (SunRleDecode.c): 0x80 0 is a literal 0x80,
 * 0x80 n v a run of n + 1 bytes v that goes on across scanlines, any other
 * byte itself; scanlines of `bytes` bytes, no padding.  Returns 0 when
 * every row was decoded, -1 when the data ends first. */
int vpt_sun_rle(const uint8_t *in, int64_t n, int64_t bytes, int64_t rows, uint8_t *out) {
    int64_t i = 0, x = 0, y = 0;
    while (y < rows) {
        int64_t run, extra = 0;
        uint8_t v;
        if (i >= n) return -1;
        if (in[i] == 0x80) {
            if (i + 2 > n) return -1;
            if (in[i + 1] == 0) {
                run = 1;
                v = 0x80;
                i += 2;
            } else {
                if (i + 3 > n) return -1;
                run = in[i + 1] + 1;
                v = in[i + 2];
                i += 3;
            }
        } else {
            run = 1;
            v = in[i++];
        }
        if (x + run > bytes) {
            extra = run - (bytes - x);
            run = bytes - x;
        }
        for (;;) {
            memset(out + y * bytes + x, v, (size_t)run);
            x += run;
            if (x >= bytes) {
                x = 0;
                if (++y >= rows) return 0;
            }
            if (extra == 0) break;
            run = extra < bytes ? extra : bytes;
            extra -= run;
        }
    }
    return 0;
}

/* PIL's Windows Paint v2 decoder (MspImagePlugin.MspDecoder): the row map
 * of h 16-bit lengths at byte 32, then each row's runs (0 count value: a
 * run; n: n literal bytes, cut at the row's end); an empty row is `blank`
 * bytes of 0xff.  The rows' bytes go out back to back, the first `cap`
 * kept; *made is how many there were.  Returns 0, -1 for a file shorter
 * than its row map or a row, -2 for a run cut by its row's end. */
int vpt_msp_rle(const uint8_t *in, int64_t n, int64_t h, int64_t blank, uint8_t *out, int64_t cap, int64_t *made) {
    int64_t o = 0, pos = 32 + 2 * h;
    *made = 0;
    if (pos > n) return -1;
    for (int64_t y = 0; y < h; y++) {
        int64_t len = in[32 + 2 * y] | (int64_t)in[33 + 2 * y] << 8;
        if (len == 0) {
            for (int64_t k = 0; k < blank; k++, o++)
                if (o < cap) out[o] = 0xff;
            continue;
        }
        if (pos + len > n) return -1;
        const uint8_t *row = in + pos;
        pos += len;
        int64_t idx = 0;
        while (idx < len) {
            int type = row[idx++];
            if (type == 0) {
                if (idx + 2 > len) return -2;
                int count = row[idx], val = row[idx + 1];
                idx += 2;
                for (int k = 0; k < count; k++, o++)
                    if (o < cap) out[o] = (uint8_t)val;
            } else {
                int64_t end = idx + type < len ? idx + type : len;
                for (int64_t k = idx; k < end; k++, o++)
                    if (o < cap) out[o] = row[k];
                idx += type;
            }
        }
    }
    *made = o;
    return 0;
}

/* PIL's X bitmap decoder (XbmDecode.c): skip to the next 'x', take the two
 * characters after it as hex digits (anything else counts 0), three bytes
 * a value; scanlines of `bytes` values.  Returns 0 when every row was
 * decoded, -1 when the data ends first. */
static int hexval(uint8_t c) {
    return c >= '0' && c <= '9' ? c - '0' : c >= 'a' && c <= 'f' ? c - 'a' + 10 : c >= 'A' && c <= 'F' ? c - 'A' + 10 : 0;
}

int vpt_xbm_hex(const uint8_t *in, int64_t n, int64_t bytes, int64_t rows, uint8_t *out) {
    int64_t i = 0, k = 0, total = bytes * rows;
    while (k < total) {
        while (i < n && in[i] != 'x') i++;
        if (i + 3 > n) return -1;
        out[k++] = (uint8_t)((hexval(in[i + 1]) << 4) + hexval(in[i + 2]));
        i += 3;
    }
    return 0;
}

/* PIL's PhotoCD base-image decoder (PcdDecode.c): each 3 * w bytes hold two
 * rows of luma and one row each of the two half-width chroma planes; out
 * gets (rows, w, 3) Y, C1, C2 for PIL's "YCC;P" unpacker.  Returns 0, or
 * -1 when the data ends first. */
int vpt_pcd_planes(const uint8_t *in, int64_t n, int64_t w, int64_t rows, uint8_t *out) {
    int64_t chunk = 3 * w, y = 0;
    const uint8_t *p = in;
    while (y < rows) {
        if (n < chunk) return -1;
        for (int line = 0; line < 2 && y < rows; line++, y++)
            for (int64_t x = 0; x < w; x++) {
                uint8_t *o = out + (y * w + x) * 3;
                o[0] = p[x + line * w];
                o[1] = p[(x + 4 * w) / 2];
                o[2] = p[(x + 5 * w) / 2];
            }
        p += chunk;
        n -= chunk;
    }
    return 0;
}

/* PIL's FLI / FLC frame decoder (FliDecode.c) called on the bytes PIL's
 * ImageFile.load has gathered: nothing is done until the frame's size (its
 * first 32-bit word, a pad byte allowed) is in hand; then the 0xf1fa
 * frame's sub-chunks are applied to the (h, w) image: colour chunks
 * (4, 11) and the postage stamp (18) skipped, SS2 (7) word and LC (12)
 * byte deltas, BLACK (13), BRUN (15) and COPY (16).  Returns the bytes
 * consumed (more data wanted), or -1 with *err 0 (the frame is done) or
 * PIL's error code: -1 unknown chunk or frame, -2 overrun, -3 a chunk that
 * does not advance. */
#define FLI_I16(p) ((p)[0] + ((int)(p)[1] << 8))
#define FLI_I32(p) ((int32_t)((uint32_t)(p)[0] | (uint32_t)(p)[1] << 8 | (uint32_t)(p)[2] << 16 | (uint32_t)(p)[3] << 24))
#define FLI_OOB(k) if (data + (k) > ptr + bytes) { *err = -2; return -1; }

int64_t vpt_fli_decode(const uint8_t *buf, int64_t bytes, uint8_t *img, int64_t xsize, int64_t ysize, int *err) {
    const uint8_t *ptr = buf;
    *err = 0;
    if (bytes < 4) return 0;
    int64_t framesize = (uint32_t)FLI_I32(ptr);
    if (bytes + (bytes % 2) < framesize) return 0;
    if (bytes < 8) { *err = -2; return -1; }
    if (FLI_I16(ptr + 4) != 0xF1FA) { *err = -1; return -1; }
    int chunks = FLI_I16(ptr + 6);
    ptr += 16;
    bytes -= 16;
    for (int c = 0; c < chunks; c++) {
        const uint8_t *data;
        int64_t x, y, i, j;
        if (bytes < 10) { *err = -2; return -1; }
        data = ptr + 6;
        switch (FLI_I16(ptr + 4)) {
        case 4: case 11: case 18:
            break;
        case 7: {  /* SS2 */
            int lines = FLI_I16(data), l;
            data += 2;
            for (l = 0, y = 0; l < lines && y < ysize; l++, y++) {
                uint8_t *line = img + y * xsize;
                int p, packets;
                FLI_OOB(2)
                packets = FLI_I16(data);
                data += 2;
                while (packets & 0x8000) {
                    if (packets & 0x4000) {
                        y += 65536 - packets;
                        if (y >= ysize) { *err = -2; return -1; }
                        line = img + y * xsize;
                    } else {
                        line[xsize - 1] = (uint8_t)packets;
                    }
                    FLI_OOB(2)
                    packets = FLI_I16(data);
                    data += 2;
                }
                for (p = 0, x = 0; p < packets; p++) {
                    FLI_OOB(2)
                    x += data[0];
                    if (data[1] >= 128) {
                        FLI_OOB(4)
                        i = 256 - data[1];
                        if (x + i + i > xsize) break;
                        for (j = 0; j < i; j++) {
                            line[x++] = data[2];
                            line[x++] = data[3];
                        }
                        data += 4;
                    } else {
                        i = 2 * (int64_t)data[1];
                        if (x + i > xsize) break;
                        FLI_OOB(2 + i)
                        memcpy(line + x, data + 2, (size_t)i);
                        data += 2 + i;
                        x += i;
                    }
                }
                if (p < packets) break;
            }
            if (l < lines) { *err = -2; return -1; }
            break;
        }
        case 12: {  /* LC */
            int64_t ymax;
            y = FLI_I16(data);
            ymax = y + FLI_I16(data + 2);
            data += 4;
            for (; y < ymax && y < ysize; y++) {
                uint8_t *out = img + y * xsize;
                int p, packets;
                FLI_OOB(1)
                packets = *data++;
                for (p = 0, x = 0; p < packets; p++, x += i) {
                    FLI_OOB(2)
                    x += data[0];
                    if (data[1] & 0x80) {
                        i = 256 - data[1];
                        if (x + i > xsize) break;
                        FLI_OOB(3)
                        memset(out + x, data[2], (size_t)i);
                        data += 3;
                    } else {
                        i = data[1];
                        if (x + i > xsize) break;
                        FLI_OOB(2 + i)
                        memcpy(out + x, data + 2, (size_t)i);
                        data += i + 2;
                    }
                }
                if (p < packets) break;
            }
            if (y < ymax) { *err = -2; return -1; }
            break;
        }
        case 13:  /* BLACK */
            memset(img, 0, (size_t)(xsize * ysize));
            break;
        case 15:  /* BRUN */
            for (y = 0; y < ysize; y++) {
                uint8_t *out = img + y * xsize;
                data += 1;
                for (x = 0; x < xsize; x += i) {
                    FLI_OOB(2)
                    if (data[0] & 0x80) {
                        i = 256 - data[0];
                        if (x + i > xsize) break;
                        FLI_OOB(i + 1)
                        memcpy(out + x, data + 1, (size_t)i);
                        data += i + 1;
                    } else {
                        i = data[0];
                        if (x + i > xsize) break;
                        memset(out + x, data[1], (size_t)i);
                        data += 2;
                    }
                }
                if (x != xsize) { *err = -2; return -1; }
            }
            break;
        case 16:  /* COPY */
            if (INT32_MAX / xsize < ysize) { *err = -2; return -1; }
            if (data + xsize * ysize > ptr + bytes) return ptr - buf;
            for (y = 0; y < ysize; y++) {
                memcpy(img + y * xsize, data, (size_t)xsize);
                data += xsize;
            }
            break;
        default:
            *err = -1;
            return -1;
        }
        int64_t advance = FLI_I32(ptr);
        if (advance == 0) { *err = -3; return -1; }
        if (advance < 0 || advance > bytes) { *err = -2; return -1; }
        ptr += advance;
        bytes -= advance;
    }
    return -1;
}

/* BLP2's DXT1 / DXT3 / DXT5 blocks as PIL's Python decode_dxt1 / 3 / 5
 * (BlpImagePlugin.py) decode them, which differ from PIL's C BCn decoder:
 * 565 colours widened by shifts alone (no bit replication), integer thirds
 * and halves, DXT3 / DXT5 colours always in the four-colour mode.  `in`
 * holds `rows` block rows of `blocks` blocks each; out gets PIL's stream:
 * per block row its four pixel rows of 4 * blocks pixels, `c` bytes each
 * (c 4, or 3 for DXT1 without alpha).  kind: 1, 3 or 5. */
static void dxt_colours(const uint8_t *b, int four, int table[4][4]) {
    int c0 = b[0] | b[1] << 8, c1 = b[2] | b[3] << 8;
    int p[2][3] = {{(c0 >> 11 & 0x1F) << 3, (c0 >> 5 & 0x3F) << 2, (c0 & 0x1F) << 3},
                   {(c1 >> 11 & 0x1F) << 3, (c1 >> 5 & 0x3F) << 2, (c1 & 0x1F) << 3}};
    int more = four || c0 > c1;
    for (int k = 0; k < 3; k++) {
        table[0][k] = p[0][k];
        table[1][k] = p[1][k];
        table[2][k] = more ? (2 * p[0][k] + p[1][k]) / 3 : (p[0][k] + p[1][k]) / 2;
        table[3][k] = more ? (2 * p[1][k] + p[0][k]) / 3 : 0;
    }
    table[0][3] = table[1][3] = table[2][3] = 255;
    table[3][3] = more ? 255 : 0;
}

void vpt_blp_dxt(const uint8_t *in, int64_t rows, int64_t blocks, int kind, int c, uint8_t *out) {
    int64_t size = kind == 1 ? 8 : 16, line = 4 * blocks * c;
    for (int64_t r = 0; r < rows; r++)
        for (int64_t k = 0; k < blocks; k++) {
            const uint8_t *b = in + (r * blocks + k) * size;
            int table[4][4], alpha[16];
            dxt_colours(kind == 1 ? b : b + 8, kind != 1, table);
            uint32_t code = b[size - 4] | (uint32_t)b[size - 3] << 8 | (uint32_t)b[size - 2] << 16 |
                            (uint32_t)b[size - 1] << 24;
            if (kind == 3) {
                for (int i = 0; i < 16; i++) alpha[i] = (b[i / 2] >> (4 * (i & 1)) & 0xF) * 17;
            } else if (kind == 5) {
                int a0 = b[0], a1 = b[1];
                uint64_t bits = 0;
                for (int i = 0; i < 6; i++) bits |= (uint64_t)b[2 + i] << (8 * i);
                for (int i = 0; i < 16; i++) {
                    int q = (int)(bits >> (3 * i) & 7);
                    alpha[i] = q == 0 ? a0 : q == 1 ? a1 : a0 > a1 ? ((8 - q) * a0 + (q - 1) * a1) / 7
                             : q == 6 ? 0 : q == 7 ? 255 : ((6 - q) * a0 + (q - 1) * a1) / 5;
                }
            }
            for (int i = 0; i < 16; i++) {
                int q = code >> (2 * i) & 3;
                uint8_t *o = out + (r * 4 + i / 4) * line + (k * 4 + i % 4) * c;
                for (int ch = 0; ch < 3; ch++) o[ch] = (uint8_t)table[q][ch];
                if (c == 4) o[3] = (uint8_t)(kind == 1 ? table[q][3] : alpha[i]);
            }
        }
}

/* libtiff's PackBitsDecode (tif_packbits.c) of one strip or tile: runs cut
 * at the `occ` bytes the strip holds, a literal run that the data cannot
 * fill whole dropped ("lack of data"), -128 a no-op.  Returns the bytes
 * written; the strip decoded whole when that is occ. */
int64_t vpt_packbits_libtiff(const uint8_t *in, int64_t cc, uint8_t *out, int64_t occ) {
    int64_t i = 0, o = 0;
    while (cc > 0 && occ > 0) {
        int n = (int8_t)in[i++];
        cc--;
        if (n < 0) {
            if (n == -128) continue;
            int64_t k = -n + 1;
            if (occ < k) k = occ;
            if (cc == 0) break;
            occ -= k;
            uint8_t b = in[i++];
            cc--;
            memset(out + o, b, (size_t)k);
            o += k;
        } else {
            int64_t k = n + 1;
            if (occ < k) k = occ;
            if (cc < k) break;
            memcpy(out + o, in + i, (size_t)k);
            o += k;
            occ -= k;
            i += k;
            cc -= k;
        }
    }
    return o;
}
