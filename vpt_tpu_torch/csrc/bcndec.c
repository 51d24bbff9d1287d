/* Block-compressed texture decoding for the port's DDS reader (io/dds.py):
 * BC1-BC5 (DXT1, DXT3, DXT5, ATI1 / BC4, ATI2 / BC5 and its signed form),
 * BC6H (unsigned and signed half floats, brought to 8 bits) and BC7, as
 * PIL's DDS plugin gives them.  Plain C with a C interface, built with gcc
 * into vpt_tpu_torch/build/ at first use and called through ctypes
 * (io/codec.py).
 *
 * Written from the block layouts of the Direct3D 11 specification (BC1-BC7)
 * and the Khronos Data Format Specification (section 21, the BC6H and BC7
 * mode tables, partitions and anchor indices).  Where a reader's arithmetic
 * is its own choice, the decoders take PIL's: BC1-BC3's thirds and halves
 * truncate, BC2's four-bit alpha is a | a << 4, BC4 / BC5 interpolate in
 * integers with truncation and read a signed block as its endpoints plus 128
 * (blue 128), BC6H unquantises as the specification's reference decoder
 * does (except that a signed block's delta-coded endpoints are not
 * sign-extended again after the deltas are added) and then converts the half
 * float to 8 bits by truncating its value in [0, 1] times 255, and BC7's
 * reserved mode (a first byte of 0) is opaque black.
 */

#include <stdint.h>
#include <string.h>

typedef struct { uint8_t r, g, b, a; } rgba_t;

static inline unsigned get_bit(const uint8_t *src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

static inline unsigned get_bits(const uint8_t *src, int bit, int count) {
    if (!count) return 0;
    int by = bit >> 3;
    bit &= 7;
    unsigned x = src[by] | (bit + count > 8 ? src[by + 1] << 8 : 0);
    return (x >> bit) & ((1u << count) - 1);
}

/* -------------------------------------------------------------- BC1-BC5 */

static rgba_t decode_565(unsigned x) {
    rgba_t c;
    unsigned r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
    c.r = (uint8_t)(r | r >> 5);
    c.g = (uint8_t)(g | g >> 6);
    c.b = (uint8_t)(b | b >> 5);
    c.a = 255;
    return c;
}

/* A BC1 colour block; BC2 and BC3 (separate_alpha) always take the
 * four-colour reading. */
static void bc1_colour(rgba_t *dst, const uint8_t *src, int separate_alpha) {
    unsigned c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
    uint32_t lut = (uint32_t)src[4] | (uint32_t)src[5] << 8 | (uint32_t)src[6] << 16 | (uint32_t)src[7] << 24;
    rgba_t p[4];
    p[0] = decode_565(c0);
    p[1] = decode_565(c1);
    int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
    if (c0 > c1 || separate_alpha) {
        p[2] = (rgba_t){(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3), (uint8_t)((2 * b0 + b1) / 3), 255};
        p[3] = (rgba_t){(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3), (uint8_t)((b0 + 2 * b1) / 3), 255};
    } else {
        p[2] = (rgba_t){(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2), 255};
        p[3] = (rgba_t){0, 0, 0, 0};
    }
    for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

/* A BC3 alpha / BC4 / BC5 channel block into byte `o` of each of 16 pixels
 * `stride` bytes apart; a signed block's endpoints are read as int8 + 128. */
static void bc3_alpha(uint8_t *dst, const uint8_t *src, int stride, int o, int sign) {
    int a0 = src[0], a1 = src[1];
    if (sign) {
        a0 = (int8_t)src[0] + 128;
        a1 = (int8_t)src[1] + 128;
    }
    uint32_t lut1 = src[2] | src[3] << 8 | (uint32_t)src[4] << 16, lut2 = src[5] | src[6] << 8 | (uint32_t)src[7] << 16;
    uint8_t a[8];
    a[0] = (uint8_t)a0;
    a[1] = (uint8_t)a1;
    if (a0 > a1) {
        for (int k = 1; k < 7; k++) a[k + 1] = (uint8_t)(((7 - k) * a0 + k * a1) / 7);
    } else {
        for (int k = 1; k < 5; k++) a[k + 1] = (uint8_t)(((5 - k) * a0 + k * a1) / 5);
        a[6] = 0;
        a[7] = 255;
    }
    for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
    for (int n = 0; n < 8; n++) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

/* ------------------------------------------------------------ BC6H / BC7 */

/* The two- and three-subset partitions (bit n, or bits 2n..2n+1, is pixel
 * n's subset) and the anchor indices of the second and third subsets. */
static const uint16_t P2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8,
    0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110,
    0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696,
    0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720,
    0xc936, 0x936c, 0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
static const uint32_t P3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0, 0x5a5a5050,
    0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250,
    0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200,
    0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50,
    0x500aa550, 0xaaaa4444, 0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
static const uint8_t ANCHOR2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2,  8, 2,  2, 8,  8,  15, 2,  8, 2,  2,
    8,  8,  2,  2,  15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6, 6,  2, 6,  8,  15, 15, 2,  2,
    15, 15, 15, 15, 15, 2,  2,  15};
static const uint8_t ANCHOR3A[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3, 3,  3,  8,  15, 3,  3,  6, 10, 5, 8,  8,  6,
    8,  5,  15, 15, 8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5, 15, 15, 15, 15, 3,  15, 5, 5,  5, 8,  5,  10,
    5,  10, 8,  13, 15, 12, 3,  3};
static const uint8_t ANCHOR3B[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,  15, 8,  15, 3,  15, 8,  15, 8, 3,  15, 6,  10,
    15, 15, 10, 8,  15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,  15, 3,  15, 15, 15, 15, 15, 15,
    15, 15, 15, 15, 3,  15, 15, 8};

static const uint8_t W2[4] = {0, 21, 43, 64};
static const uint8_t W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const uint8_t W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

static const uint8_t *weights(int bits) { return bits == 2 ? W2 : (bits == 3 ? W3 : W4); }

static int subset(int ns, int partition, int n) {
    if (ns == 2) return 1 & (P2[partition] >> n);
    if (ns == 3) return 3 & (P3[partition] >> (2 * n));
    return 0;
}

/* The index of pixel n has one bit fewer when it is its subset's anchor. */
static int is_anchor(int ns, int partition, int n) {
    return n == 0 || (ns == 2 && n == ANCHOR2[partition]) ||
           (ns == 3 && (n == ANCHOR3A[partition] || n == ANCHOR3B[partition]));
}

/* BC7 modes: subsets, partition bits, rotation bits, index-selection bits,
 * colour bits, alpha bits, per-endpoint and per-subset P bits, index bits,
 * secondary index bits. */
static const uint8_t BC7_MODES[8][10] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0}, {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},
    {2, 6, 0, 0, 7, 0, 1, 0, 2, 0}, {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

static inline uint8_t expand_bits(unsigned v, int bits) {
    uint8_t x = (uint8_t)(v << (8 - bits));
    return (uint8_t)(x | (x >> bits));
}

static void bc7_lerp(rgba_t *dst, const rgba_t *e, int s0, int s1) {
    int t0 = 64 - s0, t1 = 64 - s1;
    dst->r = (uint8_t)((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
    dst->g = (uint8_t)((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
    dst->b = (uint8_t)((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
    dst->a = (uint8_t)((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

static void bc7_block(rgba_t *col, const uint8_t *src) {
    if (!src[0]) { /* the reserved mode 8 */
        for (int i = 0; i < 16; i++) col[i] = (rgba_t){0, 0, 0, 255};
        return;
    }
    int mode = 0;
    while (!(src[0] & (1 << mode))) mode++;
    int bit = mode + 1;
    const uint8_t *m = BC7_MODES[mode];
    int ns = m[0], cb = m[4], ab = m[5], ib = m[8], ib2 = m[9];
    const uint8_t *cw = weights(ib), *aw = weights(ab && ib2 ? ib2 : ib);
    int partition = (int)get_bits(src, bit, m[1]);
    bit += m[1];
    int rotation = (int)get_bits(src, bit, m[2]);
    bit += m[2];
    int index_sel = (int)get_bits(src, bit, m[3]);
    bit += m[3];
    int numep = ns * 2;
    uint8_t ep[6][4];
    for (int c = 0; c < 3; c++)
        for (int i = 0; i < numep; i++, bit += cb) ep[i][c] = (uint8_t)get_bits(src, bit, cb);
    for (int i = 0; i < numep; i++) {
        ep[i][3] = ab ? (uint8_t)get_bits(src, bit, ab) : 255;
        if (ab) bit += ab;
    }
    if (m[6] || m[7]) { /* P bits, per endpoint or per subset */
        cb++;
        if (ab) ab++;
        for (int i = 0; i < numep; i++) {
            unsigned p = get_bit(src, m[6] ? bit + i : bit + i / 2);
            for (int c = 0; c < (ab ? 4 : 3); c++) ep[i][c] = (uint8_t)(ep[i][c] << 1 | p);
        }
        bit += m[6] ? numep : numep / 2;
    }
    rgba_t e[6];
    for (int i = 0; i < numep; i++) {
        e[i].r = expand_bits(ep[i][0], cb);
        e[i].g = expand_bits(ep[i][1], cb);
        e[i].b = expand_bits(ep[i][2], cb);
        e[i].a = ab ? expand_bits(ep[i][3], ab) : ep[i][3];
    }
    int cibit = bit, aibit = cibit + 16 * ib - ns;
    for (int i = 0; i < 16; i++) {
        int s = subset(ns, partition, i) << 1;
        int bits = ib - is_anchor(ns, partition, i);
        int i0 = (int)get_bits(src, cibit, bits);
        cibit += bits;
        if (ab && ib2) {
            int bits2 = ib2 - (i == 0);
            int i1 = (int)get_bits(src, aibit, bits2);
            aibit += bits2;
            if (index_sel) bc7_lerp(&col[i], &e[s], aw[i1], cw[i0]);
            else bc7_lerp(&col[i], &e[s], cw[i0], aw[i1]);
        } else {
            bc7_lerp(&col[i], &e[s], cw[i0], cw[i0]);
        }
        uint8_t t = col[i].a;
        if (rotation == 1) { col[i].a = col[i].r; col[i].r = t; }
        else if (rotation == 2) { col[i].a = col[i].g; col[i].g = t; }
        else if (rotation == 3) { col[i].a = col[i].b; col[i].b = t; }
    }
}

/* BC6H modes: subsets, delta-coded endpoints, partition bits, endpoint bits
 * and the red, green and blue delta bits. */
static const uint8_t BC6_MODES[14][7] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6}, {2, 1, 5, 11, 5, 4, 4}, {2, 1, 5, 11, 4, 5, 4},
    {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},  {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},
    {2, 1, 5, 8, 5, 5, 6},  {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

/* Each mode's endpoint bits in stream order: 16 * endpoint value (r0, g0,
 * b0, r1, ..., b3) + bit. */
static const uint8_t BC6_PACKING[14][75] = {
    {116, 132, 180, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0, 1, 2, 3, 4, 5, 6, 176, 177, 132, 16, 17, 18, 19, 20, 21, 22, 133, 178, 116, 32, 33, 34, 35, 36, 37, 38, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 10, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 26, 160, 161, 162, 163, 80, 81, 82, 83, 42, 177, 128, 129, 130, 131, 96, 97, 98, 99, 176, 178, 144, 145, 146, 147, 116, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 10, 132, 112, 113, 114, 115, 64, 65, 66, 67, 26, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 42, 128, 129, 130, 131, 96, 97, 98, 99, 177, 178, 144, 145, 146, 147, 180, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 132, 16, 17, 18, 19, 20, 21, 22, 23, 24, 116, 32, 33, 34, 35, 36, 37, 38, 39, 40, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 164, 132, 16, 17, 18, 19, 20, 21, 22, 23, 178, 116, 32, 33, 34, 35, 36, 37, 38, 39, 179, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 176, 132, 16, 17, 18, 19, 20, 21, 22, 23, 117, 116, 32, 33, 34, 35, 36, 37, 38, 39, 165, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 177, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 177, 132, 16, 17, 18, 19, 20, 21, 22, 23, 133, 116, 32, 33, 34, 35, 36, 37, 38, 39, 181, 180, 48, 49, 50, 51, 52, 164, 112, 113, 114, 115, 64, 65, 66, 67, 68, 176, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 178, 144, 145, 146, 147, 148, 179, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 164, 176, 177, 132, 16, 17, 18, 19, 20, 21, 117, 133, 178, 116, 32, 33, 34, 35, 36, 37, 165, 179, 181, 180, 48, 49, 50, 51, 52, 53, 112, 113, 114, 115, 64, 65, 66, 67, 68, 69, 160, 161, 162, 163, 80, 81, 82, 83, 84, 85, 128, 129, 130, 131, 96, 97, 98, 99, 100, 101, 144, 145, 146, 147, 148, 149, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10, 64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10, 64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10, 64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

static inline uint16_t sign_extend(unsigned v, int prec) {
    unsigned x = v & 0xffff;
    if (x & (1u << (prec - 1))) x |= ~0u << prec;
    return (uint16_t)x;
}

static int bc6_unquantize(uint16_t v, int prec, int sign) {
    if (!sign) {
        int x = v;
        if (prec >= 15) return x;
        if (x == 0) return 0;
        if (x == (1 << prec) - 1) return 0xffff;
        return ((x << 15) + 0x4000) >> (prec - 1);
    }
    int x = (int16_t)v, s = 0;
    if (prec >= 16) return x;
    if (x < 0) {
        s = 1;
        x = -x;
    }
    if (x) x = x >= (1 << (prec - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (prec - 1);
    return s ? -x : x;
}

static float half_to_float(uint16_t h) {
    union { uint32_t u; float f; } o, m;
    m.u = 0x77800000;
    o.u = (uint32_t)(h & 0x7fff) << 13;
    o.f *= m.f;
    m.u = 0x47800000;
    if (o.f >= m.f) o.u |= 255u << 23;
    o.u |= (uint32_t)(h & 0x8000) << 16;
    return o.f;
}

static uint8_t bc6_channel(int v, int sign) {
    float f;
    if (sign) f = v < 0 ? half_to_float((uint16_t)(0x8000 | ((-v) * 31) / 32)) : half_to_float((uint16_t)((v * 31) / 32));
    else f = half_to_float((uint16_t)((v * 31) / 64));
    if (f < 0.0f) return 0;
    if (f > 1.0f) return 255;
    return (uint8_t)(f * 255.0f);
}

static void bc6_block(rgba_t *col, const uint8_t *src, int sign) {
    int mode = src[0] & 0x1f, bit = 5, epbits = 75, ib = 3;
    if ((mode & 3) < 2) {
        mode &= 3;
        bit = 2;
    } else if ((mode & 3) == 2) {
        mode = 2 + (mode >> 2);
        epbits = 72;
    } else {
        mode = 10 + (mode >> 2);
        epbits = 60;
        ib = 4;
    }
    if (mode >= 14) { /* a reserved mode */
        memset(col, 0, 16 * sizeof(rgba_t));
        return;
    }
    const uint8_t *info = BC6_MODES[mode];
    int ns = info[0], tr = info[1], pb = info[2], epb = info[3];
    const uint8_t *cw = weights(ib);
    int numep = ns == 2 ? 12 : 6;
    uint16_t ep[12] = {0};
    for (int i = 0; i < epbits; i++) {
        int d = BC6_PACKING[mode][i];
        ep[d >> 4] |= (uint16_t)(get_bit(src, bit + i) << (d & 15));
    }
    bit += epbits;
    int partition = (int)get_bits(src, bit, pb);
    bit += pb;
    unsigned mask = (1u << epb) - 1;
    if (sign)
        for (int c = 0; c < 3; c++) ep[c] = sign_extend(ep[c], epb);
    if (sign || tr)
        for (int i = 3; i < numep; i += 3)
            for (int c = 0; c < 3; c++) ep[i + c] = sign_extend(ep[i + c], info[4 + c]);
    if (tr) {
        for (int i = 3; i < numep; i += 3)
            for (int c = 0; c < 3; c++) ep[i + c] = (uint16_t)((ep[i + c] + ep[c]) & mask);
    }
    int u[12];
    for (int i = 0; i < numep; i++) u[i] = bc6_unquantize(ep[i], epb, sign);
    for (int i = 0; i < 16; i++) {
        int s = subset(ns, partition, i) * 6;
        int bits = ib - (i == 0 || (ns == 2 && i == ANCHOR2[partition]));
        int w = cw[get_bits(src, bit, bits)];
        bit += bits;
        int t = 64 - w;
        col[i].r = bc6_channel((u[s] * t + u[s + 3] * w) >> 6, sign);
        col[i].g = bc6_channel((u[s + 1] * t + u[s + 4] * w) >> 6, sign);
        col[i].b = bc6_channel((u[s + 2] * t + u[s + 5] * w) >> 6, sign);
    }
}

/* ---------------------------------------------------------------- surface */

/* Decode the blocks of a w x h surface (kind 1-7: BC1-BC7; sign: BC5's or
 * BC6H's signed form) from in[0:n] into out, (h, w, 4) RGBA or, for BC4,
 * (h, w) luminance.  Blocks run left to right, top to bottom; a block past
 * the right or bottom edge is cut.  Returns 0 when every block was decoded,
 * 1 when the data ends first (PIL: the file is truncated), -1 for an unknown
 * kind. */
int vpt_bcn_decode(const uint8_t *in, int64_t n, int64_t w, int64_t h, int kind, int sign, uint8_t *out) {
    if (kind < 1 || kind > 7) return -1;
    int64_t size = (kind == 1 || kind == 4) ? 8 : 16, bx = (w + 3) / 4, by = (h + 3) / 4;
    int channels = kind == 4 ? 1 : 4;
    for (int64_t b = 0; b < bx * by; b++) {
        if ((b + 1) * size > n) return 1;
        const uint8_t *src = in + b * size;
        rgba_t col[16];
        memset(col, kind == 5 && sign ? 128 : 0, sizeof(col));
        switch (kind) {
        case 1: bc1_colour(col, src, 0); break;
        case 2:
            bc1_colour(col, src + 8, 1);
            for (int i = 0; i < 16; i++) {
                unsigned a = 0xf & (src[i >> 1] >> (4 * (i & 1)));
                col[i].a = (uint8_t)(a << 4 | a);
            }
            break;
        case 3:
            bc1_colour(col, src + 8, 1);
            bc3_alpha((uint8_t *)col, src, 4, 3, 0);
            break;
        case 4: bc3_alpha((uint8_t *)col, src, 1, 0, 0); break;
        case 5:
            bc3_alpha((uint8_t *)col, src, 4, 0, sign);
            bc3_alpha((uint8_t *)col, src + 8, 4, 1, sign);
            break;
        case 6: bc6_block(col, src, sign); break;
        default: bc7_block(col, src);
        }
        int64_t x0 = (b % bx) * 4, y0 = (b / bx) * 4;
        const uint8_t *px = (const uint8_t *)col;
        for (int j = 0; j < 4 && y0 + j < h; j++)
            for (int i = 0; i < 4 && x0 + i < w; i++)
                memcpy(out + ((y0 + j) * w + x0 + i) * channels, px + (j * 4 + i) * channels, channels);
    }
    return 0;
}
