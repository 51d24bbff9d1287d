/* LZ4 block-format codec for blosc-compressed OpenVDB value buffers (the
 * port's copy of the JAX package's vpt_tpu/scene/cpp/lz4_block.c; the code
 * is unchanged).
 *
 * Implements the public LZ4 block format (token / literals / 2-byte LE
 * offset / match) from the format description — decode mirrors
 * LZ4_decompress_safe semantics, encode is a greedy hash-chain matcher
 * producing valid (not byte-identical to reference lz4) streams.
 * Built with gcc -O3 -shared into vpt_tpu_torch/build/ at first use and
 * loaded with ctypes (vpt_tpu_torch/scene/blosc.py, whose plain Python
 * decoder the tests hold it against).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

int vpt_lz4_decompress(const uint8_t *src, int src_len, uint8_t *dst,
                       int dst_cap) {
    const uint8_t *ip = src, *iend = src + src_len;
    uint8_t *op = dst, *oend = dst + dst_cap;
    while (ip < iend) {
        unsigned token = *ip++;
        size_t len = token >> 4;
        if (len == 15) {
            unsigned s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                len += s;
            } while (s == 255);
        }
        if ((size_t)(iend - ip) < len || (size_t)(oend - op) < len) return -1;
        memcpy(op, ip, len);
        ip += len;
        op += len;
        if (ip >= iend) break; /* block ends with literals */
        if (iend - ip < 2) return -1;
        unsigned offset = (unsigned)ip[0] | ((unsigned)ip[1] << 8);
        ip += 2;
        if (offset == 0 || (size_t)(op - dst) < offset) return -1;
        size_t mlen = token & 15;
        if (mlen == 15) {
            unsigned s;
            do {
                if (ip >= iend) return -1;
                s = *ip++;
                mlen += s;
            } while (s == 255);
        }
        mlen += 4;
        if ((size_t)(oend - op) < mlen) return -1;
        const uint8_t *match = op - offset;
        for (size_t k = 0; k < mlen; k++) op[k] = match[k]; /* may overlap */
        op += mlen;
    }
    return (int)(op - dst);
}

static uint32_t lz4_hash(const uint8_t *p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (v * 2654435761u) >> 20; /* 12-bit table */
}

/* Greedy single-pass encoder.  Returns compressed size, or -1 if the
 * output would not fit in dst_cap (caller then stores the block raw). */
int vpt_lz4_compress(const uint8_t *src, int src_len, uint8_t *dst,
                     int dst_cap) {
    int32_t table[1 << 12];
    for (int i = 0; i < (1 << 12); i++) table[i] = -1;
    const uint8_t *ip = src, *iend = src + src_len;
    /* Spec: last match must start >= 12 bytes before end; last 5 bytes are
     * always literals. */
    const uint8_t *mlimit = src_len > 12 ? iend - 12 : src;
    uint8_t *op = dst, *oend = dst + dst_cap;
    const uint8_t *anchor = src;

    while (ip < mlimit) {
        uint32_t h = lz4_hash(ip);
        int32_t cand = table[h];
        table[h] = (int32_t)(ip - src);
        if (cand >= 0 && (ip - src) - cand <= 65535 &&
            memcmp(src + cand, ip, 4) == 0) {
            /* extend match */
            const uint8_t *match = src + cand;
            const uint8_t *mend = iend - 5;
            size_t mlen = 4;
            while (ip + mlen < mend && ip[mlen] == match[mlen]) mlen++;
            size_t lit = (size_t)(ip - anchor);
            /* token + literal extension + literals + offset + match ext */
            size_t need = 1 + lit / 255 + 1 + lit + 2 + mlen / 255 + 1;
            if ((size_t)(oend - op) < need) return -1;
            uint8_t *token = op++;
            if (lit >= 15) {
                *token = 15 << 4;
                size_t rest = lit - 15;
                while (rest >= 255) { *op++ = 255; rest -= 255; }
                *op++ = (uint8_t)rest;
            } else {
                *token = (uint8_t)(lit << 4);
            }
            memcpy(op, anchor, lit);
            op += lit;
            unsigned offset = (unsigned)(ip - match);
            *op++ = (uint8_t)offset;
            *op++ = (uint8_t)(offset >> 8);
            size_t mrec = mlen - 4;
            if (mrec >= 15) {
                *token |= 15;
                size_t rest = mrec - 15;
                while (rest >= 255) { *op++ = 255; rest -= 255; }
                *op++ = (uint8_t)rest;
            } else {
                *token |= (uint8_t)mrec;
            }
            ip += mlen;
            anchor = ip;
        } else {
            ip++;
        }
    }
    /* trailing literals */
    size_t lit = (size_t)(iend - anchor);
    size_t need = 1 + lit / 255 + 1 + lit;
    if ((size_t)(oend - op) < need) return -1;
    uint8_t *token = op++;
    if (lit >= 15) {
        *token = 15 << 4;
        size_t rest = lit - 15;
        while (rest >= 255) { *op++ = 255; rest -= 255; }
        *op++ = (uint8_t)rest;
    } else {
        *token = (uint8_t)(lit << 4);
    }
    memcpy(op, anchor, lit);
    op += lit;
    return (int)(op - dst);
}

#ifdef __cplusplus
}
#endif
