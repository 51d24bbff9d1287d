/* JPEG 2000 codestream decoder (ISO/IEC 15444-1), bitwise as OpenJPEG 2.5
 * decodes a codestream through its tile interface (opj_read_tile_header /
 * opj_decode_tile_data), the way PIL's Jpeg2KDecode.c drives it, and then
 * PIL's unpackers that place each tile's samples in PIL's image.
 *
 * The layers, in OpenJPEG's order:
 *   - the main header and the tile-part headers (SIZ, COD, COC, QCD, QCC,
 *     RGN, POC, PPM, PPT, TLM, PLM, PLT, CRG, COM) with OpenJPEG's checks,
 *     and its tile-part state machine (SOT, SOD, EOC, Psot = 0);
 *   - tier 2: the progression iterators (LRCP, RLCP, RPCL, PCRL, CPRL, POC),
 *     packet headers (tag trees, inclusion, zero bit-planes, passes,
 *     lengths; SOP, EPH, packed headers from PPM / PPT);
 *   - tier 1: EBCOT's three passes with the MQ decoder (and raw passes for
 *     the bypass style), every code-block style but the high-throughput one;
 *   - dequantisation (reversible: a halving in integers; irreversible: a
 *     float32 step), the ROI shift, the 5/3 and 9/7 inverse wavelets in
 *     OpenJPEG's lifting order, the RCT and ICT, the DC level shift with
 *     lrintf and clamping.
 * The float arithmetic is OpenJPEG's operation by operation: build with
 * -ffp-contract=off and without -ffast-math.
 *
 * Entry points (ctypes, io/codec.py): vpt_j2k_open parses the main
 * header, vpt_j2k_info reads the image it describes, vpt_j2k_decode decodes
 * every tile into a PIL image buffer through one of PIL's unpackers,
 * vpt_j2k_position tells where the codestream ended, vpt_j2k_close frees.
 * Errors return -1 with OpenJPEG's message in the caller's buffer.
 */

#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MAXRLVLS 33
#define MAXBANDS (3 * MAXRLVLS - 2)
#define MAX_POCS 32
#define CBLK_EXTRA 2

enum { ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16, ST_NEOC = 64, ST_DATA = 128,
       ST_EOC = 256 };

typedef struct { int32_t expn, mant; } stepsize_t;

typedef struct {
    uint32_t csty, numresolutions, cblkw, cblkh, cblksty, qmfbid, qntsty, numgbits, roishift;
    stepsize_t stepsizes[MAXBANDS];
    uint32_t prcw[MAXRLVLS], prch[MAXRLVLS];
    int32_t dc_level_shift;
} tccp_t;

typedef struct { uint32_t resno0, compno0, layno1, resno1, compno1, prg; } poc_t;

typedef struct { uint8_t *data; uint32_t size; } marker_t;

/* Part 2's MCT records (arrays) and MCC records (collections; deco and
   offset: positions of MCT records, or -1).  OpenJPEG reads them, and an
   MCO marker can set the DC level shifts from an offset array; it never
   applies a custom transform (COD's transform byte is 0 or 1). */
typedef struct { uint32_t index, element_type; uint8_t *data; uint32_t size; } mct_rec_t;
typedef struct { uint32_t index, nb_comps; int deco, offset; } mcc_rec_t;

typedef struct {
    uint32_t csty, prg, numlayers, mct;
    int cod, POC, ppt;
    uint32_t numpocs;
    poc_t pocs[MAX_POCS];
    tccp_t *tccps;
    uint8_t *data;
    size_t data_size;
    int32_t cur_tp;
    uint32_t nb_tile_parts;
    marker_t *ppt_markers;
    uint32_t ppt_count;
    uint8_t *ppt_buffer, *ppt_data;
    uint32_t ppt_len;
    mct_rec_t *mcts;
    uint32_t nb_mct;
    mcc_rec_t *mccs;
    uint32_t nb_mcc;
} tcp_t;

typedef struct { uint32_t dx, dy, prec, sgnd, resno_decoded; } comp_t;

typedef struct {
    const uint8_t *buf;
    size_t len, pos;
    char err[256];
    /* the image */
    uint32_t x0, y0, x1, y1, numcomps;
    comp_t *comps;
    /* the coding parameters */
    uint32_t tx0, ty0, tdx, tdy, tw, th;
    uint32_t ihdr_w, ihdr_h;
    tcp_t default_tcp;
    tcp_t *tcps;
    int ppm;
    marker_t *ppm_markers;
    uint32_t ppm_count;
    uint8_t *ppm_buffer, *ppm_data;
    uint32_t ppm_len;
    /* the decoder's state */
    int state;
    uint32_t cur_tile;
    int can_decode, last_tile_part;
    uint32_t sot_length;
} j2k_t;

static int fail(j2k_t *j, const char *msg) {
    if (!j->err[0]) snprintf(j->err, sizeof j->err, "%s", msg);
    return -1;
}

static uint32_t rd(const uint8_t *p, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | p[i];
    return v;
}

static size_t left(const j2k_t *j) { return j->len - j->pos; }

static int read_n(j2k_t *j, uint8_t *out, size_t n) {  /* opj_stream_read_data: whole or short */
    size_t k = n < left(j) ? n : left(j);
    if (out) memcpy(out, j->buf + j->pos, k);
    j->pos += k;
    return k == n;
}

static int32_t int_ceildiv(int32_t a, int32_t b) { return (int32_t)(((int64_t)a + b - 1) / b); }
static uint32_t uint_ceildiv(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a + b - 1) / b); }
static int32_t int_ceildivpow2(int32_t a, int32_t b) { return (int32_t)(((int64_t)a + ((int64_t)1 << b) - 1) >> b); }
static int32_t int64_ceildivpow2(int64_t a, int32_t b) { return (int32_t)((a + ((int64_t)1 << b) - 1) >> b); }
static int32_t int_floordivpow2(int32_t a, int32_t b) { return a >> b; }
static uint32_t uint_adds(uint32_t a, uint32_t b) { uint64_t s = (uint64_t)a + b; return s > UINT32_MAX ? UINT32_MAX : (uint32_t)s; }
static uint32_t umin(uint32_t a, uint32_t b) { return a < b ? a : b; }
static uint32_t umax(uint32_t a, uint32_t b) { return a > b ? a : b; }
static int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }
static int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }
static uint32_t floorlog2(uint32_t a) { uint32_t l = 0; while (a > 1) { a >>= 1; l++; } return l; }

/* ------------------------------------------------------------------ */
/* Marker segments                                                     */

static tcp_t *cur_tcp(j2k_t *j) { return j->state == ST_TPH ? &j->tcps[j->cur_tile] : &j->default_tcp; }

static int read_siz(j2k_t *j, const uint8_t *p, uint32_t n) {
    if (n < 36) return fail(j, "Error with SIZ marker size");
    uint32_t rem = n - 36;
    if (rem % 3) return fail(j, "Error with SIZ marker size");
    j->x1 = rd(p + 2, 4); j->y1 = rd(p + 6, 4); j->x0 = rd(p + 10, 4); j->y0 = rd(p + 14, 4);
    j->tdx = rd(p + 18, 4); j->tdy = rd(p + 22, 4); j->tx0 = rd(p + 26, 4); j->ty0 = rd(p + 30, 4);
    uint32_t csiz = rd(p + 34, 2);
    if (csiz >= 16385) return fail(j, "Error with SIZ marker: number of component is illegal");
    if (csiz != rem / 3) return fail(j, "Error with SIZ marker: number of component is not compatible with the "
                                        "remaining number of parameters");
    j->numcomps = csiz;
    if (j->x0 >= j->x1 || j->y0 >= j->y1) return fail(j, "Error with SIZ marker: negative or zero image size");
    if (j->tdx == 0 || j->tdy == 0) return fail(j, "Error with SIZ marker: invalid tile size");
    uint32_t tx1 = uint_adds(j->tx0, j->tdx), ty1 = uint_adds(j->ty0, j->tdy);
    if (j->tx0 > j->x0 || j->ty0 > j->y0 || tx1 <= j->x0 || ty1 <= j->y0)
        return fail(j, "Error with SIZ marker: illegal tile offset");
    if (j->ihdr_w > 0 && j->ihdr_h > 0 && (j->ihdr_w != j->x1 - j->x0 || j->ihdr_h != j->y1 - j->y0))
        return fail(j, "Error with SIZ marker: IHDR w, h vs. SIZ w, h");
    j->comps = calloc(csiz ? csiz : 1, sizeof(comp_t));
    if (!j->comps) return fail(j, "out of memory");
    for (uint32_t i = 0; i < csiz; i++) {
        const uint8_t *c = p + 36 + 3 * i;
        j->comps[i].prec = (c[0] & 0x7f) + 1;
        j->comps[i].sgnd = c[0] >> 7;
        j->comps[i].dx = c[1];
        j->comps[i].dy = c[2];
        if (j->comps[i].dx < 1 || j->comps[i].dy < 1) return fail(j, "Invalid values for comp: dx, dy");
        if (j->comps[i].prec > 31) return fail(j, "Invalid values for comp: prec (OpenJPEG only supports up to 31)");
    }
    j->tw = uint_ceildiv(j->x1 - j->tx0, j->tdx);
    j->th = uint_ceildiv(j->y1 - j->ty0, j->tdy);
    if (j->tw == 0 || j->th == 0 || j->tw > 65535 / j->th) return fail(j, "Invalid number of tiles");
    j->default_tcp.tccps = calloc(csiz ? csiz : 1, sizeof(tccp_t));
    j->tcps = calloc((size_t)j->tw * j->th, sizeof(tcp_t));
    if (!j->default_tcp.tccps || !j->tcps) return fail(j, "out of memory");
    for (uint32_t t = 0; t < j->tw * j->th; t++) j->tcps[t].cur_tp = -1;
    for (uint32_t i = 0; i < csiz; i++)  /* from SIZ's precision; a CBD marker does not change them */
        if (!j->comps[i].sgnd) j->default_tcp.tccps[i].dc_level_shift = (int32_t)(1u << (j->comps[i].prec - 1));
    j->state = ST_MH;
    return 0;
}

static void copy_tile_component_parameters(j2k_t *j, tcp_t *tcp) {
    tccp_t *r = &tcp->tccps[0];
    for (uint32_t i = 1; i < j->numcomps; i++) {
        tccp_t *c = &tcp->tccps[i];
        c->numresolutions = r->numresolutions; c->cblkw = r->cblkw; c->cblkh = r->cblkh;
        c->cblksty = r->cblksty; c->qmfbid = r->qmfbid;
        memcpy(c->prcw, r->prcw, sizeof r->prcw);
        memcpy(c->prch, r->prch, sizeof r->prch);
    }
}

static void copy_tile_quantization_parameters(j2k_t *j, tcp_t *tcp) {
    tccp_t *r = &tcp->tccps[0];
    for (uint32_t i = 1; i < j->numcomps; i++) {
        tccp_t *c = &tcp->tccps[i];
        c->qntsty = r->qntsty; c->numgbits = r->numgbits;
        memcpy(c->stepsizes, r->stepsizes, sizeof r->stepsizes);
    }
}

static int read_spcod(j2k_t *j, tcp_t *tcp, uint32_t compno, const uint8_t *p, uint32_t *n) {
    tccp_t *t = &tcp->tccps[compno];
    if (*n < 5) return fail(j, "Error reading SPCod SPCoc element");
    t->numresolutions = p[0] + 1u;
    if (t->numresolutions > MAXRLVLS) return fail(j, "Invalid value for numresolutions");
    t->cblkw = p[1] + 2u;
    t->cblkh = p[2] + 2u;
    if (t->cblkw > 10 || t->cblkh > 10 || t->cblkw + t->cblkh > 12)
        return fail(j, "Error reading SPCod SPCoc element, Invalid cblk w/h");
    t->cblksty = p[3];
    if (t->cblksty & 0x80) return fail(j, "Error reading SPCod SPCoc element. Unsupported Mixed HT code-block style");
    t->qmfbid = p[4];
    if (t->qmfbid > 1) return fail(j, "Error reading SPCod SPCoc element, Invalid transformation found");
    *n -= 5;
    p += 5;
    if (t->csty & 1) {
        if (*n < t->numresolutions) return fail(j, "Error reading SPCod SPCoc element");
        for (uint32_t i = 0; i < t->numresolutions; i++) {
            uint32_t v = p[i];
            if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) return fail(j, "Invalid precinct size");
            t->prcw[i] = v & 0xf;
            t->prch[i] = v >> 4;
        }
        *n -= t->numresolutions;
    } else {
        for (uint32_t i = 0; i < t->numresolutions; i++) t->prcw[i] = t->prch[i] = 15;
    }
    return 0;
}

static int read_cod(j2k_t *j, const uint8_t *p, uint32_t n) {
    tcp_t *tcp = cur_tcp(j);
    if (tcp->cod) return fail(j, "COD marker already read. No more than one COD marker per tile.");
    tcp->cod = 1;
    if (n < 5) return fail(j, "Error reading COD marker");
    tcp->csty = p[0];
    if (tcp->csty & ~7u) return fail(j, "Unknown Scod value in COD marker");
    tcp->prg = p[1];
    if (tcp->prg > 4) tcp->prg = 0xffffffffu;  /* OPJ_PROG_UNKNOWN */
    tcp->numlayers = rd(p + 2, 2);
    if (tcp->numlayers < 1) return fail(j, "Invalid number of layers in COD marker");
    tcp->mct = p[4];
    if (tcp->mct > 1) return fail(j, "Invalid multiple component transformation");
    n -= 5;
    for (uint32_t i = 0; i < j->numcomps; i++) tcp->tccps[i].csty = tcp->csty & 1;
    if (read_spcod(j, tcp, 0, p + 5, &n) || n != 0) return fail(j, "Error reading COD marker");
    copy_tile_component_parameters(j, tcp);
    return 0;
}

static int read_coc(j2k_t *j, const uint8_t *p, uint32_t n) {
    tcp_t *tcp = cur_tcp(j);
    uint32_t room = j->numcomps <= 256 ? 1 : 2;
    if (n < room + 1) return fail(j, "Error reading COC marker");
    n -= room + 1;
    uint32_t c = rd(p, room);
    if (c >= j->numcomps) return fail(j, "Error reading COC marker (bad number of components)");
    tcp->tccps[c].csty = p[room];
    if (read_spcod(j, tcp, c, p + room + 1, &n) || n != 0) return fail(j, "Error reading COC marker");
    return 0;
}

static int read_sqcd(j2k_t *j, tcp_t *tcp, uint32_t compno, const uint8_t *p, uint32_t *n) {
    tccp_t *t = &tcp->tccps[compno];
    if (*n < 1) return fail(j, "Error reading SQcd or SQcc element");
    *n -= 1;
    t->qntsty = p[0] & 0x1f;
    t->numgbits = p[0] >> 5;
    p++;
    uint32_t nb = t->qntsty == 1 ? 1 : (t->qntsty == 0 ? *n : *n / 2);
    if (t->qntsty == 0) {
        for (uint32_t b = 0; b < nb; b++) {
            if (b < MAXBANDS) { t->stepsizes[b].expn = p[b] >> 3; t->stepsizes[b].mant = 0; }
        }
        if (*n < nb) return fail(j, "Error reading SQcd or SQcc element");
        *n -= nb;
    } else {
        /* OpenJPEG reads nb values before it checks the segment holds them */
        for (uint32_t b = 0; b < nb; b++) {
            uint32_t v = 2 * b + 1 < *n + 1 ? rd(p + 2 * b, 2) : 0;
            if (b < MAXBANDS) { t->stepsizes[b].expn = v >> 11; t->stepsizes[b].mant = v & 0x7ff; }
        }
        if (*n < 2 * nb) return fail(j, "Error reading SQcd or SQcc element");
        *n -= 2 * nb;
    }
    if (t->qntsty == 1) {
        for (uint32_t b = 1; b < MAXBANDS; b++) {
            int32_t e = t->stepsizes[0].expn - (int32_t)((b - 1) / 3);
            t->stepsizes[b].expn = e > 0 ? e : 0;
            t->stepsizes[b].mant = t->stepsizes[0].mant;
        }
    }
    return 0;
}

static int read_qcd(j2k_t *j, const uint8_t *p, uint32_t n) {
    tcp_t *tcp = cur_tcp(j);
    if (read_sqcd(j, tcp, 0, p, &n) || n != 0) return fail(j, "Error reading QCD marker");
    copy_tile_quantization_parameters(j, tcp);
    return 0;
}

static int read_qcc(j2k_t *j, const uint8_t *p, uint32_t n) {
    tcp_t *tcp = cur_tcp(j);
    uint32_t room = j->numcomps <= 256 ? 1 : 2;
    if (n < room) return fail(j, "Error reading QCC marker");
    uint32_t c = rd(p, room);
    n -= room;
    if (c >= j->numcomps) return fail(j, "Invalid component number in QCC marker");
    if (read_sqcd(j, tcp, c, p + room, &n) || n != 0) return fail(j, "Error reading QCC marker");
    return 0;
}

static int read_rgn(j2k_t *j, const uint8_t *p, uint32_t n) {
    uint32_t room = j->numcomps <= 256 ? 1 : 2;
    if (n != 2 + room) return fail(j, "Error reading RGN marker");
    tcp_t *tcp = cur_tcp(j);
    uint32_t c = rd(p, room);
    if (c >= j->numcomps) return fail(j, "bad component number in RGN");
    tcp->tccps[c].roishift = p[room + 1];
    return 0;
}

static int read_poc(j2k_t *j, const uint8_t *p, uint32_t n) {
    uint32_t room = j->numcomps <= 256 ? 1 : 2;
    uint32_t chunk = 5 + 2 * room;
    uint32_t nb = n / chunk;
    if (nb == 0 || n % chunk) return fail(j, "Error reading POC marker");
    tcp_t *tcp = cur_tcp(j);
    uint32_t old = tcp->POC ? tcp->numpocs + 1 : 0;
    nb += old;
    if (nb >= MAX_POCS) return fail(j, "Too many POCs");
    tcp->POC = 1;
    for (uint32_t i = old; i < nb; i++, p += chunk) {
        poc_t *c = &tcp->pocs[i];
        c->resno0 = p[0];
        c->compno0 = rd(p + 1, room);
        c->layno1 = umin(rd(p + 1 + room, 2), tcp->numlayers);
        c->resno1 = p[3 + room];
        c->compno1 = umin(rd(p + 4 + room, room), j->numcomps);
        c->prg = p[4 + 2 * room];
    }
    tcp->numpocs = nb - 1;
    return 0;
}

static int store_marker(j2k_t *j, marker_t **list, uint32_t *count, uint32_t z, const uint8_t *p, uint32_t n,
                        const char *what) {
    if (*count <= z) {
        marker_t *m = realloc(*list, (size_t)(z + 1) * sizeof(marker_t));
        if (!m) return fail(j, "out of memory");
        memset(m + *count, 0, (size_t)(z + 1 - *count) * sizeof(marker_t));
        *list = m;
        *count = z + 1;
    }
    if ((*list)[z].data) return fail(j, what);
    (*list)[z].data = malloc(n ? n : 1);
    if (!(*list)[z].data) return fail(j, "out of memory");
    memcpy((*list)[z].data, p, n);
    (*list)[z].size = n;
    return 0;
}

static int read_ppm(j2k_t *j, const uint8_t *p, uint32_t n) {
    if (n < 2) return fail(j, "Error reading PPM marker");
    j->ppm = 1;
    return store_marker(j, &j->ppm_markers, &j->ppm_count, p[0], p + 1, n - 1, "Zppm already read");
}

static int read_ppt(j2k_t *j, const uint8_t *p, uint32_t n) {
    if (n < 2) return fail(j, "Error reading PPT marker");
    if (j->ppm) return fail(j, "Error reading PPT marker: packet header have been previously found in the main "
                               "header (PPM marker).");
    tcp_t *tcp = &j->tcps[j->cur_tile];
    tcp->ppt = 1;
    return store_marker(j, &tcp->ppt_markers, &tcp->ppt_count, p[0], p + 1, n - 1, "Zppt already read");
}

static int read_tlm(j2k_t *j, const uint8_t *p, uint32_t n) {
    if (n < 2) return fail(j, "Error reading TLM marker");
    uint32_t st = p[1] >> 4 & 3, sp = (p[1] >> 6) & 1;
    uint32_t size = st + (sp ? 4 : 2);
    if ((n - 2) % size) return fail(j, "Error reading TLM marker");
    return 0;
}

static int read_plm(j2k_t *j, const uint8_t *p, uint32_t n) {
    (void)p;
    if (n < 1) return fail(j, "Error reading PLM marker");
    return 0;
}

static int read_plt(j2k_t *j, const uint8_t *p, uint32_t n) {
    if (n < 1) return fail(j, "Error reading PLT marker");
    uint32_t packet_len = 0;
    for (uint32_t i = 1; i < n; i++) {
        packet_len |= p[i] & 0x7f;
        if (p[i] & 0x80) packet_len <<= 7;
        else packet_len = 0;
    }
    if (packet_len != 0) return fail(j, "Error reading PLT marker");
    return 0;
}

static int read_crg(j2k_t *j, const uint8_t *p, uint32_t n) {
    (void)p;
    if (n != j->numcomps * 4) return fail(j, "Error reading CRG marker");
    return 0;
}

static int read_com(j2k_t *j, const uint8_t *p, uint32_t n) { (void)j; (void)p; (void)n; return 0; }

static int read_cbd(j2k_t *j, const uint8_t *p, uint32_t n) {
    if (n != j->numcomps + 2 || rd(p, 2) != j->numcomps) return fail(j, "Error reading CBD marker");
    for (uint32_t i = 0; i < j->numcomps; i++) {
        j->comps[i].sgnd = (p[2 + i] >> 7) & 1;
        j->comps[i].prec = (p[2 + i] & 0x7f) + 1u;
        if (j->comps[i].prec > 31) return fail(j, "Invalid values for comp: prec (OpenJPEG only supports up to 31)");
    }
    return 0;
}

static int read_mct(j2k_t *j, const uint8_t *p, uint32_t n) {
    tcp_t *tcp = cur_tcp(j);
    if (n < 2) return fail(j, "Error reading MCT marker");
    if (rd(p, 2) != 0) return 0;  /* Zmct: data over several markers is not read */
    if (n <= 6) return fail(j, "Error reading MCT marker");
    uint32_t imct = rd(p + 2, 2), idx = imct & 0xff, i;
    for (i = 0; i < tcp->nb_mct && tcp->mcts[i].index != idx; i++) {
    }
    if (i == tcp->nb_mct) {
        mct_rec_t *m = realloc(tcp->mcts, (size_t)(tcp->nb_mct + 1) * sizeof(mct_rec_t));
        if (!m) return fail(j, "out of memory");
        tcp->mcts = m;
        memset(&m[tcp->nb_mct], 0, sizeof(mct_rec_t));
        tcp->nb_mct++;
    }
    mct_rec_t *rec = &tcp->mcts[i];
    free(rec->data);
    rec->data = NULL;
    rec->size = 0;
    rec->index = idx;
    rec->element_type = (imct >> 10) & 3;
    if (rd(p + 4, 2) != 0) return 0;  /* Ymct: several markers are not read */
    rec->data = malloc(n - 6);
    if (!rec->data) return fail(j, "Error reading MCT marker");
    memcpy(rec->data, p + 6, n - 6);
    rec->size = n - 6;
    return 0;
}

static int find_mct(const tcp_t *tcp, uint32_t idx) {
    for (uint32_t i = 0; i < tcp->nb_mct; i++)
        if (tcp->mcts[i].index == idx) return (int)i;
    return -1;
}

static int read_mcc(j2k_t *j, const uint8_t *p, uint32_t n) {
    tcp_t *tcp = cur_tcp(j);
    if (n < 2) return fail(j, "Error reading MCC marker");
    if (rd(p, 2) != 0) return 0;  /* Zmcc */
    if (n < 7) return fail(j, "Error reading MCC marker");
    uint32_t idx = p[2], i;
    for (i = 0; i < tcp->nb_mcc && tcp->mccs[i].index != idx; i++) {
    }
    int fresh = i == tcp->nb_mcc;
    if (fresh) {
        mcc_rec_t *m = realloc(tcp->mccs, (size_t)(tcp->nb_mcc + 1) * sizeof(mcc_rec_t));
        if (!m) return fail(j, "out of memory");
        tcp->mccs = m;
        memset(&m[i], 0, sizeof(mcc_rec_t));
    }
    mcc_rec_t *rec = &tcp->mccs[i];
    rec->index = idx;
    if (rd(p + 3, 2) != 0) return 0;  /* Ymcc */
    uint32_t collections = rd(p + 5, 2);
    if (collections > 1) return 0;
    p += 7;
    n -= 7;
    for (uint32_t c = 0; c < collections; c++) {
        if (n < 3) return fail(j, "Error reading MCC marker");
        if (p[0] != 1) return 0;  /* only array-based decorrelation */
        uint32_t nbc = rd(p + 1, 2), width = 1 + (nbc >> 15);
        rec->nb_comps = nbc & 0x7fff;
        p += 3;
        n -= 3;
        if (n < width * rec->nb_comps + 2) return fail(j, "Error reading MCC marker");
        n -= width * rec->nb_comps + 2;
        for (uint32_t k = 0; k < rec->nb_comps; k++, p += width)
            if (rd(p, (int)width) != k) return 0;
        nbc = rd(p, 2);
        p += 2;
        width = 1 + (nbc >> 15);
        if ((nbc & 0x7fff) != rec->nb_comps) return 0;
        if (n < width * rec->nb_comps + 3) return fail(j, "Error reading MCC marker");
        n -= width * rec->nb_comps + 3;
        for (uint32_t k = 0; k < rec->nb_comps; k++, p += width)
            if (rd(p, (int)width) != k) return 0;
        uint32_t t = rd(p, 3);
        p += 3;
        rec->deco = rec->offset = -1;
        if ((t & 0xff) && (rec->deco = find_mct(tcp, t & 0xff)) < 0) return fail(j, "Error reading MCC marker");
        if (((t >> 8) & 0xff) && (rec->offset = find_mct(tcp, (t >> 8) & 0xff)) < 0)
            return fail(j, "Error reading MCC marker");
    }
    if (n != 0) return fail(j, "Error reading MCC marker");
    if (fresh) tcp->nb_mcc++;
    return 0;
}

static int32_t mct_int(const mct_rec_t *m, uint32_t k) {
    const uint8_t *q = m->data + (size_t)k * (m->element_type == 0 ? 2 : m->element_type == 3 ? 8 : 4);
    double v;
    if (m->element_type == 0) return (int32_t)rd(q, 2);
    if (m->element_type == 1) return (int32_t)rd(q, 4);
    if (m->element_type == 2) { uint32_t b = rd(q, 4); float f; memcpy(&f, &b, 4); v = f; }
    else { uint64_t b = ((uint64_t)rd(q, 4) << 32) | rd(q + 4, 4); memcpy(&v, &b, 8); }
    return v >= -2147483648.0 && v < 2147483648.0 ? (int32_t)v : INT32_MIN;  /* x86's cvtt for the rest */
}

/* opj_j2k_add_mct: the decorrelation array's size is checked; an offset
   array sets the DC level shifts. */
static int add_mct(j2k_t *j, tcp_t *tcp, uint32_t idx) {
    static const uint32_t elem[4] = {2, 4, 4, 8};
    uint32_t i, nc = j->numcomps;
    for (i = 0; i < tcp->nb_mcc && tcp->mccs[i].index != idx; i++) {
    }
    if (i == tcp->nb_mcc || tcp->mccs[i].nb_comps != nc) return 0;
    const mcc_rec_t *rec = &tcp->mccs[i];
    if (rec->deco >= 0) {
        const mct_rec_t *d = &tcp->mcts[rec->deco];
        if (d->size != elem[d->element_type] * nc * nc) return fail(j, "Error reading MCO marker (decorrelation array)");
    }
    if (rec->offset >= 0) {
        const mct_rec_t *o = &tcp->mcts[rec->offset];
        if (o->size != elem[o->element_type] * nc) return fail(j, "Error reading MCO marker (offset array)");
        for (uint32_t c = 0; c < nc; c++) tcp->tccps[c].dc_level_shift = mct_int(o, c);
    }
    return 0;
}

static int read_mco(j2k_t *j, const uint8_t *p, uint32_t n) {
    tcp_t *tcp = cur_tcp(j);
    if (n < 1) return fail(j, "Error reading MCO marker");
    uint32_t stages = p[0];
    if (stages > 1) return 0;  /* several transform stages are not read */
    if (n != stages + 1) return fail(j, "Error reading MCO marker");
    for (uint32_t c = 0; c < j->numcomps; c++) tcp->tccps[c].dc_level_shift = 0;
    for (uint32_t i = 0; i < stages; i++)
        if (add_mct(j, tcp, p[1 + i])) return -1;
    return 0;
}

static int read_sot(j2k_t *j, const uint8_t *p, uint32_t n);

typedef struct { uint32_t id; int states; int (*handler)(j2k_t *, const uint8_t *, uint32_t); } handler_t;

static const handler_t HANDLERS[] = {
    {0xff90, ST_MH | ST_TPHSOT, read_sot},
    {0xff52, ST_MH | ST_TPH, read_cod},
    {0xff53, ST_MH | ST_TPH, read_coc},
    {0xff5e, ST_MH | ST_TPH, read_rgn},
    {0xff5c, ST_MH | ST_TPH, read_qcd},
    {0xff5d, ST_MH | ST_TPH, read_qcc},
    {0xff5f, ST_MH | ST_TPH, read_poc},
    {0xff51, ST_MHSIZ, read_siz},
    {0xff55, ST_MH, read_tlm},
    {0xff57, ST_MH, read_plm},
    {0xff58, ST_TPH, read_plt},
    {0xff60, ST_MH, read_ppm},
    {0xff61, ST_TPH, read_ppt},
    {0xff91, 0, NULL},
    {0xff63, ST_MH, read_crg},
    {0xff64, ST_MH | ST_TPH, read_com},
    {0xff74, ST_MH | ST_TPH, read_mct},
    {0xff78, ST_MH, read_cbd},
    {0xff50, ST_MH, read_com},  /* CAP and CPF (HTJ2K's): read, nothing decoded from them */
    {0xff59, ST_MH, read_com},
    {0xff75, ST_MH | ST_TPH, read_mcc},
    {0xff77, ST_MH | ST_TPH, read_mco},
    {0, ST_MH | ST_TPH, NULL},  /* unknown */
};

static const handler_t *handler_of(uint32_t id) {
    const handler_t *h = HANDLERS;
    while (h->id && h->id != id) h++;
    return h;
}

/* opj_j2k_read_unk: step two bytes at a time to a known marker. */
static int read_unk(j2k_t *j, uint32_t *out) {
    uint8_t b[2];
    const handler_t *h;
    for (;;) {
        if (!read_n(j, b, 2)) return fail(j, "Stream too short");
        uint32_t m = rd(b, 2);
        if (m >= 0xff00) {
            h = handler_of(m);
            if (!(j->state & h->states)) return fail(j, "Marker is not compliant with its position");
            if (h->id != 0) break;
        }
    }
    *out = h->id;
    return 0;
}

static int get_sot_values(j2k_t *j, const uint8_t *p, uint32_t n, uint32_t *tile, uint32_t *tot, uint32_t *part,
                          uint32_t *parts) {
    if (n != 8) return fail(j, "Error reading SOT marker");
    *tile = rd(p, 2); *tot = rd(p + 2, 4); *part = p[6]; *parts = p[7];
    return 0;
}

static int read_sot(j2k_t *j, const uint8_t *p, uint32_t n) {
    uint32_t tile, tot, part, parts;
    if (get_sot_values(j, p, n, &tile, &tot, &part, &parts)) return fail(j, "Error reading SOT marker");
    j->cur_tile = tile;
    if (tile >= j->tw * j->th) return fail(j, "Invalid tile number");
    tcp_t *tcp = &j->tcps[tile];
    if (tcp->cur_tp + 1 != (int32_t)part) return fail(j, "Invalid tile part index for tile number");
    tcp->cur_tp = (int32_t)part;
    if (!tot) j->last_tile_part = 1;
    if (tcp->nb_tile_parts != 0 && part >= tcp->nb_tile_parts) {
        j->last_tile_part = 1;
        return fail(j, "In SOT marker, TPSot is not valid regards to the previous number of tile-part");
    }
    if (parts != 0) {
        if (tcp->nb_tile_parts && part >= tcp->nb_tile_parts) {
            j->last_tile_part = 1;
            return fail(j, "In SOT marker, TPSot is not valid regards to the current number of tile-part");
        }
        if (part >= parts) {
            j->last_tile_part = 1;
            return fail(j, "In SOT marker, TPSot is not valid regards to the current number of tile-part (header)");
        }
        tcp->nb_tile_parts = parts;
    }
    if (tcp->nb_tile_parts && tcp->nb_tile_parts == part + 1) j->can_decode = 1;
    j->sot_length = j->last_tile_part ? 0 : tot - 12;
    j->state = ST_TPH;
    return 0;
}

/* opj_j2k_read_sod: the tile-part's data, appended to its tile's. */
static int read_sod(j2k_t *j) {
    tcp_t *tcp = &j->tcps[j->cur_tile];
    if (j->last_tile_part) {
        j->sot_length = (uint32_t)(left(j) - 2);
    } else if (j->sot_length >= 2) {
        j->sot_length -= 2;
    }
    if (j->sot_length) {
        if ((uint64_t)j->sot_length > left(j)) return fail(j, "Tile part length size inconsistent with stream length");
        if (j->sot_length > UINT32_MAX - CBLK_EXTRA) return fail(j, "tile-part too long");
        uint8_t *d = realloc(tcp->data, tcp->data_size + j->sot_length + CBLK_EXTRA);
        if (!d) return fail(j, "Not enough memory to decode tile");
        tcp->data = d;
    }
    size_t got = 0;
    if (j->sot_length) {
        got = umin(j->sot_length, (uint32_t)umin(left(j), UINT32_MAX));
        memcpy(tcp->data + tcp->data_size, j->buf + j->pos, got);
        j->pos += got;
    }
    j->state = got != j->sot_length ? ST_NEOC : ST_TPHSOT;
    tcp->data_size += got;
    return 0;
}

/* Copy the main header's coding parameters to every tile (after the main
   header), as opj_j2k_copy_default_tcp_and_create_tcd does. */
static int copy_default_tcp(j2k_t *j) {
    for (uint32_t t = 0; t < j->tw * j->th; t++) {
        tcp_t *tcp = &j->tcps[t];
        tccp_t *tccps = malloc((size_t)(j->numcomps ? j->numcomps : 1) * sizeof(tccp_t));
        if (!tccps) return fail(j, "out of memory");
        memcpy(tccps, j->default_tcp.tccps, (size_t)j->numcomps * sizeof(tccp_t));
        int32_t cur_tp = tcp->cur_tp;
        *tcp = j->default_tcp;
        tcp->tccps = tccps;
        tcp->cod = 0;
        tcp->ppt = 0;
        tcp->ppt_markers = NULL;
        tcp->ppt_count = 0;
        tcp->data = NULL;
        tcp->data_size = 0;
        tcp->cur_tp = cur_tp;
        tcp->nb_tile_parts = 0;
        tcp->mcts = NULL;
        tcp->mccs = NULL;
        tcp->nb_mct = tcp->nb_mcc = 0;
        if (j->default_tcp.nb_mct) {
            tcp->mcts = calloc(j->default_tcp.nb_mct, sizeof(mct_rec_t));
            if (!tcp->mcts) return fail(j, "out of memory");
            for (uint32_t i = 0; i < j->default_tcp.nb_mct; i++, tcp->nb_mct++) {
                tcp->mcts[i] = j->default_tcp.mcts[i];
                tcp->mcts[i].data = NULL;
                if (j->default_tcp.mcts[i].data) {
                    tcp->mcts[i].data = malloc(tcp->mcts[i].size ? tcp->mcts[i].size : 1);
                    if (!tcp->mcts[i].data) return fail(j, "out of memory");
                    memcpy(tcp->mcts[i].data, j->default_tcp.mcts[i].data, tcp->mcts[i].size);
                }
            }
        }
        if (j->default_tcp.nb_mcc) {
            tcp->mccs = malloc(j->default_tcp.nb_mcc * sizeof(mcc_rec_t));
            if (!tcp->mccs) return fail(j, "out of memory");
            memcpy(tcp->mccs, j->default_tcp.mccs, j->default_tcp.nb_mcc * sizeof(mcc_rec_t));
            tcp->nb_mcc = j->default_tcp.nb_mcc;
        }
    }
    return 0;
}

static int merge_ppm(j2k_t *j) {
    if (!j->ppm) return 0;
    uint64_t total = 0;
    uint32_t remaining = 0;
    for (int pass = 0; pass < 2; pass++) {
        uint32_t out = 0;
        remaining = 0;
        for (uint32_t i = 0; i < j->ppm_count; i++) {
            const uint8_t *d = j->ppm_markers[i].data;
            if (!d) continue;
            uint32_t size = j->ppm_markers[i].size;
            uint32_t take = remaining >= size ? size : remaining;
            if (pass) memcpy(j->ppm_buffer + out, d, take);
            out += take;
            remaining -= take;
            d += take;
            size -= take;
            while (size > 0) {
                if (size < 4) return fail(j, "Not enough bytes to read Nppm");
                uint32_t nppm = rd(d, 4);
                d += 4;
                size -= 4;
                if (!pass) {
                    if (total + nppm > UINT32_MAX) return fail(j, "Too large value for Nppm");
                    total += nppm;
                }
                uint32_t k = size >= nppm ? nppm : size;
                if (pass) memcpy(j->ppm_buffer + out, d, k);
                out += k;
                d += k;
                size -= k;
                remaining = nppm - k;
            }
        }
        if (!pass) {
            if (remaining != 0) return fail(j, "Corrupted PPM markers");
            j->ppm_buffer = malloc(total ? total : 1);
            if (!j->ppm_buffer) return fail(j, "out of memory");
        }
    }
    j->ppm_data = j->ppm_buffer;
    j->ppm_len = (uint32_t)total;
    return 0;
}

static int merge_ppt(j2k_t *j, tcp_t *tcp) {
    if (tcp->ppt_buffer) return fail(j, "opj_j2k_merge_ppt() has already been called");
    if (!tcp->ppt) return 0;
    uint32_t size = 0;
    for (uint32_t i = 0; i < tcp->ppt_count; i++) size += tcp->ppt_markers[i].size;
    tcp->ppt_buffer = malloc(size ? size : 1);
    if (!tcp->ppt_buffer) return fail(j, "out of memory");
    tcp->ppt_len = size;
    size = 0;
    for (uint32_t i = 0; i < tcp->ppt_count; i++) {
        if (tcp->ppt_markers[i].data) {
            memcpy(tcp->ppt_buffer + size, tcp->ppt_markers[i].data, tcp->ppt_markers[i].size);
            size += tcp->ppt_markers[i].size;
            free(tcp->ppt_markers[i].data);
        }
    }
    free(tcp->ppt_markers);
    tcp->ppt_markers = NULL;
    tcp->ppt_count = 0;
    tcp->ppt_data = tcp->ppt_buffer;
    return 0;
}

/* opj_j2k_read_header_procedure: SOC, then the main header up to the first SOT. */
static int read_main_header(j2k_t *j) {
    uint8_t b[2];
    j->state = ST_MHSOC;
    if (!read_n(j, b, 2) || rd(b, 2) != 0xff4f) return fail(j, "Expected a SOC marker");
    j->state = ST_MHSIZ;
    if (!read_n(j, b, 2)) return fail(j, "Stream too short");
    uint32_t marker = rd(b, 2);
    int has_siz = 0, has_cod = 0, has_qcd = 0;
    while (marker != 0xff90) {
        if (marker < 0xff00) return fail(j, "A marker ID was expected (0xff--)");
        const handler_t *h = handler_of(marker);
        if (h->id == 0) {
            if (read_unk(j, &marker)) return fail(j, "Unknown marker has been detected and generated error.");
            if (marker == 0xff90) break;
            h = handler_of(marker);
        }
        if (h->id == 0xff51) has_siz = 1;
        if (h->id == 0xff52) has_cod = 1;
        if (h->id == 0xff5c) has_qcd = 1;
        if (!(j->state & h->states)) return fail(j, "Marker is not compliant with its position");
        if (!read_n(j, b, 2)) return fail(j, "Stream too short");
        uint32_t size = rd(b, 2);
        if (size < 2) return fail(j, "Invalid marker size");
        size -= 2;
        if (left(j) < size) return fail(j, "Stream too short");
        const uint8_t *seg = j->buf + j->pos;
        j->pos += size;
        if (h->handler(j, seg, size)) return fail(j, "Marker handler function failed to read the marker segment");
        if (!read_n(j, b, 2)) return fail(j, "Stream too short");
        marker = rd(b, 2);
    }
    if (!has_siz) return fail(j, "required SIZ marker not found in main header");
    if (!has_cod) return fail(j, "required COD marker not found in main header");
    if (!has_qcd) return fail(j, "required QCD marker not found in main header");
    if (merge_ppm(j)) return fail(j, "Failed to merge PPM data");
    if (copy_default_tcp(j)) return -1;
    j->state = ST_TPHSOT;
    return 0;
}

/* opj_j2k_read_tile_header: read tile-parts until a tile can be decoded.
   Returns 1 with *tile set, 0 when no tile is left, -1 on error. */
static int read_tile_header(j2k_t *j, uint32_t *tile) {
    uint8_t b[2];
    uint32_t marker = 0xff90;
    uint32_t nb_tiles = j->tw * j->th;
    if (j->state == ST_EOC) marker = 0xffd9;
    else if (j->state != ST_TPHSOT) return fail(j, "unexpected decoder state");
    while (!j->can_decode && marker != 0xffd9) {
        while (marker != 0xff93) {
            if (left(j) == 0) { j->state = ST_NEOC; break; }
            if (!read_n(j, b, 2)) return fail(j, "Stream too short");
            uint32_t size = rd(b, 2);
            if (size < 2) return fail(j, "Inconsistent marker size");
            if (marker == 0x8080 && left(j) == 0) { j->state = ST_NEOC; break; }
            if ((j->state & ST_TPH) && j->sot_length != 0) {
                if (j->sot_length < size + 2) return fail(j, "Sot length is less than marker size + marker ID");
                j->sot_length -= size + 2;
            }
            size -= 2;
            const handler_t *h = handler_of(marker);
            if (!(j->state & h->states)) return fail(j, "Marker is not compliant with its position");
            if (left(j) < size) return fail(j, "Stream too short");
            const uint8_t *seg = j->buf + j->pos;
            j->pos += size;
            if (!h->handler) return fail(j, "Not sure how that happened.");
            if (h->handler(j, seg, size)) return fail(j, "Fail to read the current marker segment");
            if (!read_n(j, b, 2)) return fail(j, "Stream too short");
            marker = rd(b, 2);
        }
        if (left(j) == 0 && j->state == ST_NEOC) break;
        /* OpenJPEG's TNsot correction looks ahead by seeking, and PIL's
           stream has no seek function: it never applies. */
        if (read_sod(j)) return -1;
        if (!j->can_decode) {
            if (!read_n(j, b, 2)) {
                if (j->cur_tile + 1 == nb_tiles) {
                    uint32_t t;
                    for (t = 0; t < nb_tiles; t++)
                        if (j->tcps[t].cur_tp == 0 && j->tcps[t].nb_tile_parts == 0) break;
                    if (t < nb_tiles) {
                        j->cur_tile = t;
                        marker = 0xffd9;
                        j->state = ST_EOC;
                        break;
                    }
                }
                return fail(j, "Stream too short");
            }
            marker = rd(b, 2);
        }
    }
    if (marker == 0xffd9 && j->state != ST_EOC) {
        j->cur_tile = 0;
        j->state = ST_EOC;
    }
    if (!j->can_decode) {
        while (j->cur_tile < nb_tiles && j->tcps[j->cur_tile].data == NULL) j->cur_tile++;
        if (j->cur_tile == nb_tiles) return 0;
    }
    if (merge_ppt(j, &j->tcps[j->cur_tile])) return fail(j, "Failed to merge PPT data");
    *tile = j->cur_tile;
    j->state |= ST_DATA;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Tile structure                                                      */

typedef struct { uint32_t numpasses, len, maxpasses, numnewpasses, newlen, real_num_passes; } seg_t;
typedef struct { const uint8_t *data; uint32_t len; } chunk_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t numbps, numlenbits, numnewpasses;
    uint32_t numsegs, real_num_segs, segs_cap;
    seg_t *segs;
    chunk_t *chunks;
    uint32_t numchunks, chunks_cap;
} cblk_t;

typedef struct { int32_t value, low; int32_t parent; } tgt_node_t;
typedef struct { uint32_t numleafsh, numleafsv, numnodes; tgt_node_t *nodes; } tgt_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t cw, ch;
    cblk_t *cblks;
    tgt_t incl, imsb;
} prc_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t bandno;
    int32_t numbps;
    float stepsize;
    prc_t *prcs;
} band_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t pw, ph, numbands;
    band_t bands[3];
} res_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    uint32_t numresolutions;
    res_t *res;
    int32_t *data;  /* int32 or float32 samples, w x h of the full resolution */
} tilec_t;

typedef struct {
    int32_t x0, y0, x1, y1;
    tilec_t *comps;
} tile_t;

static void tgt_init(tgt_t *t, uint32_t w, uint32_t h) {
    t->numleafsh = w; t->numleafsv = h; t->nodes = NULL; t->numnodes = 0;
    if (!w || !h) return;
    int32_t nplh[32], nplv[32];
    uint32_t numlvls = 0, n;
    nplh[0] = (int32_t)w; nplv[0] = (int32_t)h;
    do {
        n = (uint32_t)(nplh[numlvls] * nplv[numlvls]);
        nplh[numlvls + 1] = (nplh[numlvls] + 1) / 2;
        nplv[numlvls + 1] = (nplv[numlvls] + 1) / 2;
        t->numnodes += n;
        ++numlvls;
    } while (n > 1);
    t->nodes = calloc(t->numnodes, sizeof(tgt_node_t));
    if (!t->nodes) return;
    int32_t node = 0, parent = (int32_t)(w * h), parent0 = parent;
    for (uint32_t i = 0; i + 1 < numlvls; ++i) {
        for (int32_t jj = 0; jj < nplv[i]; ++jj) {
            int32_t k = nplh[i];
            while (--k >= 0) {
                t->nodes[node++].parent = parent;
                if (--k >= 0) t->nodes[node++].parent = parent;
                ++parent;
            }
            if ((jj & 1) || jj == nplv[i] - 1) {
                parent0 = parent;
            } else {
                parent = parent0;
                parent0 += nplh[i];
            }
        }
    }
    t->nodes[node].parent = -1;
}

static void tgt_reset(tgt_t *t) {
    for (uint32_t i = 0; i < t->numnodes; i++) { t->nodes[i].value = 999; t->nodes[i].low = 0; }
}

static void tile_free(tile_t *tile, uint32_t numcomps) {
    if (!tile->comps) return;
    for (uint32_t c = 0; c < numcomps; c++) {
        tilec_t *tc = &tile->comps[c];
        if (tc->res) {
            for (uint32_t r = 0; r < tc->numresolutions; r++) {
                for (uint32_t b = 0; b < tc->res[r].numbands; b++) {
                    band_t *band = &tc->res[r].bands[b];
                    if (!band->prcs) continue;
                    for (uint32_t p = 0; p < tc->res[r].pw * tc->res[r].ph; p++) {
                        prc_t *prc = &band->prcs[p];
                        if (prc->cblks) {
                            for (uint32_t k = 0; k < prc->cw * prc->ch; k++) {
                                free(prc->cblks[k].segs);
                                free(prc->cblks[k].chunks);
                            }
                            free(prc->cblks);
                        }
                        free(prc->incl.nodes);
                        free(prc->imsb.nodes);
                    }
                    free(band->prcs);
                }
            }
            free(tc->res);
        }
        free(tc->data);
    }
    free(tile->comps);
    tile->comps = NULL;
}

/* opj_tcd_init_tile for decoding. */
static int tile_init(j2k_t *j, tcp_t *tcp, uint32_t tileno, tile_t *tile) {
    uint32_t p = tileno % j->tw, q = tileno / j->tw;
    uint32_t l_tx0 = j->tx0 + p * j->tdx, l_ty0 = j->ty0 + q * j->tdy;
    tile->x0 = (int32_t)umax(l_tx0, j->x0);
    tile->y0 = (int32_t)umax(l_ty0, j->y0);
    tile->x1 = (int32_t)umin(uint_adds(l_tx0, j->tdx), j->x1);
    tile->y1 = (int32_t)umin(uint_adds(l_ty0, j->tdy), j->y1);
    if (tcp->tccps[0].numresolutions == 0) return fail(j, "tiles require at least one resolution");
    tile->comps = calloc(j->numcomps, sizeof(tilec_t));
    if (!tile->comps) return fail(j, "out of memory");
    for (uint32_t c = 0; c < j->numcomps; c++) {
        tccp_t *tccp = &tcp->tccps[c];
        comp_t *ic = &j->comps[c];
        tilec_t *tc = &tile->comps[c];
        if (tccp->numresolutions == 0) return fail(j, "tiles require at least one resolution");
        tc->x0 = int_ceildiv(tile->x0, (int32_t)ic->dx);
        tc->y0 = int_ceildiv(tile->y0, (int32_t)ic->dy);
        tc->x1 = int_ceildiv(tile->x1, (int32_t)ic->dx);
        tc->y1 = int_ceildiv(tile->y1, (int32_t)ic->dy);
        tc->numresolutions = tccp->numresolutions;
        tc->res = calloc(tc->numresolutions, sizeof(res_t));
        if (!tc->res) return fail(j, "out of memory");
        uint32_t level = tc->numresolutions;
        const stepsize_t *step = tccp->stepsizes;
        for (uint32_t r = 0; r < tc->numresolutions; r++) {
            res_t *res = &tc->res[r];
            --level;
            res->x0 = int_ceildivpow2(tc->x0, (int32_t)level);
            res->y0 = int_ceildivpow2(tc->y0, (int32_t)level);
            res->x1 = int_ceildivpow2(tc->x1, (int32_t)level);
            res->y1 = int_ceildivpow2(tc->y1, (int32_t)level);
            uint32_t pdx = tccp->prcw[r], pdy = tccp->prch[r];
            int32_t tlpx = int_floordivpow2(res->x0, (int32_t)pdx) << pdx;
            int32_t tlpy = int_floordivpow2(res->y0, (int32_t)pdy) << pdy;
            uint32_t brx = ((uint32_t)int_ceildivpow2(res->x1, (int32_t)pdx)) << pdx;
            uint32_t bry = ((uint32_t)int_ceildivpow2(res->y1, (int32_t)pdy)) << pdy;
            if (brx > (uint32_t)INT_MAX || bry > (uint32_t)INT_MAX) return fail(j, "Integer overflow");
            res->pw = res->x0 == res->x1 ? 0 : (uint32_t)(((int32_t)brx - tlpx) >> pdx);
            res->ph = res->y0 == res->y1 ? 0 : (uint32_t)(((int32_t)bry - tlpy) >> pdy);
            if (res->pw && UINT32_MAX / res->pw < res->ph) return fail(j, "Size of tile data exceeds system limits");
            uint32_t nprc = res->pw * res->ph;
            if (nprc > (1u << 26)) return fail(j, "Size of tile data exceeds system limits");
            int32_t tlcbgx, tlcbgy;
            uint32_t cbgw, cbgh;
            if (r == 0) {
                tlcbgx = tlpx; tlcbgy = tlpy; cbgw = pdx; cbgh = pdy; res->numbands = 1;
            } else {
                tlcbgx = int_ceildivpow2(tlpx, 1); tlcbgy = int_ceildivpow2(tlpy, 1);
                cbgw = pdx - 1; cbgh = pdy - 1; res->numbands = 3;
            }
            uint32_t cbw = umin(tccp->cblkw, cbgw), cbh = umin(tccp->cblkh, cbgh);
            for (uint32_t bi = 0; bi < res->numbands; bi++, step++) {
                band_t *band = &res->bands[bi];
                if (r == 0) {
                    band->bandno = 0;
                    band->x0 = int_ceildivpow2(tc->x0, (int32_t)level);
                    band->y0 = int_ceildivpow2(tc->y0, (int32_t)level);
                    band->x1 = int_ceildivpow2(tc->x1, (int32_t)level);
                    band->y1 = int_ceildivpow2(tc->y1, (int32_t)level);
                } else {
                    band->bandno = bi + 1;
                    int64_t x0b = band->bandno & 1, y0b = band->bandno >> 1;
                    band->x0 = int64_ceildivpow2(tc->x0 - (x0b << level), (int32_t)(level + 1));
                    band->y0 = int64_ceildivpow2(tc->y0 - (y0b << level), (int32_t)(level + 1));
                    band->x1 = int64_ceildivpow2(tc->x1 - (x0b << level), (int32_t)(level + 1));
                    band->y1 = int64_ceildivpow2(tc->y1 - (y0b << level), (int32_t)(level + 1));
                }
                {
                    int32_t log2_gain = tccp->qmfbid == 0 ? 0 : band->bandno == 0 ? 0 : band->bandno == 3 ? 2 : 1;
                    int32_t rb = (int32_t)ic->prec + log2_gain;
                    band->stepsize = (float)((1.0 + step->mant / 2048.0) * pow(2.0, (int32_t)(rb - step->expn)));
                }
                band->numbps = step->expn + (int32_t)tccp->numgbits - 1;
                if (!nprc) continue;
                band->prcs = calloc(nprc, sizeof(prc_t));
                if (!band->prcs) return fail(j, "out of memory");
                for (uint32_t pi = 0; pi < nprc; pi++) {
                    prc_t *prc = &band->prcs[pi];
                    int32_t cbgxs = tlcbgx + (int32_t)(pi % res->pw) * (1 << cbgw);
                    int32_t cbgys = tlcbgy + (int32_t)(pi / res->pw) * (1 << cbgh);
                    prc->x0 = imax(cbgxs, band->x0);
                    prc->y0 = imax(cbgys, band->y0);
                    prc->x1 = imin(cbgxs + (1 << cbgw), band->x1);
                    prc->y1 = imin(cbgys + (1 << cbgh), band->y1);
                    int32_t tlcx = int_floordivpow2(prc->x0, (int32_t)cbw) << cbw;
                    int32_t tlcy = int_floordivpow2(prc->y0, (int32_t)cbh) << cbh;
                    int32_t brcx = int_ceildivpow2(prc->x1, (int32_t)cbw) << cbw;
                    int32_t brcy = int_ceildivpow2(prc->y1, (int32_t)cbh) << cbh;
                    prc->cw = (uint32_t)((brcx - tlcx) >> cbw);
                    prc->ch = (uint32_t)((brcy - tlcy) >> cbh);
                    uint32_t ncb = prc->cw * prc->ch;
                    if (ncb) {
                        prc->cblks = calloc(ncb, sizeof(cblk_t));
                        if (!prc->cblks) return fail(j, "out of memory");
                    }
                    for (uint32_t k = 0; k < ncb; k++) {
                        cblk_t *cb = &prc->cblks[k];
                        int32_t cxs = tlcx + (int32_t)(k % prc->cw) * (1 << cbw);
                        int32_t cys = tlcy + (int32_t)(k / prc->cw) * (1 << cbh);
                        cb->x0 = imax(cxs, prc->x0);
                        cb->y0 = imax(cys, prc->y0);
                        cb->x1 = imin(cxs + (1 << cbw), prc->x1);
                        cb->y1 = imin(cys + (1 << cbh), prc->y1);
                    }
                    tgt_init(&prc->incl, prc->cw, prc->ch);
                    tgt_init(&prc->imsb, prc->cw, prc->ch);
                    if (ncb && (!prc->incl.nodes || !prc->imsb.nodes)) return fail(j, "out of memory");
                }
            }
        }
        res_t *full = &tc->res[tc->numresolutions - 1];
        uint64_t w = (uint64_t)(full->x1 - full->x0), h = (uint64_t)(full->y1 - full->y0);
        if (w * h > ((uint64_t)1 << 31) / 4) return fail(j, "Size of tile data exceeds system limits");
        tc->data = calloc(w * h > 0 ? w * h : 1, sizeof(int32_t));
        if (!tc->data) return fail(j, "Size of tile data exceeds system limits");
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Packet iterator (opj_pi_*)                                          */

typedef struct { uint32_t pdx, pdy, pw, ph; } pi_res_t;
typedef struct { uint32_t dx, dy, numresolutions; pi_res_t res[MAXRLVLS]; } pi_comp_t;

typedef struct {
    uint32_t compno, resno, precno, layno, x, y, dx, dy;
    uint32_t tx0, ty0, tx1, ty1;
    int first;
    poc_t poc;
    uint32_t precno0, precno1, layno0;
    uint32_t numcomps;
    pi_comp_t *comps;
    uint8_t *include;
    uint64_t include_size, step_l, step_r, step_c;
} pi_t;

static uint32_t ceildiv64(uint64_t a, uint64_t b) { return (uint32_t)((a + b - 1) / b); }

static int pi_emit(pi_t *pi) {
    uint64_t index = pi->layno * pi->step_l + pi->resno * pi->step_r + pi->compno * pi->step_c + pi->precno;
    if (index >= pi->include_size) return -1;
    if (!pi->include[index]) { pi->include[index] = 1; return 1; }
    return 0;
}

/* The position checks of B.12.1.3-5 (RPCL, PCRL, CPRL); sets precno. */
static int pi_position(pi_t *pi, pi_comp_t *comp) {
    pi_res_t *res = &comp->res[pi->resno];
    uint32_t levelno = comp->numresolutions - 1 - pi->resno;
    if ((uint32_t)(((uint64_t)comp->dx << levelno) >> levelno) != comp->dx ||
        (uint32_t)(((uint64_t)comp->dy << levelno) >> levelno) != comp->dy) return 0;
    uint32_t trx0 = ceildiv64(pi->tx0, (uint64_t)comp->dx << levelno);
    uint32_t try0 = ceildiv64(pi->ty0, (uint64_t)comp->dy << levelno);
    uint32_t trx1 = ceildiv64(pi->tx1, (uint64_t)comp->dx << levelno);
    uint32_t try1 = ceildiv64(pi->ty1, (uint64_t)comp->dy << levelno);
    uint32_t rpx = res->pdx + levelno, rpy = res->pdy + levelno;
    if ((uint32_t)(((uint64_t)comp->dx << rpx) >> rpx) != comp->dx ||
        (uint32_t)(((uint64_t)comp->dy << rpy) >> rpy) != comp->dy) return 0;
    if (!(((uint64_t)pi->y % ((uint64_t)comp->dy << rpy) == 0) ||
          ((pi->y == pi->ty0) && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy))))) return 0;
    if (!(((uint64_t)pi->x % ((uint64_t)comp->dx << rpx) == 0) ||
          ((pi->x == pi->tx0) && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx))))) return 0;
    if (res->pw == 0 || res->ph == 0) return 0;
    if (trx0 == trx1 || try0 == try1) return 0;
    uint32_t prci = (ceildiv64(pi->x, (uint64_t)comp->dx << levelno) >> res->pdx) - (trx0 >> res->pdx);
    uint32_t prcj = (ceildiv64(pi->y, (uint64_t)comp->dy << levelno) >> res->pdy) - (try0 >> res->pdy);
    pi->precno = prci + prcj * res->pw;
    return 1;
}

static void pi_min_steps(pi_t *pi, uint32_t c0, uint32_t c1) {
    pi->dx = pi->dy = 0;
    for (uint32_t c = c0; c < c1; c++) {
        pi_comp_t *comp = &pi->comps[c];
        for (uint32_t r = 0; r < comp->numresolutions; r++) {
            pi_res_t *res = &comp->res[r];
            uint32_t sx = res->pdx + comp->numresolutions - 1 - r, sy = res->pdy + comp->numresolutions - 1 - r;
            if (sx < 32 && comp->dx <= UINT32_MAX / (1u << sx)) {
                uint32_t d = comp->dx * (1u << sx);
                pi->dx = !pi->dx ? d : umin(pi->dx, d);
            }
            if (sy < 32 && comp->dy <= UINT32_MAX / (1u << sy)) {
                uint32_t d = comp->dy * (1u << sy);
                pi->dy = !pi->dy ? d : umin(pi->dy, d);
            }
        }
    }
}

/* The next packet of the progression, as opj_pi_next: 1, or 0 at the end
   (which also covers OpenJPEG's "invalid" ends), -1 for its include error. */
#define EMIT() do { int e_ = pi_emit(pi); if (e_) return e_ < 0 ? -1 : 1; } while (0)

static int pi_next(pi_t *pi) {
    pi_comp_t *comp = NULL;
    if (pi->poc.compno0 >= pi->numcomps || pi->poc.compno1 >= pi->numcomps + 1) return 0;
    if (!pi->first) comp = &pi->comps[pi->compno];
    switch (pi->poc.prg) {
    case 0: /* LRCP */
        if (!pi->first) goto lrcp_skip;
        pi->first = 0;
        for (pi->layno = pi->layno0; pi->layno < pi->poc.layno1; pi->layno++)
            for (pi->resno = pi->poc.resno0; pi->resno < pi->poc.resno1; pi->resno++)
                for (pi->compno = pi->poc.compno0; pi->compno < pi->poc.compno1; pi->compno++) {
                    comp = &pi->comps[pi->compno];
                    if (pi->resno >= comp->numresolutions) continue;
                    pi->precno1 = comp->res[pi->resno].pw * comp->res[pi->resno].ph;
                    for (pi->precno = pi->precno0; pi->precno < pi->precno1; pi->precno++) {
                        EMIT();
                    lrcp_skip:;
                    }
                }
        return 0;
    case 1: /* RLCP */
        if (!pi->first) goto rlcp_skip;
        pi->first = 0;
        for (pi->resno = pi->poc.resno0; pi->resno < pi->poc.resno1; pi->resno++)
            for (pi->layno = pi->layno0; pi->layno < pi->poc.layno1; pi->layno++)
                for (pi->compno = pi->poc.compno0; pi->compno < pi->poc.compno1; pi->compno++) {
                    comp = &pi->comps[pi->compno];
                    if (pi->resno >= comp->numresolutions) continue;
                    pi->precno1 = comp->res[pi->resno].pw * comp->res[pi->resno].ph;
                    for (pi->precno = pi->precno0; pi->precno < pi->precno1; pi->precno++) {
                        EMIT();
                    rlcp_skip:;
                    }
                }
        return 0;
    case 2: /* RPCL */
        if (!pi->first) goto rpcl_skip;
        pi->first = 0;
        pi_min_steps(pi, 0, pi->numcomps);
        if (pi->dx == 0 || pi->dy == 0) return 0;
        for (pi->resno = pi->poc.resno0; pi->resno < pi->poc.resno1; pi->resno++)
            for (pi->y = pi->ty0; pi->y < pi->ty1; pi->y += pi->dy - (pi->y % pi->dy))
                for (pi->x = pi->tx0; pi->x < pi->tx1; pi->x += pi->dx - (pi->x % pi->dx))
                    for (pi->compno = pi->poc.compno0; pi->compno < pi->poc.compno1; pi->compno++) {
                        comp = &pi->comps[pi->compno];
                        if (pi->resno >= comp->numresolutions) continue;
                        if (!pi_position(pi, comp)) continue;
                        for (pi->layno = pi->layno0; pi->layno < pi->poc.layno1; pi->layno++) {
                            EMIT();
                        rpcl_skip:;
                        }
                    }
        return 0;
    case 3: /* PCRL */
        if (!pi->first) goto pcrl_skip;
        pi->first = 0;
        pi_min_steps(pi, 0, pi->numcomps);
        if (pi->dx == 0 || pi->dy == 0) return 0;
        for (pi->y = pi->ty0; pi->y < pi->ty1; pi->y += pi->dy - (pi->y % pi->dy))
            for (pi->x = pi->tx0; pi->x < pi->tx1; pi->x += pi->dx - (pi->x % pi->dx))
                for (pi->compno = pi->poc.compno0; pi->compno < pi->poc.compno1; pi->compno++) {
                    comp = &pi->comps[pi->compno];
                    for (pi->resno = pi->poc.resno0; pi->resno < umin(pi->poc.resno1, comp->numresolutions);
                         pi->resno++) {
                        if (!pi_position(pi, comp)) continue;
                        for (pi->layno = pi->layno0; pi->layno < pi->poc.layno1; pi->layno++) {
                            EMIT();
                        pcrl_skip:;
                        }
                    }
                }
        return 0;
    case 4: /* CPRL */
        if (!pi->first) goto cprl_skip;
        pi->first = 0;
        for (pi->compno = pi->poc.compno0; pi->compno < pi->poc.compno1; pi->compno++) {
            comp = &pi->comps[pi->compno];
            pi_min_steps(pi, pi->compno, pi->compno + 1);
            if (pi->dx == 0 || pi->dy == 0) return 0;
            for (pi->y = pi->ty0; pi->y < pi->ty1; pi->y += pi->dy - (pi->y % pi->dy))
                for (pi->x = pi->tx0; pi->x < pi->tx1; pi->x += pi->dx - (pi->x % pi->dx))
                    for (pi->resno = pi->poc.resno0; pi->resno < umin(pi->poc.resno1, comp->numresolutions);
                         pi->resno++) {
                        if (!pi_position(pi, comp)) continue;
                        for (pi->layno = pi->layno0; pi->layno < pi->poc.layno1; pi->layno++) {
                            EMIT();
                        cprl_skip:;
                        }
                    }
        }
        return 0;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Tier 2                                                              */

typedef struct { const uint8_t *start, *end, *bp; uint32_t buf, ct; } bio_t;

static void bio_init(bio_t *b, const uint8_t *p, uint32_t len) { b->start = b->bp = p; b->end = p + len; b->buf = 0; b->ct = 0; }

static void bio_bytein(bio_t *b) {
    b->buf = (b->buf << 8) & 0xffff;
    b->ct = b->buf == 0xff00 ? 7 : 8;
    if (b->bp >= b->end) return;
    b->buf |= *b->bp++;
}

static uint32_t bio_getbit(bio_t *b) {
    if (b->ct == 0) bio_bytein(b);
    b->ct--;
    return (b->buf >> b->ct) & 1;
}

static uint32_t bio_read(bio_t *b, uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; i--) v |= bio_getbit(b) << i;
    return v;
}

static void bio_inalign(bio_t *b) {
    if ((b->buf & 0xff) == 0xff) bio_bytein(b);
    b->ct = 0;
}

static uint32_t tgt_decode(bio_t *bio, tgt_t *t, uint32_t leaf, int32_t threshold) {
    int32_t stk[32];
    int sp = 0;
    int32_t node = (int32_t)leaf;
    while (t->nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = t->nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
        tgt_node_t *nd = &t->nodes[node];
        if (low > nd->low) nd->low = low;
        else low = nd->low;
        while (low < threshold && low < nd->value) {
            if (bio_read(bio, 1)) nd->value = low;
            else ++low;
        }
        nd->low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t->nodes[node].value < threshold ? 1 : 0;
}

static uint32_t getnumpasses(bio_t *b) {
    uint32_t n;
    if (!bio_read(b, 1)) return 1;
    if (!bio_read(b, 1)) return 2;
    if ((n = bio_read(b, 2)) != 3) return 3 + n;
    if ((n = bio_read(b, 5)) != 31) return 6 + n;
    return 37 + bio_read(b, 7);
}

static int init_seg(cblk_t *cb, uint32_t segno, uint32_t cblksty, int first) {
    if (segno >= cb->segs_cap) {
        uint32_t cap = cb->segs_cap ? cb->segs_cap * 2 : 10;
        while (cap <= segno) cap *= 2;
        seg_t *s = realloc(cb->segs, (size_t)cap * sizeof(seg_t));
        if (!s) return -1;
        memset(s + cb->segs_cap, 0, (size_t)(cap - cb->segs_cap) * sizeof(seg_t));
        cb->segs = s;
        cb->segs_cap = cap;
    }
    seg_t *seg = &cb->segs[segno];
    memset(seg, 0, sizeof *seg);
    if (cblksty & 4) seg->maxpasses = 1;
    else if (cblksty & 1) {
        if (first) seg->maxpasses = 10;
        else seg->maxpasses = (seg[-1].maxpasses == 1 || seg[-1].maxpasses == 10) ? 2 : 1;
    } else seg->maxpasses = 109;
    return 0;
}

static int add_chunk(cblk_t *cb, const uint8_t *d, uint32_t len) {
    if (cb->numchunks == cb->chunks_cap) {
        uint32_t cap = cb->chunks_cap ? cb->chunks_cap * 2 : 8;
        chunk_t *c = realloc(cb->chunks, (size_t)cap * sizeof(chunk_t));
        if (!c) return -1;
        cb->chunks = c;
        cb->chunks_cap = cap;
    }
    cb->chunks[cb->numchunks].data = d;
    cb->chunks[cb->numchunks].len = len;
    cb->numchunks++;
    return 0;
}

static int band_empty(const band_t *b) { return b->x1 - b->x0 == 0 || b->y1 - b->y0 == 0; }

/* opj_t2_read_packet_header + read / skip packet data. */
static int t2_packet(j2k_t *j, tcp_t *tcp, tile_t *tile, pi_t *pi, const uint8_t *src, uint32_t max_len,
                     uint32_t *read, int skip) {
    res_t *res = &tile->comps[pi->compno].res[pi->resno];
    tccp_t *tccp = &tcp->tccps[pi->compno];
    const uint8_t *cur = src;
    if (pi->layno == 0) {
        for (uint32_t b = 0; b < res->numbands; b++) {
            band_t *band = &res->bands[b];
            if (band_empty(band)) continue;
            if (!(pi->precno < res->pw * res->ph)) return fail(j, "Invalid precinct");
            prc_t *prc = &band->prcs[pi->precno];
            tgt_reset(&prc->incl);
            tgt_reset(&prc->imsb);
            for (uint32_t k = 0; k < prc->cw * prc->ch; k++) { prc->cblks[k].numsegs = 0; prc->cblks[k].real_num_segs = 0; }
        }
    }
    if (tcp->csty & 2) {  /* SOP: optional, OpenJPEG only warns */
        if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    const uint8_t **hstart;
    const uint8_t *hdata;
    uint32_t *hlen, remaining;
    if (j->ppm) {
        hstart = (const uint8_t **)&j->ppm_data; hlen = &j->ppm_len;
    } else if (tcp->ppt) {
        hstart = (const uint8_t **)&tcp->ppt_data; hlen = &tcp->ppt_len;
    } else {
        hstart = &cur;
        remaining = (uint32_t)(src + max_len - cur);
        hlen = &remaining;
    }
    hdata = *hstart;
    bio_t bio;
    bio_init(&bio, hdata, *hlen);
    uint32_t present = bio_read(&bio, 1);
    if (present) {
        for (uint32_t b = 0; b < res->numbands; b++) {
            band_t *band = &res->bands[b];
            if (band_empty(band)) continue;
            prc_t *prc = &band->prcs[pi->precno];
            for (uint32_t k = 0; k < prc->cw * prc->ch; k++) {
                cblk_t *cb = &prc->cblks[k];
                uint32_t included;
                if (!cb->numsegs) included = tgt_decode(&bio, &prc->incl, k, (int32_t)(pi->layno + 1));
                else included = bio_read(&bio, 1);
                if (!included) { cb->numnewpasses = 0; continue; }
                if (!cb->numsegs) {
                    uint32_t i = 0;
                    while (!tgt_decode(&bio, &prc->imsb, k, (int32_t)i)) ++i;
                    cb->numbps = (uint32_t)band->numbps + 1 - i;
                    cb->numlenbits = 3;
                }
                cb->numnewpasses = getnumpasses(&bio);
                uint32_t inc = 0;
                while (bio_read(&bio, 1)) ++inc;
                cb->numlenbits += inc;
                uint32_t segno = 0;
                if (!cb->numsegs) {
                    if (init_seg(cb, 0, tccp->cblksty, 1)) return fail(j, "out of memory");
                } else {
                    segno = cb->numsegs - 1;
                    if (cb->segs[segno].numpasses == cb->segs[segno].maxpasses) {
                        ++segno;
                        if (init_seg(cb, segno, tccp->cblksty, 0)) return fail(j, "out of memory");
                    }
                }
                int32_t n = (int32_t)cb->numnewpasses;
                if (tccp->cblksty & 0x40) return fail(j, "high-throughput (HTJ2K) code-blocks are not read");
                do {
                    seg_t *seg = &cb->segs[segno];
                    seg->numnewpasses = (uint32_t)imin((int32_t)(seg->maxpasses - seg->numpasses), n);
                    uint32_t bits = cb->numlenbits + floorlog2(seg->numnewpasses);
                    if (bits > 32) return fail(j, "Invalid bit number in opj_t2_read_packet_header()");
                    seg->newlen = bio_read(&bio, bits);
                    n -= (int32_t)seg->numnewpasses;
                    if (n > 0) {
                        ++segno;
                        if (init_seg(cb, segno, tccp->cblksty, 0)) return fail(j, "out of memory");
                    }
                } while (n > 0);
            }
        }
    }
    bio_inalign(&bio);
    hdata += bio.bp - bio.start;
    if (tcp->csty & 4) {  /* EPH: required after every packet header */
        int room = *hlen - (uint32_t)(hdata - *hstart) >= 2;
        if (room && hdata[0] == 0xff && hdata[1] == 0x92) hdata += 2;
        else return fail(j, room ? "Expected EPH marker" : "Not enough space for expected EPH marker");
    }
    uint32_t hl = (uint32_t)(hdata - *hstart);
    *hlen -= hl;
    *hstart += hl;
    if (!present) { *read = (uint32_t)(cur - src); return 0; }
    uint32_t hdr_read = (uint32_t)(cur - src);
    src = cur;
    max_len -= hdr_read;
    /* the packet's data */
    const uint8_t *d = src;
    uint32_t dread = 0;
    for (uint32_t b = 0; b < res->numbands; b++) {
        band_t *band = &res->bands[b];
        if (band_empty(band)) continue;
        prc_t *prc = &band->prcs[pi->precno];
        for (uint32_t k = 0; k < prc->cw * prc->ch; k++) {
            cblk_t *cb = &prc->cblks[k];
            if (!cb->numnewpasses) continue;
            seg_t *seg;
            if (!cb->numsegs) { seg = cb->segs; ++cb->numsegs; }
            else {
                seg = &cb->segs[cb->numsegs - 1];
                if (seg->numpasses == seg->maxpasses) { ++seg; ++cb->numsegs; }
            }
            do {
                if (skip) {
                    if ((uint64_t)dread + seg->newlen > max_len) return fail(j, "skip: segment too long");
                    dread += seg->newlen;
                } else {
                    if ((uint64_t)(d - src) + seg->newlen > max_len) return fail(j, "read: segment too long");
                    if (add_chunk(cb, d, seg->newlen)) return fail(j, "out of memory");
                    d += seg->newlen;
                    seg->len += seg->newlen;
                }
                seg->numpasses += seg->numnewpasses;
                cb->numnewpasses -= seg->numnewpasses;
                seg->real_num_passes = seg->numpasses;
                if (cb->numnewpasses > 0) { ++seg; ++cb->numsegs; }
            } while (cb->numnewpasses > 0);
            cb->real_num_segs = cb->numsegs;
        }
    }
    *read = hdr_read + (skip ? dread : (uint32_t)(d - src));
    return 0;
}

static int t2_decode(j2k_t *j, tcp_t *tcp, tile_t *tile) {
    uint32_t nc = j->numcomps;
    pi_comp_t *comps = calloc(nc, sizeof(pi_comp_t));
    if (!comps) return fail(j, "out of memory");
    uint32_t max_res = 0, max_prec = 0;
    for (uint32_t c = 0; c < nc; c++) {
        tccp_t *tccp = &tcp->tccps[c];
        pi_comp_t *pc = &comps[c];
        pc->dx = j->comps[c].dx; pc->dy = j->comps[c].dy; pc->numresolutions = tccp->numresolutions;
        if (tccp->numresolutions > max_res) max_res = tccp->numresolutions;
        int32_t tcx0 = int_ceildiv(tile->x0, (int32_t)pc->dx), tcy0 = int_ceildiv(tile->y0, (int32_t)pc->dy);
        int32_t tcx1 = int_ceildiv(tile->x1, (int32_t)pc->dx), tcy1 = int_ceildiv(tile->y1, (int32_t)pc->dy);
        uint32_t level = tccp->numresolutions;
        for (uint32_t r = 0; r < tccp->numresolutions; r++) {
            --level;
            pi_res_t *pr = &pc->res[r];
            pr->pdx = tccp->prcw[r]; pr->pdy = tccp->prch[r];
            int32_t rx0 = int_ceildivpow2(tcx0, (int32_t)level), ry0 = int_ceildivpow2(tcy0, (int32_t)level);
            int32_t rx1 = int_ceildivpow2(tcx1, (int32_t)level), ry1 = int_ceildivpow2(tcy1, (int32_t)level);
            int32_t px0 = int_floordivpow2(rx0, (int32_t)pr->pdx) << pr->pdx;
            int32_t py0 = int_floordivpow2(ry0, (int32_t)pr->pdy) << pr->pdy;
            int32_t px1 = int_ceildivpow2(rx1, (int32_t)pr->pdx) << pr->pdx;
            int32_t py1 = int_ceildivpow2(ry1, (int32_t)pr->pdy) << pr->pdy;
            pr->pw = rx0 == rx1 ? 0 : (uint32_t)((px1 - px0) >> pr->pdx);
            pr->ph = ry0 == ry1 ? 0 : (uint32_t)((py1 - py0) >> pr->pdy);
            if (pr->pw * pr->ph > max_prec) max_prec = pr->pw * pr->ph;
        }
    }
    pi_t base;
    memset(&base, 0, sizeof base);
    base.numcomps = nc;
    base.comps = comps;
    base.tx0 = (uint32_t)tile->x0; base.ty0 = (uint32_t)tile->y0; base.tx1 = (uint32_t)tile->x1; base.ty1 = (uint32_t)tile->y1;
    base.step_c = max_prec;
    base.step_r = (uint64_t)nc * base.step_c;
    base.step_l = (uint64_t)max_res * base.step_r;
    base.include_size = (uint64_t)(tcp->numlayers + 1) * base.step_l;
    if (base.include_size > ((uint64_t)1 << 31)) { free(comps); return fail(j, "Invalid access to pi->include"); }
    base.include = calloc(base.include_size ? base.include_size : 1, 1);
    if (!base.include) { free(comps); return fail(j, "out of memory"); }
    uint8_t *first_failed = malloc(nc);
    if (!first_failed) { free(comps); free(base.include); return fail(j, "out of memory"); }
    memset(first_failed, 1, nc);
    const uint8_t *cur = tcp->data;
    uint32_t max_len = (uint32_t)tcp->data_size;
    int rc = 0;
    for (uint32_t pino = 0; pino <= tcp->numpocs && rc == 0; pino++) {
        pi_t pi = base;
        pi.first = 1;
        pi.layno0 = 0;
        pi.precno0 = 0;
        if (tcp->POC) {
            poc_t *p = &tcp->pocs[pino];
            pi.poc = *p;
            pi.poc.layno1 = umin(p->layno1, tcp->numlayers);
        } else {
            pi.poc.prg = tcp->prg;
            pi.poc.resno0 = 0; pi.poc.compno0 = 0;
            pi.poc.resno1 = max_res; pi.poc.compno1 = nc;
            pi.poc.layno1 = tcp->numlayers;
        }
        if (pi.poc.prg == 0xffffffffu) { rc = fail(j, "opj_t2_decode_packets(): Invalid progression order"); break; }
        for (;;) {
            int nx = pi_next(&pi);
            if (nx <= 0) break;
            tilec_t *tc = &tile->comps[pi.compno];
            int skip = !(tc->x0 < tc->x1 && tc->y0 < tc->y1);
            uint32_t nread = 0;
            if (!skip) first_failed[pi.compno] = 0;
            if (t2_packet(j, tcp, tile, &pi, cur, max_len, &nread, skip)) { rc = -1; break; }
            comp_t *ic = &j->comps[pi.compno];
            if (!skip && pi.resno > ic->resno_decoded) ic->resno_decoded = pi.resno;
            if (first_failed[pi.compno] && ic->resno_decoded == 0) ic->resno_decoded = tc->numresolutions - 1;
            cur += nread;
            max_len -= nread;
        }
    }
    free(comps); free(base.include); free(first_failed);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Tier 1                                                              */

typedef struct { uint32_t qeval; uint32_t mps; int nmps, nlps; } mqc_state_t;

static mqc_state_t MQ_STATES[47 * 2];

static void mq_table_init(void) {
    static const uint32_t qe[47] = {0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
                                    0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
                                    0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
                                    0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
                                    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
    static const int nmps[47] = {1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
                                 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45,
                                 46};
    static const int nlps[47] = {1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20,
                                 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
                                 43, 46};
    static const int sw[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                               0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int s = 0; s < 47; s++) {
        for (int m = 0; m < 2; m++) {
            mqc_state_t *st = &MQ_STATES[2 * s + m];
            st->qeval = qe[s];
            st->mps = (uint32_t)m;
            st->nmps = 2 * nmps[s] + m;
            st->nlps = 2 * nlps[s] + (sw[s] ? 1 - m : m);
        }
    }
}

typedef struct {
    uint32_t c, a, ct;
    uint32_t end_of_byte_stream_counter;
    uint8_t *bp, *start, *end;
    uint8_t backup[CBLK_EXTRA];
    int ctxs[19];
    int cur;
} mqc_t;

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18 };

static void mqc_resetstates(mqc_t *m) {
    for (int i = 0; i < 19; i++) m->ctxs[i] = 0;
    m->ctxs[CTX_UNI] = 2 * 46;
    m->ctxs[CTX_AGG] = 2 * 3;
    m->ctxs[CTX_ZC] = 2 * 4;
}

static void mqc_init_common(mqc_t *m, uint8_t *bp, uint32_t len) {
    m->start = bp;
    m->end = bp + len;
    memcpy(m->backup, m->end, CBLK_EXTRA);
    m->end[0] = 0xff;
    m->end[1] = 0xff;
    m->bp = bp;
}

static void mqc_finish(mqc_t *m) { memcpy(m->end, m->backup, CBLK_EXTRA); }

static inline void mqc_bytein(mqc_t *m) {
    if (*m->bp == 0xff) {
        if (*(m->bp + 1) > 0x8f) {
            m->c += 0xff00;
            m->ct = 8;
            m->end_of_byte_stream_counter++;
        } else {
            m->bp++;
            m->c += (uint32_t)(*m->bp << 9);
            m->ct = 7;
        }
    } else {
        m->bp++;
        m->c += (uint32_t)(*m->bp << 8);
        m->ct = 8;
    }
}

static void mqc_init_dec(mqc_t *m, uint8_t *bp, uint32_t len) {
    mqc_init_common(m, bp, len);
    m->cur = 0;
    m->end_of_byte_stream_counter = 0;
    m->c = len == 0 ? 0xffu << 16 : (uint32_t)(*m->bp << 16);
    mqc_bytein(m);
    m->c <<= 7;
    m->ct -= 7;
    m->a = 0x8000;
}

static void mqc_raw_init_dec(mqc_t *m, uint8_t *bp, uint32_t len) {
    mqc_init_common(m, bp, len);
    m->c = 0;
    m->ct = 0;
}

static inline void mqc_renorm(mqc_t *m) {
    do {
        if (m->ct == 0) mqc_bytein(m);
        m->a <<= 1;
        m->c <<= 1;
        m->ct--;
    } while (m->a < 0x8000);
}

static inline uint32_t mqc_decode(mqc_t *m) {
    int *ctx = &m->ctxs[m->cur];
    const mqc_state_t *st = &MQ_STATES[*ctx];
    uint32_t d;
    m->a -= st->qeval;
    if ((m->c >> 16) < st->qeval) {
        if (m->a < st->qeval) { m->a = st->qeval; d = st->mps; *ctx = st->nmps; }
        else { m->a = st->qeval; d = !st->mps; *ctx = st->nlps; }
        mqc_renorm(m);
    } else {
        m->c -= st->qeval << 16;
        if ((m->a & 0x8000) == 0) {
            if (m->a < st->qeval) { d = !st->mps; *ctx = st->nlps; }
            else { d = st->mps; *ctx = st->nmps; }
            mqc_renorm(m);
        } else {
            d = st->mps;
        }
    }
    return d;
}

static inline uint32_t mqc_raw_decode(mqc_t *m) {
    if (m->ct == 0) {
        if (m->c == 0xff) {
            if (*m->bp > 0x8f) { m->c = 0xff; m->ct = 8; }
            else { m->c = *m->bp; m->bp++; m->ct = 7; }
        } else {
            m->c = *m->bp;
            m->bp++;
            m->ct = 8;
        }
    }
    m->ct--;
    return (m->c >> m->ct) & 1u;
}

/* OpenJPEG's flag word: 3 columns x 6 rows of significance around a
   column of four, the signs, and the visited / refined bits. */
#define SIGMA_0 (1u << 0)
#define SIGMA_1 (1u << 1)
#define SIGMA_2 (1u << 2)
#define SIGMA_3 (1u << 3)
#define SIGMA_4 (1u << 4)
#define SIGMA_5 (1u << 5)
#define SIGMA_6 (1u << 6)
#define SIGMA_7 (1u << 7)
#define SIGMA_8 (1u << 8)
#define SIGMA_15 (1u << 15)
#define SIGMA_16 (1u << 16)
#define SIGMA_17 (1u << 17)
#define CHI_0_I 18
#define CHI_1_I 19
#define CHI_2_I 22
#define CHI_5_I 31
#define MU_0 (1u << 20)
#define PI_0 (1u << 21)
#define PI_1 (1u << 24)
#define PI_2 (1u << 27)
#define PI_3 (1u << 30)
#define SIGMA_THIS SIGMA_4
#define SIGMA_NEIGHBOURS (SIGMA_0 | SIGMA_1 | SIGMA_2 | SIGMA_3 | SIGMA_5 | SIGMA_6 | SIGMA_7 | SIGMA_8)
#define PI_THIS PI_0
#define MU_THIS MU_0

static uint8_t LUT_ZC[4][512];
static uint8_t LUT_SC[256];
static uint8_t LUT_SPB[256];

static void luts_init(void) {
    for (uint32_t band = 0; band < 4; band++) {
        /* the table of band number b is t1_init_ctxno_zc's for orientation
           b with 1 and 2 exchanged (t1_generate_luts.c) */
        uint32_t orient = band == 1 ? 2 : band == 2 ? 1 : band;
        for (uint32_t f = 0; f < 512; f++) {
            int h = ((f & SIGMA_3) != 0) + ((f & SIGMA_5) != 0);
            int v = ((f & SIGMA_1) != 0) + ((f & SIGMA_7) != 0);
            int d = ((f & SIGMA_0) != 0) + ((f & SIGMA_2) != 0) + ((f & SIGMA_8) != 0) + ((f & SIGMA_6) != 0);
            int n = 0, t, hv;
            switch (orient) {
            case 2:
                t = h; h = v; v = t;
                /* fall through */
            case 0:
            case 1:
                if (!h) {
                    if (!v) n = !d ? 0 : d == 1 ? 1 : 2;
                    else n = v == 1 ? 3 : 4;
                } else if (h == 1) {
                    n = !v ? (!d ? 5 : 6) : 7;
                } else n = 8;
                break;
            case 3:
                hv = h + v;
                if (!d) n = !hv ? 0 : hv == 1 ? 1 : 2;
                else if (d == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
                else if (d == 2) n = !hv ? 6 : 7;
                else n = 8;
                break;
            }
            LUT_ZC[band][f] = (uint8_t)(CTX_ZC + n);
        }
    }
    /* sign context index bits: 0 SGN_W, 1 SIG_N, 2 SGN_E, 3 SIG_W, 4 SGN_N, 5 SIG_E, 6 SGN_S, 7 SIG_S */
    for (uint32_t f = 0; f < 256; f++) {
        int pe = (f & 0x24) == 0x20, ne = (f & 0x24) == 0x24, pw = (f & 0x09) == 0x08, nw = (f & 0x09) == 0x09;
        int pn = (f & 0x12) == 0x02, nn = (f & 0x12) == 0x12, ps = (f & 0xc0) == 0x80, ns = (f & 0xc0) == 0xc0;
        int hc = imin(pe + pw, 1) - imin(ne + nw, 1);
        int vc = imin(pn + ps, 1) - imin(nn + ns, 1);
        int spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
        if (hc < 0) { hc = -hc; vc = -vc; }
        int n = 0;
        if (!hc) n = vc == -1 ? 1 : !vc ? 0 : 1;
        else if (hc == 1) n = vc == -1 ? 2 : !vc ? 3 : 4;
        LUT_SC[f] = (uint8_t)(CTX_SC + n);
        LUT_SPB[f] = (uint8_t)spb;
    }
}

static inline uint32_t sc_index(uint32_t fX, uint32_t pfX, uint32_t nfX, uint32_t ci) {
    uint32_t lu = (fX >> (ci * 3u)) & (SIGMA_1 | SIGMA_3 | SIGMA_5 | SIGMA_7);
    lu |= (pfX >> (CHI_1_I + ci * 3u)) & 1u;
    lu |= (nfX >> (CHI_1_I - 2u + ci * 3u)) & (1u << 2);
    if (ci == 0) lu |= (fX >> (CHI_0_I - 4u)) & (1u << 4);
    else lu |= (fX >> (CHI_1_I - 4u + (ci - 1u) * 3u)) & (1u << 4);
    lu |= (fX >> (CHI_2_I - 6u + ci * 3u)) & (1u << 6);
    return lu;
}

static inline uint32_t ctx_mag(uint32_t f) {
    uint32_t t = (f & SIGMA_NEIGHBOURS) ? CTX_MAG + 1 : CTX_MAG;
    return (f & MU_0) ? CTX_MAG + 2 : t;
}

typedef struct {
    mqc_t mqc;
    int32_t *data;
    uint32_t *flags;
    uint32_t w, h, stride;
    const uint8_t *zc;
} t1_t;

static inline void update_flags(uint32_t *fp, uint32_t ci, uint32_t s, uint32_t stride, int vsc) {
    fp[-1] |= SIGMA_5 << (3u * ci);
    *fp |= ((s << CHI_1_I) | SIGMA_4) << (3u * ci);
    fp[1] |= SIGMA_3 << (3u * ci);
    if (ci == 0 && !vsc) {
        uint32_t *north = fp - stride;
        *north |= (s << CHI_5_I) | SIGMA_16;
        north[-1] |= SIGMA_17;
        north[1] |= SIGMA_15;
    }
    if (ci == 3) {
        uint32_t *south = fp + stride;
        *south |= (s << CHI_0_I) | SIGMA_1;
        south[-1] |= SIGMA_2;
        south[1] |= SIGMA_0;
    }
}

static inline void sig_step(t1_t *t, uint32_t *fp, int32_t *dp, int32_t oph, uint32_t ci, int vsc, int raw) {
    uint32_t f = *fp;
    if ((f & ((SIGMA_THIS | PI_THIS) << (ci * 3u))) == 0 && (f & (SIGMA_NEIGHBOURS << (ci * 3u))) != 0) {
        mqc_t *m = &t->mqc;
        if (raw) {
            if (mqc_raw_decode(m)) {
                uint32_t v = mqc_raw_decode(m);
                *dp = v ? -oph : oph;
                update_flags(fp, ci, v, t->stride, vsc);
            }
        } else {
            m->cur = t->zc[(f >> (ci * 3u)) & 0x1ff];
            if (mqc_decode(m)) {
                uint32_t lu = sc_index(*fp, fp[-1], fp[1], ci);
                m->cur = LUT_SC[lu];
                uint32_t v = mqc_decode(m) ^ LUT_SPB[lu];
                *dp = v ? -oph : oph;
                update_flags(fp, ci, v, t->stride, vsc);
            }
        }
        *fp |= PI_THIS << (ci * 3u);
    }
}

static void sigpass(t1_t *t, int32_t bpno, int vsc, int raw) {
    int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    uint32_t w = t->w, h = t->h, k, i, jj;
    int32_t *data = t->data;
    uint32_t *fp = &t->flags[t->stride + 1];
    for (k = 0; k < (h & ~3u); k += 4, data += 3 * w, fp += 2) {
        for (i = 0; i < w; ++i, ++data, ++fp) {
            if (*fp == 0) continue;
            sig_step(t, fp, data, oph, 0, vsc, raw);
            sig_step(t, fp, data + w, oph, 1, 0, raw);
            sig_step(t, fp, data + 2 * w, oph, 2, 0, raw);
            sig_step(t, fp, data + 3 * w, oph, 3, 0, raw);
        }
    }
    if (k < h) {
        for (i = 0; i < w; ++i, ++fp, ++data)
            for (jj = 0; jj < h - k; ++jj) sig_step(t, fp, data + jj * w, oph, jj, vsc, raw);
    }
}

static inline void ref_step(t1_t *t, uint32_t *fp, int32_t *dp, int32_t poshalf, uint32_t ci, int raw) {
    uint32_t f = *fp;
    if ((f & ((SIGMA_THIS | PI_THIS) << (ci * 3u))) == (SIGMA_THIS << (ci * 3u))) {
        uint32_t v;
        if (raw) v = mqc_raw_decode(&t->mqc);
        else {
            t->mqc.cur = (int)ctx_mag(f >> (ci * 3u));
            v = mqc_decode(&t->mqc);
        }
        *dp += (v ^ (*dp < 0)) ? poshalf : -poshalf;
        *fp |= MU_THIS << (ci * 3u);
    }
}

static void refpass(t1_t *t, int32_t bpno, int raw) {
    int32_t one = 1 << bpno, poshalf = one >> 1;
    uint32_t w = t->w, h = t->h, k, i, jj;
    int32_t *data = t->data;
    uint32_t *fp = &t->flags[t->stride + 1];
    for (k = 0; k < (h & ~3u); k += 4, data += 3 * w, fp += 2) {
        for (i = 0; i < w; ++i, ++data, ++fp) {
            if (*fp == 0) continue;
            ref_step(t, fp, data, poshalf, 0, raw);
            ref_step(t, fp, data + w, poshalf, 1, raw);
            ref_step(t, fp, data + 2 * w, poshalf, 2, raw);
            ref_step(t, fp, data + 3 * w, poshalf, 3, raw);
        }
    }
    if (k < h) {
        for (i = 0; i < w; ++i, ++fp, ++data)
            for (jj = 0; jj < h - k; ++jj) ref_step(t, fp, data + jj * w, poshalf, jj, raw);
    }
}

/* One sample of the cleanup pass (partial: its significance is known, only
   its sign is decoded). */
static inline void cln_step(t1_t *t, uint32_t *fp, int32_t *dp, int32_t oph, uint32_t ci, int vsc, int check,
                            int partial) {
    uint32_t f = *fp;
    if (check && (f & ((SIGMA_THIS | PI_THIS) << (ci * 3u)))) return;
    mqc_t *m = &t->mqc;
    if (!partial) {
        m->cur = t->zc[(f >> (ci * 3u)) & 0x1ff];
        if (!mqc_decode(m)) return;
    }
    uint32_t lu = sc_index(*fp, fp[-1], fp[1], ci);
    m->cur = LUT_SC[lu];
    uint32_t v = mqc_decode(m) ^ LUT_SPB[lu];
    *dp = v ? -oph : oph;
    update_flags(fp, ci, v, t->stride, vsc);
}

static void clnpass(t1_t *t, int32_t bpno, int vsc, int segsym) {
    int32_t one = 1 << bpno, half = one >> 1, oph = one | half;
    uint32_t w = t->w, h = t->h, k, i, jj;
    int32_t *data = t->data;
    uint32_t *fp = &t->flags[t->stride + 1];
    mqc_t *m = &t->mqc;
    for (k = 0; k < (h & ~3u); k += 4, data += 3 * w, fp += 2) {
        for (i = 0; i < w; ++i, ++data, ++fp) {
            if (*fp == 0) {
                m->cur = CTX_AGG;
                if (!mqc_decode(m)) continue;
                m->cur = CTX_UNI;
                uint32_t runlen = mqc_decode(m);
                runlen = (runlen << 1) | mqc_decode(m);
                int partial = 1;
                switch (runlen) {
                case 0:
                    cln_step(t, fp, data, oph, 0, vsc, 0, 1);
                    partial = 0;
                    /* fall through */
                case 1:
                    cln_step(t, fp, data + w, oph, 1, 0, 0, partial);
                    partial = 0;
                    /* fall through */
                case 2:
                    cln_step(t, fp, data + 2 * w, oph, 2, 0, 0, partial);
                    partial = 0;
                    /* fall through */
                case 3:
                    cln_step(t, fp, data + 3 * w, oph, 3, 0, 0, partial);
                    break;
                }
            } else {
                cln_step(t, fp, data, oph, 0, vsc, 1, 0);
                cln_step(t, fp, data + w, oph, 1, 0, 1, 0);
                cln_step(t, fp, data + 2 * w, oph, 2, 0, 1, 0);
                cln_step(t, fp, data + 3 * w, oph, 3, 0, 1, 0);
            }
            *fp &= ~(PI_0 | PI_1 | PI_2 | PI_3);
        }
    }
    if (k < h) {
        for (i = 0; i < w; ++i, ++fp, ++data) {
            for (jj = 0; jj < h - k; ++jj) cln_step(t, fp, data + jj * w, oph, jj, vsc, 1, 0);
            *fp &= ~(PI_0 | PI_1 | PI_2 | PI_3);
        }
    }
    if (segsym) {
        m->cur = CTX_UNI;
        for (int s = 0; s < 4; s++) mqc_decode(m);
    }
}

static int t1_alloc(t1_t *t, uint32_t w, uint32_t h) {
    t->w = w; t->h = h; t->stride = w + 2;
    uint32_t fh = (h + 3) / 4;
    size_t fsize = (size_t)t->stride * (fh + 2);
    t->data = calloc((size_t)w * h > 0 ? (size_t)w * h : 1, sizeof(int32_t));
    t->flags = calloc(fsize, sizeof(uint32_t));
    if (!t->data || !t->flags) return -1;
    for (uint32_t x = 0; x < t->stride; x++) t->flags[x] = PI_0 | PI_1 | PI_2 | PI_3;
    for (uint32_t x = 0; x < t->stride; x++) t->flags[(fh + 1) * t->stride + x] = PI_0 | PI_1 | PI_2 | PI_3;
    if (h % 4) {
        uint32_t v = h % 4 == 1 ? (PI_1 | PI_2 | PI_3) : h % 4 == 2 ? (PI_2 | PI_3) : PI_3;
        for (uint32_t x = 0; x < t->stride; x++) t->flags[fh * t->stride + x] = v;
    }
    return 0;
}

/* opj_t1_decode_cblk: 0, or -1 with the error. */
static int decode_cblk(j2k_t *j, cblk_t *cb, uint32_t orient, uint32_t roishift, uint32_t cblksty, t1_t *t) {
    uint32_t w = (uint32_t)(cb->x1 - cb->x0), h = (uint32_t)(cb->y1 - cb->y0);
    if (t1_alloc(t, w, h)) return fail(j, "out of memory");
    t->zc = LUT_ZC[orient];
    mqc_t *m = &t->mqc;
    mqc_resetstates(m);
    int32_t bpno_plus_one = (int32_t)(roishift + cb->numbps);
    if (bpno_plus_one >= 31) return fail(j, "opj_t1_decode_cblk(): unsupported bpno_plus_one >= 31");
    uint32_t passtype = 2;
    size_t total = 0;
    for (uint32_t i = 0; i < cb->numchunks; i++) total += cb->chunks[i].len;
    uint8_t *buf = malloc(total + CBLK_EXTRA);
    if (!buf) return fail(j, "out of memory");
    size_t at = 0;
    for (uint32_t i = 0; i < cb->numchunks; i++) { memcpy(buf + at, cb->chunks[i].data, cb->chunks[i].len); at += cb->chunks[i].len; }
    memset(buf + total, 0, CBLK_EXTRA);
    size_t idx = 0;
    int vsc = (cblksty & 8) != 0;
    for (uint32_t segno = 0; segno < cb->real_num_segs; ++segno) {
        seg_t *seg = &cb->segs[segno];
        int raw = (bpno_plus_one <= (int32_t)cb->numbps - 4) && passtype < 2 && (cblksty & 1);
        if (raw) mqc_raw_init_dec(m, buf + idx, seg->len);
        else mqc_init_dec(m, buf + idx, seg->len);
        idx += seg->len;
        for (uint32_t passno = 0; passno < seg->real_num_passes && bpno_plus_one >= 1; ++passno) {
            switch (passtype) {
            case 0: sigpass(t, bpno_plus_one, vsc, raw); break;
            case 1: refpass(t, bpno_plus_one, raw); break;
            case 2: clnpass(t, bpno_plus_one, vsc, (cblksty & 0x20) != 0); break;
            }
            if ((cblksty & 2) && !raw) mqc_resetstates(m);
            if (++passtype == 3) { passtype = 0; bpno_plus_one--; }
        }
        mqc_finish(m);
    }
    free(buf);
    return 0;
}

static int t1_decode(j2k_t *j, tcp_t *tcp, tile_t *tile) {
    t1_t t;
    memset(&t, 0, sizeof t);
    for (uint32_t c = 0; c < j->numcomps; c++) {
        tilec_t *tc = &tile->comps[c];
        tccp_t *tccp = &tcp->tccps[c];
        res_t *full = &tc->res[tc->numresolutions - 1];
        uint32_t tile_w = (uint32_t)(full->x1 - full->x0);
        for (uint32_t r = 0; r < tc->numresolutions; r++) {
            res_t *res = &tc->res[r];
            for (uint32_t b = 0; b < res->numbands; b++) {
                band_t *band = &res->bands[b];
                if (!band->prcs) continue;
                for (uint32_t p = 0; p < res->pw * res->ph; p++) {
                    prc_t *prc = &band->prcs[p];
                    for (uint32_t k = 0; k < prc->cw * prc->ch; k++) {
                        cblk_t *cb = &prc->cblks[k];
                        int32_t x = cb->x0 - band->x0, y = cb->y0 - band->y0;
                        if (band->bandno & 1) x += tc->res[r - 1].x1 - tc->res[r - 1].x0;
                        if (band->bandno & 2) y += tc->res[r - 1].y1 - tc->res[r - 1].y0;
                        if (decode_cblk(j, cb, band->bandno, tccp->roishift, tccp->cblksty, &t)) {
                            free(t.data); free(t.flags);
                            return -1;
                        }
                        uint32_t cw = (uint32_t)(cb->x1 - cb->x0), ch = (uint32_t)(cb->y1 - cb->y0);
                        int32_t *dp = t.data;
                        if (tccp->roishift) {
                            if (tccp->roishift >= 31) {
                                memset(dp, 0, (size_t)cw * ch * sizeof(int32_t));
                            } else {
                                int32_t thresh = 1 << tccp->roishift;
                                for (size_t i = 0; i < (size_t)cw * ch; i++) {
                                    int32_t val = dp[i];
                                    int32_t mag = val < 0 ? -val : val;
                                    if (mag >= thresh) {
                                        mag >>= tccp->roishift;
                                        dp[i] = val < 0 ? -mag : mag;
                                    }
                                }
                            }
                        }
                        int32_t *tiled = tc->data + (size_t)y * tile_w + (size_t)x;
                        if (tccp->qmfbid == 1) {
                            for (uint32_t yy = 0; yy < ch; yy++)
                                for (uint32_t xx = 0; xx < cw; xx++) tiled[(size_t)yy * tile_w + xx] = dp[yy * cw + xx] / 2;
                        } else {
                            const float step = 0.5f * band->stepsize;
                            for (uint32_t yy = 0; yy < ch; yy++)
                                for (uint32_t xx = 0; xx < cw; xx++) {
                                    float v = (float)dp[yy * cw + xx] * step;
                                    memcpy(&tiled[(size_t)yy * tile_w + xx], &v, sizeof v);
                                }
                        }
                        free(t.data); free(t.flags);
                        t.data = NULL; t.flags = NULL;
                    }
                }
            }
        }
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Inverse wavelets                                                    */

static inline int32_t wadd(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
static inline int32_t wsub(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }

/* One 5/3 line in place: x[0..sn) low, x[sn..sn+dn) high, interleaved out. */
static void idwt53_line(int32_t *x, size_t stride, int32_t sn, int32_t dn, int cas, int32_t *tmp) {
    int32_t len = sn + dn;
    if (cas == 0) {
        if (len <= 1) return;
    } else {
        if (len == 1) { x[0] /= 2; return; }
    }
    int32_t *s = tmp, *d = tmp + len;  /* the low and high inputs */
    for (int32_t i = 0; i < sn; i++) s[i] = x[(size_t)i * stride];
    for (int32_t i = 0; i < dn; i++) d[i] = x[(size_t)(sn + i) * stride];
    if (cas == 0) {
        /* even outputs: s[i] - ((d[i-1] + d[i] + 2) >> 2), d[-1] = d[0], d[dn] = d[dn-1] */
        for (int32_t i = 0; i < sn; i++) {
            int32_t dl = d[i - 1 >= 0 ? i - 1 : 0], dr = d[i < dn ? i : dn - 1];
            s[i] = wsub(s[i], wadd(wadd(dl, dr), 2) >> 2);
        }
        for (int32_t i = 0; i < dn; i++) {
            int32_t sl = s[i], sr = s[i + 1 < sn ? i + 1 : sn - 1];
            d[i] = wadd(d[i], wadd(sl, sr) >> 1);
        }
        for (int32_t i = 0; i < sn; i++) x[(size_t)(2 * i) * stride] = s[i];
        for (int32_t i = 0; i < dn; i++) x[(size_t)(2 * i + 1) * stride] = d[i];
    } else {
        /* odd outputs are low: s[i] - ((d[i] + d[i+1] + 2) >> 2), even are high */
        for (int32_t i = 0; i < sn; i++) {
            int32_t dl = d[i < dn ? i : dn - 1], dr = d[i + 1 < dn ? i + 1 : dn - 1];
            s[i] = wsub(s[i], wadd(wadd(dl, dr), 2) >> 2);
        }
        for (int32_t i = 0; i < dn; i++) {
            int32_t sl = s[i - 1 >= 0 ? i - 1 : 0], sr = s[i < sn ? i : sn - 1];
            d[i] = wadd(d[i], wadd(sl, sr) >> 1);
        }
        for (int32_t i = 0; i < sn; i++) x[(size_t)(2 * i + 1) * stride] = s[i];
        for (int32_t i = 0; i < dn; i++) x[(size_t)(2 * i) * stride] = d[i];
    }
}

static const float K = 1.230174104914001f;
static const float TWO_INVK = 1.625732422f;
static const float DWT_ALPHA = -1.586134342f;
static const float DWT_BETA = -0.052980118f;
static const float DWT_GAMMA = 0.882911075f;
static const float DWT_DELTA = 0.443506852f;

static void v8_step1(float *w, uint32_t end, float c) {
    for (uint32_t i = 0; i < end; i++) w[2 * i] = w[2 * i] * c;
}

/* opj_v8dwt_decode_step2 on one lane: w[-1] += (l + w[0]) * c along the line. */
static void v8_step2(float *l, float *w, uint32_t end, uint32_t m, float c) {
    uint32_t imax = umin(end, m);
    float *fl = l, *fw = w;
    for (uint32_t i = 0; i < imax; i++) {
        fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
        fl = fw;
        fw += 2;
    }
    if (m < end) {
        c += c;
        fw[-1] = fw[-1] + fl[0] * c;
    }
}

static void idwt97_line(float *x, size_t stride, int32_t sn, int32_t dn, int cas, float *w) {
    int32_t a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0; b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1; b = 0;
    }
    int32_t len = sn + dn;
    for (int32_t i = 0; i < sn; i++) w[cas + 2 * i] = x[(size_t)i * stride];
    for (int32_t i = 0; i < dn; i++) w[1 - cas + 2 * i] = x[(size_t)(sn + i) * stride];
    v8_step1(w + a, (uint32_t)sn, K);
    v8_step1(w + b, (uint32_t)dn, TWO_INVK);
    v8_step2(w + b, w + a + 1, (uint32_t)sn, (uint32_t)imin(sn, dn - a), -DWT_DELTA);
    v8_step2(w + a, w + b + 1, (uint32_t)dn, (uint32_t)imin(dn, sn - b), -DWT_GAMMA);
    v8_step2(w + b, w + a + 1, (uint32_t)sn, (uint32_t)imin(sn, dn - a), -DWT_BETA);
    v8_step2(w + a, w + b + 1, (uint32_t)dn, (uint32_t)imin(dn, sn - b), -DWT_ALPHA);
    for (int32_t i = 0; i < len; i++) x[(size_t)i * stride] = w[i];
}

static int dwt_decode(j2k_t *j, tcp_t *tcp, tile_t *tile) {
    for (uint32_t c = 0; c < j->numcomps; c++) {
        tilec_t *tc = &tile->comps[c];
        uint32_t numres = j->comps[c].resno_decoded + 1;
        res_t *tr = tc->res;
        uint32_t rw = (uint32_t)(tr->x1 - tr->x0), rh = (uint32_t)(tr->y1 - tr->y0);
        res_t *full = &tc->res[tc->numresolutions - 1];
        size_t w = (size_t)(full->x1 - full->x0);
        if (numres == 1 || w == 0) continue;
        size_t maxlen = 0;
        for (uint32_t r = 0; r < numres; r++) {
            maxlen = umax((uint32_t)maxlen, (uint32_t)(tc->res[r].x1 - tc->res[r].x0));
            maxlen = umax((uint32_t)maxlen, (uint32_t)(tc->res[r].y1 - tc->res[r].y0));
        }
        void *tmp = malloc((2 * maxlen + 8) * sizeof(int32_t));
        if (!tmp) return fail(j, "out of memory");
        int rev = tcp->tccps[c].qmfbid == 1;
        while (--numres) {
            ++tr;
            int32_t hsn = (int32_t)rw, vsn = (int32_t)rh;
            rw = (uint32_t)(tr->x1 - tr->x0);
            rh = (uint32_t)(tr->y1 - tr->y0);
            int32_t hdn = (int32_t)rw - hsn, vdn = (int32_t)rh - vsn;
            int hcas = tr->x0 % 2, vcas = tr->y0 % 2;
            for (uint32_t y = 0; y < rh; y++) {
                if (rev) idwt53_line(tc->data + y * w, 1, hsn, hdn, hcas, tmp);
                else idwt97_line((float *)tc->data + y * w, 1, hsn, hdn, hcas, tmp);
            }
            for (uint32_t x = 0; x < rw; x++) {
                if (rev) idwt53_line(tc->data + x, w, vsn, vdn, vcas, tmp);
                else idwt97_line((float *)tc->data + x, w, vsn, vdn, vcas, tmp);
            }
        }
        free(tmp);
    }
    return 0;
}

static int mct_decode(j2k_t *j, tcp_t *tcp, tile_t *tile) {
    if (tcp->mct == 0) return 0;
    tilec_t *c0 = &tile->comps[0];
    res_t *r0 = &c0->res[c0->numresolutions - 1];
    size_t n = (size_t)(r0->x1 - r0->x0) * (size_t)(r0->y1 - r0->y0);
    if (j->numcomps >= 3) {
        tilec_t *c1 = &tile->comps[1], *c2 = &tile->comps[2];
        if (c0->numresolutions != c1->numresolutions || c0->numresolutions != c2->numresolutions)
            return fail(j, "Tiles don't all have the same dimension. Skip the MCT step.");
        res_t *r1 = &c1->res[c0->numresolutions - 1], *r2 = &c2->res[c0->numresolutions - 1];
        if (j->comps[0].resno_decoded != j->comps[1].resno_decoded ||
            j->comps[0].resno_decoded != j->comps[2].resno_decoded ||
            (size_t)(r1->x1 - r1->x0) * (size_t)(r1->y1 - r1->y0) != n ||
            (size_t)(r2->x1 - r2->x0) * (size_t)(r2->y1 - r2->y0) != n)
            return fail(j, "Tiles don't all have the same dimension. Skip the MCT step.");
        if (tcp->tccps[0].qmfbid == 1) {
            int32_t *a = c0->data, *b = c1->data, *c = c2->data;
            for (size_t i = 0; i < n; i++) {
                int32_t y = a[i], u = b[i], v = c[i];
                int32_t g = wsub(y, wadd(u, v) >> 2);
                int32_t r = wadd(v, g), bb = wadd(u, g);
                a[i] = r; b[i] = g; c[i] = bb;
            }
        } else {
            float *a = (float *)c0->data, *b = (float *)c1->data, *c = (float *)c2->data;
            for (size_t i = 0; i < n; i++) {
                float y = a[i], u = b[i], v = c[i];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f) - (v * 0.71414f);
                float bb = y + (u * 1.772f);
                a[i] = r; b[i] = g; c[i] = bb;
            }
        }
    }
    return 0;
}

static void dc_level_shift(j2k_t *j, tcp_t *tcp, tile_t *tile) {
    for (uint32_t c = 0; c < j->numcomps; c++) {
        tilec_t *tc = &tile->comps[c];
        comp_t *ic = &j->comps[c];
        res_t *res = &tc->res[ic->resno_decoded];
        res_t *full = &tc->res[tc->numresolutions - 1];
        uint32_t w = (uint32_t)(res->x1 - res->x0), h = (uint32_t)(res->y1 - res->y0);
        size_t stride = (size_t)(full->x1 - full->x0);
        int32_t mn, mx, shift = tcp->tccps[c].dc_level_shift;
        if (ic->sgnd) { mn = -(int32_t)(1u << (ic->prec - 1)); mx = (int32_t)((1u << (ic->prec - 1)) - 1); }
        else { mn = 0; mx = (int32_t)((1u << ic->prec) - 1); }
        for (uint32_t y = 0; y < h; y++) {
            int32_t *p = tc->data + y * stride;
            if (tcp->tccps[c].qmfbid == 1) {
                for (uint32_t x = 0; x < w; x++) {
                    int32_t v = wadd(p[x], shift);
                    p[x] = v < mn ? mn : v > mx ? mx : v;
                }
            } else {
                for (uint32_t x = 0; x < w; x++) {
                    float f;
                    memcpy(&f, &p[x], sizeof f);
                    if (f > (float)INT_MAX) p[x] = mx;
                    else if (f < INT_MIN) p[x] = mn;
                    else {
                        int64_t v = (int64_t)lrintf(f) + shift;
                        p[x] = (int32_t)(v < mn ? mn : v > mx ? mx : v);
                    }
                }
            }
        }
    }
}

/* ------------------------------------------------------------------ */
/* PIL's unpackers (Jpeg2KDecode.c)                                    */

typedef struct { int32_t x0, y0, x1, y1; } tinfo_t;

static inline uint32_t pil_shift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

static inline uint32_t word_at(const uint8_t *p, int csiz, size_t i) {
    if (csiz == 1) return p[i];
    if (csiz == 2) { uint16_t v; memcpy(&v, p + 2 * i, 2); return v; }
    uint32_t v; memcpy(&v, p + 4 * i, 4); return v;
}

static void comp_params(const comp_t *c, int bits, int *shift, int *offset, int *csiz) {
    *shift = bits - (int)c->prec;
    *offset = c->sgnd ? 1 << (c->prec - 1) : 0;
    *csiz = (int)(c->prec + 7) >> 3;
    if (*csiz == 3) *csiz = 4;
    if (*shift < 0) *offset += 1 << (-*shift - 1);
}

static void ycbcr2rgb(uint8_t *row, uint32_t w, const int16_t *tab);

static void unpack(j2k_t *j, int kind, const tinfo_t *ti, const uint8_t *data, uint8_t *out, size_t ostride,
                   const int16_t *ycc) {
    uint32_t x0 = (uint32_t)(ti->x0 - (int32_t)j->x0), y0 = (uint32_t)(ti->y0 - (int32_t)j->y0);
    uint32_t w = (uint32_t)(ti->x1 - ti->x0), h = (uint32_t)(ti->y1 - ti->y0);
    comp_t *cp = j->comps;
    int shift, offset, csiz;
    switch (kind) {
    case 1: /* j2ku_gray_l */
    case 2: /* j2ku_gray_i */
    case 3: /* j2ku_gray_rgb */
        comp_params(&cp[0], kind == 2 ? 16 : 8, &shift, &offset, &csiz);
        for (uint32_t y = 0; y < h; y++) {
            const uint8_t *d = data + (size_t)csiz * y * w;
            uint8_t *row = out + (size_t)(y0 + y) * ostride;
            for (uint32_t x = 0; x < w; x++) {
                uint32_t v = pil_shift((uint32_t)offset + word_at(d, csiz, x), shift);
                if (kind == 1) row[x0 + x] = (uint8_t)v;
                else if (kind == 2) { uint16_t s = (uint16_t)v; memcpy(row + 2 * (x0 + x), &s, 2); }
                else { uint8_t *px = row + 4 * (x0 + x); px[0] = px[1] = px[2] = (uint8_t)v; px[3] = 0xff; }
            }
        }
        break;
    case 4: { /* j2ku_graya_la */
        int ashift, aoffset, acsiz;
        comp_params(&cp[0], 8, &shift, &offset, &csiz);
        comp_params(&cp[1], 8, &ashift, &aoffset, &acsiz);
        const uint8_t *adata = data + (size_t)csiz * w * h;
        for (uint32_t y = 0; y < h; y++) {
            const uint8_t *d = data + (size_t)csiz * y * w, *ad = adata + (size_t)acsiz * y * w;
            uint8_t *row = out + (size_t)(y0 + y) * ostride + 4 * (size_t)x0;
            for (uint32_t x = 0; x < w; x++, row += 4) {
                uint8_t v = (uint8_t)pil_shift((uint32_t)offset + word_at(d, csiz, x), shift);
                row[0] = row[1] = row[2] = v;
                row[3] = (uint8_t)pil_shift((uint32_t)aoffset + word_at(ad, acsiz, x), ashift);
            }
        }
        break;
    }
    case 9: /* raw: each component's samples as unsigned 32-bit words, (h, w, numcomps) at full resolution */
        for (uint32_t n = 0, off = 0; n < j->numcomps; n++) {
            comp_params(&cp[n], 8, &shift, &offset, &csiz);
            uint32_t cw = w / cp[n].dx, chh = h / cp[n].dy;
            const uint8_t *d = data + off;
            for (uint32_t y = 0; y < h; y++) {
                uint32_t *row = (uint32_t *)(out + (size_t)(y0 + y) * ostride) + (size_t)x0 * j->numcomps;
                for (uint32_t x = 0; x < w; x++)
                    row[(size_t)x * j->numcomps + n] = word_at(d, csiz, (size_t)(y / cp[n].dy) * cw + x / cp[n].dx);
            }
            off += (uint32_t)csiz * cw * chh;
        }
        break;
    default: { /* 5 srgb_rgb, 6 sycc_rgb (3 components), 7 srgba_rgba, 8 sycca_rgba (4) */
        int n_c = (kind == 7 || kind == 8) ? 4 : 3;
        int shifts[4], offsets[4], csizs[4];
        uint32_t dx[4], dy[4];
        const uint8_t *cdata[4];
        const uint8_t *ptr = data;
        for (int n = 0; n < n_c; n++) {
            cdata[n] = ptr;
            comp_params(&cp[n], 8, &shifts[n], &offsets[n], &csizs[n]);
            dx[n] = cp[n].dx; dy[n] = cp[n].dy;
            ptr += (size_t)csizs[n] * (w / dx[n]) * (h / dy[n]);
        }
        for (uint32_t y = 0; y < h; y++) {
            const uint8_t *d[4];
            uint8_t *row = out + (size_t)(y0 + y) * ostride + 4 * (size_t)x0;
            for (int n = 0; n < n_c; n++) d[n] = cdata[n] + (size_t)csizs[n] * (y / dy[n]) * (w / dx[n]);
            for (uint32_t x = 0; x < w; x++) {
                for (int n = 0; n < n_c; n++)
                    row[4 * x + n] = (uint8_t)pil_shift((uint32_t)offsets[n] + word_at(d[n], csizs[n], x / dx[n]),
                                                        shifts[n]);
                if (n_c == 3) row[4 * x + 3] = 0xff;
            }
            if (kind == 6 || kind == 8) ycbcr2rgb(row, w, ycc);
        }
        break;
    }
    }
}

/* PIL's ImagingConvertYCbCr2RGB with its tables (passed in: R_Cr, G_Cb,
   G_Cr, B_Cb, 256 each). */
static void ycbcr2rgb(uint8_t *row, uint32_t w, const int16_t *tab) {
    for (uint32_t x = 0; x < w; x++, row += 4) {
        int y = row[0], cb = row[1], cr = row[2];
        int r = y + (tab[cr] >> 6);
        int g = y + ((tab[256 + cb] + tab[512 + cr]) >> 6);
        int b = y + (tab[768 + cb] >> 6);
        row[0] = (uint8_t)(r <= 0 ? 0 : r >= 255 ? 255 : r);
        row[1] = (uint8_t)(g <= 0 ? 0 : g >= 255 ? 255 : g);
        row[2] = (uint8_t)(b <= 0 ? 0 : b >= 255 ? 255 : b);
    }
}

/* opj_tcd_update_tile_data: each component's decoded samples packed at 1,
   2 or 4 bytes (its precision), one component after the other. */
static uint8_t *tile_bytes(j2k_t *j, tile_t *tile, size_t *size) {
    size_t total = 0, pil = 0;
    uint32_t tw = (uint32_t)(tile->x1 - tile->x0), th = (uint32_t)(tile->y1 - tile->y0);
    for (uint32_t c = 0; c < j->numcomps; c++) {
        tilec_t *tc = &tile->comps[c];
        res_t *full = &tc->res[tc->numresolutions - 1];
        size_t cs = (j->comps[c].prec + 7) >> 3;
        if (cs == 3) cs = 4;
        total += cs * (size_t)(full->x1 - full->x0) * (size_t)(full->y1 - full->y0);
        pil += cs * (size_t)tw * th;
    }
    *size = total > pil ? total : pil;
    uint8_t *buf = calloc(*size ? *size : 1, 1);
    if (!buf) return NULL;
    uint8_t *p = buf;
    for (uint32_t c = 0; c < j->numcomps; c++) {
        tilec_t *tc = &tile->comps[c];
        comp_t *ic = &j->comps[c];
        res_t *res = &tc->res[ic->resno_decoded];
        res_t *full = &tc->res[tc->numresolutions - 1];
        uint32_t w = (uint32_t)(res->x1 - res->x0), h = (uint32_t)(res->y1 - res->y0);
        size_t stride = (size_t)(full->x1 - full->x0);
        size_t cs = (ic->prec + 7) >> 3;
        if (cs == 3) cs = 4;
        for (uint32_t y = 0; y < h; y++) {
            const int32_t *s = tc->data + y * stride;
            for (uint32_t x = 0; x < w; x++) {
                uint32_t v = (uint32_t)s[x];
                if (cs == 1) *p++ = (uint8_t)v;
                else if (cs == 2) { uint16_t v16 = (uint16_t)v; memcpy(p, &v16, 2); p += 2; }
                else { memcpy(p, &v, 4); p += 4; }
            }
        }
    }
    return buf;
}

/* ------------------------------------------------------------------ */
/* Entry points                                                        */

/* The MQ states and context tables, filled once when the library loads
   (before any thread of load_gltf's pool decodes). */
__attribute__((constructor)) static void tables_init(void) {
    mq_table_init();
    luts_init();
}

/* The codec after its main header: NULL when out of memory; *rc is 0, or
   -1 with the error in err (the codec is still to be closed). */
void *vpt_j2k_open(const uint8_t *data, int64_t len, uint32_t ihdr_w, uint32_t ihdr_h, int *rc, char *err,
                   int64_t errlen) {
    j2k_t *j = calloc(1, sizeof(j2k_t));
    if (!j) return NULL;
    j->buf = data;
    j->len = (size_t)len;
    j->ihdr_w = ihdr_w;
    j->ihdr_h = ihdr_h;
    *rc = read_main_header(j);
    if (*rc) snprintf(err, (size_t)errlen, "%s", j->err);
    return j;
}

static void j2k_free(j2k_t *j) {
    if (j->tcps) {
        for (uint32_t t = 0; t < j->tw * j->th; t++) {
            tcp_t *tcp = &j->tcps[t];
            free(tcp->tccps);
            free(tcp->data);
            for (uint32_t i = 0; i < tcp->ppt_count; i++) free(tcp->ppt_markers[i].data);
            free(tcp->ppt_markers);
            free(tcp->ppt_buffer);
            for (uint32_t i = 0; i < tcp->nb_mct; i++) free(tcp->mcts[i].data);
            free(tcp->mcts);
            free(tcp->mccs);
        }
    }
    for (uint32_t i = 0; i < j->default_tcp.nb_mct; i++) free(j->default_tcp.mcts[i].data);
    free(j->default_tcp.mcts);
    free(j->default_tcp.mccs);
    free(j->tcps);
    free(j->default_tcp.tccps);
    for (uint32_t i = 0; i < j->ppm_count; i++) free(j->ppm_markers[i].data);
    free(j->ppm_markers);
    free(j->ppm_buffer);
    free(j->comps);
    free(j);
}

void vpt_j2k_close(void *h) { if (h) j2k_free((j2k_t *)h); }

/* info: x0, y0, x1, y1, numcomps, then per component prec, sgnd, dx, dy. */
int vpt_j2k_info(void *h, int64_t *info, int64_t cap) {
    j2k_t *j = (j2k_t *)h;
    if (cap < 5) return -1;
    info[0] = j->x0; info[1] = j->y0; info[2] = j->x1; info[3] = j->y1; info[4] = j->numcomps;
    for (uint32_t c = 0; c < j->numcomps && 5 + 4 * (int64_t)c + 3 < cap; c++) {
        info[5 + 4 * c] = j->comps[c].prec;
        info[6 + 4 * c] = j->comps[c].sgnd;
        info[7 + 4 * c] = j->comps[c].dx;
        info[8 + 4 * c] = j->comps[c].dy;
    }
    return 0;
}

/* Decode every tile and unpack it into `out` (rows of `ostride` bytes) as
   PIL's decoder does; xsize / ysize: PIL's image size.  0, or -1 with the
   error in err. */
int vpt_j2k_decode(void *h, int kind, uint8_t *out, int64_t ostride, int64_t xsize, int64_t ysize,
                   const int16_t *ycc, char *err, int64_t errlen) {
    j2k_t *j = (j2k_t *)h;
    int rc = 0;
    uint32_t decoded = 0;
    for (;;) {
        uint32_t tileno;
        int got = read_tile_header(j, &tileno);
        if (got < 0) { rc = -1; break; }
        if (got == 0) break;
        tcp_t *tcp = &j->tcps[tileno];
        tile_t tile;
        memset(&tile, 0, sizeof tile);
        if (tile_init(j, tcp, tileno, &tile)) { tile_free(&tile, j->numcomps); rc = -1; break; }
        tinfo_t ti = {tile.x0, tile.y0, tile.x1, tile.y1};
        if (ti.x0 >= ti.x1 || ti.y0 >= ti.y1 || ti.x0 < 0 || ti.y0 < 0 || (uint32_t)ti.x0 < j->x0 ||
            (uint32_t)ti.y0 < j->y0 || (int64_t)(int32_t)((uint32_t)ti.x1 - j->x0) > xsize ||
            (int64_t)(int32_t)((uint32_t)ti.y1 - j->y0) > ysize) {
            tile_free(&tile, j->numcomps);
            rc = fail(j, "tile outside the image (PIL)");
            break;
        }
        /* opj_j2k_decode_tile */
        if (!tcp->data) { tile_free(&tile, j->numcomps); rc = fail(j, "tile without data"); break; }
        int bad = t2_decode(j, tcp, &tile) || t1_decode(j, tcp, &tile) || dwt_decode(j, tcp, &tile) ||
                  mct_decode(j, tcp, &tile);
        if (!bad) {
            dc_level_shift(j, tcp, &tile);
            size_t size;
            uint8_t *bytes = tile_bytes(j, &tile, &size);
            if (!bytes) bad = fail(j, "out of memory");
            else {
                unpack(j, kind, &ti, bytes, out, (size_t)ostride, ycc);
                free(bytes);
            }
        }
        tile_free(&tile, j->numcomps);
        free(tcp->data);
        tcp->data = NULL;
        if (bad) { rc = -1; break; }
        /* after a tile: EOC, SOT or the stream's end */
        j->can_decode = 0;
        j->state &= ~ST_DATA;
        if (j->state != ST_EOC && j->state != ST_NEOC) {
            uint8_t b[2];
            if (!read_n(j, b, 2)) { rc = fail(j, "Stream too short"); break; }
            uint32_t m = rd(b, 2);
            if (m == 0xffd9) { j->cur_tile = 0; j->state = ST_EOC; }
            else if (m != 0xff90) {
                if (left(j) == 0) j->state = ST_NEOC;
                else {
                    rc = fail(j, "Stream too short, expected SOT");
                    break;
                }
            }
        }
        /* opj_decode (OpenCV's call, kind 9) stops at the stream's end after a tile or once every tile is
           decoded; PIL's tile loop reads the next tile header whatever the state */
        decoded++;
        if (kind == 9 && ((left(j) == 0 && j->state == ST_NEOC) || decoded == j->tw * j->th)) break;
    }
    /* opj_j2k_are_all_used_components_decoded: opj_decode fails where no tile reached the image */
    if (!rc && kind == 9 && decoded == 0) rc = fail(j, "Failed to decode component 0");
    if (rc) snprintf(err, (size_t)errlen, "%s", j->err);
    return rc;
}

/* The stream position after the decode (where opj_jp2_end_decompress reads on). */
int64_t vpt_j2k_position(void *h) { return (int64_t)((j2k_t *)h)->pos; }
