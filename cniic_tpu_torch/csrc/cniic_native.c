/* cniic_tpu native runtime.
 *
 * Exact sequential engines for the stages that are irreducibly serial in the
 * reference design (hkapp/cniic):
 *
 *   - gilbert_curve:     arbitrary-rectangle space-filling scan. The reference
 *                        wraps the zhang_hilbert crate (reference
 *                        src/hilbert.rs:40-43); we use the generalized Hilbert
 *                        ("gilbert") construction, which serves the same role
 *                        (a locality-preserving bijective scan of any W x H
 *                        rectangle). Encode and decode share the permutation,
 *                        which is the only correctness requirement.
 *   - huf_decode:        bit-serial Huffman trie walk (reference
 *                        src/huf.rs:187-206) over a flattened node table.
 *   - zip_dict_*:        LZ78/LZW-pair engine (reference src/zip/dict.rs):
 *                        u16 symbol pairs, dictionary grown by concatenating
 *                        the two sequences of each emitted pair, 0xFFFF EOF
 *                        marker for odd-length symbol streams.
 *   - zip_back_*:        LZ77 engine (reference src/zip/back.rs): 65535-byte
 *                        window over the input, greedy longest-match >= 6,
 *                        explicit runs grown by doubling. Match-finding is
 *                        parse-independent, so the candidate index is one
 *                        up-front counting sort of positions by hashed
 *                        6-byte prefix (window validity by binary search)
 *                        instead of the reference's per-byte map inserts.
 *   - approx_rle_encode: running-average approximate RLE recurrence
 *                        (reference src/codec/hilbertc.rs:200-285).
 *
 * All functions use a plain C ABI for ctypes. Buffers whose size is unknown
 * in advance are malloc'd here and must be released with cniic_buf_free.
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <time.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#ifdef _WIN32
#define EXPORT __declspec(dllexport)
#else
#define EXPORT __attribute__((visibility("default")))
#endif

/* ------------------------------------------------------------------ */
/* growable byte buffer                                                */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *data;
    int64_t len;
    int64_t cap;
} Buf;

static int buf_init(Buf *b, int64_t cap) {
    if (cap < 64) cap = 64;
    b->data = (uint8_t *)malloc((size_t)cap);
    b->len = 0;
    b->cap = cap;
    return b->data != NULL;
}

static int buf_reserve(Buf *b, int64_t extra) {
    if (b->len + extra <= b->cap) return 1;
    int64_t ncap = b->cap * 2;
    while (ncap < b->len + extra) ncap *= 2;
    uint8_t *nd = (uint8_t *)realloc(b->data, (size_t)ncap);
    if (!nd) return 0;
    b->data = nd;
    b->cap = ncap;
    return 1;
}

static int buf_push(Buf *b, uint8_t x) {
    if (!buf_reserve(b, 1)) return 0;
    b->data[b->len++] = x;
    return 1;
}

static int buf_push_all(Buf *b, const uint8_t *src, int64_t n) {
    if (!buf_reserve(b, n)) return 0;
    memcpy(b->data + b->len, src, (size_t)n);
    b->len += n;
    return 1;
}

static int buf_push_u16le(Buf *b, uint16_t v) {
    if (!buf_reserve(b, 2)) return 0;
    b->data[b->len++] = (uint8_t)(v & 0xff);
    b->data[b->len++] = (uint8_t)(v >> 8);
    return 1;
}

EXPORT void cniic_buf_free(uint8_t *p) { free(p); }

/* ------------------------------------------------------------------ */
/* Encode scratch: thread-local grow-once. The per-call mallocs of the
 * histogram pair arrays (16 MB at 1 MP) and the Huffman tree-build
 * tables (16 MB at north-star alphabet sizes) crossed glibc's mmap
 * threshold, so every encode re-paid kernel page faults on multi-MB
 * buffers — the r5 decode-side fix (hd_*_tls below), applied to the
 * encode side. Slots must be distinct only WITHIN one exported call
 * (including its internal callees); reuse across calls is the point.  */
/* ------------------------------------------------------------------ */

enum {
    ESC_KEYS, ESC_PAIR_A, ESC_PAIR_B, ESC_H16, ESC_STAB, ESC_HTAB,
    ESC_UKC, ESC_RANK, ESC_SKA, ESC_SKB, ESC_SIA, ESC_SIB, ESC_LSORT,
    ESC_TW, ESC_TLR, ESC_TD, ESC_ORDER, ESC_N
};
static _Thread_local void *esc_buf[ESC_N];
static _Thread_local size_t esc_cap[ESC_N];
static void *esc_get(int slot, size_t bytes) {
    if (esc_cap[slot] < bytes) {
        free(esc_buf[slot]);
        esc_buf[slot] = malloc(bytes);
        esc_cap[slot] = esc_buf[slot] ? bytes : 0;
    }
    return esc_buf[slot];
}

/* histogram engines (defined with the Huffman section below); when perm
 * is non-NULL the key stream is the delta codec's packed diff keys of
 * rgb[perm[i]], computed inline (never materialized) */
static int64_t hist_sample_ds(const uint32_t *keys, const uint8_t *rgb,
                              const int64_t *perm, int64_t n);
static int64_t hist_u32_hash(const uint32_t *keys, const uint8_t *rgb,
                             const int64_t *perm, int64_t n, int64_t ds,
                             uint32_t *uniq, int64_t *counts,
                             int32_t *inverse);
static int64_t hist_u32_radix(const uint32_t *keys, int64_t n,
                              uint32_t *uniq, int64_t *counts,
                              int32_t *inverse);
static int64_t hist_rgb24_radix(const uint8_t *rgb, int64_t n,
                                uint32_t *uniq, int64_t *counts,
                                int32_t *inverse);
static int64_t hist_rgb24_radix_u32(const uint8_t *rgb, int64_t n,
                                    uint32_t *uniq, int64_t *counts,
                                    int32_t *inverse);

/* ------------------------------------------------------------------ */
/* gilbert: generalized Hilbert scan of an arbitrary rectangle          */
/* ------------------------------------------------------------------ */

static inline int sgn64(int64_t x) { return (x > 0) - (x < 0); }

/* floor(a/2); C division truncates toward zero, the recursion needs floor */
static inline int64_t fdiv2(int64_t a) { return a >= 0 ? a / 2 : -((-a + 1) / 2); }

typedef struct {
    int32_t *out; /* interleaved x,y */
    int64_t pos;
} GilbertCtx;

static void gilbert_gen(GilbertCtx *ctx, int64_t x, int64_t y,
                        int64_t ax, int64_t ay, int64_t bx, int64_t by) {
    int64_t w = llabs(ax + ay);
    int64_t h = llabs(bx + by);
    int dax = sgn64(ax), day = sgn64(ay);
    int dbx = sgn64(bx), dby = sgn64(by);

    if (h == 1) {
        for (int64_t i = 0; i < w; i++) {
            ctx->out[2 * ctx->pos] = (int32_t)x;
            ctx->out[2 * ctx->pos + 1] = (int32_t)y;
            ctx->pos++;
            x += dax;
            y += day;
        }
        return;
    }
    if (w == 1) {
        for (int64_t i = 0; i < h; i++) {
            ctx->out[2 * ctx->pos] = (int32_t)x;
            ctx->out[2 * ctx->pos + 1] = (int32_t)y;
            ctx->pos++;
            x += dbx;
            y += dby;
        }
        return;
    }

    int64_t ax2 = fdiv2(ax), ay2 = fdiv2(ay);
    int64_t bx2 = fdiv2(bx), by2 = fdiv2(by);
    int64_t w2 = llabs(ax2 + ay2);
    int64_t h2 = llabs(bx2 + by2);

    if (2 * w > 3 * h) {
        if ((w2 % 2) && (w > 2)) { ax2 += dax; ay2 += day; }
        gilbert_gen(ctx, x, y, ax2, ay2, bx, by);
        gilbert_gen(ctx, x + ax2, y + ay2, ax - ax2, ay - ay2, bx, by);
    } else {
        if ((h2 % 2) && (h > 2)) { bx2 += dbx; by2 += dby; }
        gilbert_gen(ctx, x, y, bx2, by2, ax2, ay2);
        gilbert_gen(ctx, x + bx2, y + by2, ax, ay, bx - bx2, by - by2);
        gilbert_gen(ctx, x + (ax - dax) + (bx2 - dbx), y + (ay - day) + (by2 - dby),
                    -bx2, -by2, -(ax - ax2), -(ay - ay2));
    }
}

/* out must hold 2*w*h int32. Returns 0 on success. */
EXPORT int gilbert_curve(int64_t w, int64_t h, int32_t *out) {
    if (w <= 0 || h <= 0) return -1;
    GilbertCtx ctx = {out, 0};
    if (w >= h)
        gilbert_gen(&ctx, 0, 0, w, 0, 0, h);
    else
        gilbert_gen(&ctx, 0, 0, 0, h, w, 0);
    return ctx.pos == w * h ? 0 : -2;
}

/* ------------------------------------------------------------------ */
/* Huffman bit-serial decode (trie walk, MSB-first bits)               */
/* ------------------------------------------------------------------ */

/* left/right: child node index or -1; symbol: leaf payload id or -1.
 * Decodes up to n_symbols symbols from the payload bit stream, writing
 * symbol ids to out. Returns the number decoded (may be < n_symbols if the
 * stream runs out), or -1 on malformed tables.
 */
EXPORT int64_t huf_decode(const uint8_t *payload, int64_t payload_len,
                          const int32_t *left, const int32_t *right,
                          const int32_t *symbol, int64_t n_nodes, int32_t root,
                          int64_t n_symbols, int32_t *out) {
    if (root < 0 || root >= n_nodes) return -1;
    int64_t total_bits = payload_len * 8;
    int64_t bitpos = 0;
    int64_t produced = 0;

    if (symbol[root] >= 0) {
        /* Single-symbol alphabet: zero-length codes, no bits consumed
         * (reference huf.rs:140-142). */
        for (; produced < n_symbols; produced++) out[produced] = symbol[root];
        return produced;
    }

    while (produced < n_symbols) {
        int32_t node = root;
        while (symbol[node] < 0) {
            if (bitpos >= total_bits) return produced; /* EOF mid-code */
            int bit = (payload[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
            bitpos++;
            node = bit ? right[node] : left[node];
            if (node < 0 || node >= n_nodes) return -1;
        }
        out[produced++] = symbol[node];
    }
    return produced;
}

/* Table-accelerated decode: a 16-bit prefix lookup resolves any code of
 * <= 16 bits in one load + shift (DIV2K-scale alphabets average ~14.5
 * bits/code, so a 12-bit table missed most symbols — r3 measured 43 ->
 * 26-29 ms/MP from widening); longer codes resolve through adaptively
 * sized SECOND-LEVEL subtables (r5: at north-star corpus statistics,
 * 370-440k uniques push average code length past 16 bits, so nearly
 * every symbol escaped the root table into the bit-serial walk — 88.6
 * ms/MP measured at 386k uniques vs 16.5 at 48k; a zlib-style subtable
 * per escaping 16-bit prefix, sized to its subtree's real depth and
 * capped at HSUB_MAX extra bits, turns an escape into one more indexed
 * probe). Codes longer than HD_BITS+HSUB_MAX — or escapes past the
 * bounded arena — continue the trie walk from the stored internal node,
 * preserving the old path exactly. Works for ANY preorder prefix tree
 * (reference streams included), not just our canonical ones, and decodes
 * bit-for-bit the same symbols as huf_decode (tests pin the equality).
 */
#ifndef HD_BITS /* overridable for A/B table-geometry experiments */
#define HD_BITS 16
#endif
#define HD_SIZE (1 << HD_BITS)
#define HSUB_MAX 12              /* subtable covers up to 12 more bits */
#define HSUB_ARENA_CAP (1 << 21) /* total subtable slots across escapes */

/* Packed table entries — ONE 8-byte load per probe level (the decode
 * chain is latency-bound: split sym/len/node arrays cost up to 5
 * dependent cache misses per escaped symbol at corpus statistics;
 * packing collapses that to 2). Tag in bits 62-63:
 *   root:  0 = leaf (sym in low 32, code len in bits 32-39)
 *          1 = subtable (arena base in low 32, dm in bits 32-39)
 *          2 = walk (continue node in low 32)
 *   arena: 0 = leaf (sym, RELATIVE len in bits 32-39)
 *          1 = continue walk (node in low 32)
 */
#define HD_LEAF(sym, len) (((uint64_t)(uint32_t)(len) << 32) | (uint32_t)(sym))
#define HD_SUB(base, dm) ((1ULL << 62) | ((uint64_t)(uint32_t)(dm) << 32) | (uint32_t)(base))
#define HD_WALK(node) ((2ULL << 62) | (uint32_t)(node))
#define HD_CONT(node) ((1ULL << 62) | (uint32_t)(node))

/* Max depth of any leaf under nd, capped at HSUB_MAX (an internal node
 * surviving at HSUB_MAX forces the cap). Returns -1 on out-of-range
 * child indices among the visited nodes. Stack bound: classic DFS on a
 * binary tree holds at most depth+1 pending nodes. */
static int hd_sub_depth(const int32_t *left, const int32_t *right,
                        const int32_t *symbol, int64_t n_nodes, int32_t nd) {
    int32_t st_n[HSUB_MAX + 2];
    int8_t st_d[HSUB_MAX + 2];
    int sp = 0, dm = 1;
    st_n[sp] = nd; st_d[sp] = 0; sp++;
    while (sp > 0) {
        sp--;
        int32_t x = st_n[sp];
        int d = st_d[sp];
        if (x < 0 || x >= n_nodes) return -1;
        if (symbol[x] >= 0) {
            if (d > dm) dm = d;
        } else if (d == HSUB_MAX) {
            return HSUB_MAX; /* deep subtree: cap (walk handles the rest) */
        } else {
            st_n[sp] = left[x]; st_d[sp] = (int8_t)(d + 1); sp++;
            st_n[sp] = right[x]; st_d[sp] = (int8_t)(d + 1); sp++;
        }
    }
    return dm;
}

/* Fill a 2^dm-slot subtable for the subtree under nd: leaf at relative
 * depth d covers its prefix range; an internal node at depth dm stores
 * the continue node. */
static int hd_sub_fill(const int32_t *left, const int32_t *right,
                       const int32_t *symbol, int64_t n_nodes, int32_t nd,
                       int dm, uint64_t *arena) {
    int32_t st_n[HSUB_MAX + 2], st_p[HSUB_MAX + 2];
    int8_t st_d[HSUB_MAX + 2];
    int sp = 0;
    st_n[sp] = nd; st_d[sp] = 0; st_p[sp] = 0; sp++;
    while (sp > 0) {
        sp--;
        int32_t x = st_n[sp], pre = st_p[sp];
        int d = st_d[sp];
        if (x < 0 || x >= n_nodes) return -1;
        if (symbol[x] >= 0) {
            int32_t lo = pre << (dm - d), hi = (pre + 1) << (dm - d);
            uint64_t ent = HD_LEAF(symbol[x], d);
            for (int32_t i = lo; i < hi; i++) arena[i] = ent;
        } else if (d == dm) {
            arena[pre] = HD_CONT(x);
        } else {
            st_n[sp] = left[x]; st_d[sp] = (int8_t)(d + 1);
            st_p[sp] = pre << 1; sp++;
            st_n[sp] = right[x]; st_d[sp] = (int8_t)(d + 1);
            st_p[sp] = (pre << 1) | 1; sp++;
        }
    }
    return 0;
}

/* Decode scratch: thread-local, grow-once. The old per-call mallocs of
 * the root table and arena crossed glibc's mmap threshold, so every
 * decode re-paid kernel page faults on multi-MB buffers; caching them
 * per thread keeps the pages warm across a chunk's 32 decodes. A wider
 * root was A/B'd here (rb 17-20, fixed and alphabet-adaptive): high-
 * unique images gained ~2-3 ms/MP (inside host noise) but 39k-unique
 * images LOST ~8 ms/MP even with warm tables — the 512 KB 16-bit root
 * is L2-resident on this host (2 MB L2) and wider tables evict it —
 * so the width stays a compile-time 16. */
static _Thread_local uint64_t *hd_tab_tls = NULL;   /* HD_SIZE */
static _Thread_local int32_t *hd_epre_tls = NULL;   /* HD_SIZE */
static _Thread_local uint64_t *hd_arena_tls = NULL; /* HSUB_ARENA_CAP */

EXPORT int64_t huf_decode_fast(const uint8_t *payload, int64_t payload_len,
                               const int32_t *left, const int32_t *right,
                               const int32_t *symbol, int64_t n_nodes,
                               int32_t root, int64_t n_symbols, int32_t *out) {
    if (root < 0 || root >= n_nodes) return -1;
    if (symbol[root] >= 0) { /* single-symbol alphabet: zero-length codes */
        for (int64_t i = 0; i < n_symbols; i++) out[i] = symbol[root];
        return n_symbols;
    }

    const int rb = HD_BITS;
    const int64_t rb_size = (int64_t)1 << rb;

    if (!hd_tab_tls) {
        hd_tab_tls = (uint64_t *)malloc(HD_SIZE * sizeof(uint64_t));
        hd_epre_tls = (int32_t *)malloc(HD_SIZE * sizeof(int32_t));
        if (!hd_tab_tls || !hd_epre_tls) {
            free(hd_tab_tls); free(hd_epre_tls);
            hd_tab_tls = NULL; hd_epre_tls = NULL;
            return -1;
        }
    }
    uint64_t *tab = hd_tab_tls;
    int32_t *epre = hd_epre_tls;
    uint64_t *arena = hd_arena_tls;

    /* fill stack: (node, depth, prefix). Bounded by the traversal depth
     * cap — a pop pushes at most two children one level deeper, so the
     * stack never exceeds rb+2 entries. */
    int32_t snode[HD_BITS + 2], spre[HD_BITS + 2];
    int8_t sdep[HD_BITS + 2];
    int64_t sp = 0, n_esc = 0;
    snode[sp] = root; sdep[sp] = 0; spre[sp] = 0; sp++;
    int bad = 0;
    while (sp > 0 && !bad) {
        sp--;
        int32_t nd = snode[sp], pre = spre[sp];
        int d = sdep[sp];
        if (nd < 0 || nd >= n_nodes) { bad = 1; break; }
        if (symbol[nd] >= 0) { /* leaf: fill the whole prefix range */
            int32_t lo = pre << (rb - d);
            int32_t hi = (pre + 1) << (rb - d);
            uint64_t ent = HD_LEAF(symbol[nd], d);
            for (int32_t i = lo; i < hi; i++) tab[i] = ent;
        } else if (d == rb) {
            tab[pre] = HD_WALK(nd);
            epre[n_esc++] = pre;
        } else {
            snode[sp] = left[nd]; sdep[sp] = (int8_t)(d + 1);
            spre[sp] = pre << 1; sp++;
            snode[sp] = right[nd]; sdep[sp] = (int8_t)(d + 1);
            spre[sp] = (pre << 1) | 1; sp++;
        }
    }
    if (bad) return -1;

    /* second level: one adaptively-sized subtable per escape, packed into
     * a bounded arena; escapes that don't fit keep the walk path */
    if (n_esc) {
        int64_t used = 0;
        for (int64_t e = 0; e < n_esc; e++) {
            int32_t pre = epre[e];
            int32_t nd = (int32_t)(uint32_t)tab[pre];
            int dm = hd_sub_depth(left, right, symbol, n_nodes, nd);
            if (dm < 0) return -1;
            if (used + ((int64_t)1 << dm) > HSUB_ARENA_CAP) continue;
            if (!arena) {
                arena = (uint64_t *)malloc(HSUB_ARENA_CAP * sizeof(uint64_t));
                hd_arena_tls = arena;
                if (!arena) break; /* degrade: all escapes keep the walk */
            }
            if (hd_sub_fill(left, right, symbol, n_nodes, nd, dm,
                            arena + used) != 0) return -1;
            tab[pre] = HD_SUB(used, dm);
            used += (int64_t)1 << dm;
        }
    }

    int64_t total_bits = payload_len * 8;
    int64_t bitpos = 0, produced = 0;
    const uint32_t rb_mask = (uint32_t)(rb_size - 1);
    while (produced < n_symbols && bitpos + 64 <= total_bits) {
        int64_t idx = bitpos >> 3;
        int off = (int)(bitpos & 7);
        uint64_t w64;
        memcpy(&w64, payload + idx, 8);
        w64 = __builtin_bswap64(w64);
        uint32_t w = (uint32_t)(w64 >> (64 - rb - off)) & rb_mask;
        uint64_t ent = tab[w];
        uint64_t tag = ent >> 62;
        if (tag == 0) { /* root leaf: one load resolved the symbol */
            out[produced++] = (int32_t)(uint32_t)ent;
            bitpos += (int)((ent >> 32) & 0xff);
            continue;
        }
        int32_t node;
        if (tag == 1) { /* second-level probe */
            int dm = (int)((ent >> 32) & 0xff);
            int64_t slot = (int64_t)(uint32_t)ent +
                ((uint32_t)(w64 >> (64 - rb - dm - off)) &
                 (((uint32_t)1 << dm) - 1));
            uint64_t a = arena[slot];
            if (!(a >> 62)) {
                out[produced++] = (int32_t)(uint32_t)a;
                bitpos += rb + (int)((a >> 32) & 0xff);
                continue;
            }
            node = (int32_t)(uint32_t)a;
            bitpos += rb + dm; /* code longer: finish with the walk */
        } else {
            node = (int32_t)(uint32_t)ent;
            bitpos += rb;
        }
        while (symbol[node] < 0) {
            if (bitpos >= total_bits) goto tail_done;
            int bit = (payload[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
            bitpos++;
            node = bit ? right[node] : left[node];
            if (node < 0 || node >= n_nodes) return -1;
        }
        out[produced++] = symbol[node];
    }
    /* tail: the last <64 bits, decoded with the plain walk */
    while (produced < n_symbols) {
        int32_t node = root;
        while (symbol[node] < 0) {
            if (bitpos >= total_bits) goto tail_done;
            int bit = (payload[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
            bitpos++;
            node = bit ? right[node] : left[node];
            if (node < 0 || node >= n_nodes) return -1;
        }
        out[produced++] = symbol[node];
    }
tail_done:
    return produced; /* tab/arena are thread-local caches, kept warm */
}

static inline uint64_t hash64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

/* ------------------------------------------------------------------ */
/* zip-dict (LZ78/LZW-pair engine, reference src/zip/dict.rs)          */
/* ------------------------------------------------------------------ */

#define ZIP_EOF 0xffffu

/* Node-major trie storage, mirroring the shape of the reference's hybrid
 * TrieMap (dict.rs:442-553): per node a linear-scanned (key byte, edge)
 * list up to DT_THRESHOLD entries, then promoted to a direct 256-entry
 * array. The measured trie is overwhelmingly SPARSE (avg 1.2 edges/node on
 * framed streams), so the first DT_INLINE entries live inside the node
 * itself: a descent step touches ONE cache line of the contiguous node
 * array instead of chasing separate key/edge heap buffers (was 3 misses
 * per step, ~80% of encode time). Storage only — match results are
 * identical to the reference's map semantics.
 * DT_THRESHOLD swept in r3 on the 1024^2 framed stream (64/32/16/8/6/4 ->
 * 43.6/50.2/51.8/59.5/58.8/55.9 MB/s): early promotion to direct indexing
 * beats linear scans well before the reference's 64. */
#define DT_THRESHOLD 8
#define DT_INLINE 4

typedef struct { int32_t code, child; } DEdge; /* -1 = absent */

typedef struct {
    int16_t len;               /* live entries (256 once promoted full) */
    int16_t cap;               /* DT_INLINE | 16..DT_THRESHOLD | 256 */
    uint8_t k4[DT_INLINE];     /* inline keys while cap == DT_INLINE */
    DEdge ie[DT_INLINE];       /* inline edges */
    uint8_t *hk;               /* heap keys (partial heap mode) */
    DEdge *he;                 /* heap edges (partial) / 256 direct (full) */
} DNode;                       /* 56 bytes: one cache line per step */

typedef struct {
    DNode *nodes;
    int32_t n_nodes, node_cap;
    uint32_t counter; /* next symbol code */
} DictTrie;

static int dnode_full(DictTrie *t, int32_t id) {
    DNode *nd = &t->nodes[id];
    DEdge *full = (DEdge *)malloc(256 * sizeof(DEdge));
    if (!full) return 0;
    for (int b = 0; b < 256; b++) { full[b].code = -1; full[b].child = -1; }
    const uint8_t *ks = nd->cap == DT_INLINE ? nd->k4 : nd->hk;
    const DEdge *es = nd->cap == DT_INLINE ? nd->ie : nd->he;
    for (int32_t i = 0; i < nd->len; i++) full[ks[i]] = es[i];
    free(nd->hk);
    free(nd->he);
    nd->hk = NULL;
    nd->he = full;
    nd->len = 256;
    nd->cap = 256;
    return 1;
}

/* Edge for (node, byte); created (absent code/child) when create != 0.
 * NOTE: the returned pointer may live inside t->nodes[id] (inline mode) —
 * it is invalidated by anything that can grow the nodes array. */
static DEdge *dnode_edge(DictTrie *t, int32_t id, uint8_t b, int create) {
    DNode *nd = &t->nodes[id];
    if (nd->cap == 256) return &nd->he[b]; /* full node: direct-indexed */
    uint8_t *ks = nd->cap == DT_INLINE ? nd->k4 : nd->hk;
    DEdge *es = nd->cap == DT_INLINE ? nd->ie : nd->he;
    for (int32_t i = 0; i < nd->len; i++)
        if (ks[i] == b) return &es[i];
    if (!create) return NULL;
    if (nd->len == DT_THRESHOLD) {
        if (!dnode_full(t, id)) return NULL;
        return &nd->he[b];
    }
    if (nd->len == nd->cap) {
        int32_t ncap = nd->cap == DT_INLINE ? 16 : nd->cap * 2;
        uint8_t *nk = (uint8_t *)realloc(nd->hk, (size_t)ncap);
        if (!nk) return NULL;
        nd->hk = nk;
        DEdge *ne = (DEdge *)realloc(nd->he, (size_t)ncap * sizeof(DEdge));
        if (!ne) return NULL;
        nd->he = ne;
        if (nd->cap == DT_INLINE) { /* spill the inline entries */
            memcpy(nd->hk, nd->k4, DT_INLINE);
            memcpy(nd->he, nd->ie, DT_INLINE * sizeof(DEdge));
        }
        nd->cap = (int16_t)ncap;
        ks = nd->hk;
        es = nd->he;
    }
    ks[nd->len] = b;
    es[nd->len].code = -1;
    es[nd->len].child = -1;
    return &es[nd->len++];
}

/* Ensure one more node can be created without moving the nodes array
 * (callers hold DEdge pointers into it across dnode_new). */
static int trie_reserve(DictTrie *t) {
    if (t->n_nodes < t->node_cap) return 1;
    int32_t ncap = t->node_cap * 2;
    DNode *nn = (DNode *)realloc(t->nodes, (size_t)ncap * sizeof(DNode));
    if (!nn) return 0;
    t->nodes = nn;
    t->node_cap = ncap;
    return 1;
}

static int32_t dnode_new(DictTrie *t) {
    if (!trie_reserve(t)) return -1;
    DNode *nd = &t->nodes[t->n_nodes];
    nd->len = 0;
    nd->cap = DT_INLINE;
    nd->hk = NULL;
    nd->he = NULL;
    return t->n_nodes++;
}

static void trie_destroy(DictTrie *t) {
    for (int32_t i = 0; i < t->n_nodes; i++) {
        free(t->nodes[i].hk);
        free(t->nodes[i].he);
    }
    free(t->nodes);
}

static int trie_init(DictTrie *t) {
    t->node_cap = 1024;
    t->nodes = (DNode *)malloc((size_t)t->node_cap * sizeof(DNode));
    if (!t->nodes) return 0;
    t->n_nodes = 0;
    t->counter = 0;
    if (dnode_new(t) != 0) return 0; /* node 0 = root */
    if (!dnode_full(t, 0)) return 0; /* root is dense by construction */
    /* 256 single-byte symbols (dict.rs:44-47) */
    for (int b = 0; b < 256; b++)
        t->nodes[0].he[b].code = (int32_t)t->counter++;
    return 1;
}

/* Greedy longest-registered-prefix match starting at in[pos]
 * (dict.rs:96-137). Returns the symbol (or -1) and sets *end to one past the
 * matched sequence. *hint receives the node owning the matched symbol's
 * final edge, so a following insert of match+suffix can skip re-walking the
 * match's path from the root (pure walk reuse: the edges it skips were just
 * verified to exist, and child creation only ever happens at or past that
 * final edge). */
static int32_t trie_find(DictTrie *t, const uint8_t *in, int64_t n, int64_t pos,
                         int64_t *end, int32_t *hint) {
    int32_t node = 0;
    int32_t longest = -1;
    int64_t longest_end = pos;
    int64_t p = pos;
    while (p < n) {
        const DNode *nd = &t->nodes[node];
        const DEdge *ed;
        if (nd->cap == 256) {
            ed = &nd->he[in[p]];
            if (ed->code < 0 && ed->child < 0) break; /* absent */
        } else {
            const uint8_t *ks = nd->cap == DT_INLINE ? nd->k4 : nd->hk;
            const DEdge *es = nd->cap == DT_INLINE ? nd->ie : nd->he;
            ed = NULL;
            for (int32_t i = 0; i < nd->len; i++)
                if (ks[i] == in[p]) { ed = &es[i]; break; }
            if (!ed) break;
        }
        if (ed->code >= 0) {
            longest = ed->code;
            longest_end = p + 1;
            *hint = node;
        }
        if (ed->child < 0) break;
        node = ed->child;
        p++;
    }
    *end = longest_end;
    return longest;
}

/* Insert seq1+seq2 -> code where seq1 = in[s1_last] prefixed by the path to
 * *hint (from trie_find): the walk resumes at the matched symbol's final
 * edge instead of the root. Identical trie mutations to trie_insert over
 * the concatenated sequence. */
static int trie_insert_hint(DictTrie *t, int32_t hint, const uint8_t *in,
                            int64_t s1_last, int64_t e2, int32_t code) {
    int32_t node = hint;
    for (int64_t i = s1_last; i < e2 - 1; i++) {
        /* reserve BEFORE taking the edge pointer: inline edges live inside
         * the nodes array, which dnode_new may otherwise move */
        if (!trie_reserve(t)) return 0;
        DEdge *ed = dnode_edge(t, node, in[i], 1);
        if (!ed) return 0;
        if (ed->child < 0) {
            int32_t child = dnode_new(t);
            if (child < 0) return 0;
            ed->child = child;
            node = child;
        } else {
            node = ed->child;
        }
    }
    DEdge *ed = dnode_edge(t, node, in[e2 - 1], 1);
    if (!ed) return 0;
    ed->code = code;
    return 1;
}

EXPORT int zip_dict_encode(const uint8_t *in, int64_t n,
                           uint8_t **out, int64_t *out_len) {
    DictTrie t;
    Buf b;
    if (!trie_init(&t)) { trie_destroy(&t); return -1; }
    if (!buf_init(&b, n / 2 + 64)) { trie_destroy(&t); return -1; }

    int64_t pos = 0;
    int ok = 1;
    while (pos < n) {
        int64_t e1, e2;
        int32_t h1 = 0, h2 = 0;
        int32_t s1 = trie_find(&t, in, n, pos, &e1, &h1);
        if (s1 < 0) break; /* only possible when input exhausted */
        int32_t s2 = trie_find(&t, in, n, e1, &e2, &h2);
        if (s2 < 0) {
            /* odd symbol count: EOF marker (dict.rs:81-86) */
            ok = buf_push_u16le(&b, (uint16_t)s1) && buf_push_u16le(&b, ZIP_EOF);
            pos = e1;
            break;
        }
        if (!buf_push_u16le(&b, (uint16_t)s1) || !buf_push_u16le(&b, (uint16_t)s2)) {
            ok = 0;
            break;
        }
        /* register concat(seq1, seq2) = in[pos..e2) while codes remain
         * (dict.rs:52-62, 90-92), resuming the walk at seq1's final edge */
        if (t.counter < ZIP_EOF) {
            if (!trie_insert_hint(&t, h1, in, e1 - 1, e2, (int32_t)t.counter)) { ok = 0; break; }
            t.counter++;
        }
        pos = e2;
    }
    trie_destroy(&t);
    if (!ok) { free(b.data); return -1; }
    *out = b.data;
    *out_len = b.len;
    return 0;
}

EXPORT int zip_dict_decode(const uint8_t *in, int64_t n,
                           uint8_t **out, int64_t *out_len,
                           int64_t max_out) {
    /* max_out > 0 caps the decoded size: LZ78 pair expansion doubles per
     * 4-byte input pair, so a ~150-byte crafted stream otherwise forces
     * multi-GB allocations before any validity check can fire (r4 fuzz
     * audit). Callers pass the wire-format maximum their context allows.
     * Returns -2 when the cap is exceeded. */
    /* mapping: symbol -> (offset, len) into the decoded output itself.
     * Single-byte symbols use offset -1-byte as a sentinel. */
    int64_t *offs = (int64_t *)malloc(65536 * sizeof(int64_t));
    int64_t *lens = (int64_t *)malloc(65536 * sizeof(int64_t));
    Buf b;
    if (!offs || !lens || !buf_init(&b, n * 3 + 64)) {
        free(offs); free(lens);
        return -1;
    }
    for (int i = 0; i < 65536; i++) { offs[i] = -1; lens[i] = 0; }
    for (int i = 0; i < 256; i++) { offs[i] = -(int64_t)i - 2; lens[i] = 1; }
    lens[ZIP_EOF] = 0;
    offs[ZIP_EOF] = 0;
    uint32_t counter = 0x0100;

    int64_t pos = 0;
    int ok = 1;
    while (pos + 4 <= n) {
        uint16_t s1 = (uint16_t)(in[pos] | (in[pos + 1] << 8));
        uint16_t s2 = (uint16_t)(in[pos + 2] | (in[pos + 3] << 8));
        pos += 4;
        if (offs[s1] == -1 || offs[s2] == -1) { ok = 0; break; } /* unknown code */
        int64_t start = b.len;

        int64_t o1 = offs[s1], l1 = lens[s1];
        if (max_out > 0 && b.len + l1 + lens[s2] > max_out) {
            ok = -2; break;
        }
        if (!buf_reserve(&b, l1 + lens[s2])) { ok = 0; break; }
        if (o1 <= -2) {
            b.data[b.len++] = (uint8_t)(-o1 - 2);
        } else {
            memcpy(b.data + b.len, b.data + o1, (size_t)l1);
            b.len += l1;
        }
        int64_t o2 = offs[s2], l2 = lens[s2];
        if (o2 <= -2) {
            b.data[b.len++] = (uint8_t)(-o2 - 2);
        } else if (l2 > 0) {
            memcpy(b.data + b.len, b.data + o2, (size_t)l2);
            b.len += l2;
        }
        if (counter < ZIP_EOF) {
            offs[counter] = start;
            lens[counter] = b.len - start;
            counter++;
        }
    }
    free(offs);
    free(lens);
    if (ok != 1) { free(b.data); return ok == -2 ? -2 : -1; }
    *out = b.data;
    *out_len = b.len;
    return 0;
}

/* ------------------------------------------------------------------ */
/* zip-back (LZ77 engine, reference src/zip/back.rs)                   */
/* ------------------------------------------------------------------ */

#define ZB_RING 65535            /* MAX_RING_BUFFER_SIZE = Back::MAX (back.rs:291) */
#define ZB_MINREP 6              /* MIN_REP (back.rs:143) */
#define ZB_MAXLEN 32767          /* 15-bit length field (back.rs:44-49) */

/* In the encoder the committed history is always exactly the already-
 * consumed input prefix (both the explicit-extend and lookback-commit paths
 * write input bytes in order, back.rs:176-179, 279-287), so the ring buffer
 * degenerates to a window [pos-65535, pos) over the input itself — no ring
 * storage, no per-byte modulo. Better still, the candidate set a query at
 * `pos` sees (every earlier position keyed by its 6-/7-byte prefix, windowed
 * and capped by lim = pos - cand) depends only on the INPUT, never on the
 * parse — so the whole index is built up front with one stable counting
 * sort instead of the reference's two hash-map inserts per committed byte
 * (back.rs:538-559; the per-byte maps were ~55% of encode time measured).
 *
 * Buckets key a 22-bit hash of the prefix; different keys may share a
 * bucket, but collisions self-filter exactly:
 *   - the 7-scan only accepts candidates whose measured match length
 *     exceeds the running best (>= 7), which implies true 7-byte prefix
 *     equality — a collider can never win;
 *   - the 6-fallback verifies the 6-byte key per candidate.
 * Window validity is a binary search over the (ascending) position list,
 * replacing generation aging. */

#define ZB_HBITS 22

/* Prefix keys as a single little-endian load + mask (the key value is an
 * opaque bucket key: only build/query consistency matters). The byte-fold
 * fallback keeps the last <8 bytes of the stream off the fast path. */
static inline uint64_t keyat(const uint8_t *in, int64_t n, int64_t p, int bytes) {
    uint64_t k;
    if (p + 8 <= n) {
        memcpy(&k, in + p, 8);
        return k & (~0ULL >> (8 * (8 - bytes)));
    }
    k = 0;
    for (int i = bytes - 1; i >= 0; i--) k = (k << 8) | in[p + i];
    return k;
}

static inline uint32_t zb_bucket(uint64_t key) {
    return (uint32_t)(hash64(key) >> (64 - ZB_HBITS));
}

typedef struct {
    int32_t *pos;    /* positions, bucket-major, ascending within a bucket */
    int32_t *off;    /* bucket start offsets, (1 << ZB_HBITS) + 1 entries */
} PosIndex;

static void posindex_destroy(PosIndex *ix) {
    free(ix->pos);
    free(ix->off);
}

/* Stable counting sort of [0, count) positions by prefix-key bucket.
 * Two streaming passes; peak extra memory 4 bytes/byte of input per index
 * (~an order of magnitude more than the generation maps, but bounded and
 * linear — a 30 MB framed stream costs ~250 MB transiently). */
static int posindex_build(PosIndex *ix, const uint8_t *in, int64_t n, int bytes) {
    const int64_t nb = (int64_t)1 << ZB_HBITS;
    int64_t count = n - bytes + 1;
    if (count < 0) count = 0;
    ix->off = (int32_t *)calloc((size_t)nb + 1, sizeof(int32_t));
    ix->pos = (int32_t *)malloc((size_t)(count > 0 ? count : 1) * sizeof(int32_t));
    int32_t *cursor = (int32_t *)malloc((size_t)nb * sizeof(int32_t));
    if (!ix->off || !ix->pos || !cursor) {
        free(cursor);
        return 0;
    }
    for (int64_t p = 0; p < count; p++)
        ix->off[zb_bucket(keyat(in, n, p, bytes)) + 1]++;
    for (int64_t b = 0; b < nb; b++) ix->off[b + 1] += ix->off[b];
    memcpy(cursor, ix->off, (size_t)nb * sizeof(int32_t));
    for (int64_t p = 0; p < count; p++)
        ix->pos[cursor[zb_bucket(keyat(in, n, p, bytes))]++] = (int32_t)p;
    free(cursor);
    return 1;
}

/* First list slot with pos[i] >= limit (the list is ascending). */
static inline int64_t zb_lower_bound(const int32_t *pos, int64_t lo, int64_t hi,
                                     int64_t limit) {
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (pos[mid] < limit) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

/* Full-match extension (the index buckets hash-mix keys, so nothing is
 * known about a candidate's prefix until compared). */
static inline int64_t match_extend(const uint8_t *a, const uint8_t *c, int64_t lim) {
    int64_t l = 0;
    while (l + 8 <= lim) {
        uint64_t xa, xc;
        memcpy(&xa, a + l, 8);
        memcpy(&xc, c + l, 8);
        if (xa != xc) return l + (int64_t)(__builtin_ctzll(xa ^ xc) >> 3);
        l += 8;
    }
    while (l < lim && a[l] == c[l]) l++;
    return l;
}

/* prof-only counters (CNIIC_ZB_PROF; single-threaded use only).
 * zb_prof gates every increment (ADVICE r3): unguarded they cost a touch
 * on every encode and race benignly when the runner pipeline encodes in a
 * worker thread; profiling runs are explicitly single-threaded. */
static int zb_prof = 0;
static int64_t zb_cand_steps, zb_extends, zb_extend_bytes, zb_first6_steps;
static int64_t zb_steps_bl6;

/* Longest match with the reference's winner rule: the scan takes the first
 * strictly-longer candidate in ascending-position order (back.rs:253-277),
 * i.e. the earliest position achieving the maximum length. One bucket walk
 * serves both levels of the reference's semantics:
 *   - the >=7 scan pre-filters 8 candidates at a time (AVX2 gather of the
 *     byte each one must match at best_len to improve — the overwhelmingly
 *     common reject) and measures survivors with a full compare, so hash
 *     colliders can never win (an update needs length > 6, which implies
 *     true 6-byte key equality and beyond);
 *   - if nothing exceeds 6, every valid 6-key candidate matches exactly
 *     min(6, lim), so the winner is the oldest valid one — the first
 *     genuine entry of the windowed range (a short scalar walk; colliders
 *     are rare at 22 hash bits). */
static int64_t best_match(const PosIndex *ix6, const uint8_t *in, int64_t n,
                          int64_t pos, int64_t *back_out) {
    if (n - pos < ZB_MINREP) return 0;
    const int64_t total = pos; /* history == consumed prefix */
    int64_t window_start = total > ZB_RING ? total - ZB_RING : 0;
    int64_t qcap = n - pos < ZB_MAXLEN ? n - pos : ZB_MAXLEN;

    int64_t best_len = ZB_MINREP; /* sentinel: only matches >= 7 update it */
    int64_t best_pos = -1;
    const uint8_t *qa = in + pos;

    uint64_t k6 = keyat(in, n, pos, ZB_MINREP);
    uint32_t b = zb_bucket(k6);
    const int32_t *pp = ix6->pos;
    /* candidates: same-bucket positions in [window_start, pos-6] */
    int64_t lo = zb_lower_bound(pp, ix6->off[b], ix6->off[b + 1], window_start);
    int64_t hi = zb_lower_bound(pp, lo, ix6->off[b + 1], pos - (ZB_MINREP - 1));

    int64_t first6 = -1;
    for (int64_t i = lo; i < hi; i++) {
        if (zb_prof) zb_first6_steps++;
        if (keyat(in, n, pp[i], ZB_MINREP) == k6) { first6 = pp[i]; break; }
    }

    if (n - pos >= ZB_MINREP + 1) {
        int64_t i = lo, len = hi;
#if defined(__AVX512F__)
        /* 16-wide gather pre-filter: the scan is memory-latency-bound
         * (~150 scattered reads/query measured), so doubling the gather
         * width doubles the loads in flight per iteration. Same exact
         * semantics as the AVX2 block below (pre-filter only; survivors
         * re-validated scalar). */
        const __m512i wff = _mm512_set1_epi32(0xFF);
        while (i + 16 <= len) {
            if (best_len >= qcap) break;
            if ((int64_t)pp[i + 15] + best_len + 4 > n) break;
            if (zb_prof) { zb_cand_steps += 16;
                if (best_len == ZB_MINREP) zb_steps_bl6 += 16; }
            __m512i wqb = _mm512_set1_epi32(qa[best_len]);
            __m512i wcut = _mm512_set1_epi32((int32_t)(total - best_len));
            __m512i wpos = _mm512_loadu_si512((const void *)(pp + i));
            __m512i g = _mm512_i32gather_epi32(wpos, (const void *)(in + best_len), 1);
            __mmask16 beq = _mm512_cmpeq_epi32_mask(_mm512_and_si512(g, wff), wqb);
            __mmask16 wlt = _mm512_cmplt_epi32_mask(wpos, wcut);
            unsigned m = (unsigned)(beq & wlt);
            while (m) {
                int lane = __builtin_ctz(m);
                m &= m - 1;
                int64_t cand = pp[i + lane];
                int64_t lim = total - cand;
                if (lim > qcap) lim = qcap;
                if (lim <= best_len) continue;
                if (in[cand + best_len] != qa[best_len]) continue;
                int64_t l = match_extend(qa, in + cand, lim);
                if (zb_prof) { zb_extends++; zb_extend_bytes += l; }
                if (l > best_len) {
                    best_len = l;
                    best_pos = cand;
                }
            }
            i += 16;
        }
#endif
#if defined(__AVX2__)
        const __m256i vff = _mm256_set1_epi32(0xFF);
        while (i + 8 <= len) {
            if (best_len >= qcap) break;
            /* the dword gather reads in[cand+best_len .. +4): bail to
             * the scalar tail once candidates get that close to n */
            if ((int64_t)pp[i + 7] + best_len + 4 > n) break;
            if (zb_prof) { zb_cand_steps += 8;
                if (best_len == ZB_MINREP) zb_steps_bl6 += 8; }
            __m256i vqb = _mm256_set1_epi32(qa[best_len]);
            __m256i vcut = _mm256_set1_epi32((int32_t)(total - best_len));
            __m256i vpos = _mm256_loadu_si256((const __m256i *)(pp + i));
            __m256i g = _mm256_i32gather_epi32((const int *)(in + best_len), vpos, 1);
            __m256i beq = _mm256_cmpeq_epi32(_mm256_and_si256(g, vff), vqb);
            __m256i vlt = _mm256_cmpgt_epi32(vcut, vpos); /* lim > best_len */
            int m = _mm256_movemask_ps(_mm256_castsi256_ps(_mm256_and_si256(beq, vlt)));
            while (m) { /* pre-filter only: lanes re-validated exactly */
                int lane = __builtin_ctz((unsigned)m);
                m &= m - 1;
                int64_t cand = pp[i + lane];
                int64_t lim = total - cand;
                if (lim > qcap) lim = qcap;
                if (lim <= best_len) continue;
                if (in[cand + best_len] != qa[best_len]) continue;
                int64_t l = match_extend(qa, in + cand, lim);
                if (zb_prof) { zb_extends++; zb_extend_bytes += l; }
                if (l > best_len) {
                    best_len = l;
                    best_pos = cand;
                }
            }
            i += 8;
        }
#endif
        for (; i < len; i++) {
            if (best_len >= qcap) break;
            if (zb_prof) { zb_cand_steps++;
                if (best_len == ZB_MINREP) zb_steps_bl6++; }
            int64_t cand = pp[i];
            int64_t lim = total - cand; /* no run past history end */
            if (lim > qcap) lim = qcap;
            if (lim <= best_len) continue;
            /* quick reject: to beat best_len the (best_len+1)-prefix
             * must match, so the byte at best_len must */
            if (in[cand + best_len] != qa[best_len]) continue;
            int64_t l = match_extend(qa, in + cand, lim);
            if (zb_prof) { zb_extends++; zb_extend_bytes += l; }
            if (l > best_len) {
                best_len = l;
                best_pos = cand;
            }
        }
    }
    if (best_pos >= 0) {
        *back_out = total - best_pos;
        return best_len;
    }
    if (first6 < 0) {
        *back_out = 0;
        return 0;
    }
    *back_out = total - first6;
    return ZB_MINREP;
}

static double zb_now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

EXPORT int zip_back_encode(const uint8_t *in, int64_t n,
                           uint8_t **out, int64_t *out_len) {
    if (n >= ((int64_t)1 << 31) - 16) return -1; /* int32 index positions */
    const int prof = getenv("CNIIC_ZB_PROF") != NULL; /* phase timing probe */
    zb_prof = prof;
    double t0 = prof ? zb_now() : 0.0;
    PosIndex ix6 = {0};
    Buf b;
    if (!posindex_build(&ix6, in, n, ZB_MINREP) ||
        !buf_init(&b, n / 2 + 64)) {
        posindex_destroy(&ix6);
        return -1;
    }
    double t1 = prof ? zb_now() : 0.0;
    int64_t n_queries = 0;

    int64_t pos = 0;
    int64_t exp_start = 0, exp_len = 0; /* current explicit run = in[exp_start..+exp_len) */
    int ok = 1;

    while (ok) {
        int64_t back;
        n_queries++;
        int64_t mlen = best_match(&ix6, in, n, pos, &back);
        if (mlen >= ZB_MINREP) {
            /* flush explicit, then the lookback (back.rs:188-199) */
            if (exp_len > 0) {
                ok = buf_push_u16le(&b, (uint16_t)exp_len) && buf_push_all(&b, in + exp_start, exp_len);
                exp_len = 0;
            }
            if (ok) {
                ok = buf_push_u16le(&b, (uint16_t)(mlen | 0x8000)) &&
                     buf_push_u16le(&b, (uint16_t)back);
                pos += mlen;
            }
        } else {
            /* extend explicit by doubling (back.rs:163-186); cap at 15 bits */
            int64_t want = exp_len > 2 ? exp_len : 2;
            if (exp_len + want > ZB_MAXLEN) want = ZB_MAXLEN - exp_len;
            int64_t got = n - pos < want ? n - pos : want;
            if (exp_len == 0) exp_start = pos;
            pos += got;
            exp_len += got;
            if (exp_len == ZB_MAXLEN) {
                ok = buf_push_u16le(&b, (uint16_t)exp_len) &&
                     buf_push_all(&b, in + exp_start, exp_len);
                exp_len = 0;
            }
            if (got < want) { /* input depleted */
                if (exp_len > 0)
                    ok = ok && buf_push_u16le(&b, (uint16_t)exp_len) &&
                         buf_push_all(&b, in + exp_start, exp_len);
                break;
            }
        }
    }

    if (prof) {
        fprintf(stderr, "zb_prof: n=%lld index=%.3fs parse=%.3fs queries=%lld "
                "cand_steps=%lld (bl6=%lld) extends=%lld extend_bytes=%lld first6=%lld\n",
                (long long)n, t1 - t0, zb_now() - t1, (long long)n_queries,
                (long long)zb_cand_steps, (long long)zb_steps_bl6,
                (long long)zb_extends,
                (long long)zb_extend_bytes, (long long)zb_first6_steps);
        zb_cand_steps = zb_extends = zb_extend_bytes = zb_first6_steps = 0;
        zb_steps_bl6 = 0;
    }
    posindex_destroy(&ix6);
    if (!ok) { free(b.data); return -1; }
    *out = b.data;
    *out_len = b.len;
    return 0;
}

EXPORT int zip_back_decode(const uint8_t *in, int64_t n,
                           uint8_t **out, int64_t *out_len,
                           int64_t max_out) {
    /* The decode history is always the already-decoded output prefix, so
     * lookbacks copy straight out of the output buffer (len <= back, so the
     * source region never overlaps the destination). max_out > 0 caps the
     * decoded size (lookback copies expand up to ~8000x the input; see
     * zip_dict_decode) — returns -2 when exceeded. */
    Buf b;
    if (!buf_init(&b, n * 2 + 64)) return -1;
    int64_t pos = 0;
    int ok = 1;
    while (pos + 2 <= n && ok) {
        uint16_t word = (uint16_t)(in[pos] | (in[pos + 1] << 8));
        pos += 2;
        int64_t len = word & 0x7fff;
        if (word & 0x8000) {
            if (pos + 2 > n) { ok = 0; break; }
            uint16_t back = (uint16_t)(in[pos] | (in[pos + 1] << 8));
            pos += 2;
            int64_t start = b.len - (int64_t)back;
            if (start < 0 || len > (int64_t)back) { ok = 0; break; }
            if (max_out > 0 && b.len + len > max_out) { ok = -2; break; }
            if (!buf_reserve(&b, len)) { ok = 0; break; }
            memcpy(b.data + b.len, b.data + start, (size_t)len);
            b.len += len;
        } else {
            if (pos + len > n) { ok = 0; break; }
            if (max_out > 0 && b.len + len > max_out) { ok = -2; break; }
            if (!buf_push_all(&b, in + pos, len)) { ok = 0; break; }
            pos += len;
        }
    }
    if (ok != 1) { free(b.data); return ok == -2 ? -2 : -1; }
    *out = b.data;
    *out_len = b.len;
    return 0;
}

/* ------------------------------------------------------------------ */
/* 11-byte Rgb wire framing (ser.rs:210-222 quirk), hot on zip paths   */
/* ------------------------------------------------------------------ */

/* rgb: n*3 bytes -> out: n*11 bytes of [03 00 00 00 00 00 00 00 R G B] */
/* Permutation gather/scatter of 3-byte pixels (int64 row indices, the
 * dtype hilbert.scan_indices produces). gather: out[i] = rgb[perm[i]];
 * scatter: out[perm[i]] = rgb[i]. */
EXPORT void gather_rgb(const uint8_t *rgb, const int64_t *perm, int64_t n,
                       uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *s = rgb + 3 * perm[i];
        uint8_t *d = out + 3 * i;
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
    }
}

EXPORT void scatter_rgb(const uint8_t *rgb, const int64_t *perm, int64_t n,
                        uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *s = rgb + 3 * i;
        uint8_t *d = out + 3 * perm[i];
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
    }
}

/* Exact RLE over an RGB stream, emitting the reference's 12-byte records
 * in one pass: u8 count + the 11-byte Rgb wire quirk (hilbertc.rs:115-196
 * record loop with the count==255 cap, ser.rs:210-222 layout). Runs longer
 * than 255 split as 255,...,remainder. out must hold 12*n bytes; returns
 * the number of bytes written. */
/* Fused RGB->24-bit-key + histogram: identical output to hist_u32 over
 * pack_colors(pixels), but the key packing happens inline during the first
 * radix pass instead of materializing numpy temporaries on the host
 * (~10 ms/MP of pure array traffic saved). */
EXPORT int64_t hist_rgb(const uint8_t *rgb, int64_t n,
                        uint32_t *uniq, int64_t *counts, int32_t *inverse) {
    if (n <= 0) return 0;
    /* the stride sample reads packed colors straight from the RGB bytes,
     * so the radix regime never materializes the 4 MB/MP key array */
    int64_t ds = hist_sample_ds(NULL, rgb, NULL, n);
    if (ds <= 26000) {
        uint32_t *keys = (uint32_t *)esc_get(ESC_KEYS,
                                             (size_t)n * sizeof(uint32_t));
        if (keys) {
            for (int64_t i = 0; i < n; i++) {
                const uint8_t *p = rgb + 3 * i;
                keys[i] = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
            }
            int64_t u = hist_u32_hash(keys, NULL, NULL, n, ds,
                                      uniq, counts, inverse);
            if (u >= 0) return u;
        }
    }
    if (n <= ((int64_t)1 << 20))
        return hist_rgb24_radix_u32(rgb, n, uniq, counts, inverse);
    return hist_rgb24_radix(rgb, n, uniq, counts, inverse);
}

/* Packed diff keys for the delta codec (hilbertc.rs:442-445 semantics):
 * keys[i] = pack(scan[i] - scan[i-1] + 255) with an implicit [0,0,0]
 * predecessor; each channel delta lands in [0, 510] and packs into 9 bits. */
EXPORT void delta_keys(const uint8_t *scan, int64_t n, uint32_t *out) {
    int pr = 0, pg = 0, pb = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = scan + 3 * i;
        uint32_t dr = (uint32_t)(p[0] - pr + 255);
        uint32_t dg = (uint32_t)(p[1] - pg + 255);
        uint32_t db = (uint32_t)(p[2] - pb + 255);
        out[i] = (dr << 18) | (dg << 9) | db;
        pr = p[0];
        pg = p[1];
        pb = p[2];
    }
}

/* delta_keys fused with the curve gather: diff keys straight off
 * rgb[perm[i]] instead of materializing the 3n-byte scan first
 * (gather_rgb + delta_keys wrote and re-read it; this reads the image
 * once — unlike rle_frame_gather's run scan, the diff pass touches each
 * pixel exactly once, so there is nothing to re-read and no buffer pays
 * for itself). Identical output to delta_keys(gather_rgb(rgb, perm)) by
 * construction (same (d+255) 9-bit packing, hilbertc.rs:442-445);
 * pinned by tests. */
EXPORT void delta_keys_gather(const uint8_t *rgb, const int64_t *perm,
                              int64_t n, uint32_t *out) {
    int pr = 0, pg = 0, pb = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = rgb + 3 * perm[i];
        uint32_t dr = (uint32_t)(p[0] - pr + 255);
        uint32_t dg = (uint32_t)(p[1] - pg + 255);
        uint32_t db = (uint32_t)(p[2] - pb + 255);
        out[i] = (dr << 18) | (dg << 9) | db;
        pr = p[0];
        pg = p[1];
        pb = p[2];
    }
}

/* MSB-first bit packer (bit.rs:209-253 semantics, zero-padded tail).
 * ids index the codebook; returns bytes written. ~2-3 ns/symbol with
 * the 64-bit block flush — measured
 * 20x the XLA segment-sum scatter path end-to-end on the bench host (TPU
 * scatters run ~30M elem/s, and the id upload disappears entirely), which
 * is why entropy coding lives on the host in this design (BENCH_NOTES.md).
 */
EXPORT int64_t pack_bits(const uint64_t *codes, const uint32_t *lens,
                         const int32_t *ids, int64_t n, uint8_t *out) {
    unsigned __int128 acc = 0;
    int nbits = 0;
    int64_t len_out = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t s = ids[i];
        uint32_t l = lens[s];
        acc = (acc << l) | codes[s];
        nbits += (int)l;
        if (nbits >= 64) {
            /* flush a whole 64-bit block with one byteswapped store
             * (MSB-first == big-endian byte order) instead of a per-byte
             * loop: 2.2-2.9x across alphabet profiles, byte-identical
             * (measured r4). acc stays < 2^127: nbits < 64 before the
             * append and l <= 63. */
            uint64_t be = __builtin_bswap64((uint64_t)(acc >> (nbits - 64)));
            memcpy(out + len_out, &be, 8);
            len_out += 8;
            nbits -= 64;
        }
    }
    while (nbits >= 8) {
        out[len_out++] = (uint8_t)(acc >> (nbits - 8));
        nbits -= 8;
    }
    if (nbits > 0)
        out[len_out++] = (uint8_t)((acc << (8 - nbits)) & 0xFF);
    return len_out;
}

EXPORT int64_t rle_frame(const uint8_t *rgb, int64_t n, uint8_t *out) {
    int64_t w = 0;
    int64_t i = 0;
    while (i < n) {
        uint8_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        int64_t j = i + 1;
        while (j < n && rgb[3 * j] == r && rgb[3 * j + 1] == g && rgb[3 * j + 2] == b)
            j++;
        int64_t len = j - i;
        while (len > 0) {
            int64_t c = len > 255 ? 255 : len;
            out[w] = (uint8_t)c;
            out[w + 1] = 3;
            memset(out + w + 2, 0, 7);
            out[w + 9] = r;
            out[w + 10] = g;
            out[w + 11] = b;
            w += 12;
            len -= c;
        }
        i = j;
    }
    return w;
}

/* rle_frame fused with the curve gather: RLE directly over rgb[perm[i]]
 * instead of materializing the 3n-byte scan first (gather_rgb + rle_frame
 * wrote and re-read it; this reads the image once — the scan locality of
 * the curve keeps the random reads cache-resident). Byte-identical output
 * to rle_frame(gather_rgb(rgb, perm)) by construction (same record loop,
 * hilbertc.rs:115-196 + ser.rs:210-222); pinned by tests. */
EXPORT int64_t rle_frame_gather(const uint8_t *rgb, const int64_t *perm,
                                int64_t n, uint8_t *out) {
    if (n <= 0) return 0;
    /* stage 1: gather the scan into a private buffer with 5 bytes of
     * sentinel slack so stage 2 can use unaligned u32 loads (1 load + 1
     * compare per pixel vs 3+3 byte-wise — ~2x the whole leg, measured) */
    uint8_t *scan = (uint8_t *)malloc((size_t)(3 * n + 8));
    if (!scan) {
        /* fallback: byte-wise compares straight off the image */
        int64_t w = 0, i = 0;
        while (i < n) {
            const uint8_t *p = rgb + 3 * perm[i];
            uint8_t r = p[0], g = p[1], b = p[2];
            int64_t j = i + 1;
            for (; j < n; j++) {
                const uint8_t *q = rgb + 3 * perm[j];
                if (q[0] != r || q[1] != g || q[2] != b) break;
            }
            int64_t len = j - i;
            while (len > 0) {
                int64_t c = len > 255 ? 255 : len;
                out[w] = (uint8_t)c;
                out[w + 1] = 3;
                memset(out + w + 2, 0, 7);
                out[w + 9] = r;
                out[w + 10] = g;
                out[w + 11] = b;
                w += 12;
                len -= c;
            }
            i = j;
        }
        return w;
    }
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *s = rgb + 3 * perm[i];
        uint8_t *d = scan + 3 * i;
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
    }
    /* sentinel pixel != last pixel ends the final run exactly at n */
    scan[3 * n] = (uint8_t)(scan[3 * n - 3] + 1);
    scan[3 * n + 1] = 0;
    scan[3 * n + 2] = 0;
    scan[3 * n + 3] = 0;
    scan[3 * n + 4] = 0;

    int64_t w = 0, i = 0;
    while (i < n) {
        uint32_t cur;
        memcpy(&cur, scan + 3 * i, 4);
        cur &= 0xFFFFFFu;
        int64_t j = i + 1;
        for (;;) {
            uint32_t v;
            memcpy(&v, scan + 3 * j, 4);
            if ((v & 0xFFFFFFu) != cur) break;
            j++;
        }
        int64_t len = j - i;
        uint8_t r = (uint8_t)cur, g = (uint8_t)(cur >> 8),
                b = (uint8_t)(cur >> 16);
        while (len > 0) {
            int64_t c = len > 255 ? 255 : len;
            out[w] = (uint8_t)c;
            out[w + 1] = 3;
            memset(out + w + 2, 0, 7);
            out[w + 9] = r;
            out[w + 10] = g;
            out[w + 11] = b;
            w += 12;
            len -= c;
        }
        i = j;
    }
    free(scan);
    return w;
}

/* RGB palette gather: out[i] = colors[ids[i]] for (u, 3) u8 colors.
 * numpy's row fancy-index ran at 13 ms/MP — 40% of the whole hufman
 * decode (measured r4); this loop streams it in ~2 ms. ids must be
 * in-range (they come from huf_decode, bounded by the parsed tree).
 * Sibling of gather_rgb (int64 curve permutations) and gather_i32: the
 * index width is deliberate — decoder ids are int32, and widening a
 * megapixel id array would cost more than the gather. Any hardening
 * applied to one of the three gathers belongs on all of them. */
EXPORT void palette_gather_rgb(const int32_t *ids, const uint8_t *colors,
                               int64_t n, uint8_t *out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *c = colors + 3 * (int64_t)ids[i];
        out[3 * i] = c[0];
        out[3 * i + 1] = c[1];
        out[3 * i + 2] = c[2];
    }
}

/* Preorder Huffman tree serialization (huf.rs:296-321 layout): per node a
 * tag byte (1=branch, 0=leaf), leaves followed by their payload record.
 * tags are the preorder tag sequence; leaf_sym maps the i-th preorder
 * leaf to its payload row. One C sweep — the numpy 2-D fancy scatter this
 * replaces cost 3.5 ms/46k-leaf tree (measured r4). Returns bytes
 * written (n_nodes + n_leaves*leaf_size). */
EXPORT int64_t huf_tree_serialize(const uint8_t *tags, int64_t n_nodes,
                                  const int32_t *leaf_sym,
                                  const uint8_t *payloads, int64_t leaf_size,
                                  uint8_t *out) {
    int64_t w = 0, leaf_i = 0;
    for (int64_t i = 0; i < n_nodes; i++) {
        uint8_t t = tags[i];
        out[w++] = t;
        if (t == 0) {
            memcpy(out + w, payloads + (int64_t)leaf_sym[leaf_i] * leaf_size,
                   (size_t)leaf_size);
            w += leaf_size;
            leaf_i++;
        }
    }
    return w;
}

/* i32 table gather: out[i] = table[idx[i]] (the palette-id resolution of
 * the cluster-colors encoder; numpy's 1-D fancy-index ran 4 ms/MP). */
EXPORT void gather_i32(const int32_t *idx, const int32_t *table, int64_t n,
                       int32_t *out) {
    for (int64_t i = 0; i < n; i++) out[i] = table[idx[i]];
}

/* Sum of squared byte differences over n bytes (the round-trip MSE of
 * bench.rs:95-104 before the per-pixel division). Exact in u64: worst
 * case 255^2 * n overflows only past n ~ 2^47 bytes. The numpy chain it
 * replaces (two int64 casts, subtract, float64 square, sum) measured
 * 32.6 ms/MP on this host — a ~30 MP/s ceiling that sat inside every
 * per-image verification; this loop auto-vectorizes and runs at memory
 * bandwidth. */
EXPORT uint64_t mse_sum_u8(const uint8_t *a, const uint8_t *b, int64_t n) {
    uint64_t tot = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t d = (int32_t)a[i] - (int32_t)b[i];
        tot += (uint64_t)(d * d);
    }
    return tot;
}

/* (count, color) record list -> 12-byte RLE wire records (the framing
 * tail of the approx-RLE encoders; the column-wise numpy assembly cost
 * 8.2 ms/MP at DIV2K-scale record counts, this loop ~1 ms). */
EXPORT void rle_records_frame(const uint8_t *counts, const uint8_t *colors,
                              int64_t r, uint8_t *out) {
    for (int64_t i = 0; i < r; i++) {
        out[0] = counts[i];
        out[1] = 3;
        memset(out + 2, 0, 7);
        out[9] = colors[3 * i];
        out[10] = colors[3 * i + 1];
        out[11] = colors[3 * i + 2];
        out += 12;
    }
}

EXPORT void rgb_frame(const uint8_t *rgb, int64_t n, uint8_t *out) {
    static const uint8_t prefix[8] = {3, 0, 0, 0, 0, 0, 0, 0};
    for (int64_t i = 0; i < n; i++) {
        memcpy(out, prefix, 8);
        out[8] = rgb[0];
        out[9] = rgb[1];
        out[10] = rgb[2];
        out += 11;
        rgb += 3;
    }
}

/* Fused delta decode (VERDICT r3 #3a): Huffman ids -> leaf-diff gather ->
 * 3-channel running sum -> u8 range check -> inverse-curve scatter, one
 * pass (reference decode semantics: hilbertc.rs:482-509 walk + the
 * ser.rs:188-195 3 x i16 LE leaf layout). Replaces the numpy chain
 * (diffs[ids] gather, per-channel cumsum, min/max scan, separate C
 * scatter) that was the decode floor at 28.6 MP/s.
 *
 * payloads: m 6-byte leaves (i16 LE per channel, biased diffs already
 * removed by the encoder: values are the signed deltas). ids: n symbol
 * indices. perm: scan->row-major flat positions (scan_indices). out:
 * 3*n bytes, fully written on success.
 * Returns 0; -1 on an id out of range; -2 when a running sum leaves
 * [0, 255] (corrupt stream). */
EXPORT int delta_unpack(const uint8_t *payloads, int64_t m,
                        const int32_t *ids, int64_t n,
                        const int64_t *perm, uint8_t *out) {
    int32_t r = 0, g = 0, b = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t s = ids[i];
        if (s < 0 || (int64_t)s >= m) return -1;
        const uint8_t *p = payloads + 6 * (int64_t)s;
        r += (int16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
        g += (int16_t)((uint16_t)p[2] | ((uint16_t)p[3] << 8));
        b += (int16_t)((uint16_t)p[4] | ((uint16_t)p[5] << 8));
        if ((uint32_t)r > 255u || (uint32_t)g > 255u || (uint32_t)b > 255u)
            return -2;
        uint8_t *d = out + 3 * perm[i];
        d[0] = (uint8_t)r;
        d[1] = (uint8_t)g;
        d[2] = (uint8_t)b;
    }
    return 0;
}

/* Fused RLE decode (VERDICT r3 #3b): validate the 12-byte records, expand
 * each run and scatter it through the inverse curve in one pass
 * (hilbertc.rs:59-113 decode + ser.rs:210-222 record layout). Replaces
 * np.repeat + separate scatter (38 MP/s floor). Extra records beyond n
 * pixels are still fully validated (the numpy path checked every prefix),
 * their pixels dropped — the reference's scan[:n] truncation.
 * Returns 0; -1 on a corrupt Rgb prefix; -2 when the records cover fewer
 * than n pixels. */
EXPORT int rle_unframe_scatter(const uint8_t *recs, int64_t nrec,
                               const int64_t *perm, int64_t n,
                               uint8_t *out) {
    static const uint8_t prefix[8] = {3, 0, 0, 0, 0, 0, 0, 0};
    int64_t pos = 0;
    for (int64_t i = 0; i < nrec; i++) {
        const uint8_t *rec = recs + 12 * i;
        if (memcmp(rec + 1, prefix, 8) != 0) return -1;
        int64_t c = rec[0];
        uint8_t r = rec[9], g = rec[10], b = rec[11];
        if (c > n - pos) c = n - pos; /* reference truncates at n */
        for (int64_t k = 0; k < c; k++) {
            uint8_t *d = out + 3 * perm[pos + k];
            d[0] = r;
            d[1] = g;
            d[2] = b;
        }
        pos += c;
    }
    if (pos < n) return -2;
    return 0;
}

/* inverse; returns 0, or -1 if any length prefix is corrupt */
EXPORT int rgb_unframe(const uint8_t *framed, int64_t n, uint8_t *rgb) {
    static const uint8_t prefix[8] = {3, 0, 0, 0, 0, 0, 0, 0};
    for (int64_t i = 0; i < n; i++) {
        if (memcmp(framed, prefix, 8) != 0) return -1;
        rgb[0] = framed[8];
        rgb[1] = framed[9];
        rgb[2] = framed[10];
        framed += 11;
        rgb += 3;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* u32 key histogram (count_freqs analog, reference utils.rs:4-16):      */
/* hash for low-unique streams, LSD radix + boundary pass otherwise      */
/* ------------------------------------------------------------------ */

/* Radix path: 12-bit LSD passes over (key, index) pairs packed in u64,
 * then one boundary pass.
 *
 * keys: n values. Outputs (caller-allocated, size n): uniq (ascending),
 * counts, inverse. Returns the number of unique values, or -1 on OOM.
 */
static int64_t hist_u32_radix(const uint32_t *keys, int64_t n,
                              uint32_t *uniq, int64_t *counts,
                              int32_t *inverse) {
    uint64_t *a = (uint64_t *)esc_get(ESC_PAIR_A, (size_t)n * sizeof(uint64_t));
    uint64_t *b = (uint64_t *)esc_get(ESC_PAIR_B, (size_t)n * sizeof(uint64_t));
    /* 12-bit digits: 24-bit color keys sort in 2 passes instead of 3 and
     * the 4096-counter table still lives in L1. (Wider digits measured a
     * wash: 2 x 14-bit over the delta codec's 27-bit keys saved a pass
     * but the 16K-way scatter lost the saving — BENCH_NOTES r4.) */
    int64_t *hist = (int64_t *)esc_get(ESC_H16, 4096 * sizeof(int64_t));
    if (!a || !b || !hist) return -1;

    uint32_t all_or = 0;
    for (int64_t i = 0; i < n; i++) {
        a[i] = ((uint64_t)keys[i] << 32) | (uint64_t)(uint32_t)i;
        all_or |= keys[i];
    }
    int passes = all_or > 0xFFFFFF ? 3 : (all_or > 0xFFF ? 2 : 1);

    for (int p = 0; p < passes; p++) {
        int shift = 32 + 12 * p;
        memset(hist, 0, 4096 * sizeof(int64_t));
        for (int64_t i = 0; i < n; i++) hist[(a[i] >> shift) & 0xFFF]++;
        int64_t sum = 0;
        for (int j = 0; j < 4096; j++) { int64_t c = hist[j]; hist[j] = sum; sum += c; }
        for (int64_t i = 0; i < n; i++) b[hist[(a[i] >> shift) & 0xFFF]++] = a[i];
        uint64_t *t = a; a = b; b = t;
    }

    int64_t u = 0;
    uint32_t prev = ~(uint32_t)(a[0] >> 32); /* anything != first key */
    for (int64_t i = 0; i < n; i++) {
        uint32_t k = (uint32_t)(a[i] >> 32);
        if (k != prev) {
            uniq[u] = k;
            counts[u] = 0;
            u++;
            prev = k;
        }
        counts[u - 1]++;
        inverse[(uint32_t)a[i]] = (int32_t)(u - 1);
    }
    return u;
}

/* 24-bit-key histogram for RGB streams in the radix regime: one MSD
 * scatter by the high 12 bits, then per-bucket low-12 counting with a
 * bitmap ascent — one full materialize+scatter pass fewer than the
 * generic 2-pass LSD above, with the (key,pos) pairs built straight
 * from the RGB bytes (the 4 MB/MP key materialization disappears).
 * The per-bucket tables (16 KB counts + 16 KB ranks + 512 B bitmap)
 * stay L1-resident. Output identical to hist_u32 over packed keys:
 * uniq ascending, counts, inverse = ascending-key rank per pixel. */
static int64_t hist_rgb24_radix(const uint8_t *rgb, int64_t n,
                                uint32_t *uniq, int64_t *counts,
                                int32_t *inverse) {
    uint64_t *a = (uint64_t *)esc_get(ESC_PAIR_A, (size_t)n * sizeof(uint64_t));
    int64_t *off = (int64_t *)esc_get(ESC_H16, 2 * 4097 * sizeof(int64_t));
    if (!a || !off) return -1;
    int64_t *bstart = off + 4097;
    memset(off, 0, 4097 * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = rgb + 3 * i;
        uint32_t hi = ((uint32_t)p[0] << 4) | (p[1] >> 4); /* key >> 12 */
        off[hi + 1]++;
    }
    for (int j = 0; j < 4096; j++) off[j + 1] += off[j];
    memcpy(bstart, off, 4097 * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = rgb + 3 * i;
        uint32_t k = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
        a[off[k >> 12]++] = ((uint64_t)k << 32) | (uint32_t)i;
    }
    /* u32 per-bucket counts cannot wrap: positions are stored as u32, so
     * n (and any per-key count) is < 2^32 */
    uint32_t cnt12[4096];
    int32_t rank12[4096];
    uint64_t bitmap[64];
    memset(cnt12, 0, sizeof cnt12);
    memset(bitmap, 0, sizeof bitmap);
    int64_t u = 0;
    for (int b = 0; b < 4096; b++) {
        int64_t s = bstart[b], e = bstart[b + 1];
        if (s == e) continue;
        for (int64_t j = s; j < e; j++) {
            uint32_t low = (uint32_t)(a[j] >> 32) & 0xFFF;
            if (cnt12[low]++ == 0)
                bitmap[low >> 6] |= (uint64_t)1 << (low & 63);
        }
        uint32_t base = (uint32_t)b << 12;
        for (int w = 0; w < 64; w++) {
            uint64_t bits = bitmap[w];
            while (bits) {
                int t = __builtin_ctzll(bits);
                bits &= bits - 1;
                uint32_t low = (uint32_t)((w << 6) | t);
                uniq[u] = base | low;
                counts[u] = cnt12[low];
                rank12[low] = (int32_t)u;
                cnt12[low] = 0;
                u++;
            }
            bitmap[w] = 0;
        }
        for (int64_t j = s; j < e; j++)
            inverse[(uint32_t)a[j]] = rank12[(uint32_t)(a[j] >> 32) & 0xFFF];
    }
    return u;
}

/* u32-pair variant of hist_rgb24_radix for n <= 2^20 pixels (every
 * 1024x1024 bench/corpus image, and anything smaller): the scattered
 * (low12, pos) pair packs into one u32 (low12 << 20 | pos), halving the
 * write bandwidth of the MSD scatter and the read bandwidth of the
 * per-bucket pass — the two passes that dominate the radix regime on
 * this host (measured r5: 17.5-22 ms/MP at ~400k uniques with u64
 * pairs). Output bit-identical to hist_rgb24_radix (tests pin it). */
static int64_t hist_rgb24_radix_u32(const uint8_t *rgb, int64_t n,
                                    uint32_t *uniq, int64_t *counts,
                                    int32_t *inverse) {
    uint32_t *a = (uint32_t *)esc_get(ESC_PAIR_A, (size_t)n * sizeof(uint32_t));
    int64_t *off = (int64_t *)esc_get(ESC_H16, 2 * 4097 * sizeof(int64_t));
    if (!a || !off) return -1;
    int64_t *bstart = off + 4097;
    memset(off, 0, 4097 * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = rgb + 3 * i;
        uint32_t hi = ((uint32_t)p[0] << 4) | (p[1] >> 4); /* key >> 12 */
        off[hi + 1]++;
    }
    for (int j = 0; j < 4096; j++) off[j + 1] += off[j];
    memcpy(bstart, off, 4097 * sizeof(int64_t));
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = rgb + 3 * i;
        uint32_t hi = ((uint32_t)p[0] << 4) | (p[1] >> 4);
        uint32_t low = (((uint32_t)p[1] & 0xF) << 8) | p[2];
        a[off[hi]++] = (low << 20) | (uint32_t)i;
    }
    uint32_t cnt12[4096];
    int32_t rank12[4096];
    uint64_t bitmap[64];
    memset(cnt12, 0, sizeof cnt12);
    memset(bitmap, 0, sizeof bitmap);
    int64_t u = 0;
    for (int b = 0; b < 4096; b++) {
        int64_t s = bstart[b], e = bstart[b + 1];
        if (s == e) continue;
        for (int64_t j = s; j < e; j++) {
            uint32_t low = a[j] >> 20;
            if (cnt12[low]++ == 0)
                bitmap[low >> 6] |= (uint64_t)1 << (low & 63);
        }
        uint32_t base = (uint32_t)b << 12;
        for (int w = 0; w < 64; w++) {
            uint64_t bits = bitmap[w];
            while (bits) {
                int t = __builtin_ctzll(bits);
                bits &= bits - 1;
                uint32_t low = (uint32_t)((w << 6) | t);
                uniq[u] = base | low;
                counts[u] = cnt12[low];
                rank12[low] = (int32_t)u;
                cnt12[low] = 0;
                u++;
            }
            bitmap[w] = 0;
        }
        for (int64_t j = s; j < e; j++)
            inverse[a[j] & 0xFFFFF] = rank12[a[j] >> 20];
    }
    return u;
}

/* Single-pass open-addressing histogram with ADAPTIVE table sizing.
 * Slot layout: key<<32 | (provisional_id + 1); 0 = empty. The provisional
 * ids are assigned in first-appearance order, then remapped to ascending-
 * key rank so the output (uniq asc, counts, inverse) is bit-identical to
 * the radix path. Returns -2 when the stream is not hash-friendly (too
 * many uniques — the streaming radix wins there).
 *
 * r5 re-measurement: the r4 single-tier table (2^16 slots, bail at 16k
 * uniques) assumed a 512 KB L2; this host has a 2 MB L2 + large L3, and a
 * probe over real key streams (BENCH_NOTES "adaptive hash histogram")
 * measured, vs the radix path, per 1 MP:
 *   10k uniques (delta diffs):   3.5 ms vs 23.6   (2^17 slots)
 *   47k uniques (hufman colors): 5.1 ms vs 16.4   (2^19)
 *   99k / 184k / 250k uniques:   12 / 17 / 20 vs ~22-25  (2^19-2^20)
 *   323k / 615k uniques:         24 / 30 vs ~23   (radix wins)
 * Crossover ~300k uniques. The stride-sample's distinct count (ds of
 * 32768) discriminates the regimes (measured: 4.2k / 15.5k / 21.2k /
 * 23.9k / 25.4k / 26.6k / 32.0k for the streams above), so the tier is
 * chosen from ds and the in-pass unique cap stays as the backstop for
 * sample under-estimates (a bailed pass costs a bounded partial scan).
 */
/* Stride-sample distinct count (32768 even-spread probes). keys==NULL
 * fetches 24-bit packed colors from rgb instead, so the caller can pick
 * an engine before materializing any key array. Returns the sample's
 * distinct count, early-exited past 26000 (radix regime certain — this
 * also bounds the sample table's load at 26000/2^15 = 79% so its own
 * linear probing never degenerates near full). */
static int64_t hist_sample_ds(const uint32_t *keys, const uint8_t *rgb,
                              const int64_t *perm, int64_t n) {
    int64_t sn = n < 32768 ? n : 32768;
    enum { SLG = 15 };
    /* u64 slots so the k+1 "occupied" sentinel cannot wrap to the empty
     * marker for key 0xFFFFFFFF */
    uint64_t *stab = (uint64_t *)esc_get(ESC_STAB,
                                         ((size_t)1 << SLG) * sizeof(uint64_t));
    if (!stab) return 26001; /* treat alloc failure as the radix regime */
    memset(stab, 0, ((size_t)1 << SLG) * sizeof(uint64_t));
    const uint32_t smask = ((uint32_t)1 << SLG) - 1;
    int64_t ds = 0;
    for (int64_t s = 0; s < sn; s++) {
        int64_t idx = (s * n) / sn;  /* even spread over the stream */
        uint32_t k;
        if (keys) {
            k = keys[idx];
        } else if (perm) {
            /* delta diff key at scan position idx, computed in place */
            const uint8_t *p = rgb + 3 * perm[idx];
            int pr = 0, pg = 0, pb = 0;
            if (idx > 0) {
                const uint8_t *q = rgb + 3 * perm[idx - 1];
                pr = q[0]; pg = q[1]; pb = q[2];
            }
            k = ((uint32_t)(p[0] - pr + 255) << 18) |
                ((uint32_t)(p[1] - pg + 255) << 9) |
                (uint32_t)(p[2] - pb + 255);
        } else {
            const uint8_t *p = rgb + 3 * idx;
            k = ((uint32_t)p[0] << 16) | ((uint32_t)p[1] << 8) | p[2];
        }
        /* multiplicative hashing must take the HIGH product bits: the low
         * bits are a permutation of k mod 2^SLG, and structured keys
         * (delta diffs) collide there en masse (measured 6.3 probes/elem
         * vs 1.04 with the shift) */
        uint32_t h = (uint32_t)(k * 2654435761u) >> (32 - SLG);
        uint64_t want = (uint64_t)k + 1;
        for (;;) {
            uint64_t v = stab[h];
            if (!v) { stab[h] = want; ds++; break; }
            if (v == want) break;
            h = (h + 1) & smask;
        }
        if (ds > 26000) return ds; /* radix regime certain */
    }
    return ds;
}

static int64_t hist_u32_hash(const uint32_t *keys, const uint8_t *rgb,
                             const int64_t *perm, int64_t n, int64_t ds,
                             uint32_t *uniq, int64_t *counts,
                             int32_t *inverse) {
    /* tier choice (measured thresholds above; ucap keeps worst-case load
     * <= ~38% except the top tier, capped at the ~300k crossover) */
    int tlg;
    int64_t ucap;
    if (ds > 26000) return -2;                       /* radix regime */
    else if (ds > 20000) { tlg = 20; ucap = 300000; }
    else if (ds > 8000)  { tlg = 19; ucap = 196608; }
    else                 { tlg = 17; ucap = 49152; }
    if (ucap > n) ucap = n;                          /* u can never exceed n */

    uint64_t *tab = (uint64_t *)esc_get(ESC_HTAB,
                                        ((size_t)1 << tlg) * sizeof(uint64_t));
    /* ucnt first so both halves stay 8-aligned */
    int64_t *ucnt = (int64_t *)esc_get(ESC_UKC, (size_t)ucap * 12);
    if (!tab || !ucnt) return -2;
    uint32_t *ukey = (uint32_t *)(ucnt + ucap);
    memset(tab, 0, ((size_t)1 << tlg) * sizeof(uint64_t));
    const uint32_t tmask = ((uint32_t)1 << tlg) - 1;
    const int tshift = 32 - tlg;
    int64_t u = 0;
    int pr = 0, pg = 0, pb = 0; /* delta predecessor (perm mode) */
    for (int64_t i = 0; i < n; i++) {
        uint32_t k;
        if (keys) {
            k = keys[i];
        } else {
            const uint8_t *p = rgb + 3 * perm[i];
            k = ((uint32_t)(p[0] - pr + 255) << 18) |
                ((uint32_t)(p[1] - pg + 255) << 9) |
                (uint32_t)(p[2] - pb + 255);
            pr = p[0]; pg = p[1]; pb = p[2];
        }
        uint32_t h = (uint32_t)(k * 2654435761u) >> tshift;
        for (;;) {
            uint64_t s = tab[h];
            if (!s) {
                if (u == ucap) return -2;  /* sample under-estimated: bail */
                tab[h] = ((uint64_t)k << 32) | (uint32_t)(u + 1);
                ukey[u] = k;
                ucnt[u] = 1;
                inverse[i] = (int32_t)u;
                u++;
                break;
            }
            if ((uint32_t)(s >> 32) == k) {
                int32_t id = (int32_t)(uint32_t)s - 1;
                ucnt[id]++;
                inverse[i] = id;
                break;
            }
            h = (h + 1) & tmask;
        }
    }
    /* remap provisional (first-appearance) ids to ascending-key rank via
     * a 2x16-bit LSD radix sort of (key<<32 | prov) — qsort at 46k+
     * uniques costs whole milliseconds, the radix is two linear passes */
    uint64_t *sk = (uint64_t *)esc_get(ESC_SKA, (size_t)u * sizeof(uint64_t));
    uint64_t *sb = (uint64_t *)esc_get(ESC_SKB, (size_t)u * sizeof(uint64_t));
    int64_t *h16 = (int64_t *)esc_get(ESC_H16, 65536 * sizeof(int64_t));
    int32_t *rank = (int32_t *)esc_get(ESC_RANK, (size_t)u * sizeof(int32_t));
    if (!sk || !sb || !h16 || !rank) return -2;
    for (int64_t j = 0; j < u; j++)
        sk[j] = ((uint64_t)ukey[j] << 32) | (uint32_t)j;
    for (int p = 0; p < 2; p++) {
        int shift = 32 + 16 * p;
        memset(h16, 0, 65536 * sizeof(int64_t));
        for (int64_t j = 0; j < u; j++) h16[(sk[j] >> shift) & 0xFFFF]++;
        int64_t sum = 0;
        for (int j = 0; j < 65536; j++) { int64_t c = h16[j]; h16[j] = sum; sum += c; }
        for (int64_t j = 0; j < u; j++) sb[h16[(sk[j] >> shift) & 0xFFFF]++] = sk[j];
        uint64_t *t = sk; sk = sb; sb = t;
    }
    for (int64_t j = 0; j < u; j++) {
        uint32_t prov = (uint32_t)sk[j];
        rank[prov] = (int32_t)j;
        uniq[j] = (uint32_t)(sk[j] >> 32);
        counts[j] = ucnt[prov];
    }
    for (int64_t i = 0; i < n; i++) inverse[i] = rank[inverse[i]];
    return u;
}

/* Unique values, counts, inverse — dispatcher: hash for low-unique
 * streams (delta diff keys, palette-heavy images), LSD radix otherwise.
 * Both paths produce identical output. */
EXPORT int64_t hist_u32(const uint32_t *keys, int64_t n,
                        uint32_t *uniq, int64_t *counts, int32_t *inverse) {
    if (n <= 0) return 0;
    int64_t ds = hist_sample_ds(keys, NULL, NULL, n);
    if (ds <= 26000) {
        int64_t u = hist_u32_hash(keys, NULL, NULL, n, ds,
                                  uniq, counts, inverse);
        if (u >= 0) return u;
    }
    return hist_u32_radix(keys, n, uniq, counts, inverse);
}

/* Fully fused delta-encode statistics: curve gather + diff + pack +
 * histogram in one pass — the 4n-byte key array is never materialized
 * in the hash regime (sample and count both compute diff keys straight
 * off rgb[perm[i]]). Identical output to
 * hist_u32(delta_keys(gather_rgb(rgb, perm))) by construction; pinned by
 * tests. High-unique streams (ds > 26000 or a hash bail) fall back to
 * materializing the keys once into scratch and running the LSD radix. */
EXPORT int64_t delta_hist_gather(const uint8_t *rgb, const int64_t *perm,
                                 int64_t n, uint32_t *uniq, int64_t *counts,
                                 int32_t *inverse) {
    if (n <= 0) return 0;
    int64_t ds = hist_sample_ds(NULL, rgb, perm, n);
    if (ds <= 26000) {
        int64_t u = hist_u32_hash(NULL, rgb, perm, n, ds,
                                  uniq, counts, inverse);
        if (u >= 0) return u;
    }
    uint32_t *keys = (uint32_t *)esc_get(ESC_KEYS,
                                         (size_t)n * sizeof(uint32_t));
    if (!keys) return -1;
    delta_keys_gather(rgb, perm, n, keys);
    return hist_u32_radix(keys, n, uniq, counts, inverse);
}

/* ------------------------------------------------------------------ */
/* Huffman: build, canonical codes, preorder tree (reference huf.rs)   */
/* ------------------------------------------------------------------ */

/* Optimal code lengths via the two-queue method over frequencies sorted
 * ascending. Any optimal Huffman code has the same total payload length
 * (sum freq*len), so compressed sizes match the reference's heap-built
 * trees exactly up to final-byte padding; we pin a deterministic canonical
 * tree (huf.rs:58-117 builds the same-cost tree with BinaryHeap ordering).
 *
 * freqs: u sorted ascending. out lens[u]. Returns 0 / -1.
 */
EXPORT int huf_lengths(const uint64_t *freqs, int64_t u, uint32_t *lens) {
    if (u <= 0) return -1;
    if (u == 1) { lens[0] = 0; return 0; }
    int64_t nn = 2 * u - 1;
    uint64_t *w = (uint64_t *)esc_get(ESC_TW, (size_t)nn * sizeof(uint64_t));
    /* l and r share one slot (contiguous halves) */
    int32_t *l = (int32_t *)esc_get(ESC_TLR, (size_t)nn * 2 * sizeof(int32_t));
    uint32_t *depth = (uint32_t *)esc_get(ESC_TD, (size_t)nn * sizeof(uint32_t));
    if (!w || !l || !depth) return -1;
    int32_t *r = l + nn;
    memcpy(w, freqs, (size_t)u * sizeof(uint64_t));

    int64_t leaf_head = 0;            /* queue 1: leaves (sorted) */
    int64_t int_head = u, int_tail = u; /* queue 2: internal nodes */

    for (int64_t made = 0; made < u - 1; made++) {
        int32_t picks[2];
        for (int k = 0; k < 2; k++) {
            int take_leaf;
            if (leaf_head >= u) take_leaf = 0;
            else if (int_head >= int_tail) take_leaf = 1;
            else take_leaf = w[leaf_head] <= w[int_head]; /* tie: prefer leaf */
            picks[k] = (int32_t)(take_leaf ? leaf_head++ : int_head++);
        }
        w[int_tail] = w[picks[0]] + w[picks[1]];
        l[int_tail] = picks[0];
        r[int_tail] = picks[1];
        int_tail++;
    }
    /* root = nn-1; propagate depths top-down (children created before
     * parent). Every non-root node's depth is written by its parent
     * before it is read, so only the root needs initializing — no
     * full-array clear. */
    depth[nn - 1] = 0;
    for (int64_t i = nn - 1; i >= u; i--) {
        depth[l[i]] = depth[i] + 1;
        depth[r[i]] = depth[i] + 1;
    }
    for (int64_t i = 0; i < u; i++) lens[i] = depth[i];
    return 0;
}

/* Optimal code lengths from UNSORTED frequencies: a stable LSD radix
 * argsort (ascending; ties keep index order — exactly numpy's
 * argsort(kind='stable')) + the two-queue pass above + scatter back to
 * caller order. Replaces build_codebook's numpy argsort + gather +
 * scatter, which cost 13-16 ms/image at north-star alphabet sizes
 * (~400k symbols) vs ~2 ms here. Output is bit-identical by
 * construction (same stable order, same two-queue).
 * freqs: u64[u], any order. out lens: u32[u], caller order. 0 / -1. */
EXPORT int huf_lens_unsorted(const uint64_t *freqs, int64_t u,
                             uint32_t *lens) {
    if (u <= 0 || u > 0x7FFFFFFF) return -1;
    if (u == 1) { lens[0] = 0; return 0; }
    uint64_t *ka = (uint64_t *)esc_get(ESC_SKA, (size_t)u * sizeof(uint64_t));
    uint64_t *kb = (uint64_t *)esc_get(ESC_SKB, (size_t)u * sizeof(uint64_t));
    uint32_t *ia = (uint32_t *)esc_get(ESC_SIA, (size_t)u * sizeof(uint32_t));
    uint32_t *ib = (uint32_t *)esc_get(ESC_SIB, (size_t)u * sizeof(uint32_t));
    int64_t *h16 = (int64_t *)esc_get(ESC_H16, 65536 * sizeof(int64_t));
    uint32_t *ls = (uint32_t *)esc_get(ESC_LSORT, (size_t)u * sizeof(uint32_t));
    if (!ka || !kb || !ia || !ib || !h16 || !ls) return -1;
    uint64_t orv = 0, andv = ~(uint64_t)0;
    for (int64_t i = 0; i < u; i++) {
        ka[i] = freqs[i];
        ia[i] = (uint32_t)i;
        orv |= freqs[i];
        andv &= freqs[i];
    }
    /* a 16-bit digit position where every key agrees needs no pass;
     * image frequencies (<= pixel count) typically sort in 1-2 passes */
    uint64_t diff = orv ^ andv;
    for (int p = 0; p < 4; p++) {
        int shift = 16 * p;
        if (!((diff >> shift) & 0xFFFF)) continue;
        memset(h16, 0, 65536 * sizeof(int64_t));
        for (int64_t i = 0; i < u; i++) h16[(ka[i] >> shift) & 0xFFFF]++;
        int64_t sum = 0;
        for (int j = 0; j < 65536; j++) { int64_t c = h16[j]; h16[j] = sum; sum += c; }
        for (int64_t i = 0; i < u; i++) {
            int64_t d = h16[(ka[i] >> shift) & 0xFFFF]++;
            kb[d] = ka[i];
            ib[d] = ia[i];
        }
        uint64_t *tk = ka; ka = kb; kb = tk;
        uint32_t *ti = ia; ia = ib; ib = ti;
    }
    if (huf_lengths(ka, u, ls) != 0) return -1;
    for (int64_t j = 0; j < u; j++) lens[ia[j]] = ls[j];
    return 0;
}

/* Canonical codes + preorder tree from code lengths.
 *
 * lens[u]: code length per symbol (any order). Outputs:
 *   codes[u]   right-aligned canonical code bits (<= 63 bits),
 *   tags[2u-1] preorder node tags: 1 = branch, 0 = leaf (huf.rs:296-321),
 *   leaf_sym[u] symbol index of each leaf in preorder order.
 * Returns 0, or -1 on invalid input (lengths not a Kraft-complete set).
 */
EXPORT int huf_canonical(const uint32_t *lens, int64_t u,
                         uint64_t *codes, uint8_t *tags, int32_t *leaf_sym) {
    if (u <= 0) return -1;
    if (u == 1) {
        if (lens[0] != 0) return -1;
        codes[0] = 0;
        tags[0] = 0;
        leaf_sym[0] = 0;
        return 0;
    }
    /* order symbols by (len asc, index asc) via counting sort on len */
    uint32_t max_len = 0;
    for (int64_t i = 0; i < u; i++) {
        if (lens[i] == 0 || lens[i] > 63) return -1;
        if (lens[i] > max_len) max_len = lens[i];
    }
    int64_t cnt[65] = {0};  /* lens <= 63, so max_len + 2 <= 65 */
    int32_t *order = (int32_t *)esc_get(ESC_ORDER, (size_t)u * sizeof(int32_t));
    if (!order) return -1;
    for (int64_t i = 0; i < u; i++) cnt[lens[i] + 1]++;
    for (uint32_t d = 1; d <= max_len + 1; d++) cnt[d] += cnt[d - 1];
    for (int64_t i = 0; i < u; i++) order[cnt[lens[i]]++] = (int32_t)i;

    /* canonical assignment, shortest codes first */
    uint64_t code = 0;
    uint32_t prev_len = lens[order[0]];
    codes[order[0]] = 0;
    for (int64_t k = 1; k < u; k++) {
        uint32_t len = lens[order[k]];
        code = (code + 1) << (len - prev_len);
        codes[order[k]] = code;
        prev_len = len;
    }

    /* preorder walk of the canonical trie without materializing it:
     * leaves in `order` are already in left-to-right tree order. Standard
     * stack simulation over (leaf index, depth). */
    int64_t tag_pos = 0, leaf_pos = 0;
    int64_t k = 0;
    uint32_t cur_depth = 0;
    uint64_t path = 0; /* bits of current path, LSB = deepest */
    int ok = 1;
    while (k < u) {
        uint32_t len = lens[order[k]];
        if (len < cur_depth) { ok = 0; break; }
        /* descend: every level from cur_depth to len-1 is a branch */
        for (uint32_t d = cur_depth; d < len; d++) {
            if (tag_pos >= 2 * u - 1) { ok = 0; break; }
            tags[tag_pos++] = 1;
        }
        if (!ok) break;
        if (tag_pos >= 2 * u - 1) { ok = 0; break; }
        tags[tag_pos++] = 0;
        leaf_sym[leaf_pos++] = order[k];
        path = codes[order[k]];
        cur_depth = len;
        k++;
        /* backtrack: pop trailing 1-bits of the path */
        while (cur_depth > 0 && (path & 1)) {
            path >>= 1;
            cur_depth--;
        }
        if (cur_depth == 0 && k < u) { ok = 0; break; }
        /* next leaf will branch right at cur_depth-1; its code already
         * encodes that, nothing to emit (the branch tag was written when
         * we first descended through that level) */
    }
    if (!ok || leaf_pos != u || tag_pos != 2 * u - 1) return -1;
    return 0;
}

/* Count the nodes of a preorder-serialized trie without building tables.
 * The tag stream alone determines the structure: start expecting one node;
 * a branch tag adds two expected children, a leaf tag skips its payload.
 * Returns the node count (and sets *consumed) so the caller can allocate
 * the parse tables exactly — sizing them from the whole stream (tree +
 * payload) transiently cost ~20 bytes per stream byte on multi-MB streams.
 * -1 on malformed input (same acceptance set as huf_tree_parse). */
EXPORT int64_t huf_tree_count(const uint8_t *data, int64_t len,
                              int64_t leaf_size, int64_t *consumed) {
    int64_t pos = 0, n_nodes = 0, open = 1;
    while (open > 0) {
        if (pos >= len) return -1;
        uint8_t tag = data[pos++];
        open--;
        n_nodes++;
        if (tag == 1) {
            open += 2;
        } else if (tag == 0) {
            if (pos + leaf_size > len) return -1;
            pos += leaf_size;
        } else {
            return -1;
        }
    }
    *consumed = pos;
    return n_nodes;
}

/* Parse a preorder-serialized trie (tag byte 0=leaf/1=branch; leaves carry a
 * fixed-size payload; huf.rs:296-348). Outputs flattened node tables for
 * huf_decode plus the leaf payload bytes, copied out contiguously in
 * preorder during the same sweep (r5: the numpy offset-gather this
 * replaces cost ~20 ms/MP at north-star tree sizes — ~440k leaves × 11
 * bytes — vs <1 ms for the in-pass memcpy; the bytes are already in
 * cache when the tag scan passes them).
 *   left/right/symbol: caller-allocated, >= max_nodes entries
 *   payloads:          caller-allocated, >= ((max_nodes+1)/2)*leaf_size
 *                      bytes (one row per leaf; a walk of n nodes holds
 *                      <= (n+1)/2 leaves)
 * Returns number of nodes, and sets *consumed; -1 on malformed input. The
 * root is node 0. symbol[i] numbers leaves in preorder order.
 */
EXPORT int64_t huf_tree_parse(const uint8_t *data, int64_t len, int64_t leaf_size,
                              int32_t *left, int32_t *right, int32_t *symbol,
                              uint8_t *payloads, int64_t max_nodes,
                              int64_t *consumed) {
    int64_t pos = 0;
    int64_t n_nodes = 0, n_leaves = 0;
    /* stack of node ids whose right child is pending */
    int32_t *stack = (int32_t *)malloc((size_t)(max_nodes > 64 ? max_nodes : 64) * sizeof(int32_t));
    if (!stack) return -1;
    int64_t sp = 0;
    int32_t pending_parent = -1; /* node waiting for its LEFT child */

    for (;;) {
        if (pos >= len || n_nodes >= max_nodes) { free(stack); return -1; }
        uint8_t tag = data[pos++];
        int32_t me = (int32_t)n_nodes++;
        if (pending_parent >= 0) {
            left[pending_parent] = me;
            stack[sp++] = pending_parent; /* its right child comes later */
            pending_parent = -1;
        } else if (sp > 0) {
            right[stack[--sp]] = me;
        } else if (me != 0) {
            free(stack);
            return -1;
        }
        if (tag == 1) {
            left[me] = right[me] = -1; /* filled by children */
            symbol[me] = -1;
            pending_parent = me;
        } else if (tag == 0) {
            if (pos + leaf_size > len) { free(stack); return -1; }
            left[me] = right[me] = -1;
            symbol[me] = (int32_t)n_leaves;
            memcpy(payloads + n_leaves * leaf_size, data + pos,
                   (size_t)leaf_size);
            n_leaves++;
            pos += leaf_size;
            if (sp == 0 && pending_parent < 0) break; /* tree complete */
        } else {
            free(stack);
            return -1;
        }
    }
    free(stack);
    *consumed = pos;
    return n_nodes;
}

/* ------------------------------------------------------------------ */
/* approximate RLE (running average, reference hilbertc.rs:200-285)    */
/* ------------------------------------------------------------------ */

/* rgb: n*3 bytes in scan order. Emits (count u8, r, g, b) records:
 * out_counts[i], out_colors[3*i..]. Caller allocates n records.
 * Returns the record count. Exact f64 running-average semantics: a pixel is
 * accepted iff dist(avg, pixel) <= allow, the run caps at 255 including the
 * accepted pixel, and the emitted color is the rounded running average. */
/* The reference's f64 acceptance test (sqrt of the average-form distance,
 * hilbertc.rs:224-238) — the conformance definition, and the slow path. */
static inline int ar_accept_f64(int64_t s0, int64_t s1, int64_t s2,
                                int64_t count, int x0, int x1, int x2,
                                double allow) {
    double a0 = (double)s0 / (double)count;
    double a1 = (double)s1 / (double)count;
    double a2 = (double)s2 / (double)count;
    double d0 = a0 - (double)x0;
    double d1 = a1 - (double)x1;
    double d2 = a2 - (double)x2;
    return sqrt(d0 * d0 + d1 * d1 + d2 * d2) <= allow;
}

EXPORT int64_t approx_rle_encode(const uint8_t *rgb, int64_t n, double allow,
                                 uint8_t *out_counts, uint8_t *out_colors) {
    /* Integer fast path (r3, the wide-kernel argument applied to the host
     * engine): for integer allowances the acceptance test
     *   sum_c (S_c - count*x_c)^2 <= (allow*count)^2
     * is exact int arithmetic (terms <= 65025; clamping |t| at 16384 keeps
     * the sum < 2^31 and never flips a decision while allow <= 64 keeps
     * every threshold <= 16384^2), and the reference's f64 evaluation
     * provably agrees everywhere except EXACT ties — which fall back to
     * the f64 test itself. Byte-identical output, ~2x fewer cycles/pixel
     * (3 f64 divs + sqrt -> a handful of int ops). */
    const int32_t ai = (int32_t)allow;
    const int fast = (double)ai == allow && ai >= 0 && ai <= 64;
    int64_t nrec = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t sum0 = rgb[3 * i], sum1 = rgb[3 * i + 1], sum2 = rgb[3 * i + 2];
        int64_t count = 1;
        i++;
        while (i < n && count < 255) {
            const int x0 = rgb[3 * i], x1 = rgb[3 * i + 1], x2 = rgb[3 * i + 2];
            int accept;
            if (fast) {
                int64_t t0 = sum0 - count * x0;
                int64_t t1 = sum1 - count * x1;
                int64_t t2 = sum2 - count * x2;
                if (t0 < 0) t0 = -t0;
                if (t1 < 0) t1 = -t1;
                if (t2 < 0) t2 = -t2;
                if (t0 > 16384) t0 = 16384;
                if (t1 > 16384) t1 = 16384;
                if (t2 > 16384) t2 = 16384;
                const int64_t dist2 = t0 * t0 + t1 * t1 + t2 * t2;
                const int64_t ac = (int64_t)ai * count;
                const int64_t th = ac * ac;
                if (dist2 < th) accept = 1;
                else if (dist2 > th) accept = 0;
                else /* exact tie: defer to the reference's own f64 */
                    accept = ar_accept_f64(sum0, sum1, sum2, count,
                                           x0, x1, x2, allow);
            } else {
                accept = ar_accept_f64(sum0, sum1, sum2, count,
                                       x0, x1, x2, allow);
            }
            if (accept) {
                sum0 += x0;
                sum1 += x1;
                sum2 += x2;
                count++;
                i++;
            } else {
                break;
            }
        }
        out_counts[nrec] = (uint8_t)count;
        out_colors[3 * nrec] = (uint8_t)round((double)sum0 / (double)count);
        out_colors[3 * nrec + 1] = (uint8_t)round((double)sum1 / (double)count);
        out_colors[3 * nrec + 2] = (uint8_t)round((double)sum2 / (double)count);
        nrec++;
    }
    return nrec;
}
