// D1 and D2: the device Huffman paths (bit packer, chunked decode), for
// Hopper.
//
// * D1 (huf_pack_tiles) replaces the XLA program cniic_tpu/ops/bitpack.py:43
//   `_pack_core`: each symbol's canonical code (<= 63 bits, a u64 split
//   hi/lo) is written MSB-first at its bit offset, the sum of the lengths
//   before it, into 32-bit words that the caller reads as big-endian.
//   What bounds it: bytes. The ids are read once and the words written once
//   (53 MB at 8 streams of 1M ids); the codebook gathers hit L2 (a 1024^2
//   image has some 46k colours). The design, one pass over the ids:
//     - A block takes a tile of 2048 consecutive symbols of one stream
//       (blockIdx.y), 8 a thread, ids loaded as 16-byte vectors, and gathers
//       each symbol's len, hi and lo once. Alphabets of up to 1024 entries
//       (delta's 511, cluster-colors' k) are first copied to shared memory.
//       A larger codebook stays in L2, where a gather costs a 32-byte
//       sector whatever it reads: three gathers a symbol from three arrays
//       held both this kernel and the one before it at ~0.12 ms for 8M
//       symbols, so `book_kernel` first interleaves hi, lo and len into
//       16-byte entries (a few MB, once a call) and a symbol makes one
//       16-byte gather.
//     - The offsets come from a scan inside the kernel: warp shuffles and a
//       row of warp totals give each thread its offset in the tile (int32),
//       and the tile's base (int64) comes from a single-pass scan across the
//       stream's tiles with decoupled look-back (LightScan, arXiv
//       1604.04815; Merrill and Garland's descriptors). A tile publishes its
//       total, then warp 0 reads the 32 tiles before it at a time, adding
//       totals until it meets a tile that has published its inclusive
//       prefix. A tile's index is a ticket drawn when its block starts, not
//       blockIdx.x, so every tile before it is already running and has
//       published, or will without waiting for anyone: the look-back cannot
//       deadlock. Flag and sum share one 64-bit word (2 + 62 bits), so a
//       reader sees both or neither. A spin that outlasts any real wait
//       traps rather than hang the card.
//     - The tile's words are assembled in shared memory (2048 x 63 bits is
//       16 KB): every symbol ORs its at most three words into the tile's
//       buffer with shared-memory atomics, then the block stores the buffer
//       coalesced. Only a tile's first and last word, which a neighbouring
//       tile may share, go to global memory by atomicOr: two global atomics
//       a tile. The caller zeroes `words` (the shared edge words and the
//       tail past the payload need it; one memset of the output).
//   The one-thread-a-symbol kernel it replaced (huf_pack: offsets from the
//   caller's int64 scan, 1-3 global atomicOr a symbol) stays launchable
//   beside it, so that the two can be timed in turns.
//
// * D2 (huf_walk) replaces cniic_tpu/ops/hufdec.py:82 `_pass1` and :99
//   `_pass2`, one kernel with a pass flag (out_ids null in pass 1). One
//   thread per lane: pass 1 has C x E lanes (every chunk of 512 payload
//   bytes at every entry offset < 32), pass 2 one lane per chunk at its
//   true entry offset. A lane walks the flattened trie lr2 (lr2[2*node+bit]
//   is the child, or -(leaf)-1) one bit at a time from `starts` until it is
//   frozen (back at the root at or past its chunk's end, or past the
//   payload) or the fixed step budget `n_steps` runs out, exactly as JAX's
//   fori_loop does: a lane still walking after the budget makes the caller
//   decline. Bit positions are int32 (the caller refuses payloads of 2^28
//   bytes or more). Pass 1 reports each lane's exit offset and symbol count
//   and raises `unfrozen` if any lane did not freeze; pass 2 writes each
//   symbol straight to out_ids[out_start[lane] + rank], dropping indices at
//   or past n_symbols (JAX recorded a (steps, C) buffer and compacted it
//   with a cumsum-rank scatter because the TPU has no scatters).
//   What bounds it: latency. A bit is one dependent gather from lr2, which
//   for a Hufman tree of ~46k colours is ~740 KB, too large for shared
//   memory (it lives in L2, read through __ldg), and codes average ~14 bits.
//   With K = 0 the walk is exactly that, the payload byte held in a
//   register: the dependent chain is one L1/L2 load a bit, which pass 1's
//   C x E lanes (~117k for a 1024^2 Hufman payload) partly hide and pass 2's
//   C lanes cannot. With K >= 1, `table_kernel` first walks every K-bit
//   prefix from the root once (2^K threads) and each block of the walk
//   copies that table into shared memory; at the root one shared-memory
//   lookup, indexed by the next K bits of a two-word register window of the
//   payload (one funnel shift), stands for the bit steps up to the next
//   visit to the root, so a code of <= K bits costs one lookup and a longer
//   one K bits less of the chain. A lookup is taken only with K payload
//   bits and K steps of the budget left, so the freeze test and the budget
//   stop the walk at the same steps as one bit at a time. Each step makes
//   one load, from the table or from lr2 through one generic pointer, so
//   pass 1's lanes (the 32 entry offsets of one chunk in a warp, at the
//   root and inside codes at once) do not split into two paths.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see cniic_tpu_torch/ops/bitpack.py). The launchers have
// a plain C interface, run on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 256;
constexpr int kWalkThreads = 128;
constexpr int kTilePer = 8;                          // symbols a thread
constexpr int kTileSyms = kPackThreads * kTilePer;   // symbols a tile
// words of a tile's bits (63 a symbol at most) after up to 31 bits of the
// word it shares with the tile before
constexpr int kTileWords = (kTileSyms * 63 + 31) / 32 + 1;
constexpr int kBookMax = 1024;   // codebook entries that go to shared memory
constexpr unsigned kFullMask = 0xffffffffu;
// a tile's descriptor: 2 flag bits (1: the tile's total, 2: the total of
// the stream up to and with the tile) above a 62-bit sum
#define CNIIC_SUM_MASK ((1ull << 62) - 1)
#define CNIIC_HAS_TOTAL (1ull << 62)
#define CNIIC_HAS_PREFIX (2ull << 62)
constexpr int kSpinLimit = 1 << 22;   // re-reads of a descriptor: seconds

__global__ void __launch_bounds__(kPackThreads)
pack_kernel(const int32_t* __restrict__ ids, const uint32_t* __restrict__ hi,
            const uint32_t* __restrict__ lo, const int32_t* __restrict__ lens,
            const int64_t* __restrict__ offs, uint32_t* __restrict__ words,
            int64_t n, int u, int64_t n_words) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t at = (int64_t)blockIdx.y * n + i;
  const int64_t entry = (int64_t)blockIdx.y * u + ids[at];
  const int len = __ldg(lens + entry);
  if (len <= 0) return;
  const uint32_t h = __ldg(hi + entry);
  const uint32_t l = __ldg(lo + entry);
  const int64_t off = offs[at];
  const int64_t base = off >> 5;
  // the code sits in bits [s0, s0 + len) of a 96-bit big-endian window
  // starting at word `base`: shift (hi, lo) left by k = 96 - s0 - len
  // (2 <= k <= 95 for 1 <= len <= 63), r bits then q whole words
  const int k = 96 - (int)(off & 31) - len;
  const int q = k >> 5;
  const int r = k & 31;
  const uint32_t a = r ? h >> (32 - r) : 0u;
  const uint32_t b = (h << r) | (r ? l >> (32 - r) : 0u);
  const uint32_t d = l << r;
  const uint32_t w0 = q == 0 ? a : (q == 1 ? b : d);
  const uint32_t w1 = q == 0 ? b : (q == 1 ? d : 0u);
  const uint32_t w2 = q == 0 ? d : 0u;
  uint32_t* row = words + (int64_t)blockIdx.y * n_words;
  if (w0 && base < n_words) atomicOr(row + base, w0);
  if (w1 && base + 1 < n_words) atomicOr(row + base + 1, w1);
  if (w2 && base + 2 < n_words) atomicOr(row + base + 2, w2);
}

// OR the code (h, l) of `len` bits into `row`, MSB first from bit `off`.
// The code sits in bits [s0, s0 + len) of a 96-bit big-endian window that
// starts at word off >> 5: (h, l) shifted left by 96 - s0 - len.
__device__ __forceinline__ void or_code(uint32_t* row, int off, int len,
                                        uint32_t h, uint32_t l) {
  const int base = off >> 5;
  const int k = 96 - (off & 31) - len;
  const int q = k >> 5;
  const int r = k & 31;
  const uint32_t a = r ? h >> (32 - r) : 0u;
  const uint32_t b = (h << r) | (r ? l >> (32 - r) : 0u);
  const uint32_t d = l << r;
  const uint32_t w0 = q == 0 ? a : (q == 1 ? b : d);
  const uint32_t w1 = q == 0 ? b : (q == 1 ? d : 0u);
  const uint32_t w2 = q == 0 ? d : 0u;
  if (w0) atomicOr(row + base, w0);
  if (w1) atomicOr(row + base + 1, w1);
  if (w2) atomicOr(row + base + 2, w2);
}

// The bit offset at which tile `tile` of a stream starts: the totals of the
// tiles before it. `desc[t]` is 0 until tile t publishes CNIIC_HAS_TOTAL |
// its total, and later CNIIC_HAS_PREFIX | the total of tiles 0..t. Called by
// the 32
// lanes of one warp; tile t is running or done for every t < tile.
__device__ long long tile_base(unsigned long long* desc, int tile,
                               long long total) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* vdesc = desc;
  if (lane == 0)
    vdesc[tile] = (tile == 0 ? CNIIC_HAS_PREFIX : CNIIC_HAS_TOTAL) |
                  (unsigned long long)total;
  long long before = 0;
  for (int first = tile - 1; first >= 0; first -= 32) {
    const int t = first - lane;   // lane 0 reads the nearest tile
    unsigned long long v;
    int spins = 0;
    do {
      v = t >= 0 ? vdesc[t] : CNIIC_HAS_PREFIX;
      if (++spins > kSpinLimit) __trap();
    } while (__any_sync(kFullMask, (v >> 62) == 0));
    const unsigned prefixed = __ballot_sync(kFullMask, (v >> 62) == 2);
    const int stop = prefixed ? __ffs(prefixed) - 1 : 31;
    long long part = lane <= stop ? (long long)(v & CNIIC_SUM_MASK) : 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      part += __shfl_xor_sync(kFullMask, part, s);
    before += part;
    if (prefixed) break;
  }
  if (lane == 0 && tile > 0)
    vdesc[tile] = CNIIC_HAS_PREFIX | (unsigned long long)(before + total);
  return before;
}

// The codebooks of all streams as 16-byte entries (hi, lo, len, 0).
__global__ void __launch_bounds__(kPackThreads)
book_kernel(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
            const int32_t* __restrict__ lens, uint4* __restrict__ book,
            int64_t entries) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < entries) book[i] = make_uint4(hi[i], lo[i], (uint32_t)lens[i], 0u);
}

// D1: one tile of kTileSyms symbols of stream blockIdx.y a block. scratch
// is u64 [B][1 + tiles], zeroed by the caller: a stream's ticket counter,
// then its tiles' descriptors. kBook: the codebook is copied from hi, lo
// and lens to shared memory first (u <= kBookMax); else it is read from
// `book`, book_kernel's entries.
template <bool kBook>
__global__ void __launch_bounds__(kPackThreads)
pack_tiles_kernel(const int32_t* __restrict__ ids,
                  const uint32_t* __restrict__ hi,
                  const uint32_t* __restrict__ lo,
                  const int32_t* __restrict__ lens,
                  const uint4* __restrict__ book_entries, uint32_t* words,
                  unsigned long long* scratch, int64_t n, int u,
                  int64_t n_words, int tiles) {
  __shared__ uint32_t s_words[kTileWords];
  __shared__ uint32_t s_book[kBook ? 3 * kBookMax : 1];
  __shared__ int s_warp[kPackThreads / 32];
  __shared__ int s_tile;
  __shared__ long long s_base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t stream = blockIdx.y;
  unsigned long long* row = scratch + stream * (tiles + 1);
  if (tid == 0) s_tile = (int)atomicAdd(row, 1ull);
  for (int i = tid; i < kTileWords; i += kPackThreads) s_words[i] = 0;
  const int64_t book = stream * u;
  if (kBook) {
    for (int i = tid; i < u; i += kPackThreads) {
      s_book[i] = (uint32_t)lens[book + i];
      s_book[kBookMax + i] = hi[book + i];
      s_book[2 * kBookMax + i] = lo[book + i];
    }
  }
  __syncthreads();
  const int tile = s_tile;

  // this thread's kTilePer consecutive symbols
  const int64_t first = (int64_t)tile * kTileSyms + (int64_t)tid * kTilePer;
  const int32_t* src = ids + stream * n + first;
  int id[kTilePer];
  if (first + kTilePer <= n && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int v = 0; v < kTilePer / 4; ++v) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(src) + v);
      id[4 * v] = q.x;
      id[4 * v + 1] = q.y;
      id[4 * v + 2] = q.z;
      id[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTilePer; ++j)
      id[j] = first + j < n ? __ldg(src + j) : -1;
  }
  int len[kTilePer];
  uint32_t h[kTilePer], l[kTilePer];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < kTilePer; ++j) {
    len[j] = 0;
    h[j] = l[j] = 0;
    if (id[j] >= 0) {
      if (kBook) {
        len[j] = (int)s_book[id[j]];
        h[j] = s_book[kBookMax + id[j]];
        l[j] = s_book[2 * kBookMax + id[j]];
      } else {
        const uint4 e = __ldg(book_entries + book + id[j]);
        h[j] = e.x;
        l[j] = e.y;
        len[j] = (int)e.z;
      }
    }
    mine += len[j];
  }

  // the scan inside the tile: threads in a warp, then the warps' totals
  int upto = mine;   // inclusive over the warp's lanes
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(kFullMask, upto, s);
    if (lane >= s) upto += v;
  }
  if (lane == 31) s_warp[warp] = upto;
  __syncthreads();
  int at = upto - mine;   // this thread's first bit in the tile
  int total = 0;
#pragma unroll
  for (int i = 0; i < kPackThreads / 32; ++i) {
    if (i < warp) at += s_warp[i];
    total += s_warp[i];
  }

  // the tile's first bit in the stream
  if (warp == 0) {
    const long long base = tile_base(row + 1, tile, total);
    if (lane == 0) s_base = base;
  }
  __syncthreads();
  const long long base = s_base;
  const int shift = (int)(base & 31);   // bits of the first word before us

  at += shift;
#pragma unroll
  for (int j = 0; j < kTilePer; ++j) {
    if (len[j] > 0) or_code(s_words, at, len[j], h[j], l[j]);
    at += len[j];
  }
  __syncthreads();

  // whole words are this tile's alone; the first and the last may be shared
  // with a neighbour
  const int bits = shift + total;
  const int used = (bits + 31) >> 5;
  const int64_t word0 = base >> 5;
  uint32_t* out = words + stream * n_words;
  for (int i = tid; i < used; i += kPackThreads) {
    const int64_t g = word0 + i;
    if (g >= n_words) break;   // bits at or past n_words are dropped
    const uint32_t v = s_words[i];
    const bool shared_word =
        (i == 0 && shift != 0) || (i == used - 1 && (bits & 31) != 0);
    if (!shared_word)
      out[g] = v;
    else if (v)
      atomicOr(out + g, v);
  }
}

// A lane's bits: the big-endian payload words w and w + 1 in hi and lo
// (bits [32 w, 32 w + 64)), the word after them already loading in nx.
// Words at or past the payload's end read as 0 (no decision reads them);
// the payload pointer is 4-byte aligned (the caller sees to it).
struct Bits {
  const uint8_t* payload;
  int n_bytes;
  int w;
  uint32_t hi, lo, nx;

  __device__ __forceinline__ uint32_t word(int i) const {
    if (4 * i + 4 <= n_bytes)
      return __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(payload) + i),
                         0, 0x0123);
    uint32_t v = 0;
    for (int b = 0; b < 4; ++b)
      v = (v << 8) | (4 * i + b < n_bytes ? __ldg(payload + 4 * i + b) : 0u);
    return v;
  }

  __device__ __forceinline__ void start(int bitpos) {
    w = bitpos >> 5;
    hi = word(w);
    lo = word(w + 1);
    nx = word(w + 2);
  }

  // the 32 bits at bitpos, which lies at most 63 bits past 32 w: one step
  // moves at most 14 bits, so one shift of the window a step keeps up
  __device__ __forceinline__ uint32_t top(int bitpos) {
    if (bitpos - 32 * w >= 32) {
      hi = lo;
      lo = nx;
      ++w;
      nx = word(w + 2);
    }
    return __funnelshift_l(lo, hi, bitpos - 32 * w);
  }
};

// The root table: entry e of 2^K is the walk of the K bits of e (MSB
// first) from the root, as v * 32 + n: it returned to the root after n <= K
// bits (v < 0: through leaf -v-1; v == 0: through a missing child), or it
// is at node v > 0 after all K bits.
__global__ void __launch_bounds__(kWalkThreads)
table_kernel(const int32_t* __restrict__ lr2, int32_t* __restrict__ table,
             int K) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (1 << K)) return;
  int node = 0;
  for (int i = 0; i < K; ++i) {
    const int v = __ldg(lr2 + 2 * node + ((e >> (K - 1 - i)) & 1));
    if (v <= 0) {
      table[e] = v * 32 + i + 1;
      return;
    }
    node = v;
  }
  table[e] = node * 32 + K;
}

// One lane walks from bit `starts[j]` until it is frozen or the step budget
// runs out. kTable: at the root, with K payload bits and K steps of the
// budget left, one lookup in the block's copy of the root table takes the
// bit steps up to the next visit to the root (or K steps to a node), which
// is where the freeze test and the budget could next stop the walk; the
// walk goes on bit by bit from a node, near the payload's end and near the
// budget's.
template <bool kTable>
__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const uint8_t* __restrict__ payload,
            const int32_t* __restrict__ lr2,
            const int32_t* __restrict__ table, int K,
            const int32_t* __restrict__ starts,
            const int32_t* __restrict__ ends, int L, int total_bits,
            int n_steps, const int32_t* __restrict__ out_start,
            int32_t* __restrict__ out_ids, int n_symbols,
            int32_t* __restrict__ exits, int32_t* __restrict__ counts,
            int32_t* __restrict__ unfrozen) {
  extern __shared__ int32_t root[];
  if (kTable) {
    for (int e = threadIdx.x; e < (1 << K); e += blockDim.x)
      root[e] = __ldg(table + e);
    __syncthreads();
  }
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  const int end = ends[j];
  const int first = out_ids ? out_start[j] : 0;
  int node = 0, bitpos = starts[j], cnt = 0;
  if (kTable) {
    Bits bits{payload, (total_bits + 7) >> 3};
    bits.start(bitpos);
    int s = 0;
    while (s < n_steps) {
      if ((node == 0 && bitpos >= end) || bitpos >= total_bits) break;
      // one load a step, from the table or from lr2, so that the lanes of a
      // warp (at the root or inside a code) do not split into two paths
      const uint32_t t = bits.top(bitpos);
      const bool at_root =
          node == 0 && bitpos + K <= total_bits && s + K <= n_steps;
      const int32_t* src =
          at_root ? root + (t >> (32 - K)) : lr2 + 2 * node + (t >> 31);
      const int e = *src;
      const int v = at_root ? e >> 5 : e;
      const int n = at_root ? e & 31 : 1;
      if (v < 0) {
        if (out_ids) {
          const int t_out = first + cnt;
          if (t_out < n_symbols) out_ids[t_out] = -v - 1;
        }
        ++cnt;
        node = 0;
      } else {
        node = v;
      }
      bitpos += n;
      s += n;
    }
  } else {
    int byte_at = -1;
    int byte = 0;
    for (int s = 0; s < n_steps; ++s) {
      if ((node == 0 && bitpos >= end) || bitpos >= total_bits) break;
      const int bi = bitpos >> 3;
      if (bi != byte_at) {
        byte = __ldg(payload + bi);
        byte_at = bi;
      }
      const int v =
          __ldg(lr2 + 2 * node + ((byte >> (7 - (bitpos & 7))) & 1));
      if (v < 0) {
        if (out_ids) {
          const int t = first + cnt;
          if (t < n_symbols) out_ids[t] = -v - 1;
        }
        ++cnt;
        node = 0;
      } else {
        node = v;
      }
      ++bitpos;
    }
  }
  if (!((node == 0 && bitpos >= end) || bitpos >= total_bits)) *unfrozen = 1;
  exits[j] = bitpos - end;
  counts[j] = cnt;
}

}  // namespace

extern "C" {

// D1, one thread a symbol, on `stream` (the schedule huf_pack_tiles
// replaced): ids int32 [B][n] (each < u), hi/lo uint32 [B][u], lens
// int32 [B][u] (0..63), offs int64 [B][n] (exclusive scan of lens[ids]) ->
// words uint32 [B][n_words], which the caller zeroes. The caller checks
// the ranges; B <= 65535.
int huf_pack(const void* ids, const void* hi, const void* lo, const void* lens,
             const void* offs, void* words, int B, int64_t n, int u,
             int64_t n_words, void* stream) {
  if (B <= 0 || n <= 0) return cudaSuccess;
  if (B > 65535 || u <= 0 || n_words < 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kPackThreads - 1) / kPackThreads), B);
  pack_kernel<<<grid, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(lo), static_cast<const int32_t*>(lens),
      static_cast<const int64_t*>(offs), static_cast<uint32_t*>(words), n, u,
      n_words);
  return cudaGetLastError();
}

// D1 in one pass on `stream`: ids, hi, lo, lens and words as for huf_pack;
// scratch u64 [B][1 + ceil(n / huf_pack_tile())], zeroed by the caller, as
// are the words; book uint4 [B][huf_pack_book_entries(u)], filled here (not
// read when that is 0). The caller checks the ranges; B <= 65535.
int huf_pack_tiles(const void* ids, const void* hi, const void* lo,
                   const void* lens, void* words, void* scratch, void* book,
                   int B, int64_t n, int u, int64_t n_words, void* stream) {
  if (B <= 0 || n <= 0) return cudaSuccess;
  const int64_t tiles = (n + kTileSyms - 1) / kTileSyms;
  if (B > 65535 || u <= 0 || n_words < 0 || tiles > 0x7fffffff ||
      (u > kBookMax && !book))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, B);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* I = static_cast<const int32_t*>(ids);
  const auto* H = static_cast<const uint32_t*>(hi);
  const auto* L = static_cast<const uint32_t*>(lo);
  const auto* N = static_cast<const int32_t*>(lens);
  auto* W = static_cast<uint32_t*>(words);
  auto* S = static_cast<unsigned long long*>(scratch);
  auto* E = static_cast<uint4*>(book);
  if (u <= kBookMax) {
    pack_tiles_kernel<true><<<grid, kPackThreads, 0, s>>>(
        I, H, L, N, nullptr, W, S, n, u, n_words, (int)tiles);
    return cudaGetLastError();
  }
  const int64_t entries = (int64_t)B * u;
  book_kernel<<<(unsigned)((entries + kPackThreads - 1) / kPackThreads),
                kPackThreads, 0, s>>>(H, L, N, E, entries);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pack_tiles_kernel<false><<<grid, kPackThreads, 0, s>>>(
      I, H, L, N, E, W, S, n, u, n_words, (int)tiles);
  return cudaGetLastError();
}

// 16-byte entries a stream that huf_pack_tiles needs in `book` for an
// alphabet of u symbols (0: the codebook goes to shared memory)
int huf_pack_book_entries(int u) { return u > kBookMax ? u : 0; }

// symbols a tile of huf_pack_tiles takes
int huf_pack_tile() { return kTileSyms; }

// D2 on `stream`: payload uint8 [total_bits / 8], lr2 int32 [2 * nodes],
// starts/ends int32 [L] -> exits/counts int32 [L], unfrozen int32 [1]
// (zeroed by the caller, set to 1 if a lane did not freeze). Pass 2 when
// out_ids is not null: out_start int32 [L], out_ids int32 [n_symbols]. K = 0
// walks bit by bit; 1 <= K <= 14 walks with `table`, the root table
// huf_root_table built (int32 [2^K]).
int huf_walk(const void* payload, const void* lr2, const void* starts,
             const void* ends, int L, int total_bits, int n_steps,
             const void* out_start, void* out_ids, int n_symbols, void* exits,
             void* counts, void* unfrozen, int K, const void* table,
             void* stream) {
  if (L <= 0) return cudaSuccess;
  if (total_bits < 0 || n_steps < 0 || (out_ids && !out_start) || K < 0 ||
      K > 14 || (K && !table))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (L + kWalkThreads - 1) / kWalkThreads;
  const auto* pay = static_cast<const uint8_t*>(payload);
  const auto* lr = static_cast<const int32_t*>(lr2);
  const auto* tab = static_cast<const int32_t*>(table);
  if (K == 0) {
    walk_kernel<false><<<blocks, kWalkThreads, 0, s>>>(
        pay, lr, nullptr, 0, static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(ends), L, total_bits, n_steps,
        static_cast<const int32_t*>(out_start),
        static_cast<int32_t*>(out_ids), n_symbols,
        static_cast<int32_t*>(exits), static_cast<int32_t*>(counts),
        static_cast<int32_t*>(unfrozen));
    return cudaGetLastError();
  }
  const size_t smem = sizeof(int32_t) << K;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(walk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  walk_kernel<true><<<blocks, kWalkThreads, smem, s>>>(
      pay, lr, tab, K, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(ends), L, total_bits, n_steps,
      static_cast<const int32_t*>(out_start), static_cast<int32_t*>(out_ids),
      n_symbols, static_cast<int32_t*>(exits), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(unfrozen));
  return cudaGetLastError();
}

// The root table of D2 on `stream`: lr2 int32 [2 * nodes] -> table int32
// [2^K], 1 <= K <= 14. The caller checks nodes < 2^26, so that v * 32 + n
// fits.
int huf_root_table(const void* lr2, void* table, int K, void* stream) {
  if (K < 1 || K > 14) return cudaErrorInvalidValue;
  table_kernel<<<((1 << K) + kWalkThreads - 1) / kWalkThreads, kWalkThreads,
                 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lr2), static_cast<int32_t*>(table), K);
  return cudaGetLastError();
}

const char* huffman_dev_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
