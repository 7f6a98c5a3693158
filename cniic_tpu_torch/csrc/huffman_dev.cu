// D1 and D2: the device Huffman paths (bit packer, chunked decode), for
// Hopper.
//
// * D1 (huf_pack) replaces the XLA program cniic_tpu/ops/bitpack.py:43
//   `_pack_core`: each symbol's canonical code (<= 63 bits, a u64 split
//   hi/lo) is written MSB-first at its bit offset into 32-bit words that the
//   caller reads as big-endian. One thread per symbol, a batch axis on
//   blockIdx.y. The thread gathers len, hi and lo by its id, reads its
//   offset from the caller's exclusive int64 scan of the lengths (a torch
//   cumsum, as JAX leaves the scan to XLA), places the code in a 96-bit
//   window at word offset >> 5 and atomicOr's the at most three non-zero
//   words into place. The codes' bit ranges are disjoint, so OR is exact
//   and the order of the atomics does not matter.
//   What bounds it: memory and atomics. Per symbol it reads 4 B of id, 8 B
//   of offset and 12 B of codebook (gathers that hit L2: the codebook of a
//   1024^2 image is some 46k entries), and makes 1-3 atomics into words
//   that neighbouring threads share. Neighbouring threads read neighbouring
//   ids and offsets and hit neighbouring words, so the loads coalesce and
//   the atomics land in L2 lines already being written. No shared-memory
//   staging: a simple kernel first.
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
//   What bounds it: latency. Every bit is one dependent gather from lr2,
//   which for a Hufman tree of ~46k colours is ~740 KB, too large for
//   shared memory; it lives in L2 and is read through __ldg. The payload
//   byte is held in a register and reloaded only when the walk crosses into
//   the next byte, so the dependent chain is one L1/L2 load a bit. Pass 1's
//   C x E lanes (~140k for a 1024^2 Hufman payload) keep every SM's warp
//   slots full, which hides that latency; pass 2's C lanes cannot.
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

__global__ void __launch_bounds__(kWalkThreads)
walk_kernel(const uint8_t* __restrict__ payload,
            const int32_t* __restrict__ lr2,
            const int32_t* __restrict__ starts,
            const int32_t* __restrict__ ends, int L, int total_bits,
            int n_steps, const int32_t* __restrict__ out_start,
            int32_t* __restrict__ out_ids, int n_symbols,
            int32_t* __restrict__ exits, int32_t* __restrict__ counts,
            int32_t* __restrict__ unfrozen) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= L) return;
  const int end = ends[j];
  const int first = out_ids ? out_start[j] : 0;
  int node = 0, bitpos = starts[j], cnt = 0;
  int byte_at = -1;
  int byte = 0;
  for (int s = 0; s < n_steps; ++s) {
    if ((node == 0 && bitpos >= end) || bitpos >= total_bits) break;
    const int bi = bitpos >> 3;
    if (bi != byte_at) {
      byte = __ldg(payload + bi);
      byte_at = bi;
    }
    const int v = __ldg(lr2 + 2 * node + ((byte >> (7 - (bitpos & 7))) & 1));
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
  if (!((node == 0 && bitpos >= end) || bitpos >= total_bits)) *unfrozen = 1;
  exits[j] = bitpos - end;
  counts[j] = cnt;
}

}  // namespace

extern "C" {

// D1 on `stream`: ids int32 [B][n] (each < u), hi/lo uint32 [B][u], lens
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

// D2 on `stream`: payload uint8 [total_bits / 8], lr2 int32 [2 * nodes],
// starts/ends int32 [L] -> exits/counts int32 [L], unfrozen int32 [1]
// (zeroed by the caller, set to 1 if a lane did not freeze). Pass 2 when
// out_ids is not null: out_start int32 [L], out_ids int32 [n_symbols].
int huf_walk(const void* payload, const void* lr2, const void* starts,
             const void* ends, int L, int total_bits, int n_steps,
             const void* out_start, void* out_ids, int n_symbols, void* exits,
             void* counts, void* unfrozen, void* stream) {
  if (L <= 0) return cudaSuccess;
  if (total_bits < 0 || n_steps < 0 || (out_ids && !out_start))
    return cudaErrorInvalidValue;
  const int blocks = (L + kWalkThreads - 1) / kWalkThreads;
  walk_kernel<<<blocks, kWalkThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), static_cast<const int32_t*>(lr2),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(ends),
      L, total_bits, n_steps, static_cast<const int32_t*>(out_start),
      static_cast<int32_t*>(out_ids), n_symbols,
      static_cast<int32_t*>(exits), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(unfrozen));
  return cudaGetLastError();
}

const char* huffman_dev_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
