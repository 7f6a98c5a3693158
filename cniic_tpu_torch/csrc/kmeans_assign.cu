// K1: one fused k-means step (assignment + centroid statistics), and D3: the
// step's update (means, steal, plateau, freeze, iteration count), which runs
// in K1's last block of each lane or alone, for Hopper.
//
// K1 replaces the TPU kernel cniic_tpu/ops/kmeans_pallas.py::_kernel (and
// its XLA twin _assign_stats_xla in cniic_tpu/ops/kmeans.py). For every
// active lane b (act[b] != 0) and every point i < n[b]:
//
//   * the exact squared distance d2 to every centroid, in 32-bit integers
//     (the caller bounds d2 below 2^31; never float, never TF32);
//   * the new assignment: the lowest-index argmin if its d2 is strictly
//     below the d2 of the current centroid, else the current centroid;
//   * the lane's count of points whose assignment changed;
//   * per-cluster int64 sums of w*p per dimension and of w, added to `sums`.
//
// Frozen lanes are skipped whole; points past n[b] are not touched. The new
// assignment may be written over `cur` itself (each thread reads a point's
// current id before it writes the new one).
//
// What bounds it on this card. The step reads ptsT, w and cur and writes the
// new ids once: 134 MB at 4 lanes of 1024^2 voronoi points (d = 5), 40 us at
// 3.35 TB/s. Its arithmetic is 0.54 G (point, centroid) pairs of d
// multiply-adds there; int32 multiply-adds issue at 64 lanes a clock on an
// SM (half the FP32 rate), so the integer pipe, not memory, sets the pace.
// The design spends as few instructions a pair as it can:
//
//   * Expanded, packed scores. The shared row of centroid c holds
//     B_j = -2*pk*c_j and cc = |c|^2*pk + c (pk: the power of two >= k);
//     a point's key for c is cc + sum_j p_j*B_j, which is d2*pk + c - |p|^2*pk:
//     d multiply-adds and one signed min a pair (6 instructions at d = 5,
//     where the direct (p - c)^2 form takes ~13). Keys are
//     accumulated in uint32: wraparound is exact because every key's true
//     value lies in (-2^31, 2^31) whenever (d2_bound + 1) * pk <= 2^31. Then
//     min + |p|^2*pk = best_d2*pk + best, the lowest index among equals. The
//     wrapper picks this path from the host bound; above it (e.g. 3840x2160
//     voronoi coordinates at k = 128) the same loop runs unpacked (pk = 1,
//     cc = |c|^2) and keeps a (score, index) pair.
//   * Register tiling: each thread scores kT points, so one broadcast
//     shared load of a centroid row (16 B vectors) feeds kT points.
//   * Statistics aggregated before the atomics: a warp's 32 neighbouring
//     points mostly share a cluster (voronoi pixels, sorted histogram
//     colours). When they all do, warp reductions sum the d+1 int64 values;
//     otherwise __match_any_sync groups equal ids and a tree of shuffles sums
//     each group's. One lane a group adds them. Integer sums do not depend
//     on the order of the atomics: the result is deterministic.
//   * Two statistics branches, chosen by k: the k x (d+1) int64 tile in
//     shared memory (added to global memory once per block), or, when the
//     tile and the rows pass 48 KB (k = 2048 at d = 5), straight to global.
//
// The pruned instance (voronoi's d = 5 points on the unpacked path at
// k >= 512, the loop's one launch): at large k the scan is nearly all of the
// step, ~5 integer multiply-adds a (point, centroid) pair at ~70% of the
// integer pipe's rate, and in the loop's long tail almost no point changes
// cluster. An exact bound filter (`pruned_pass`) skips the scan of a point
// that no other centroid can have come strictly closer to, held to the
// snapshot of the centroids at its last scan; the points that fail are
// compacted into shared memory and scanned in full tiles. The statistics
// still read every point every step, so the step stays above its byte
// count; the skipped pairs are what it saves. D3 in the lane's last block
// also keeps the snapshots (`snapshot_update`).
//
// Tensor cores, estimated and not used: the exact route is int8 mma/wgmma,
// and 14-bit coordinates need byte splits of both operands, three
// accumulators of different scale and a per-(point, centroid) epilogue that
// recombines them, takes the min and tracks the index: about the 6
// instructions a pair the packed loop costs, so no gain at d <= 5. Float
// tensor cores are not exact (TF32) and are not used.
//
// D3 replaces the XLA programs of the JAX loop body around K1
// (cniic_tpu/ops/kmeans.py::_means_from_sums, ::_steal_indices,
// ::_plateau_update and the `where`s of kmeans_pallas.py::kmeans_loop_pallas):
// per lane that K1 ran, truncated means sums // wsum, the Weyl steal for
// empty clusters, moved/best/stall/act, the lane's iteration count, and the
// statistics zeroed for the next K1. It is latency-bound (a few thousand
// values a lane), so its design is about where it runs, not how fast:
//
//   * One device function, `lane_update`, does one lane with all the
//     threads of a block (k*d divisions spread over 256 threads).
//   * Fused (the k-means loop's step, kmeans_fused_step): K1's blocks of a
//     lane each flush their statistics, fence, and take a ticket on the
//     lane's counter; the block that draws the last ticket runs the lane's
//     update, reading the statistics past L1. Every block of the lane read
//     act[b] and copied cents[b] into shared memory before its ticket, so
//     the last block may overwrite both. The lanes update in different
//     blocks at once, a short lane's under a long lane's K1, and an
//     iteration is one launch. The ticket wraps to 0 by itself (atomicInc).
//   * The iteration count is per lane (`it[b]`, advanced while the lane
//     runs): lanes start together and never thaw, so every active lane's
//     count is the batch's, and no lane reads another's state.
//   * Standalone (kmeans_step_update): one block a lane calls the same
//     function after a K1 launched without the update.
//   * Given the steal candidates (kmeans_step_update with `stolen`): the
//     point-sharded k-means holds a shard of the points on each rank, so no
//     rank can gather pts[steal] itself. The ranks assemble stolen[b, j, :]
//     with an all-reduce, and the update reads the empty clusters' points
//     from it instead of from ptsT (a second instance of the standalone
//     kernel; the fused one never takes it).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see cniic_tpu_torch/ops/kmeans_kernel.py). The launchers
// have a plain C interface, run on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 4;                      // points a thread scores
constexpr int kTile = kThreads * kT;       // points a block takes at a time
constexpr size_t kDefaultSmem = 48 * 1024;  // usable without an opt-in
constexpr size_t kMaxSmem = 232448 - 64;    // per block on sm_90, opted in,
                                            // less the static shared words
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

// words of one centroid row in shared memory: B_0..B_{D-1}, cc, padding to
// whole 16-byte vectors
template <int D>
struct Row {
  static constexpr int kWords = (D + 1 + 3) / 4 * 4;
  static constexpr int kVecs = kWords / 4;
};

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

int log2_pow2_at_least(int k) {
  int s = 0;
  while ((1 << s) < k) ++s;
  return s;
}

// Sums v over each group of lanes with equal keys (`peers`, from
// __match_any_sync); the lowest lane of a group ends with the group's sum.
// A tree over each group's ranks: in round r a live lane adds the value of
// its next live peer, and the lanes whose rank has bit r set drop out.
template <int N>
__device__ __forceinline__ void reduce_peers(unsigned peers, u64 (&v)[N]) {
  const unsigned lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);
    const int src = next ? next - 1 : (int)lane;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const u64 t = __shfl_sync(kFull, v[j], src);
      if (next) v[j] += t;
    }
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
}

// Sums v over the full warp, into every lane. Each value is below 2^48
// (w < 2^31 times a coordinate below 2^16, as d2_bound < 2^31 implies), so
// three 16-bit pieces summed with 32-bit warp reductions give it exactly.
template <int N>
__device__ __forceinline__ void reduce_warp(u64 (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    u64 total = 0;
#pragma unroll
    for (int s = 0; s < 48; s += 16) {
      total += (u64)__reduce_add_sync(kFull, (unsigned)(v[j] >> s) & 0xffffu)
               << s;
    }
    v[j] = total;
  }
}

// Adds one point's w*p and w to its cluster's statistics, by the whole
// warp (every lane calls it, `valid` or not): the lanes that share a cluster
// are summed first and one of them adds the sums (warp-aggregated atomics).
template <int D>
__device__ __forceinline__ void add_point_stats(bool valid, int nw,
                                                int32_t wi,
                                                const uint32_t (&p)[D],
                                                u64* dst_sums) {
  u64 v[D + 1];
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = (u64)((long long)wi * p[d]);
  v[D] = (u64)(long long)wi;
  const int key = valid ? nw : -1;
  bool lead;
  if (__all_sync(kFull, key == __shfl_sync(kFull, key, 0))) {
    // the whole warp shares one cluster (the common case)
    reduce_warp<D + 1>(v);
    lead = (threadIdx.x & 31) == 0;
  } else {
    const unsigned peers = __match_any_sync(kFull, key);
    reduce_peers<D + 1>(peers, v);
    lead = (threadIdx.x & 31) == (unsigned)(__ffs(peers) - 1);
  }
  if (valid && lead && v[D] != 0) {
    u64* dst = dst_sums + (size_t)nw * (D + 1);
#pragma unroll
    for (int d = 0; d <= D; ++d) atomicAdd(dst + d, v[d]);
  }
}

// D3's operands beside K1's: per-lane int64 state, and the lanes' tickets
// (uint32 [B], zero before the first fused launch).
struct Update {
  long long* moved;         // [B]
  long long* best;          // [B]
  long long* stall;         // [B]
  long long* it;            // [B]
  const long long* thresh;  // [B]
  unsigned* tickets;        // [B]
  long long stall_lim;
  long long max_iters;
};

// The bound filter's state (the pruned instance only; see the note on
// `pruned_pass`): per point a lower bound on its distance to every centroid
// but its own, float32 rounded down, and the iteration of the centroids it
// was taken at; per lane the centroids of its last kWindow iterations
// (iteration s in slot s % kWindow, laid out [B, kWindow, d, k]) and, for
// each slot, the largest distance a centroid has moved since, rounded up;
// and the count of points scanned.
constexpr int kWindow = 16;

struct Prune {
  float* lb;         // [B, n_max]
  int32_t* since;    // [B, n_max]
  int32_t* ring;     // [B, kWindow, d, k]
  float* mdisp;      // [B, kWindow]
  u64* scanned;      // [1]
};

// D3 for lane b, by all threads of one block, after every K1 block of the
// lane has added its statistics (a later launch, or the last ticket).
// Inlined into K1 on purpose: as a call it made the one-launch iteration
// ~10 us slower at 4 lanes of 1024^2 points, k = 128. kStolen: an empty
// cluster j takes stolen[b, j, :] (int32 [B, k, d]) instead of the point the
// hash picks from ptsT.
template <bool kStolen>
__device__ __forceinline__ void lane_update(
    int b, u64* sums,                  // [B, k, d + 1]
    int32_t* moved_k,                  // [B], K1's counts
    const int32_t* __restrict__ ptsT,  // [B, d, n_max]
    const int32_t* __restrict__ n,     // [B]
    const int32_t* __restrict__ stolen,  // [B, k, d] (kStolen only)
    int32_t* cents,                    // [B, k, d]
    int32_t* act,                      // [B]
    const Update& up, int d, int n_max, int k) {
  const long long it = up.it[b];
  u64* s = sums + (size_t)b * k * (d + 1);
  const u64 nn = n[b] > 1 ? (u64)n[b] : 1ull;
  for (int idx = threadIdx.x; idx < k * d; idx += blockDim.x) {
    const int j = idx / d;
    const int dim = idx - j * d;
    const long long wsum = (long long)__ldcg(s + (size_t)j * (d + 1) + d);
    long long v;
    if (wsum > 0) {
      // both nonnegative: truncation = floor
      v = (long long)__ldcg(s + (size_t)j * (d + 1) + dim) / wsum;
    } else if (kStolen) {
      v = stolen[((size_t)b * k + j) * d + dim];
    } else {
      // the Weyl steal: ((it+1)*2654435769 + j*40503) & 0x7FFFFFFF over the
      // lane's valid points (JAX's int32 wraparound has the same low bits)
      const u64 mix = ((u64)(it + 1) * 2654435769ull + (u64)j * 40503ull) &
                      0x7fffffffull;
      v = ptsT[((size_t)b * d + dim) * n_max + (size_t)(mix % nn)];
    }
    cents[((size_t)b * k + j) * d + dim] = (int32_t)v;
  }
  __syncthreads();  // every mean read its sums, every thread read it[b]
  for (int i = threadIdx.x; i < k * (d + 1); i += blockDim.x) s[i] = 0;
  if (threadIdx.x == 0) {
    const long long mv = __ldcg(moved_k + b);
    long long be = up.best[b], st = up.stall[b];
    if (mv < be - be / 50) {  // a 2% improvement
      be = mv;
      st = 0;
    } else {
      st += 1;
    }
    up.moved[b] = mv;
    up.best[b] = be;
    up.stall[b] = st;
    moved_k[b] = 0;
    act[b] = mv > up.thresh[b] && st < up.stall_lim && it + 1 < up.max_iters;
    up.it[b] = it + 1;
  }
}

// After D3 (the pruned instance): lane b's new centroids, iteration `t1`,
// go into slot t1 % kWindow of its snapshots, and each slot's largest
// squared distance to them (an exact integer) sets mdisp, its root rounded
// up. One thread a centroid; `scratch`: kWindow words of shared memory.
template <int D>
__device__ __forceinline__ void snapshot_update(int b, long long t1,
                                                const int32_t* cents, int k,
                                                const Prune& pr,
                                                unsigned* scratch) {
  if (threadIdx.x < kWindow) scratch[threadIdx.x] = 0;
  __syncthreads();  // and D3's centroids are visible to the whole block
  int32_t* ring = pr.ring + (size_t)b * kWindow * D * k;
  const int slot = (int)((unsigned)t1 % kWindow);
  unsigned mx[kWindow];
#pragma unroll
  for (int q = 0; q < kWindow; ++q) mx[q] = 0;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    int32_t c[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      c[d] = cents[((size_t)b * k + j) * D + d];
      ring[((size_t)slot * D + d) * k + j] = c[d];
    }
#pragma unroll
    for (int q = 0; q < kWindow; ++q) {
      unsigned dd = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int diff = c[d] - ring[((size_t)q * D + d) * k + j];
        dd += (unsigned)(diff * diff);
      }
      mx[q] = max(mx[q], dd);
    }
  }
#pragma unroll
  for (int q = 0; q < kWindow; ++q) {
    const unsigned m = __reduce_max_sync(kFull, mx[q]);
    if ((threadIdx.x & 31) == 0 && m) atomicMax(scratch + q, m);
  }
  __syncthreads();
  if (threadIdx.x < kWindow)
    pr.mdisp[(size_t)b * kWindow + threadIdx.x] =
        __fsqrt_ru(__uint2float_ru(scratch[threadIdx.x]));
}

// The pruned instance's pass over a lane's points (unpacked keys, fused
// with D3, one launch an iteration). Each point keeps lb, a lower bound on
// its distance to every centroid but its own as they were at iteration
// `since`, its last scan. By the triangle inequality its distance to any
// other centroid now is at least lb - mdisp[since % kWindow], the largest
// distance a centroid moved since then (rounded down). Its distance to its
// own centroid a is computed exactly (the statistics read the point
// anyway). When that is at most the bound, no other centroid is strictly
// closer, and K1 moves a point only to a strictly closer one, so the point
// keeps a with no scan; one kept kWindow / 2 iterations from its snapshot
// takes the bound as its new lb, at this iteration. Any other point is
// queued. The scan runs on full tiles of queued points, so a warp never
// waits on one scanning lane among 31 kept ones, and on one partial tile at
// the end of the block's range (kTq points a thread, as few as it needs).
// It also keeps the second least key, from which it sets lb exactly
// (rounded down). Kept points add their statistics as they are tested,
// scanned points after their scan: every point of the lane, once. The
// queue is 2 * kTile ids in shared memory after the rows; count[0] its
// length, count[1] the points the block queued in all.
template <int D, int kTq>
__device__ __forceinline__ void scan_queued(
    const int* queue, int m, const uint32_t* s_rows,
    const int32_t* __restrict__ pb, const int32_t* __restrict__ w,
    const int32_t* cur, int32_t* new_out, size_t lane_row, int n_max, int k,
    int t, const Prune& pr, u64* dst_sums, int& my_moved) {
  const uint4* s_vecs = reinterpret_cast<const uint4*>(s_rows);
  uint32_t p[kTq][D];
  uint32_t pp[kTq];      // |p|^2
  int32_t best[kTq];     // least key (d2 - |p|^2) over the centroids
  int32_t second[kTq];   // least key over all but best_c
  int best_c[kTq];       // the first centroid with the least key
  int idx[kTq];
#pragma unroll
  for (int t_ = 0; t_ < kTq; ++t_) {
    const int q = t_ * kThreads + threadIdx.x;
    idx[t_] = q < m ? queue[q] : -1;
    uint32_t sq = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      p[t_][d] = idx[t_] >= 0 ? (uint32_t)pb[(size_t)d * n_max + idx[t_]]
                              : 0u;
      sq += p[t_][d] * p[t_][d];
    }
    pp[t_] = sq;
    best[t_] = second[t_] = 0x7fffffff;
    best_c[t_] = 0;
  }
#pragma unroll 4
  for (int c = 0; c < k; ++c) {
    uint32_t r[Row<D>::kWords];
#pragma unroll
    for (int v = 0; v < Row<D>::kVecs; ++v) {
      const uint4 q = s_vecs[c * Row<D>::kVecs + v];
      r[4 * v] = q.x;
      r[4 * v + 1] = q.y;
      r[4 * v + 2] = q.z;
      r[4 * v + 3] = q.w;
    }
#pragma unroll
    for (int t_ = 0; t_ < kTq; ++t_) {
      uint32_t key = r[D];
#pragma unroll
      for (int d = 0; d < D; ++d) key += p[t_][d] * r[d];
      second[t_] = min(second[t_], max(best[t_], (int32_t)key));
      if ((int32_t)key < best[t_]) {  // strict: lowest index wins
        best[t_] = (int32_t)key;
        best_c[t_] = c;
      }
    }
  }
#pragma unroll
  for (int t_ = 0; t_ < kTq; ++t_) {
    const bool valid = idx[t_] >= 0;
    int nw = 0;
    int32_t wi = 0;
    if (valid) {
      const size_t i = lane_row + idx[t_];
      const int c0 = cur[i];
      const uint32_t* row = s_rows + (size_t)c0 * Row<D>::kWords;
      uint32_t key0 = row[D];
#pragma unroll
      for (int d = 0; d < D; ++d) key0 += p[t_][d] * row[d];
      const uint32_t cur_d2 = key0 + pp[t_];
      const uint32_t best_d2 = (uint32_t)best[t_] + pp[t_];
      // a point moves only to a strictly closer centroid
      nw = best_d2 < cur_d2 ? best_c[t_] : c0;
      // lb: the least distance to a centroid other than nw (best's, when
      // nw is the current centroid tied with a lower index)
      const int32_t low = nw == best_c[t_] ? second[t_] : best[t_];
      new_out[i] = nw;
      pr.lb[i] = low == 0x7fffffff
                     ? __int_as_float(0x7f800000)  // no other centroid
                     : __fsqrt_rd(__uint2float_rd((uint32_t)low + pp[t_]));
      pr.since[i] = t;
      my_moved += nw != c0;
      wi = w[i];
    }
    add_point_stats<D>(valid, nw, wi, p[t_], dst_sums);
  }
}

template <int D>
__device__ __forceinline__ int pruned_pass(
    int b, int nb, const int32_t* __restrict__ pb,
    const int32_t* __restrict__ w, const int32_t* cur, int32_t* new_out,
    size_t lane_row, int n_max, int k, int t, const uint32_t* s_rows,
    const float* s_mdisp, int* queue, int* count, u64* dst_sums,
    const Prune& pr) {
  float* lb = pr.lb + lane_row;
  int32_t* since = pr.since + lane_row;
  const unsigned lane = threadIdx.x & 31;
  int my_moved = 0;
  // block-uniform loop over tiles: every warp's lanes at each ballot and
  // at the statistics' aggregation
  for (int base = blockIdx.x * kTile; base < nb; base += gridDim.x * kTile) {
    uint32_t p[kT][D];
    int a[kT];
    int32_t wi[kT];
    bool keep[kT];
#pragma unroll
    for (int t_ = 0; t_ < kT; ++t_) {
      const int i = base + t_ * kThreads + threadIdx.x;
      a[t_] = 0;
      wi[t_] = 0;
      keep[t_] = false;
#pragma unroll
      for (int d = 0; d < D; ++d) p[t_][d] = 0;
      if (i >= nb) continue;
      a[t_] = cur[lane_row + i];
      wi[t_] = w[lane_row + i];
      const uint32_t* row = s_rows + (size_t)a[t_] * Row<D>::kWords;
      uint32_t key = row[D], sq = 0;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        p[t_][d] = (uint32_t)pb[(size_t)d * n_max + i];
        key += p[t_][d] * row[d];
        sq += p[t_][d] * p[t_][d];
      }
      const float dist = __fsqrt_ru(__uint2float_ru(key + sq));
      const int s = since[i];
      const unsigned age = (unsigned)t - (unsigned)s;
      if (age < kWindow) {
        const float bound = __fsub_rd(lb[i], s_mdisp[(unsigned)s % kWindow]);
        keep[t_] = dist <= bound;
        if (keep[t_] && age >= kWindow / 2) {  // rebased to this iteration
          lb[i] = bound;
          since[i] = t;
        }
      }
    }
#pragma unroll
    for (int t_ = 0; t_ < kT; ++t_) {
      const int i = base + t_ * kThreads + threadIdx.x;
      add_point_stats<D>(keep[t_], a[t_], wi[t_], p[t_], dst_sums);
      const bool fail = i < nb && !keep[t_];
      const unsigned mask = __ballot_sync(kFull, fail);
      int at = 0;
      if (lane == 0 && mask) {
        at = atomicAdd(count, __popc(mask));
        atomicAdd(count + 1, __popc(mask));
      }
      at = __shfl_sync(kFull, at, 0);
      if (fail) queue[at + __popc(mask & ((1u << lane) - 1u))] = i;
    }
    __syncthreads();
    const int q = count[0];
    if (q >= kTile) {
      scan_queued<D, kT>(queue, kTile, s_rows, pb, w, cur, new_out, lane_row,
                         n_max, k, t, pr, dst_sums, my_moved);
      __syncthreads();
      for (int j = threadIdx.x; j < q - kTile; j += kThreads)
        queue[j] = queue[kTile + j];
      if (threadIdx.x == 0) count[0] = q - kTile;
    }
    __syncthreads();  // every thread read q before the next pushes
  }
  const int q = count[0];
  if (q > 2 * kThreads) {
    scan_queued<D, kT>(queue, q, s_rows, pb, w, cur, new_out, lane_row, n_max,
                       k, t, pr, dst_sums, my_moved);
  } else if (q > kThreads) {
    scan_queued<D, 2>(queue, q, s_rows, pb, w, cur, new_out, lane_row, n_max,
                      k, t, pr, dst_sums, my_moved);
  } else if (q > 0) {
    scan_queued<D, 1>(queue, q, s_rows, pb, w, cur, new_out, lane_row, n_max,
                      k, t, pr, dst_sums, my_moved);
  }
  return my_moved;
}

template <int D, bool kSmemStats, bool kPacked, bool kFused, bool kPruned>
__global__ void __launch_bounds__(kThreads)
assign_stats_kernel(const int32_t* __restrict__ ptsT,   // [B, D, n_max]
                    const int32_t* __restrict__ w,      // [B, n_max]
                    const int32_t* cur,                 // [B, n_max]
                    int32_t* cents,                     // [B, k, D]
                    const int32_t* __restrict__ n,      // [B]
                    int32_t* act,                       // [B]
                    int32_t* new_out,                   // [B, n_max], may be cur
                    u64* sums,                          // [B, k, D + 1]
                    int32_t* moved,                     // [B]
                    int n_max, int k, int shift, Update up, Prune pr) {
  static_assert(!kPruned || (kFused && !kPacked),
                "the pruned instance is the fused, unpacked step");
  const int b = blockIdx.y;
  if (act[b] == 0) return;  // uniform over the block and over the lane

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_moved;
  u64* s_sums = reinterpret_cast<u64*>(smem);
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(
      smem + (kSmemStats ? round16(sizeof(u64) * k * (D + 1)) : 0));
  const uint4* s_vecs = reinterpret_cast<const uint4*>(s_rows);
  // the pruned instance's queue, its two counts and the lane's mdisp
  int* s_queue = reinterpret_cast<int*>(s_rows + (size_t)k * Row<D>::kWords);
  int* s_count = s_queue + 2 * kTile;
  float* s_mdisp = reinterpret_cast<float*>(s_count + 4);

  const int32_t* cb = cents + (size_t)b * k * D;
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    uint32_t sq = 0;
    uint32_t* row = s_rows + (size_t)c * Row<D>::kWords;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const uint32_t v = (uint32_t)cb[c * D + d];
      sq += v * v;
      row[d] = 0u - (v << (shift + 1));
    }
    row[D] = (sq << shift) + (kPacked ? (uint32_t)c : 0u);
#pragma unroll
    for (int d = D + 1; d < Row<D>::kWords; ++d) row[d] = 0;
  }
  if (kSmemStats) {
    for (int i = threadIdx.x; i < k * (D + 1); i += blockDim.x) s_sums[i] = 0;
  }
  if (threadIdx.x == 0) {
    s_moved = 0;
    if (kPruned) s_count[0] = s_count[1] = 0;
  }
  if (kPruned && threadIdx.x < kWindow)
    s_mdisp[threadIdx.x] = pr.mdisp[(size_t)b * kWindow + threadIdx.x];
  // the lane's iteration (its snapshots' numbering; mod 2^32 throughout)
  const int t = kPruned ? (int)up.it[b] : 0;
  __syncthreads();

  const int nb = n[b];
  const int32_t* pb = ptsT + (size_t)b * D * n_max;
  const size_t lane_row = (size_t)b * n_max;
  u64* gsum = sums + (size_t)b * k * (D + 1);
  u64* dst_sums = kSmemStats ? s_sums : gsum;
  int my_moved = 0;

  if constexpr (kPruned) {
    my_moved = pruned_pass<D>(b, nb, pb, w, cur, new_out, lane_row, n_max,
                              k, t, s_rows, s_mdisp, s_queue, s_count,
                              dst_sums, pr);
  } else {
    // block-uniform loop over tiles: every warp reaches the warp-wide
    // aggregation below with all its lanes
    for (int base = blockIdx.x * kTile; base < nb; base += gridDim.x * kTile) {
      uint32_t p[kT][D];
      uint32_t pp[kT];      // |p|^2 << shift
      int32_t best[kT];     // min over c of (d2*pk + c) - |p|^2*pk
      int best_c[kT];       // unpacked path: the argmin
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int i = base + t * kThreads + threadIdx.x;
        uint32_t sq = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          p[t][d] = i < nb ? (uint32_t)pb[(size_t)d * n_max + i] : 0u;
          sq += p[t][d] * p[t][d];
        }
        pp[t] = sq << shift;
        best[t] = 0x7fffffff;
        best_c[t] = 0;
      }

#pragma unroll 4
      for (int c = 0; c < k; ++c) {
        uint32_t r[Row<D>::kWords];
#pragma unroll
        for (int v = 0; v < Row<D>::kVecs; ++v) {
          const uint4 q = s_vecs[c * Row<D>::kVecs + v];
          r[4 * v] = q.x;
          r[4 * v + 1] = q.y;
          r[4 * v + 2] = q.z;
          r[4 * v + 3] = q.w;
        }
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          uint32_t key = r[D];
#pragma unroll
          for (int d = 0; d < D; ++d) key += p[t][d] * r[d];
          if (kPacked) {
            best[t] = min(best[t], (int32_t)key);
          } else if ((int32_t)key < best[t]) {  // strict: lowest index wins
            best[t] = (int32_t)key;
            best_c[t] = c;
          }
        }
      }

#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int i = base + t * kThreads + threadIdx.x;
        const bool valid = i < nb;
        int nw = 0;
        int32_t wi = 0;
        if (valid) {
          const int c0 = cur[lane_row + i];
          const uint32_t* row = s_rows + (size_t)c0 * Row<D>::kWords;
          uint32_t key0 = row[D];
#pragma unroll
          for (int d = 0; d < D; ++d) key0 += p[t][d] * row[d];
          const uint32_t cur_d2 = (key0 + pp[t]) >> shift;
          const uint32_t best_key = (uint32_t)best[t] + pp[t];
          const uint32_t best_d2 = best_key >> shift;
          const int bc = kPacked ? (int)(best_key & ((1u << shift) - 1u))
                                 : best_c[t];
          // a point moves only to a strictly closer centroid
          nw = best_d2 < cur_d2 ? bc : c0;
          new_out[lane_row + i] = nw;
          my_moved += nw != c0;
          wi = w[lane_row + i];
        }
        add_point_stats<D>(valid, nw, wi, p[t], dst_sums);
      }
    }
  }

  my_moved = __reduce_add_sync(kFull, my_moved);
  if ((threadIdx.x & 31) == 0 && my_moved) atomicAdd(&s_moved, my_moved);
  __syncthreads();
  if (threadIdx.x == 0 && s_moved) atomicAdd(moved + b, s_moved);
  if (kPruned && threadIdx.x == 0 && s_count[1])
    atomicAdd(pr.scanned, (u64)s_count[1]);
  if (kSmemStats) {
    for (int i = threadIdx.x; i < k * (D + 1); i += blockDim.x) {
      const u64 v = s_sums[i];
      if (v) atomicAdd(gsum + i, v);
    }
  }
  if (kFused) {
    // the lane's last block to get here runs its update: every thread's
    // atomics are fenced before the block's ticket, and every block of the
    // lane has read act[b] and cents[b] by the time the last one is drawn
    __shared__ int s_last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicInc(up.tickets + b, gridDim.x - 1) == gridDim.x - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      lane_update<false>(b, sums, moved, ptsT, n, nullptr, cents, act, up, D,
                         n_max, k);
      // (the queue is free by now: the snapshot's scratch)
      if (kPruned)
        snapshot_update<D>(b, (long long)t + 1, cents, k, pr,
                           reinterpret_cast<unsigned*>(s_queue));
    }
  }
}

size_t smem_bytes(int d, int k, bool smem_stats, bool pruned = false) {
  const size_t rows = (size_t)k * ((d + 1 + 3) / 4 * 4) * sizeof(uint32_t);
  return rows + (smem_stats ? round16((size_t)k * (d + 1) * sizeof(u64)) : 0) +
         (pruned ? round16((2 * kTile + 4 + kWindow) * sizeof(int)) : 0);
}

bool stats_in_smem(int d, int k) {
  return smem_bytes(d, k, true) <= kDefaultSmem;
}

constexpr int kMaxDevices = 64;

// What the runtime was asked about one kernel instance on one device. The
// shared-memory opt-in is only ever raised, so a launch that needs less than
// an earlier one still fits; `mu` orders callers from several host threads.
struct Asked {
  size_t opted = kDefaultSmem;  // the instance's dynamic shared-memory limit
  size_t smem = ~(size_t)0;     // the size `per_sm` was asked for
  int per_sm = 0;               // resident blocks an SM at that size
  int sms = 0;                  // the device's SM count
};

template <int D, bool kSmemStats, bool kPacked, bool kFused, bool kPruned>
cudaError_t launch(const int32_t* ptsT, const int32_t* w, const int32_t* cur,
                   int32_t* cents, const int32_t* n, int32_t* act,
                   int32_t* new_out, u64* sums, int32_t* moved, int B,
                   int n_max, int k, const Update& up, const Prune& pr,
                   cudaStream_t stream) {
  auto kernel = assign_stats_kernel<D, kSmemStats, kPacked, kFused, kPruned>;
  const size_t smem = smem_bytes(D, k, kSmemStats, kPruned);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  // one wave: as many blocks as fit the card at once, shared by the lanes
  // (asked of the runtime once per instance, device and shared-memory size)
  static std::mutex mu;
  static Asked asked[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int wave = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    Asked& a = asked[dev];
    if (smem > a.opted) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      a.opted = smem;
    }
    if (smem != a.smem) {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
      if (e != cudaSuccess) return e;
      a.per_sm = per_sm < 1 ? 1 : per_sm;
      a.smem = smem;
    }
    if (a.sms == 0) {
      e = cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      if (a.sms < 1) a.sms = 1;
    }
    wave = a.per_sm * a.sms;
  }
  const int tiles = (n_max + kTile - 1) / kTile;
  int bx = (wave + B - 1) / B;
  if (bx > tiles) bx = tiles;
  if (bx < 1) bx = 1;
  const int shift = kPacked ? log2_pow2_at_least(k) : 0;
  kernel<<<dim3(bx, B), kThreads, smem, stream>>>(
      ptsT, w, cur, cents, n, act, new_out, sums, moved, n_max, k, shift, up,
      pr);
  return cudaGetLastError();
}

template <int D, bool kFused, bool kPruned>
cudaError_t launch_d(const int32_t* ptsT, const int32_t* w, const int32_t* cur,
                     int32_t* cents, const int32_t* n, int32_t* act,
                     int32_t* new_out, u64* sums, int32_t* moved, int B,
                     int n_max, int k, bool packed, const Update& up,
                     const Prune& pr, cudaStream_t stream) {
  const bool in_smem = stats_in_smem(D, k);
#define CNIIC_K1_LAUNCH(SMEM, PACKED, PRUNED)                                 \
  launch<D, SMEM, PACKED, kFused, PRUNED>(ptsT, w, cur, cents, n, act,       \
                                          new_out, sums, moved, B, n_max, k, \
                                          up, pr, stream)
  if constexpr (kPruned) {
    if (packed) return cudaErrorInvalidValue;
    return in_smem ? CNIIC_K1_LAUNCH(true, false, true)
                   : CNIIC_K1_LAUNCH(false, false, true);
  } else {
    if (packed && in_smem) return CNIIC_K1_LAUNCH(true, true, false);
    if (packed) return CNIIC_K1_LAUNCH(false, true, false);
    if (in_smem) return CNIIC_K1_LAUNCH(true, false, false);
    return CNIIC_K1_LAUNCH(false, false, false);
  }
#undef CNIIC_K1_LAUNCH
}

// The pruned instance exists at d = 5 only (voronoi's points).
constexpr int kPrunedD = 5;

template <bool kFused, bool kPruned = false>
cudaError_t launch_step(const void* ptsT, const void* w, const void* cur,
                        void* cents, const void* n, void* act, void* new_out,
                        void* sums, void* moved, int B, int d, int n_max, int k,
                        int packed, const Update& up, void* stream,
                        const Prune& pr = Prune{}) {
  if (B <= 0 || n_max <= 0) return cudaSuccess;
  if (k < 1 || B > 65535) return cudaErrorInvalidValue;
  const int32_t* P = static_cast<const int32_t*>(ptsT);
  const int32_t* W = static_cast<const int32_t*>(w);
  const int32_t* C = static_cast<const int32_t*>(cur);
  int32_t* M = static_cast<int32_t*>(cents);
  const int32_t* N = static_cast<const int32_t*>(n);
  int32_t* A = static_cast<int32_t*>(act);
  int32_t* O = static_cast<int32_t*>(new_out);
  u64* S = static_cast<u64*>(sums);
  int32_t* V = static_cast<int32_t*>(moved);
  const bool pk = packed != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kPruned) {
    // a point the filter keeps is not written: the new ids go over cur
    if (d != kPrunedD || O != C) return cudaErrorInvalidValue;
    return launch_d<kPrunedD, kFused, true>(P, W, C, M, N, A, O, S, V, B,
                                            n_max, k, pk, up, pr, s);
  }
#define CNIIC_K1_CASE(D_)                                                     \
  case D_:                                                                    \
    return launch_d<D_, kFused, false>(P, W, C, M, N, A, O, S, V, B, n_max,   \
                                       k, pk, up, pr, s);
  switch (d) {
    CNIIC_K1_CASE(1)
    CNIIC_K1_CASE(2)
    CNIIC_K1_CASE(3)
    CNIIC_K1_CASE(4)
    CNIIC_K1_CASE(5)
    CNIIC_K1_CASE(6)
    CNIIC_K1_CASE(7)
    CNIIC_K1_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef CNIIC_K1_CASE
}

// D3 alone: one block a lane that the K1 before it ran.
template <bool kStolen>
__global__ void __launch_bounds__(kThreads)
step_update_kernel(u64* sums, int32_t* moved_k,
                   const int32_t* __restrict__ ptsT,
                   const int32_t* __restrict__ n,
                   const int32_t* __restrict__ stolen, int32_t* cents,
                   int32_t* act, int d, int n_max, int k, Update up) {
  const int b = blockIdx.x;
  if (act[b] == 0) return;
  lane_update<kStolen>(b, sums, moved_k, ptsT, n, stolen, cents, act, up, d,
                       n_max, k);
}

}  // namespace

extern "C" {

// Launch one K1 step on `stream`. Pointers are device pointers of contiguous
// tensors with the shapes noted on the kernel; `sums` is int64 (added as
// two's-complement u64), `sums` and `moved` are added to, `new_out` may be
// `cur`. `packed` != 0 takes the packed-key path, which needs
// (d2_bound + 1) * pk <= 2^31 (the caller checks). Returns a cudaError_t.
int kmeans_assign_stats(const void* ptsT, const void* w, const void* cur,
                        const void* cents, const void* n, const void* act,
                        void* new_out, void* sums, void* moved, int B, int d,
                        int n_max, int k, int packed, void* stream) {
  // the unfused kernel writes neither cents nor act
  return launch_step<false>(ptsT, w, cur, const_cast<void*>(cents), n,
                            const_cast<void*>(act), new_out, sums, moved, B, d,
                            n_max, k, packed, Update{}, stream);
}

// Launch one whole iteration on `stream`: K1, then D3 in each lane's last
// block. K1's operands as above (`moved_k` its int32 counts), D3's as in
// kmeans_step_update, and `tickets` uint32 [B], zero before the first launch
// (the kernel leaves them zero). Returns a cudaError_t.
int kmeans_fused_step(const void* ptsT, const void* w, const void* cur,
                      void* cents, const void* n, void* act, void* new_out,
                      void* sums, void* moved_k, void* moved, void* best,
                      void* stall, void* it, const void* thresh, void* tickets,
                      int B, int d, int n_max, int k, int packed,
                      long long stall_lim, long long max_iters, void* stream) {
  const Update up{static_cast<long long*>(moved), static_cast<long long*>(best),
                  static_cast<long long*>(stall), static_cast<long long*>(it),
                  static_cast<const long long*>(thresh),
                  static_cast<unsigned*>(tickets), stall_lim, max_iters};
  return launch_step<true>(ptsT, w, cur, cents, n, act, new_out, sums, moved_k,
                           B, d, n_max, k, packed, up, stream);
}

// Launch one whole iteration of the pruned instance on `stream`: as
// kmeans_fused_step, d = 5, unpacked keys, `new_out` == `cur`, with the
// bound filter's state: lb float32 [B, n_max] and since int32 [B, n_max]
// (zero before the first launch), ring int32 [B, kWindow, d, k] (the first
// centroids in slot 0) and mdisp float32 [B, kWindow] (zero), and
// `scanned`, a uint64 the kernel adds the points it scanned to. Returns a
// cudaError_t.
int kmeans_pruned_step(const void* ptsT, const void* w, const void* cur,
                       void* cents, const void* n, void* act, void* new_out,
                       void* sums, void* moved_k, void* moved, void* best,
                       void* stall, void* it, const void* thresh,
                       void* tickets, void* lb, void* since, void* ring,
                       void* mdisp, void* scanned, int B, int d, int n_max,
                       int k, int packed, long long stall_lim,
                       long long max_iters, void* stream) {
  const Update up{static_cast<long long*>(moved), static_cast<long long*>(best),
                  static_cast<long long*>(stall), static_cast<long long*>(it),
                  static_cast<const long long*>(thresh),
                  static_cast<unsigned*>(tickets), stall_lim, max_iters};
  const Prune pr{static_cast<float*>(lb), static_cast<int32_t*>(since),
                 static_cast<int32_t*>(ring), static_cast<float*>(mdisp),
                 static_cast<u64*>(scanned)};
  return launch_step<true, true>(ptsT, w, cur, cents, n, act, new_out, sums,
                                 moved_k, B, d, n_max, k, packed, up, stream,
                                 pr);
}

// The pruned instance's window of snapshots (kmeans_pruned_step's ring).
int kmeans_prune_window() { return kWindow; }

// Launch one D3 update on `stream` after a kmeans_assign_stats (shapes on
// lane_update; moved, best, stall, it and thresh are int64 [B]). `stolen`
// (int32 [B, k, d]) gives the empty clusters' points; null gathers them from
// ptsT by the hash. Returns a cudaError_t.
int kmeans_step_update(void* sums, void* moved_k, const void* ptsT,
                       const void* n, const void* stolen, void* cents,
                       void* moved, void* best, void* stall, void* act,
                       void* it, const void* thresh, int B, int d, int n_max,
                       int k, long long stall_lim, long long max_iters,
                       void* stream) {
  if (B <= 0) return cudaSuccess;
  if (d < 1 || k < 1 || n_max < 1) return cudaErrorInvalidValue;
  const Update up{static_cast<long long*>(moved), static_cast<long long*>(best),
                  static_cast<long long*>(stall), static_cast<long long*>(it),
                  static_cast<const long long*>(thresh), nullptr, stall_lim,
                  max_iters};
  auto kernel = stolen ? step_update_kernel<true> : step_update_kernel<false>;
  kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<u64*>(sums), static_cast<int32_t*>(moved_k),
      static_cast<const int32_t*>(ptsT), static_cast<const int32_t*>(n),
      static_cast<const int32_t*>(stolen), static_cast<int32_t*>(cents),
      static_cast<int32_t*>(act), d, n_max, k, up);
  return cudaGetLastError();
}

// 1 when the statistics tile of a (d, k) step lives in shared memory, 0 when
// the threads add straight into global memory (the large-k branch).
int kmeans_stats_in_smem(int d, int k) { return stats_in_smem(d, k) ? 1 : 0; }

const char* kmeans_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
