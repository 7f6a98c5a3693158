// K2 and K3: approximate run-length encoding of many independent streams,
// for Hopper.
//
// Both compute the reference's running-average recurrence (hilbertc.rs:
// 200-285): a run accepts the next pixel x while
//
//   sum_c (S_c - cnt * x_c)^2 <= (allow * cnt)^2      (the count^2-scaled
//                                                      form of |avg - x| <= allow)
//
// and closes on a reject, at 255 pixels, or at the stream's end. A record
// 1<<24 | r<<16 | g<<8 | b (the run's rounded average) is written at the
// position AFTER the run's last pixel, so out has L+1 rows and every other
// entry is 0.
//
// * K2 (approx_rle_wide) replaces cniic_tpu/ops/approx_rle.py::_wkernel:
//   exact int32 arithmetic, terms clamped at 16384 (allow <= 64 keeps every
//   decision), averages rounded half up in integers, bit 25 on a record
//   closed by the stream's end, and a per-stream flag raised on a boundary
//   tie (dist2 == thresh) whose averages are not all exact in f64; the caller
//   replays flagged streams in the exact-f64 host engine. No integer
//   division: s / n is umulhi(s, M[n]) with M[n] = ceil(2^32 / n) from a
//   256-entry table in shared memory (exact for s <= 65025, n <= 255), and
//   no branch: the averages a step may write are formed every step and
//   chosen by predicate, off the chain of sums and counts.
// * K3 (approx_rle_batch) replaces cniic_tpu/ops/approx_rle.py::_kernel: the
//   same recurrence in f32, as the TPU kernel evaluates it. Every f32
//   operation is an explicit round-to-nearest intrinsic so that nvcc cannot
//   contract or reorder it: dist2 = fma(t2, t2, fma(t0, t0, t1 * t1)), the
//   form XLA gives the TPU kernel's sum; 1 / max(c, 1) by IEEE division;
//   averages s * inv + 0.5, truncated. Positions are counted in int32 (the
//   TPU kernel's f32 positions agree with them up to 2^24, which the caller
//   enforces).
//
// Each runs in two schedules of the same steps: one thread a stream
// (`wide_kernel`, `batch_kernel`: one launch), and speculative chunks of C
// positions with the seams repaired on the card (`speculate_kernel`,
// `repair_kernel`, `settle_kernel`, one template for both state types; K2
// adds `wide_flags_kernel`). The note above the chunk kernels says why the
// records are the same.
//
// Layout: rgb is int32 [L][S] (packed 0x00RRGGBB, position-major), lens
// int32 [S], out int32 [L+1][S], flags int32 [S]. A thread walks its stream
// (or its chunk of it) in position order; threads t and t+1 are neighbouring
// streams, so a warp loads or stores whole 32-byte sectors at one position
// (K2's 1024 streams: 128 contiguous bytes a warp).
//
// What bounds it on this card: the recurrence is strictly sequential within
// a stream, some 40-60 dependent integer or f32 operations a step among
// the hundred or so a K2 step issues (the averages' integer multiplies
// among them). With one thread a stream, K2's <= 1024 streams
// give at most 32 warps and K3's 8 streams 8 threads: the card idle. The
// chunks give S * L / C walkers, so what bounds both is C steps of issue
// and dependent latency a walker plus the seams' repairs, not bytes. Every
// walk issues the loads of its next kAhead positions before it works
// through the current ones, and whole groups of kAhead steps are
// straight-line code, so the compiler interleaves their independent parts.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (see cniic_tpu_torch/ops/approx_rle.py); no fast-math
// flag. The launchers have a plain C interface, run on the caller's stream,
// allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp per block
constexpr int kAhead = 8;     // positions loaded ahead of the arithmetic
constexpr int kCap = 255;
constexpr int kIcl = 16384;
constexpr int kRec = 1 << 24;
constexpr int kLast = 1 << 25;
constexpr int kTie = 1 << 26;  // K2's chunk walks: a tie at this row
constexpr int kRecipN = 256;

__device__ __forceinline__ void load_ahead(const int32_t* __restrict__ rgb,
                                           int S, int L, int j, int base,
                                           int (&v)[kAhead]) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int pos = base + k;
    v[k] = pos < L ? __ldg(rgb + (size_t)pos * S + j) : 0;
  }
}

// Walk positions [p0, p1) of stream j, writing st.step(pixel, pos) at each.
// Whole groups of kAhead positions carry no guard, so that their steps form
// one block of straight-line code the compiler can interleave; the last,
// partial group is guarded.
template <class State>
__device__ __forceinline__ void walk(const int32_t* __restrict__ rgb,
                                     int32_t* __restrict__ out, int S, int L,
                                     int j, int p0, int p1, State& st) {
  int nxt[kAhead];
  load_ahead(rgb, S, L, j, p0, nxt);
  int base = p0;
  for (; base + kAhead <= p1; base += kAhead) {
    int cur[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) cur[k] = nxt[k];
    load_ahead(rgb, S, L, j, base + kAhead, nxt);
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
      out[(size_t)(base + k) * S + j] = st.step(cur[k], base + k);
  }
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int pos = base + k;
    if (pos < p1) out[(size_t)pos * S + j] = st.step(nxt[k], pos);
  }
}

// M[n] = ceil(2^32 / n) for 2 <= n <= 255, M[0] = M[1] = 0, in `tab`
// (shared memory; every thread of the block calls this). For 0 <= s <=
// 65025, floor(s / n) = umulhi(s, M[n]) exactly: the error s * (M[n] * n -
// 2^32) / (n * 2^32) stays under 1/n since s * 254 < 2^32.
__device__ __forceinline__ const uint32_t* recip_table(uint32_t* tab) {
  for (int i = threadIdx.x; i < kRecipN; i += blockDim.x)
    tab[i] = i < 2 ? 0u : 0xFFFFFFFFu / (uint32_t)i + 1u;
  __syncthreads();
  return tab;
}

// floor(s / n), 0 <= s <= 65025, 1 <= n <= 255, m = M[n]
__device__ __forceinline__ int quot(int s, int n, uint32_t m) {
  return n == 1 ? s : (int)__umulhi((uint32_t)s, m);
}

// One channel's average s / n: round(s / n) half up, and whether s / n is
// exact in f64 (n / gcd(s, n) a power of two, i.e. n | 128 * (s mod n);
// at n = 1, M[1] = 0 and the remainder 0 give true).
struct Avg {
  int q;
  bool exact;
};

__device__ __forceinline__ Avg average(int s, int n, uint32_t m) {
  const int q = quot(s, n, m);
  const int r = s - q * n;
  const uint32_t r7 = (uint32_t)r << 7;
  return Avg{q + (2 * r >= n ? 1 : 0), __umulhi(r7, m) * n == r7};
}

__device__ __forceinline__ int pack3(const Avg& a, const Avg& b,
                                     const Avg& c) {
  return (a.q << 16) | (b.q << 8) | c.q;
}

// K2's step, without branches: both averages a step can write are formed
// every step and chosen by predicate, so the steps of a group of kAhead are
// one block of straight-line code (only the sums and the count are on the
// chain from step to step). kMark: a tie marks the row with kTie (the chunk
// walks, whose rows wide_flags_kernel reads once they are the truth's);
// otherwise it raises `flag` (one walker a stream).
template <bool kMark>
struct WideState {
  using Param = int;
  static constexpr bool kTable = true;
  struct Exit {
    int s0, s1, s2, c, pend;
  };

  int allow, len;
  const uint32_t* tab;
  int s0 = 0, s1 = 0, s2 = 0, c = 0, pend = 0, flag = 0;

  __device__ WideState(int allow_, int len_, const uint32_t* tab_)
      : allow(allow_), len(len_), tab(tab_) {}

  __device__ __forceinline__ int step(int packed, int pos) {
    const int r = (packed >> 16) & 0xFF;
    const int g = (packed >> 8) & 0xFF;
    const int b = packed & 0xFF;
    const bool active = pos < len;
    const bool fresh = c == 0;
    const int t0 = min(abs(s0 - c * r), kIcl);
    const int t1 = min(abs(s1 - c * g), kIcl);
    const int t2 = min(abs(s2 - c * b), kIcl);
    const int dist2 = t0 * t0 + t1 * t1 + t2 * t2;
    const int ac = allow * c;
    const int thresh = ac * ac;
    const bool accept = !fresh && dist2 <= thresh;
    const bool live = active && !fresh;
    const uint32_t m = tab[c];
    const Avg a0 = average(s0, c, m), a1 = average(s1, c, m),
              a2 = average(s2, c, m);
    int rec = live && !accept ? kRec | pack3(a0, a1, a2) : pend;
    const bool tie = live && dist2 == thresh &&
                     !(a0.exact && a1.exact && a2.exact);
    if constexpr (kMark) {
      rec |= tie ? kTie : 0;
    } else {
      flag |= tie ? 1 : 0;
    }
    const int n0 = accept ? s0 + r : r;
    const int n1 = accept ? s1 + g : g;
    const int n2 = accept ? s2 + b : b;
    const int nc = accept ? c + 1 : 1;
    const bool capped = nc >= kCap;
    const bool last = active && pos >= len - 1;
    const bool close = active && (capped || last);
    const uint32_t mn = tab[nc];
    const int closed = kRec | (last && !capped ? kLast : 0) |
                       pack3(average(n0, nc, mn), average(n1, nc, mn),
                             average(n2, nc, mn));
    pend = close ? closed : 0;
    const bool keep = active && !close;
    s0 = keep ? n0 : 0;
    s1 = keep ? n1 : 0;
    s2 = keep ? n2 : 0;
    c = keep ? nc : 0;
    return rec;
  }

  __device__ __forceinline__ Exit save() const {
    return Exit{s0, s1, s2, c, pend};
  }
  __device__ __forceinline__ void restore(const Exit& e) {
    s0 = e.s0;
    s1 = e.s1;
    s2 = e.s2;
    c = e.c;
    pend = e.pend;
  }
  __device__ __forceinline__ bool same(const Exit& e) const {
    return s0 == e.s0 && s1 == e.s1 && s2 == e.s2 && c == e.c &&
           pend == e.pend;
  }
};

__device__ __forceinline__ int avg_byte(float s, float inv) {
  return __float2int_rz(__fadd_rn(__fmul_rn(s, inv), 0.5f));
}

__device__ __forceinline__ int pack_avg(float s0, float s1, float s2,
                                        float n) {
  const float inv = __fdiv_rn(1.0f, fmaxf(n, 1.0f));
  return kRec | (avg_byte(s0, inv) << 16) | (avg_byte(s1, inv) << 8) |
         avg_byte(s2, inv);
}

struct BatchState {
  using Param = float;
  static constexpr bool kTable = false;
  struct Exit {
    float s0, s1, s2, c;
    int pend;
  };

  float allow;
  int len;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, c = 0.f;
  int pend = 0;

  __device__ BatchState(float allow_, int len_, const uint32_t*)
      : allow(allow_), len(len_) {}

  __device__ __forceinline__ int step(int packed, int pos) {
    const float r = (float)((packed >> 16) & 0xFF);
    const float g = (float)((packed >> 8) & 0xFF);
    const float b = (float)(packed & 0xFF);
    const bool active = pos < len;
    const bool fresh = c == 0.f;
    const float t0 = __fsub_rn(s0, __fmul_rn(c, r));
    const float t1 = __fsub_rn(s1, __fmul_rn(c, g));
    const float t2 = __fsub_rn(s2, __fmul_rn(c, b));
    const float dist2 =
        __fmaf_rn(t2, t2, __fmaf_rn(t0, t0, __fmul_rn(t1, t1)));
    const float ac = __fmul_rn(allow, c);
    const bool accept = !fresh && dist2 <= __fmul_rn(ac, ac);
    int rec = pend;
    if (active && !fresh && !accept) rec = pack_avg(s0, s1, s2, c);
    const float n0 = accept ? __fadd_rn(s0, r) : r;
    const float n1 = accept ? __fadd_rn(s1, g) : g;
    const float n2 = accept ? __fadd_rn(s2, b) : b;
    const float nc = accept ? __fadd_rn(c, 1.0f) : 1.0f;
    const bool capped = nc >= (float)kCap;
    const bool last = active && pos >= len - 1;
    const bool close = active && (capped || last);
    pend = close ? pack_avg(n0, n1, n2, nc) : 0;
    const bool keep = active && !close;
    s0 = keep ? n0 : 0.f;
    s1 = keep ? n1 : 0.f;
    s2 = keep ? n2 : 0.f;
    c = keep ? nc : 0.f;
    return rec;
  }

  __device__ __forceinline__ Exit save() const {
    return Exit{s0, s1, s2, c, pend};
  }
  __device__ __forceinline__ void restore(const Exit& e) {
    s0 = e.s0;
    s1 = e.s1;
    s2 = e.s2;
    c = e.c;
    pend = e.pend;
  }
  __device__ __forceinline__ bool same(const Exit& e) const {
    return s0 == e.s0 && s1 == e.s1 && s2 == e.s2 && c == e.c &&
           pend == e.pend;
  }
};

// the launchers' scratch holds two exits a (stream, chunk) in 10 words
static_assert(sizeof(WideState<true>::Exit) == 20, "K2 exit is 5 words");
static_assert(sizeof(BatchState::Exit) == 20, "K3 exit is 5 words");

// The block's division table where the state needs one (every thread of
// the block must call this before any returns).
template <class State>
__device__ __forceinline__ const uint32_t* tables(uint32_t* tab) {
  if constexpr (State::kTable) {
    return recip_table(tab);
  } else {
    return nullptr;
  }
}

__global__ void __launch_bounds__(kThreads)
wide_kernel(const int32_t* __restrict__ rgb, const int32_t* __restrict__ lens,
            int32_t* __restrict__ out, int32_t* __restrict__ flags, int S,
            int L, int allow) {
  __shared__ uint32_t tab[kRecipN];
  recip_table(tab);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= S) return;
  WideState<false> st(allow, lens[j], tab);
  walk(rgb, out, S, L, j, 0, L + 1, st);
  flags[j] = st.flag;
}

__global__ void __launch_bounds__(kThreads)
batch_kernel(const int32_t* __restrict__ rgb, const int32_t* __restrict__ lens,
             int32_t* __restrict__ out, int B, int L, float allow) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  BatchState st(allow, lens[j], nullptr);
  walk(rgb, out, B, L, j, 0, L + 1, st);
}

// ---------------------------------------------------------------------------
// Speculative chunks: three launches on one stream (four for K2), no host
// sync. The same kernels run K2's WideState<true> and K3's BatchState.
//
// The state after position q depends only on where the current run started
// (K2's sums are exact ints, K3's f32 sums integers below 2^24, so exact).
// So two walks that both start a run at q agree from q on, and for 0 < q <
// len a walk whose state came from a step starts a run at q exactly when
// its row q is a record (bit 24; K2's rows may also carry kTie).
//
// 1. speculate: one thread a (chunk, stream) walks the chunk from a fresh
//    state with the true length and saves its exit state;
// 2. repair: one thread a seam k >= 1 re-walks chunk k from chunk k-1's
//    speculative exit, always writing row p0 (the previous run's record),
//    until both walks start a run at one position or are past len; a seam
//    that does not sync saves its own exit and sets its bit in the stream's
//    unsynced bitmap. Chunk k's rows are then one walk from that entry;
// 3. settle: the true state is carried across the seams, by a warp a stream
//    (K3: the ballot over the bitmap jumps 1024 seams a load) or a thread a
//    stream (K2: a few bitmap words a stream, and a flat stream's lanes walk
//    in step). A seam entered in the state its repair started from needs
//    nothing: the next unsynced one's repair exit is the truth. Where the
//    true state differs, the stream's walker walks the whole chunk from it
//    (rows past a point where it meets the rows already there are rewritten
//    with the same values) and compares again at the next seam.
// 4. K2 only, wide_flags_kernel: every row is now the true walk's, so a
//    stream's flag (zeroed by pass 1) is the OR of kTie over its column,
//    which is then cleared.
//    A tie that only a speculative walk met was overwritten with the truth's
//    row; one the truth meets in a re-walked region was written by it.
//
// The worst case is a stream that never syncs (flat runs capped at 255 that
// start at other offsets than the chunks' own): the settle pass then walks
// the whole stream once with the one walker's loop, after two passes of one
// chunk each.
// ---------------------------------------------------------------------------

constexpr int kChunkThreads = 128;

// the pixels and the rows already written at positions base..base+kAhead-1
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ rgb,
                                          const int32_t* out, int S, int L,
                                          int j, int base, int p1,
                                          int (&x)[kAhead], int (&o)[kAhead]) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int pos = base + k;
    x[k] = pos < L ? __ldg(rgb + (size_t)pos * S + j) : 0;
    o[k] = pos < p1 ? out[(size_t)pos * S + j] : 0;
  }
}

// One group of positions base..base+kAhead-1 of a re-walk (kWhole: all
// below p1): writes each row and returns the first k at which this walk and
// W both start a run (see rewalk), or kAhead. The test is bitwise, not
// short-circuit, so that a whole group stays one block of straight-line
// code, as in walk.
template <bool kWhole, class State>
__device__ __forceinline__ int rewalk_group(int32_t* out, int S, int j,
                                            int base, int p0, int p1,
                                            const int (&x)[kAhead],
                                            const int (&o)[kAhead],
                                            State& st) {
  int hit = kAhead;
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int pos = base + k;
    if (kWhole || pos < p1) {
      const int row = st.step(x[k], pos);
      out[(size_t)pos * S + j] = row;
      // bit 0: W's row is a record, or W started its run at p0
      const int w_starts = (o[k] >> 24) | (pos == p0 ? 1 : 0);
      const int sync = (pos >= st.len ? 1 : 0) | ((row >> 24) & w_starts & 1);
      hit = min(hit, sync ? k : kAhead);
    }
  }
  return hit;
}

// Walk positions [p0, p1) of stream j from st over the rows of the walk W
// that started fresh at p0 (a speculative walk), writing each row, and
// stop at the first row q at which both start a run: q >= len, or this
// walk's row q is a record and W started a run at q (its row is a record,
// or q = p0). From q on W's rows and state are this walk's, so
// the walk finishes its group of kAhead positions (rewriting rows W
// already holds) and the test stays off the chain of dependent steps.
// Returns whether it met such a q. Whole groups carry no guard, as in walk.
template <class State>
__device__ __forceinline__ bool rewalk(const int32_t* __restrict__ rgb,
                                       int32_t* out, int S, int L, int j,
                                       int p0, int p1, State& st) {
  int nx[kAhead], no[kAhead];
  load_rows(rgb, out, S, L, j, p0, p1, nx, no);
  int base = p0;
  for (; base + kAhead <= p1; base += kAhead) {
    int cx[kAhead], co[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cx[k] = nx[k];
      co[k] = no[k];
    }
    load_rows(rgb, out, S, L, j, base + kAhead, p1, nx, no);
    if (rewalk_group<true>(out, S, j, base, p0, p1, cx, co, st) < kAhead)
      return true;
  }
  return base < p1 &&
         rewalk_group<false>(out, S, j, base, p0, p1, nx, no, st) < kAhead;
}

// Pass 1. Each thread issues its own loads kAhead positions ahead; every
// 32-byte sector a warp loads is one whole stretch of a row, so nothing is
// wasted. (Staging a block's rows in shared memory with cp.async instead
// was slower on the H100 for K3: PERF.md.)
template <class State>
__global__ void __launch_bounds__(kChunkThreads)
speculate_kernel(const int32_t* __restrict__ rgb,
                 const int32_t* __restrict__ lens, int32_t* __restrict__ out,
                 typename State::Exit* __restrict__ spec,
                 uint32_t* __restrict__ unsynced, int32_t* __restrict__ flags,
                 int S, int L, int C, int nk, int nw,
                 typename State::Param allow) {
  __shared__ uint32_t tab[State::kTable ? kRecipN : 1];
  const uint32_t* tb = tables<State>(tab);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = t % S;
  const int k = t / S;
  if (k >= nk) return;
  State st(allow, lens[j], tb);
  const int p0 = k * C;
  walk(rgb, out, S, L, j, p0, min(p0 + C, L + 1), st);
  if ((k & 31) == 0) unsynced[(size_t)j * nw + (k >> 5)] = 0u;
  if (flags != nullptr && k == 0) flags[j] = 0;
  spec[(size_t)j * nk + k] = st.save();
}

template <class State>
__global__ void __launch_bounds__(kChunkThreads)
repair_kernel(const int32_t* __restrict__ rgb,
              const int32_t* __restrict__ lens, int32_t* out,
              const typename State::Exit* __restrict__ spec,
              typename State::Exit* __restrict__ rep,
              uint32_t* __restrict__ unsynced, int S, int L, int C, int nk,
              int nw, typename State::Param allow) {
  __shared__ uint32_t tab[State::kTable ? kRecipN : 1];
  const uint32_t* tb = tables<State>(tab);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S * (nk - 1)) return;
  const int j = t % S;
  const int k = 1 + t / S;
  State st(allow, lens[j], tb);
  st.restore(spec[(size_t)j * nk + k - 1]);
  const int p0 = k * C;
  if (!rewalk(rgb, out, S, L, j, p0, min(p0 + C, L + 1), st)) {
    rep[(size_t)j * nk + k] = st.save();
    atomicOr(unsynced + (size_t)j * nw + (k >> 5), 1u << (k & 31));
  }
}

// The first seam >= k whose repair did not sync, or nk. G = 32: the whole
// warp reads 32 bitmap words a load and every lane gets the same answer;
// G = 1: the thread reads its own stream's words.
template <int G>
__device__ __forceinline__ int next_unsynced(const uint32_t* __restrict__ bits,
                                             int k, int nk, int nw,
                                             int lane) {
  if constexpr (G == 1) {
    for (int w = k >> 5; w < nw; ++w) {
      uint32_t v = bits[w];
      if (w == (k >> 5)) v &= ~0u << (k & 31);
      if (v) return min((w << 5) + __ffs(v) - 1, nk);
    }
    return nk;
  } else {
    for (int w = k >> 5; w < nw; w += 32) {
      const int i = w + lane;
      uint32_t v = i < nw ? bits[i] : 0u;
      if (i == (k >> 5)) v &= ~0u << (k & 31);
      const uint32_t m = __ballot_sync(~0u, v != 0u);
      if (m) {
        const int l = __ffs(m) - 1;
        v = __shfl_sync(~0u, v, l);
        return min(((w + l) << 5) + __ffs(v) - 1, nk);
      }
    }
    return nk;
  }
}

// Pass 3: G threads a stream (32 or 1), in blocks of one warp.
template <class State, int G>
__global__ void __launch_bounds__(32)
settle_kernel(const int32_t* __restrict__ rgb,
              const int32_t* __restrict__ lens, int32_t* out,
              const typename State::Exit* __restrict__ spec,
              const typename State::Exit* __restrict__ rep,
              const uint32_t* __restrict__ unsynced,
              int32_t* __restrict__ walked, int S, int L, int C, int nk,
              int nw, typename State::Param allow) {
  __shared__ uint32_t tab[State::kTable ? kRecipN : 1];
  const uint32_t* tb = tables<State>(tab);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = t / G;
  const int lane = t % G;
  if (j >= S) return;  // whole warps when G = 32
  const auto* sp = spec + (size_t)j * nk;
  const auto* rp = rep + (size_t)j * nk;
  const uint32_t* bits = unsynced + (size_t)j * nw;
  State st(allow, lens[j], tb);  // the true state entering chunk k
  st.restore(sp[0]);             // chunk 0's speculative walk is the truth
  bool eq = true;  // st is the state chunk k's repair started from
  int k = 1, steps = 0;
  while (k < nk) {
    if (eq) {
      // synced seams pass the truth on unchanged: jump to the next one that
      // did not, whose rows are right and whose repair exit is the truth
      k = next_unsynced<G>(bits, k, nk, nw, lane);
      if (k >= nk) break;
      st.restore(rp[k]);
      eq = false;
      if (++k >= nk) break;
    }
    // the truth entering chunk k against the state its repair started from;
    // where they differ, the truth walks the whole chunk
    int differ = 0;
    if (lane == 0) {
      differ = !st.same(sp[k - 1]);
      if (differ) {
        const int p0 = k * C, p1 = min(p0 + C, L + 1);
        walk(rgb, out, S, L, j, p0, p1, st);
        steps += p1 - p0;
      }
    }
    if constexpr (G > 1) differ = __shfl_sync(~0u, differ, 0);
    if (differ) {
      ++k;
    } else {
      eq = true;
    }
  }
  if (lane == 0) walked[j] = steps;
}

// Pass 4 (K2): blocks of 32 streams x 32 row phases over kFlagRows rows,
// each warp reading one row's 128 contiguous bytes at a time; a block ORs
// its streams' marks into their flags, which the speculate pass zeroed.
constexpr int kFlagRows = 32 * kAhead;

__global__ void __launch_bounds__(1024)
wide_flags_kernel(int32_t* __restrict__ out, int32_t* __restrict__ flags,
                  int S, int L) {
  __shared__ int tied[32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * 32 + tx;
  const int r0 = blockIdx.y * kFlagRows + ty;
  if (ty == 0) tied[tx] = 0;
  __syncthreads();
  if (j < S) {
    int v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = r0 + 32 * u;
      v[u] = r <= L ? out[(size_t)r * S + j] : 0;
    }
    int f = 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (v[u] & kTie) {
        f = 1;
        out[(size_t)(r0 + 32 * u) * S + j] = v[u] & ~kTie;
      }
    }
    if (f) tied[tx] = 1;
  }
  __syncthreads();
  if (ty == 0 && j < S && tied[tx]) atomicOr(flags + j, 1);
}

// nk = ceil((L + 1) / C) >= 2 chunks, nw = ceil(nk / 32); scratch: int32
// [S * nw + 10 * S * nk] (the unsynced bitmaps, then the speculative and
// the repair exits).
template <class State, int G>
cudaError_t launch_chunks(const int32_t* x, const int32_t* n, int32_t* o,
                          void* scratch, int32_t* walked, int32_t* flags,
                          int S, int L, int C, typename State::Param allow,
                          cudaStream_t s) {
  using Exit = typename State::Exit;
  if (L < 0 || C < 1) return cudaErrorInvalidValue;
  const int nk = (int)(((int64_t)L + C) / C);
  const int nw = (nk + 31) / 32;
  if (nk < 2 || (int64_t)S * nk >= (1LL << 31)) return cudaErrorInvalidValue;
  auto* bits = static_cast<uint32_t*>(scratch);
  auto* spec = reinterpret_cast<Exit*>(bits + (size_t)S * nw);
  Exit* rep = spec + (size_t)S * nk;
  const int g1 = (int)(((int64_t)S * nk + kChunkThreads - 1) / kChunkThreads);
  speculate_kernel<State><<<g1, kChunkThreads, 0, s>>>(
      x, n, o, spec, bits, flags, S, L, C, nk, nw, allow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int g2 =
      (int)(((int64_t)S * (nk - 1) + kChunkThreads - 1) / kChunkThreads);
  repair_kernel<State><<<g2, kChunkThreads, 0, s>>>(x, n, o, spec, rep, bits,
                                                    S, L, C, nk, nw, allow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  settle_kernel<State, G><<<(S * G + 31) / 32, 32, 0, s>>>(
      x, n, o, spec, rep, bits, walked, S, L, C, nk, nw, allow);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 on `stream`, one thread a stream: rgb int32 [L][S], lens int32 [S] ->
// out int32 [L+1][S], flags int32 [S]. The caller checks S <= 1024, 0 <=
// allow <= 64, lens <= L.
int approx_rle_wide(const void* rgb, const void* lens, void* out, void* flags,
                    int S, int L, int allow, void* stream) {
  if (S <= 0) return cudaSuccess;
  if (L < 0 || allow < 0 || allow > 64) return cudaErrorInvalidValue;
  const int blocks = (S + kThreads - 1) / kThreads;
  wide_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rgb), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), static_cast<int32_t*>(flags), S, L, allow);
  return cudaGetLastError();
}

// K2 as speculative chunks of C positions on `stream`: the records and
// flags of approx_rle_wide in four launches. scratch: int32 [S * nw + 10 *
// S * nk] with nk = ceil((L + 1) / C) >= 2, nw = ceil(nk / 32); walked:
// int32 [S] (positions the settle pass re-walked). The caller checks S <=
// 1024, 0 <= allow <= 64, lens <= L.
int approx_rle_wide_chunked(const void* rgb, const void* lens, void* out,
                            void* flags, void* scratch, void* walked, int S,
                            int L, int C, int allow, void* stream) {
  if (S <= 0) return cudaSuccess;
  if (allow < 0 || allow > 64) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(out);
  auto* f = static_cast<int32_t*>(flags);
  cudaError_t err = launch_chunks<WideState<true>, 1>(
      static_cast<const int32_t*>(rgb), static_cast<const int32_t*>(lens), o,
      scratch, static_cast<int32_t*>(walked), f, S, L, C, allow, s);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 31) / 32, L / kFlagRows + 1);
  wide_flags_kernel<<<grid, dim3(32, 32), 0, s>>>(o, f, S, L);
  return cudaGetLastError();
}

// K3 on `stream`: rgb int32 [L][B], lens int32 [B] -> out int32 [L+1][B].
// The caller checks L <= 2^24 and lens <= L.
int approx_rle_batch(const void* rgb, const void* lens, void* out, int B,
                     int L, float allow, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (L < 0) return cudaErrorInvalidValue;
  const int blocks = (B + kThreads - 1) / kThreads;
  batch_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rgb), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), B, L, allow);
  return cudaGetLastError();
}

// K3 as speculative chunks of C positions on `stream`: the records of
// approx_rle_batch in three launches. nk = ceil((L + 1) / C)
// >= 2 chunks, nw = ceil(nk / 32); scratch: int32 [B * nw + 10 * B * nk]
// (the unsynced bitmaps, then the speculative and the repair exits),
// walked: int32 [B] (positions the settle pass re-walked). The caller
// checks L <= 2^24, lens <= L.
int approx_rle_batch_chunked(const void* rgb, const void* lens, void* out,
                             void* scratch, void* walked, int B, int L, int C,
                             float allow, void* stream) {
  if (B <= 0) return cudaSuccess;
  return launch_chunks<BatchState, 32>(
      static_cast<const int32_t*>(rgb), static_cast<const int32_t*>(lens),
      static_cast<int32_t*>(out), scratch, static_cast<int32_t*>(walked),
      nullptr, B, L, C, allow, static_cast<cudaStream_t>(stream));
}

const char* approx_rle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
