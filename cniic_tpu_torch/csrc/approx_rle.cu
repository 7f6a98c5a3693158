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
//   replays flagged streams in the exact-f64 host engine.
// * K3 (approx_rle_batch) replaces cniic_tpu/ops/approx_rle.py::_kernel: the
//   same recurrence in f32, as the TPU kernel evaluates it. Every f32
//   operation is an explicit round-to-nearest intrinsic so that nvcc cannot
//   contract or reorder it: dist2 = fma(t2, t2, fma(t0, t0, t1 * t1)), the
//   form XLA gives the TPU kernel's sum; 1 / max(c, 1) by IEEE division;
//   averages s * inv + 0.5, truncated. Positions are counted in int32 (the
//   TPU kernel's f32 positions agree with them up to 2^24, which the caller
//   enforces). Two schedules of the same steps: one thread a stream
//   (`batch_kernel`, approx_rle_batch), and speculative chunks of C
//   positions with the seams repaired on the card (`speculate_kernel`,
//   `repair_kernel`, `settle_kernel`, approx_rle_batch_chunked; the note
//   above them says why the records are the same).
//
// Layout: rgb is int32 [L][S] (packed 0x00RRGGBB, position-major), lens
// int32 [S], out int32 [L+1][S], flags int32 [S]. A thread walks its stream
// (or its chunk of it) in position order; threads t and t+1 are neighbouring
// streams, so at B = 8 streams each 32-byte sector a warp loads or stores at
// one position holds exactly the 8 words of one row.
//
// What bounds it on this card: the recurrence is strictly sequential within
// a stream, some 40-60 dependent integer or f32 operations a step (two IEEE
// divisions on a close). With one thread a stream, K2's <= 1024 streams give
// at most 32 warps and K3's 8 streams 8 threads: latency-bound, the card
// idle. K3's chunks give 8 L / C threads, so the dependent chain is C steps
// a thread plus the seams' repairs. Every walk issues the loads of its next
// kAhead positions before it works through the current ones.
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
template <class State>
__device__ __forceinline__ void walk(const int32_t* __restrict__ rgb,
                                     int32_t* __restrict__ out, int S, int L,
                                     int j, int p0, int p1, State& st) {
  int nxt[kAhead];
  load_ahead(rgb, S, L, j, p0, nxt);
  for (int base = p0; base < p1; base += kAhead) {
    int cur[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) cur[k] = nxt[k];
    load_ahead(rgb, S, L, j, base + kAhead, nxt);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int pos = base + k;
      if (pos < p1) out[(size_t)pos * S + j] = st.step(cur[k], pos);
    }
  }
}

// round(s / n) half up, for 0 <= s <= 65025 and 1 <= n <= 255, and whether
// s / n is exact in f64 (n / gcd(s, n) a power of two, i.e. n | 128 * r).
__device__ __forceinline__ int round_avg(int s, int n, bool* exact) {
  const int q = s / n;
  const int r = s - q * n;
  *exact = ((r << 7) % n) == 0;
  return q + (2 * r >= n ? 1 : 0);
}

struct WideState {
  int allow, len;
  int s0 = 0, s1 = 0, s2 = 0, c = 0, pend = 0, flag = 0;

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
    int rec = pend;
    if (active && !fresh) {
      bool e0, e1, e2;
      const int q0 = round_avg(s0, c, &e0);
      const int q1 = round_avg(s1, c, &e1);
      const int q2 = round_avg(s2, c, &e2);
      if (!accept) rec = kRec | (q0 << 16) | (q1 << 8) | q2;
      if (dist2 == thresh && !(e0 && e1 && e2)) flag = 1;
    }
    const int n0 = accept ? s0 + r : r;
    const int n1 = accept ? s1 + g : g;
    const int n2 = accept ? s2 + b : b;
    const int nc = accept ? c + 1 : 1;
    const bool capped = nc >= kCap;
    const bool last = active && pos >= len - 1;
    const bool close = active && (capped || last);
    pend = 0;
    if (close) {
      bool unused;
      pend = kRec | (last && !capped ? kLast : 0) |
             (round_avg(n0, nc, &unused) << 16) |
             (round_avg(n1, nc, &unused) << 8) | round_avg(n2, nc, &unused);
    }
    const bool keep = active && !close;
    s0 = keep ? n0 : 0;
    s1 = keep ? n1 : 0;
    s2 = keep ? n2 : 0;
    c = keep ? nc : 0;
    return rec;
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
  float allow;
  int len;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, c = 0.f;
  int pend = 0;

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
};

__global__ void __launch_bounds__(kThreads)
wide_kernel(const int32_t* __restrict__ rgb, const int32_t* __restrict__ lens,
            int32_t* __restrict__ out, int32_t* __restrict__ flags, int S,
            int L, int allow) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= S) return;
  WideState st;
  st.allow = allow;
  st.len = lens[j];
  walk(rgb, out, S, L, j, 0, L + 1, st);
  flags[j] = st.flag;
}

__global__ void __launch_bounds__(kThreads)
batch_kernel(const int32_t* __restrict__ rgb, const int32_t* __restrict__ lens,
             int32_t* __restrict__ out, int B, int L, float allow) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= B) return;
  BatchState st;
  st.allow = allow;
  st.len = lens[j];
  walk(rgb, out, B, L, j, 0, L + 1, st);
}

// ---------------------------------------------------------------------------
// K3 as speculative chunks: three launches on one stream, no host sync.
//
// The state after position q depends only on where the current run started
// (the f32 sums are integers below 2^24, so exact). So two walks that both
// start a run at q agree from q on, and for 0 < q < len a walk whose state
// came from a step starts a run at q exactly when its row q is a record.
//
// 1. speculate: one thread a (chunk, stream) walks the chunk from a fresh
//    state with the true length and saves its exit state;
// 2. repair: one thread a seam k >= 1 re-walks chunk k from chunk k-1's
//    speculative exit, always writing row p0 (the previous run's record),
//    until both walks start a run at one position or are past len; a seam
//    that does not sync saves its own exit and sets its bit in the stream's
//    unsynced bitmap. Chunk k's rows are then one walk from that entry;
// 3. settle: one warp a stream carries the true state across the seams. A
//    seam entered in the state its repair started from needs nothing: the
//    ballot over the bitmap jumps 1024 seams a load to the next unsynced
//    one, whose repair exit is the truth. Where the true state differs, lane
//    0 re-walks that chunk until it syncs with the rows already there.
//
// The worst case is a stream that never syncs (flat runs capped at 255 that
// start at other offsets than the chunks' own): the settle pass then walks
// the whole stream once, about the one-walker schedule's time, after two
// passes of one chunk each.
// ---------------------------------------------------------------------------

constexpr int kChunkThreads = 128;

// a walk's state after a position, as saved between the passes
struct Exit {
  float s0, s1, s2, c;
  int pend;
};

__device__ __forceinline__ void save(const BatchState& st, Exit* e) {
  *e = Exit{st.s0, st.s1, st.s2, st.c, st.pend};
}

__device__ __forceinline__ void restore(BatchState& st, const Exit& e) {
  st.s0 = e.s0;
  st.s1 = e.s1;
  st.s2 = e.s2;
  st.c = e.c;
  st.pend = e.pend;
}

__device__ __forceinline__ bool same(const BatchState& st, const Exit& e) {
  return st.s0 == e.s0 && st.s1 == e.s1 && st.s2 == e.s2 && st.c == e.c &&
         st.pend == e.pend;
}

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

// Walk positions [p0, p1) of stream j from st over the rows of an earlier
// walk W, writing each row, and stop at the first row q at which both start
// a run: q >= len, or both rows are records (`w_starts_p0`: W started a run
// at p0 whatever its row says, as a speculative walk did). From q on W's
// rows and state are this walk's, so the walk finishes its group of kAhead
// positions (rewriting rows W already holds) and the test stays off the
// chain of dependent steps. Returns whether it met such a q; `steps`
// counts the positions up to it.
__device__ __forceinline__ bool rewalk(const int32_t* __restrict__ rgb,
                                       int32_t* out, int S, int L, int j,
                                       int p0, int p1, BatchState& st,
                                       bool w_starts_p0, int& steps) {
  int nx[kAhead], no[kAhead];
  load_rows(rgb, out, S, L, j, p0, p1, nx, no);
  for (int base = p0; base < p1; base += kAhead) {
    int cx[kAhead], co[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cx[k] = nx[k];
      co[k] = no[k];
    }
    load_rows(rgb, out, S, L, j, base + kAhead, p1, nx, no);
    int hit = kAhead;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int pos = base + k;
      if (pos < p1) {
        const int row = st.step(cx[k], pos);
        out[(size_t)pos * S + j] = row;
        if (hit == kAhead &&
            (pos >= st.len ||
             (row != 0 && (co[k] != 0 || (w_starts_p0 && pos == p0)))))
          hit = k;
      }
    }
    if (hit < kAhead) {
      steps += hit + 1;
      return true;
    }
    steps += min(kAhead, p1 - base);
  }
  return false;
}

// Pass 1. Each thread issues its own loads kAhead positions ahead; at B = 8
// every 32-byte sector a warp loads is one whole row, so nothing is wasted.
// (Staging a block's rows in shared memory with cp.async instead was slower
// on the H100: PERF.md.)
__global__ void __launch_bounds__(kChunkThreads)
speculate_kernel(const int32_t* __restrict__ rgb,
                 const int32_t* __restrict__ lens, int32_t* __restrict__ out,
                 Exit* __restrict__ spec, uint32_t* __restrict__ unsynced,
                 int B, int L, int C, int nk, int nw, float allow) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = t % B;
  const int k = t / B;
  if (k >= nk) return;
  BatchState st;
  st.allow = allow;
  st.len = lens[j];
  const int p0 = k * C;
  walk(rgb, out, B, L, j, p0, min(p0 + C, L + 1), st);
  if ((k & 31) == 0) unsynced[(size_t)j * nw + (k >> 5)] = 0u;
  save(st, spec + (size_t)j * nk + k);
}

__global__ void __launch_bounds__(kChunkThreads)
repair_kernel(const int32_t* __restrict__ rgb,
              const int32_t* __restrict__ lens, int32_t* out,
              const Exit* __restrict__ spec, Exit* __restrict__ rep,
              uint32_t* __restrict__ unsynced, int B, int L, int C, int nk,
              int nw, float allow) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * (nk - 1)) return;
  const int j = t % B;
  const int k = 1 + t / B;
  BatchState st;
  st.allow = allow;
  st.len = lens[j];
  restore(st, spec[(size_t)j * nk + k - 1]);
  const int p0 = k * C;
  int steps = 0;
  if (!rewalk(rgb, out, B, L, j, p0, min(p0 + C, L + 1), st, true, steps)) {
    save(st, rep + (size_t)j * nk + k);
    atomicOr(unsynced + (size_t)j * nw + (k >> 5), 1u << (k & 31));
  }
}

// The first seam >= k whose repair did not sync, or nk; every lane of the
// warp gets the same answer.
__device__ __forceinline__ int next_unsynced(const uint32_t* __restrict__ bits,
                                             int k, int nk, int nw,
                                             int lane) {
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

__global__ void __launch_bounds__(32)
settle_kernel(const int32_t* __restrict__ rgb,
              const int32_t* __restrict__ lens, int32_t* out,
              const Exit* __restrict__ spec, const Exit* __restrict__ rep,
              const uint32_t* __restrict__ unsynced,
              int32_t* __restrict__ walked, int B, int L, int C, int nk,
              int nw, float allow) {
  const int j = blockIdx.x;
  const int lane = threadIdx.x;
  const Exit* sp = spec + (size_t)j * nk;
  const Exit* rp = rep + (size_t)j * nk;
  const uint32_t* bits = unsynced + (size_t)j * nw;
  BatchState st;  // the true state entering chunk k (lane 0's is used)
  st.allow = allow;
  st.len = lens[j];
  restore(st, sp[0]);  // chunk 0's speculative walk is the truth
  bool eq = true;      // st is the state chunk k's repair started from
  int k = 1, steps = 0;
  while (k < nk) {
    if (eq) {
      // synced seams pass the truth on unchanged: jump to the next one that
      // did not, whose rows are right and whose repair exit is the truth
      k = next_unsynced(bits, k, nk, nw, lane);
      if (k >= nk) break;
      restore(st, rp[k]);
      eq = false;
      ++k;
      continue;
    }
    int synced = 0;
    if (lane == 0) {
      if (same(st, sp[k - 1])) {
        synced = 1;
      } else {
        const int p0 = k * C;
        synced = rewalk(rgb, out, B, L, j, p0, min(p0 + C, L + 1), st, false,
                        steps);
      }
    }
    // synced: chunk k's rows from here on, and its exit, are its repair's
    if (__shfl_sync(~0u, synced, 0)) {
      eq = true;
    } else {
      ++k;
    }
  }
  if (lane == 0) walked[j] = steps;
}

}  // namespace

extern "C" {

// K2 on `stream`: rgb int32 [L][S], lens int32 [S] -> out int32 [L+1][S],
// flags int32 [S]. The caller checks S <= 1024, 0 <= allow <= 64, lens <= L.
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
  if (L < 0 || C < 1) return cudaErrorInvalidValue;
  const int nk = (int)(((int64_t)L + C) / C);
  const int nw = (nk + 31) / 32;
  if (nk < 2 || (int64_t)B * nk >= (1LL << 31)) return cudaErrorInvalidValue;
  auto* bits = static_cast<uint32_t*>(scratch);
  auto* spec = reinterpret_cast<Exit*>(bits + (size_t)B * nw);
  Exit* rep = spec + (size_t)B * nk;
  const auto* x = static_cast<const int32_t*>(rgb);
  const auto* n = static_cast<const int32_t*>(lens);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int g1 = (int)(((int64_t)B * nk + kChunkThreads - 1) / kChunkThreads);
  speculate_kernel<<<g1, kChunkThreads, 0, s>>>(x, n, o, spec, bits, B, L, C,
                                                nk, nw, allow);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int g2 =
      (int)(((int64_t)B * (nk - 1) + kChunkThreads - 1) / kChunkThreads);
  repair_kernel<<<g2, kChunkThreads, 0, s>>>(x, n, o, spec, rep, bits, B, L,
                                             C, nk, nw, allow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  settle_kernel<<<B, 32, 0, s>>>(x, n, o, spec, rep, bits,
                                 static_cast<int32_t*>(walked), B, L, C, nk,
                                 nw, allow);
  return cudaGetLastError();
}

const char* approx_rle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
