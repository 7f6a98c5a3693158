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
//   enforces).
//
// Layout: rgb is int32 [L][S] (packed 0x00RRGGBB, position-major), lens
// int32 [S], out int32 [L+1][S], flags int32 [S]. Thread j walks stream j
// through positions 0..L in order, so a warp's loads and stores at one
// position touch 32 neighbouring words.
//
// What bounds it on this card: the recurrence is strictly sequential within
// a stream, so a stream costs L dependent steps of some 40-60 integer or
// f32 operations, and S <= 1024 streams give at most 32 warps: the card is
// latency-bound and mostly idle. The design keeps memory off the critical
// path: one warp per block spreads the warps over separate SMs, and each
// thread issues the loads of the next kAhead positions before it works
// through the current ones. Making it fast (more streams per image, or a
// split of the recurrence) is later work.
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

// Walk positions 0..L of stream j, writing st.step(pixel, pos) at each.
template <class State>
__device__ __forceinline__ void walk(const int32_t* __restrict__ rgb,
                                     int32_t* __restrict__ out, int S, int L,
                                     int j, State& st) {
  int nxt[kAhead];
  load_ahead(rgb, S, L, j, 0, nxt);
  for (int base = 0; base <= L; base += kAhead) {
    int cur[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) cur[k] = nxt[k];
    load_ahead(rgb, S, L, j, base + kAhead, nxt);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int pos = base + k;
      if (pos <= L) out[(size_t)pos * S + j] = st.step(cur[k], pos);
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
  walk(rgb, out, S, L, j, st);
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
  walk(rgb, out, B, L, j, st);
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

const char* approx_rle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
