// Mamba-1 selective scan for the SSM family's blocks, written for Hopper
// (sm_90a). Replaces the Pallas TPU kernel `mamba_scan_pallas` (body
// `_kernel`) in src/repro/kernels/mamba_scan.py; the design note, with the
// bound at the serving path's shapes, is in
// src/repro_torch/kernels/mamba_scan.py.
//
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] x_t[d] B_t[n]
//   y_t[d]    = sum_n h_t[d, n] C_t[n] + D[d] x_t[d]      (ascending n)
//
// x, B and C come in the block's dtype T (bf16 or f32) and dt in f32 (the
// block's softplus adds an f32 bias, so its dt is f32 in either model);
// x, B and C are widened to f32 in registers (exact); B and C may be strided
// views (unit stride over n, any batch and timestep stride). y is written
// in T, rounded to nearest; h_last is f32. h0 may be null: a zero state,
// never read.
//
// One thread per (batch, channel) with its N <= 32 states and its row of
// A' = A log2(e) in registers (template kMaxN, the smallest of 8, 16, 32
// that holds N), so each decay is one `ex2.approx` (MUFU) instead of an
// accurate expf. Threads of a block share one batch row. The block's x and
// dt are staged through shared memory kChunk timesteps at a time by
// cp.async (16-byte pieces), double-buffered: chunk c+1 is in flight while
// chunk c is scanned. B_t and C_t — the same for every channel of the row —
// are read into registers one chunk ahead and stored to shared memory after
// the scan, where every thread reads them as 16-byte broadcasts (shared
// loads and the SFU's exponentials share the MIO issue slots, so four
// values per load matter). The (B, Din, N) state never leaves registers.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);                      // round to nearest even
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Timesteps [t0, t0 + kChunk) of the block's channels [d0, d0 + kThreads)
// of a (B, S, Din) tensor into dst: by cp.async in 16-byte pieces (kVec),
// else by plain loads.
template <typename E, int kChunk, bool kVec>
__device__ __forceinline__ void stage_rows(E (*dst)[kThreads], const E* __restrict__ src,
                                           long long b, int t0, int S, int Din, int d0, int tid) {
  if constexpr (kVec) {
    constexpr int kPer = 16 / sizeof(E);            // elements per piece
    constexpr int kPieces = kThreads / kPer;        // pieces per staged row
    for (int e = tid; e < kChunk * kPieces; e += kThreads) {
      const int tt = e / kPieces;
      const int c = (e - tt * kPieces) * kPer;
      if (t0 + tt < S && d0 + c < Din)
        cp_async16(&dst[tt][c], src + (b * S + t0 + tt) * Din + d0 + c);
    }
  } else if (d0 + tid < Din) {
    for (int tt = 0; tt < kChunk && t0 + tt < S; ++tt)
      dst[tt][tid] = src[(b * S + t0 + tt) * Din + d0 + tid];
  }
}

// kVec: every row of x and dt starts on 16 bytes and Din fills whole
// 16-byte pieces, so chunks go by cp.async; otherwise by plain loads.
// kFull: N == kMaxN, so no state needs a predicate. At most 128 registers:
// four blocks an SM.
template <typename T, int kMaxN, bool kVec, bool kFull>
__global__ void __launch_bounds__(kThreads, 4)
mamba_scan_kernel(const T* __restrict__ x,          // (B, S, Din)
                  const float* __restrict__ dt,     // (B, S, Din)
                  const float* __restrict__ A,      // (Din, N)
                  const T* __restrict__ Bm,         // (B, S, N) strided
                  const T* __restrict__ Cm,         // (B, S, N) strided
                  long long b_bs, long long b_ts,   // B's batch / timestep strides
                  long long c_bs, long long c_ts,   // C's batch / timestep strides
                  const float* __restrict__ Dskip,  // (Din,)
                  const float* __restrict__ h0,     // (B, Din, N) or null
                  T* __restrict__ y,                // (B, S, Din) out
                  float* __restrict__ h_last,       // (B, Din, N) out
                  int S, int Din, int N) {
  // timesteps per stage: at most 16 KB of x and dt and 4 KB of B and C, so
  // both stages fit the 48 KB of static shared memory
  constexpr int kChunk = 16 < (512 / kMaxN) ? 16 : (512 / kMaxN);
  constexpr int kBC = kChunk * kMaxN / kThreads;    // B (and C) values per thread per chunk
  static_assert(kBC * kThreads == kChunk * kMaxN, "B/C chunk must split evenly");
  __shared__ __align__(16) T xs[2][kChunk][kThreads];
  __shared__ __align__(16) float dts[2][kChunk][kThreads];
  __shared__ __align__(16) float bs[2][kChunk][kMaxN];
  __shared__ __align__(16) float cs[2][kChunk][kMaxN];

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const bool active = d < Din;
  const float kLog2e = 1.4426950408889634f;

  float h[kMaxN], a2[kMaxN];
  const long long h_off = (b * Din + d) * N;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool ok = active && (kFull || n < N);
    h[n] = (ok && h0 != nullptr) ? h0[h_off + n] : 0.0f;
    a2[n] = ok ? A[(long long)d * N + n] * kLog2e : 0.0f;
  }
  const float dsk = active ? Dskip[d] : 0.0f;

  // x and dt of timesteps [t0, t0 + kChunk) for the block's channels
  auto stage_x = [&](int t0, int buf) {
    stage_rows<T, kChunk, kVec>(xs[buf], x, b, t0, S, Din, d0, tid);
    stage_rows<float, kChunk, kVec>(dts[buf], dt, b, t0, S, Din, d0, tid);
  };
  // B and C of the chunk at t0, into registers (the next chunk's, ahead of its use)
  float breg[kBC], creg[kBC];
  auto load_bc = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      const int tt = e / kMaxN;
      const int n = e % kMaxN;
      const bool ok = (kFull || n < N) && t0 + tt < S;
      breg[i] = ok ? to_f32(Bm[b * b_bs + (long long)(t0 + tt) * b_ts + n]) : 0.0f;
      creg[i] = ok ? to_f32(Cm[b * c_bs + (long long)(t0 + tt) * c_ts + n]) : 0.0f;
    }
  };
  auto store_bc = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      bs[buf][e / kMaxN][e % kMaxN] = breg[i];
      cs[buf][e / kMaxN][e % kMaxN] = creg[i];
    }
  };

  const int n_chunks = (S + kChunk - 1) / kChunk;
  stage_x(0, 0);
  cp_async_commit();
  load_bc(0);
  store_bc(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int buf = ci & 1;
    const int t0 = ci * kChunk;
    const bool more = ci + 1 < n_chunks;
    if (more) stage_x(t0 + kChunk, buf ^ 1);
    cp_async_commit();                 // possibly empty: keeps one group per chunk
    if (more) load_bc(t0 + kChunk);
    cp_async_wait1();                  // this chunk's pieces have landed
    __syncthreads();                   // ... everyone's, and its B/C stores
    if (active) {
      const int nt = min(kChunk, S - t0);
#pragma unroll 4
      for (int tt = 0; tt < nt; ++tt) {
        const float xv = to_f32(xs[buf][tt][tid]);
        const float dtv = dts[buf][tt][tid];
        const float dx = dtv * xv;
        float bt[kMaxN], ct[kMaxN];    // B_t, C_t: 16-byte broadcast reads
#pragma unroll
        for (int n = 0; n < kMaxN; n += 4) {
          *reinterpret_cast<float4*>(&bt[n]) = *reinterpret_cast<const float4*>(&bs[buf][tt][n]);
          *reinterpret_cast<float4*>(&ct[n]) = *reinterpret_cast<const float4*>(&cs[buf][tt][n]);
        }
        float yv = 0.0f;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (kFull || n < N) {
            h[n] = fmaf(fast_exp2(dtv * a2[n]), h[n], dx * bt[n]);
            yv = fmaf(h[n], ct[n], yv);
          }
        }
        y[(b * S + t0 + tt) * Din + d] = from_f32<T>(fmaf(dsk, xv, yv));
      }
    }
    if (more) store_bc(buf ^ 1);
    __syncthreads();                   // buf is consumed before it is staged again
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (kFull || n < N) h_last[h_off + n] = h[n];
  }
}

template <typename T, int kMaxN>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             long long b_bs, long long b_ts, long long c_bs, long long c_ts,
             const void* Dskip, const void* h0, void* y, void* h_last, int B, int S,
             int Din, int N, cudaStream_t stream) {
  const dim3 grid((Din + kThreads - 1) / kThreads, B);
  const bool vec = (Din * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)dt % 16 == 0;   // f32 dt rows then fill 16 bytes too
  auto kernel = vec ? (N == kMaxN ? mamba_scan_kernel<T, kMaxN, true, true>
                                  : mamba_scan_kernel<T, kMaxN, true, false>)
                    : (N == kMaxN ? mamba_scan_kernel<T, kMaxN, false, true>
                                  : mamba_scan_kernel<T, kMaxN, false, false>);
  kernel<<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm, (const T*)Cm, b_bs, b_ts,
      c_bs, c_ts, (const float*)Dskip, (const float*)h0, (T*)y, (float*)h_last, S, Din, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             long long b_bs, long long b_ts, long long c_bs, long long c_ts,
             const void* Dskip, const void* h0, void* y, void* h_last, int B, int S,
             int Din, int N, cudaStream_t st) {
  if (N >= 1 && N <= 8)
    return launch_n<T, 8>(x, dt, A, Bm, Cm, b_bs, b_ts, c_bs, c_ts, Dskip, h0, y, h_last,
                          B, S, Din, N, st);
  if (N > 8 && N <= 16)
    return launch_n<T, 16>(x, dt, A, Bm, Cm, b_bs, b_ts, c_bs, c_ts, Dskip, h0, y, h_last,
                           B, S, Din, N, st);
  if (N > 16 && N <= 32)
    return launch_n<T, 32>(x, dt, A, Bm, Cm, b_bs, b_ts, c_bs, c_ts, Dskip, h0, y, h_last,
                           B, S, Din, N, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, S, Din) contiguous, B and C (B, S, N) with unit stride over n and
// the given batch / timestep strides (elements), and y out: all bf16
// (x_bf16 == 1) or all f32. dt (B, S, Din), A (Din, N), D (Din,), h0
// (B, Din, N) or null, and h_last out: f32 and contiguous; 1 <= N <= 32.
// Returns cudaGetLastError().
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm, long long b_bs,
                                 long long b_ts, long long c_bs, long long c_ts,
                                 const void* Dskip, const void* h0, void* y,
                                 void* h_last, int B, int S, int Din, int N,
                                 int x_bf16, void* stream) {
  if (B <= 0 || Din <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (x_bf16)
    return launch_t<__nv_bfloat16>(x, dt, A, Bm, Cm, b_bs, b_ts, c_bs, c_ts, Dskip, h0, y,
                                   h_last, B, S, Din, N, st);
  return launch_t<float>(x, dt, A, Bm, Cm, b_bs, b_ts, c_bs, c_ts, Dskip, h0, y, h_last, B,
                         S, Din, N, st);
}
