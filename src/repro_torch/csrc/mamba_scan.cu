// Mamba-1 selective scan for the SSM family's blocks, written for Hopper
// (sm_90a). Replaces the Pallas TPU kernel `mamba_scan_pallas` (body
// `_kernel`) in src/repro/kernels/mamba_scan.py; the design note, with the
// bound at the serving path's shapes, is in
// src/repro_torch/kernels/mamba_scan.py.
//
//   h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] x_t[d] B_t[n]
//   y_t[d]    = sum_n h_t[d, n] C_t[n] + D[d] x_t[d]      (ascending n)
//
// One thread per (batch, channel) with its N <= 32 states and its row of A
// in registers (template kMaxN, the smallest of 8, 16, 32 that holds N).
// Threads of a block share one batch row, so neighbouring threads read
// neighbouring channels of x and dt, and B_t, C_t — the same for every
// channel of the row — are staged through shared memory kChunk timesteps
// at a time and read as broadcasts. The (B, Din, N) state never leaves
// registers: only x, dt, B, C and h0 are read and y, h_last written.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;

template <int kMaxN>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const float* __restrict__ x,      // (B, S, Din)
                  const float* __restrict__ dt,     // (B, S, Din)
                  const float* __restrict__ A,      // (Din, N)
                  const float* __restrict__ Bm,     // (B, S, N)
                  const float* __restrict__ Cm,     // (B, S, N)
                  const float* __restrict__ Dskip,  // (Din,)
                  const float* __restrict__ h0,     // (B, Din, N)
                  float* __restrict__ y,            // (B, S, Din) out
                  float* __restrict__ h_last,       // (B, Din, N) out
                  int S, int Din, int N) {
  __shared__ float bs[kChunk][kMaxN];
  __shared__ float cs[kChunk][kMaxN];
  const long long b = blockIdx.y;
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = d < Din;

  float h[kMaxN], a[kMaxN];
  const long long h_off = (b * Din + d) * N;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool ok = active && n < N;
    h[n] = ok ? h0[h_off + n] : 0.0f;
    a[n] = ok ? A[(long long)d * N + n] : 0.0f;
  }
  const float dsk = active ? Dskip[d] : 0.0f;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int nt = min(kChunk, S - t0);
    __syncthreads();                 // the previous chunk is consumed
    for (int e = threadIdx.x; e < nt * N; e += blockDim.x) {
      const int tt = e / N;
      const int n = e - tt * N;
      const long long off = (b * S + t0 + tt) * N + n;
      bs[tt][n] = Bm[off];
      cs[tt][n] = Cm[off];
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const long long off = (b * S + t0 + tt) * Din + d;
      const float dtv = dt[off];
      const float xv = x[off];
      const float dx = dtv * xv;
      float yv = 0.0f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          h[n] = fmaf(expf(dtv * a[n]), h[n], dx * bs[tt][n]);
          yv = fmaf(h[n], cs[tt][n], yv);
        }
      }
      y[off] = fmaf(dsk, xv, yv);
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_last[h_off + n] = h[n];
  }
}

template <int kMaxN>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* Dskip, const void* h0, void* y,
             void* h_last, int B, int S, int Din, int N, cudaStream_t stream) {
  const dim3 grid((Din + kThreads - 1) / kThreads, B);
  mamba_scan_kernel<kMaxN><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)Dskip, (const float*)h0, (float*)y,
      (float*)h_last, S, Din, N);
  return (int)cudaGetLastError();
}

}  // namespace

// All f32 and contiguous; 1 <= N <= 32. Returns cudaGetLastError().
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* A,
                                 const void* Bm, const void* Cm, const void* Dskip,
                                 const void* h0, void* y, void* h_last, int B,
                                 int S, int Din, int N, void* stream) {
  if (B <= 0 || Din <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (N >= 1 && N <= 8)
    return launch_n<8>(x, dt, A, Bm, Cm, Dskip, h0, y, h_last, B, S, Din, N, st);
  if (N > 8 && N <= 16)
    return launch_n<16>(x, dt, A, Bm, Cm, Dskip, h0, y, h_last, B, S, Din, N, st);
  if (N > 16 && N <= 32)
    return launch_n<32>(x, dt, A, Bm, Cm, Dskip, h0, y, h_last, B, S, Din, N, st);
  return (int)cudaErrorInvalidValue;
}
