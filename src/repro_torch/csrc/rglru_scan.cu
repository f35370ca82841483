// RG-LRU diagonal linear recurrence h_t = exp(log_a_t) * h_{t-1} + u_t for
// the hybrid family's recurrent blocks, written for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `rglru_scan_pallas` (body `_kernel`) in
// src/repro/kernels/rglru_scan.py; the design note, with the bound at the
// serving path's shapes, is in src/repro_torch/kernels/rglru_scan.py.
//
// One thread per (batch, channel): neighbouring threads own neighbouring
// channels, so every load and store of a timestep is one coalesced row
// segment. The thread walks the sequence carrying h in a register and
// writes h_t at every step and h_S at the end. The loads of a step do not
// depend on h, so the unrolled loop keeps several timesteps' loads in
// flight while the multiply-add chain runs.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ log_a,   // (B, S, D)
                  const float* __restrict__ u,       // (B, S, D)
                  const float* __restrict__ h0,      // (B, D)
                  float* __restrict__ y,             // (B, S, D) out
                  float* __restrict__ h_last,        // (B, D) out
                  int B, int S, int D) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * D) return;
  const long long b = idx / D;
  const long long d = idx - b * D;
  const long long base = b * S * D + d;
  float h = h0[idx];
#pragma unroll 4
  for (int t = 0; t < S; ++t) {
    const long long off = base + (long long)t * D;
    h = fmaf(expf(log_a[off]), h, u[off]);
    y[off] = h;
  }
  h_last[idx] = h;
}

}  // namespace

// All f32 and contiguous. Returns cudaGetLastError().
extern "C" int rglru_scan_launch(const void* log_a, const void* u, const void* h0,
                                 void* y, void* h_last, int B, int S, int D,
                                 void* stream) {
  const long long n = (long long)B * D;
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)u, (const float*)h0, (float*)y,
      (float*)h_last, B, S, D);
  return (int)cudaGetLastError();
}
