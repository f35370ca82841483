// Batched belief aggregation (paper Eq. 4 in log space) for the serving
// router, written for Hopper (sm_90a). Replaces the Pallas TPU kernel
// `belief_aggregate_pallas` in src/repro/kernels/belief_aggregate.py; the
// design note is in src/repro_torch/kernels/belief_aggregate.py.
//
// One warp per row. Lane `l` owns classes l, l+32, l+64, l+96 (K <= 128),
// held in registers. The row's M responses are read in ascending order by
// every lane (one broadcast load each); the lane owning the voted class adds
// the arm's weight, so each class's f32 sum is a plain chain of adds in
// ascending m. No multiply feeds an add anywhere (the build also passes
// --fmad=false), so the result equals the plain PyTorch version bit for bit.
// Classes without a vote take the row's empty belief; the prediction is the
// first-max argmax, reduced over the warp with ties going to the lower index.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxClasses = 128;
constexpr int kSlots = kMaxClasses / kWarp;   // classes per lane
constexpr int kRowsPerBlock = 8;

__global__ void belief_aggregate_kernel(
    const int* __restrict__ resp,      // (B, M) class ids, -1 = not invoked
    const float* __restrict__ w,       // (B, M) log weights
    const float* __restrict__ empty,   // (B,) empty-class belief
    float* __restrict__ bel,           // (B, K) out
    int* __restrict__ pred,            // (B,) out
    int B, int M, int K) {
  const int lane = threadIdx.x % kWarp;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= B) return;   // whole warp leaves together: one row per warp

  float acc[kSlots];
  int votes[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    acc[j] = 0.0f;
    votes[j] = 0;
  }
  const int* r = resp + row * M;
  const float* wr = w + row * M;
  for (int m = 0; m < M; ++m) {
    const int c = r[m];
    const float wm = wr[m];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (c == lane + j * kWarp) {
        acc[j] += wm;
        votes[j] += 1;
      }
    }
  }

  const float e = empty[row];
  float best = -INFINITY;
  int best_k = -1;   // -1 = this lane owns no class
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int k = lane + j * kWarp;
    if (k < K) {
      const float v = votes[j] > 0 ? acc[j] : e;
      bel[row * K + k] = v;
      if (best_k < 0 || v > best) {   // ascending k: keeps the first max
        best = v;
        best_k = k;
      }
    }
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int ok = __shfl_down_sync(0xffffffffu, best_k, off);
    if (ok >= 0 && (best_k < 0 || ov > best || (ov == best && ok < best_k))) {
      best = ov;
      best_k = ok;
    }
  }
  if (lane == 0) pred[row] = best_k;
}

}  // namespace

extern "C" int belief_aggregate_launch(const void* resp, const void* w,
                                       const void* empty, void* bel, void* pred,
                                       int B, int M, int K, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || K > kMaxClasses) return (int)cudaErrorInvalidValue;
  const dim3 block(kRowsPerBlock * kWarp);
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock);
  belief_aggregate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)resp, (const float*)w, (const float*)empty, (float*)bel,
      (int*)pred, B, M, K);
  return (int)cudaGetLastError();
}
