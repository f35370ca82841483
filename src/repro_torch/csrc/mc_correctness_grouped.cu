// Grouped Monte-Carlo correctness estimation (paper Lemma 4) for the
// planner, written for Hopper (sm_90a). Replaces the Pallas TPU kernel
// `mc_correctness_grouped_pallas` in src/repro/kernels/mc_correctness.py; the
// design note is in src/repro_torch/kernels/mc_correctness.py.
//
// One block per (group g, candidate c). Threads stride over the draws t in
// ascending order. For each valid draw a thread builds the K displayed
// beliefs in a per-thread array in LOCAL memory (K <= 128; the array is
// indexed by the response class, so it cannot live in registers): the masked
// arms add their log weights in ascending arm order, classes without a vote
// show the group's empty belief. Then the max, the number of classes within
// TIE_TOL of it, and class 0's credit 1/ties. Per-thread partial sums go
// through a fixed-shape shared-memory tree, and one division by theta_g
// gives xi. No atomics: the f32 summation order is the same on every run.
// No multiply feeds an add (and the build passes --fmad=false).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxClasses = 128;
constexpr int kThreads = 512;   // power of two: the tree halves it
constexpr float kTieTol = 1e-6f;

__global__ void __launch_bounds__(kThreads) mc_correctness_grouped_kernel(
    const int* __restrict__ resp,      // (G, T, L) class ids, -1 = padding
    const float* __restrict__ masks,   // (G, C, L) 0/1 subset indicators
    const float* __restrict__ w,       // (G, L) log weights
    const float* __restrict__ empty,   // (G,) empty-class belief
    const float* __restrict__ valid,   // (G, T) 0/1 draw mask
    const float* __restrict__ theta,   // (G,) real draw counts
    float* __restrict__ out,           // (G, C) xi
    int C, int T, int L, int K) {
  __shared__ float partial[kThreads];
  const int g = blockIdx.x / C;
  const int c = blockIdx.x % C;
  const float* mk = masks + ((long long)g * C + c) * L;
  const float* wg = w + (long long)g * L;
  const float e = empty[g];

  float bel[kMaxClasses];
  unsigned int voted[kMaxClasses / 32];
  float sum = 0.0f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    if (!(valid[(long long)g * T + t] > 0.0f)) continue;
    for (int k = 0; k < K; ++k) bel[k] = 0.0f;
    for (int j = 0; j < kMaxClasses / 32; ++j) voted[j] = 0u;
    const int* rt = resp + ((long long)g * T + t) * L;
    for (int l = 0; l < L; ++l) {
      const int r = rt[l];
      if (mk[l] > 0.0f && r >= 0 && r < K) {
        bel[r] += wg[l];
        voted[r / 32] |= 1u << (r % 32);
      }
    }
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const float v = ((voted[k / 32] >> (k % 32)) & 1u) ? bel[k] : e;
      bel[k] = v;
      mx = fmaxf(mx, v);
    }
    const float thr = mx - kTieTol;
    int ties = 0;
    for (int k = 0; k < K; ++k) ties += bel[k] >= thr ? 1 : 0;
    if (bel[0] >= thr) sum += 1.0f / (float)ties;
  }
  partial[threadIdx.x] = sum;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) partial[threadIdx.x] += partial[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[(long long)g * C + c] = partial[0] / theta[g];
}

}  // namespace

extern "C" int mc_correctness_grouped_launch(const void* resp, const void* masks,
                                             const void* w, const void* empty,
                                             const void* valid, const void* theta,
                                             void* out, int G, int C, int T,
                                             int L, int K, void* stream) {
  if (G <= 0 || C <= 0) return 0;
  if (K < 1 || K > kMaxClasses) return (int)cudaErrorInvalidValue;
  mc_correctness_grouped_kernel<<<G * C, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)resp, (const float*)masks, (const float*)w,
      (const float*)empty, (const float*)valid, (const float*)theta,
      (float*)out, C, T, L, K);
  return (int)cudaGetLastError();
}
