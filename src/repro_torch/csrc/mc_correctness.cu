// Monte-Carlo correctness estimation (paper Lemma 4) over one pool's draws,
// the estimator behind GreedyLLM on xi, written for Hopper (sm_90a).
// Replaces the Pallas TPU kernel `mc_correctness_pallas` in
// src/repro/kernels/mc_correctness.py; the design note is in
// src/repro_torch/kernels/mc_correctness.py.
//
// Two launches, no atomics, integer partials only, so the result is the
// plain version's (`xi_from_responses`) bit for bit:
//
// 1. Tie histogram: grid (draw blocks, candidates), one thread per draw t of
//    candidate c. The thread builds the K displayed beliefs in LOCAL memory
//    (K <= 128, indexed by the response class): the masked arms add their
//    log weights in ascending arm order, classes without a vote show the
//    empty belief. Where class 0 lies within TIE_TOL of the max, the draw
//    falls in bin ties - 1. Each warp counts its bins with ballots; the
//    block sums its warps in order and writes (block, c, K) counts. Draws
//    past T fall in no bin: the edge is a bounds check, not padding.
// 2. Combine: one block per candidate sums the blocks' counts in ascending
//    order in 64-bit integers, then does the plain version's f64 chain: the
//    lcm-scaled credit sum over theta * lcm when lcm(1..K) < 2^24, else
//    hist_0 + hist_1 / 2 + ... over theta; one rounding to f32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxClasses = 128;
constexpr int kDraws = 256;          // draws per block of pass 1, one per thread
constexpr int kWarps = kDraws / 32;
constexpr float kTieTol = 1e-6f;

__global__ void __launch_bounds__(kDraws) mc_tie_hist_kernel(
    const int* __restrict__ resp,      // (T, L) class ids
    const float* __restrict__ masks,   // (C, L) 0/1 subset indicators
    const float* __restrict__ w,       // (L,) log weights
    const float* __restrict__ empty,   // (1,) empty-class belief
    unsigned int* __restrict__ hist,   // (gridDim.x, C, K) tie counts
    int C, int T, int L, int K) {
  __shared__ unsigned int warp_hist[kWarps][kMaxClasses];
  const int c = blockIdx.y;
  const int t = blockIdx.x * kDraws + threadIdx.x;
  int bin = -1;                        // ties - 1 where class 0 attains the max
  if (t < T) {
    const float* mk = masks + (long long)c * L;
    const int* rt = resp + (long long)t * L;
    float bel[kMaxClasses];
    unsigned int voted[kMaxClasses / 32];
    for (int k = 0; k < K; ++k) bel[k] = 0.0f;
    for (int j = 0; j < kMaxClasses / 32; ++j) voted[j] = 0u;
    for (int l = 0; l < L; ++l) {
      const int r = rt[l];
      if (mk[l] > 0.0f && r >= 0 && r < K) {
        bel[r] += w[l];
        voted[r / 32] |= 1u << (r % 32);
      }
    }
    const float e = empty[0];
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) {
      const float v = ((voted[k / 32] >> (k % 32)) & 1u) ? bel[k] : e;
      bel[k] = v;
      mx = fmaxf(mx, v);
    }
    const float thr = mx - kTieTol;
    int ties = 0;
    for (int k = 0; k < K; ++k) ties += bel[k] >= thr ? 1 : 0;
    if (bel[0] >= thr) bin = ties - 1;
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int j = 0; j < K; ++j) {
    const unsigned int hits = __ballot_sync(0xffffffffu, bin == j);
    if (lane == 0) warp_hist[warp][j] = __popc(hits);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += kDraws) {
    unsigned int s = 0;
    for (int v = 0; v < kWarps; ++v) s += warp_hist[v][j];
    hist[((long long)blockIdx.x * C + c) * K + j] = s;
  }
}

__global__ void __launch_bounds__(kMaxClasses) mc_combine_kernel(
    const unsigned int* __restrict__ hist,  // (n_blocks, C, K)
    float* __restrict__ out,                // (C,) xi
    int n_blocks, int C, int T, int K,
    unsigned long long lcm) {               // lcm(1..K), or 0 past 2^24
  __shared__ unsigned long long h[kMaxClasses];
  const int c = blockIdx.x;
  const int j = threadIdx.x;
  if (j < K) {
    unsigned long long s = 0;
    for (int b = 0; b < n_blocks; ++b) s += hist[((long long)b * C + c) * K + j];
    h[j] = s;
  }
  __syncthreads();
  if (j != 0) return;
  double xi;
  if (lcm != 0) {
    // every draw's credit lcm / ties is an exact integer
    unsigned long long s = 0;
    for (int k = 0; k < K; ++k) s += h[k] * (lcm / (unsigned long long)(k + 1));
    xi = (double)s / ((double)T * (double)lcm);
  } else {
    double acc = (double)h[0];
    for (int k = 1; k < K; ++k) acc = acc + (double)h[k] / (double)(k + 1);
    xi = acc / (double)T;
  }
  out[c] = (float)xi;                  // round to nearest, as torch's .to(float32)
}

unsigned long long lcm_below_2_24(int K) {
  unsigned long long l = 1;
  for (unsigned long long k = 2; k <= (unsigned long long)K; ++k) {
    unsigned long long a = l, b = k;
    while (b != 0) {
      const unsigned long long r = a % b;
      a = b;
      b = r;
    }
    l = l / a * k;
    if (l >= (1ull << 24)) return 0;
  }
  return l;
}

}  // namespace

extern "C" int mc_correctness_launch(const void* resp, const void* masks,
                                     const void* w, const void* empty,
                                     void* hist, void* out, int C, int T,
                                     int L, int K, int n_blocks,
                                     void* stream) {
  if (C <= 0) return 0;
  if (K < 1 || K > kMaxClasses || T < 1 || L < 0 || C > 65535 ||
      n_blocks != (T + kDraws - 1) / kDraws)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  mc_tie_hist_kernel<<<dim3(n_blocks, C), kDraws, 0, s>>>(
      (const int*)resp, (const float*)masks, (const float*)w,
      (const float*)empty, (unsigned int*)hist, C, T, L, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mc_combine_kernel<<<C, kMaxClasses, 0, s>>>(
      (const unsigned int*)hist, (float*)out, n_blocks, C, T, K,
      lcm_below_2_24(K));
  return (int)cudaGetLastError();
}
