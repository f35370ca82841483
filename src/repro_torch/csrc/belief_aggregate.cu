// Batched belief aggregation (paper Eq. 4 in log space) for the serving
// router, written for Hopper (sm_90a). Replaces the Pallas TPU kernel
// `belief_aggregate_pallas` in src/repro/kernels/belief_aggregate.py; the
// design note is in src/repro_torch/kernels/belief_aggregate.py.
//
// A group of G lanes serves one row, G = the next power of two >= min(K,
// 32), so a warp serves 32 / G rows (8 at K=4). The group loads its row's
// responses and weights once, spread over its lanes (lane j of the group
// holds arms j, j + G, ...; up to G * kHeld arms at a time), so the warp's
// loads cover its rows' neighbouring stretch of memory. Lane j owns the
// classes j, j + G, j + 2G, ...: for each class chunk it takes the arms in
// ascending m by in-group shuffles and adds the weight of each vote for its
// class, so each class's f32 sum is a plain chain of adds in ascending m
// from 0.0f, the plain version's. No multiply feeds an add anywhere (the
// build also passes --fmad=false), so the result equals the plain PyTorch
// version bit for bit. Classes without a vote take the row's empty belief;
// the prediction is the first-max argmax, a segmented shuffle reduction
// over the group with ties going to the lower index. A lane stores its
// class of each chunk, so a warp's stores run over consecutive (row, k).
// Any K: classes past G are further chunks over the responses the group
// already holds (or loads again, past G * kHeld arms).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeld = 8;         // responses a lane holds: a group holds G * kHeld arms
constexpr int kMaxWarps = 8;     // warps a block

// Lane `gl` of a group loads arms m0 + q G + gl of its row, q < kHeld (-1
// and 0.0f past M or for a row past B).
template <int G>
__device__ __forceinline__ void load_arms(const int* rr, const float* wr, bool live, int M,
                                          int m0, int gl, int (&cls)[kHeld],
                                          float (&wt)[kHeld]) {
#pragma unroll
  for (int q = 0; q < kHeld; ++q) {
    const int m = m0 + q * G + gl;
    const bool in = live && m < M;
    cls[q] = in ? __ldg(rr + m) : -1;
    wt[q] = in ? __ldg(wr + m) : 0.0f;
  }
}

template <int G>
__global__ void __launch_bounds__(kMaxWarps * kWarp) belief_aggregate_kernel(
    const int* __restrict__ resp,      // (B, M) class ids, -1 = not invoked
    const float* __restrict__ w,       // (B, M) log weights
    const float* __restrict__ empty,   // (B,) empty-class belief
    float* __restrict__ bel,           // (B, K) out
    int* __restrict__ pred,            // (B,) out
    int B, int M, int K) {
  constexpr int kRows = kWarp / G;     // rows a warp
  const int lane = threadIdx.x % kWarp;
  const int gl = lane % G;             // lane in the group
  const long long first_row =
      ((long long)blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp) * kRows;
  if (first_row >= B) return;          // the whole warp leaves together
  const long long row = first_row + lane / G;
  const bool live = row < B;           // the warp's last rows may lie past B
  const int* rr = resp + (live ? row : 0) * M;
  const float* wr = w + (live ? row : 0) * M;
  const float e = live ? empty[row] : 0.0f;

  int cls[kHeld];                      // arms m0 + q G + gl, q < kHeld
  float wt[kHeld];
  const bool held = M <= G * kHeld;    // one load serves every class chunk
  if (held) load_arms<G>(rr, wr, live, M, 0, gl, cls, wt);

  float best = -INFINITY;
  int best_k = -1;                     // -1: this lane has no class yet
  for (int k0 = 0; k0 < K; k0 += G) {  // class chunks, uniform over the warp
    const int k = k0 + gl;
    float acc = 0.0f;
    bool voted = false;
    for (int m0 = 0; m0 < M; m0 += G * kHeld) {
      if (!held) load_arms<G>(rr, wr, live, M, m0, gl, cls, wt);
#pragma unroll
      for (int q = 0; q < kHeld; ++q) {
        if (m0 + q * G >= M) break;    // uniform
#pragma unroll
        for (int src = 0; src < G; ++src) {   // arm m0 + q G + src: ascending m
          if (m0 + q * G + src >= M) break;    // uniform
          const int c = __shfl_sync(kFull, cls[q], src, G);
          const float wm = __shfl_sync(kFull, wt[q], src, G);
          if (c == k) {
            acc = acc + wm;
            voted = true;
          }
        }
      }
    }
    if (k < K) {
      const float v = voted ? acc : e;
      if (live) bel[row * K + k] = v;
      if (best_k < 0 || v > best) {   // ascending k in the lane: keeps the first max
        best = v;
        best_k = k;
      }
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    const float ov = __shfl_xor_sync(kFull, best, off, G);
    const int ok = __shfl_xor_sync(kFull, best_k, off, G);
    if (ok >= 0 && (best_k < 0 || ov > best || (ov == best && ok < best_k))) {
      best = ov;
      best_k = ok;
    }
  }
  if (live && gl == 0) pred[row] = best_k;
}

constexpr int kMaxDevices = 64;
int sm_count[kMaxDevices];       // per device, read at its first launch (0: not yet)

// The current device's SM count, asked of the CUDA runtime once per device.
cudaError_t current_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && sm_count[dev] > 0) {
    *sms = sm_count[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) sm_count[dev] = *sms;
  return err;
}

template <int G>
int launch_group(const void* resp, const void* w, const void* empty, void* bel, void* pred,
                 int B, int M, int K, cudaStream_t stream) {
  // warps a block: as few as spread the rows' warps over every SM, up to 8
  int sms = 0;
  const cudaError_t err = current_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const long long warps = (B + kWarp / G - 1) / (kWarp / G);
  long long per_block = (warps + sms - 1) / sms;
  per_block = per_block < 1 ? 1 : per_block > kMaxWarps ? kMaxWarps : per_block;
  const dim3 grid((unsigned)((warps + per_block - 1) / per_block));
  belief_aggregate_kernel<G><<<grid, dim3((unsigned)per_block * kWarp), 0, stream>>>(
      (const int*)resp, (const float*)w, (const float*)empty, (float*)bel, (int*)pred, B, M, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int belief_aggregate_launch(const void* resp, const void* w,
                                       const void* empty, void* bel, void* pred,
                                       int B, int M, int K, void* stream) {
  if (B <= 0) return 0;
  if (K < 1 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 1) return launch_group<1>(resp, w, empty, bel, pred, B, M, K, s);
  if (K <= 2) return launch_group<2>(resp, w, empty, bel, pred, B, M, K, s);
  if (K <= 4) return launch_group<4>(resp, w, empty, bel, pred, B, M, K, s);
  if (K <= 8) return launch_group<8>(resp, w, empty, bel, pred, B, M, K, s);
  if (K <= 16) return launch_group<16>(resp, w, empty, bel, pred, B, M, K, s);
  return launch_group<32>(resp, w, empty, bel, pred, B, M, K, s);
}
