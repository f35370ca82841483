// The kernel body shared by `mc_correctness` and `mc_correctness_grouped`
// (Monte-Carlo correctness estimation, paper Lemma 4), written for Hopper
// (sm_90a). Both entry points compute the same function: the grouped plain
// version at G=1, with every draw valid and theta = T, is the single-pool
// one. The design note is in src/repro_torch/kernels/mc_correctness.py.
//
// One launch, one thread-block cluster per (group g, candidate c); no
// atomics, no scratch tensor, and only integer partial sums, so the result
// is the plain version's (`_masked_xi_core`) bit for bit:
//
// 1. Each thread loads its first draw's L responses into registers; then
//    each warp turns the candidate's mask into a 32-bit arm bitmask (one
//    ballot) and the group's log weights into registers (one shuffle each).
// 2. The cluster's threads stride over the draws. The masked arms that
//    voted a class in [0, K) are a draw's voters. For each voter l that is
//    the first voter of its class, the class's belief is the sum of w[l']
//    over the voters l' of that class in ascending l', from 0.0f: the plain
//    version's add order. Classes without a voter show the empty belief, so
//      mx   = max(voted sums, and `empty` if fewer than K classes voted),
//      ties = #(voted sums >= mx - TIE_TOL) + (K - #voted if empty is too),
//    and the draw falls in bin ties - 1 if class 0's belief is >= mx -
//    TIE_TOL. O(n L) register work per draw for n masked arms, whatever K
//    is (the mask is block-uniform, so unmasked arms are skipped by a
//    uniform branch); no per-class array. Invalid draws and draws past T
//    fall in no bin.
// 3. Warps count their bins with ballots (one round per distinct bin in the
//    warp) into per-warp histograms in shared memory.
// 4. Each block sums its warps into a K-bin histogram and writes it into
//    rank 0's shared memory (distributed shared memory), behind a cluster
//    barrier arrived at on entry (every block has started). One cluster
//    barrier (release / acquire) later, rank 0 sums the ranks' histograms
//    in 64-bit integers and does the plain version's f64 combine: the
//    lcm-scaled credit sum over theta * lcm when lcm(1..K) < 2^24, else the
//    chain hist_0 + hist_1 / 2 + ... over theta; one rounding to f32. No
//    block reads another's shared memory, so the other ranks exit at once.
//
// No multiply feeds an add (and the build passes --fmad=false).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mc {

namespace cg = cooperative_groups;

constexpr int kMaxClasses = 128;
constexpr int kMaxArms = 32;           // a 32-bit arm bitmask; the reference sizes L <= 32
constexpr int kMaxCluster = 16;        // the non-portable limit on Hopper
// The most threads a block has: 1024 for L <= 12 (<= 64 registers a thread),
// 512 for L <= 16, 256 for L <= 32. A launch sizes its blocks to the draws:
// ceil(T / cluster) threads, whole warps, up to that cap.
__host__ __device__ constexpr int max_threads(int lmax) {
  return lmax <= 12 ? 1024 : lmax <= 16 ? 512 : 256;
}
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTieTol = 1e-6f;

// A draw's L responses, as raw class ids in registers (-1 past L). `vec`:
// the row may be read as int4s (L == LMAX, a multiple of 4, 16-byte aligned).
template <int LMAX>
__device__ __forceinline__ void load_row(const int* __restrict__ rt, bool vec, int L,
                                         int (&rv)[LMAX]) {
  if (LMAX % 4 == 0 && vec) {
#pragma unroll
    for (int q = 0; q < LMAX / 4; ++q) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(rt) + q);
      rv[4 * q] = v.x;
      rv[4 * q + 1] = v.y;
      rv[4 * q + 2] = v.z;
      rv[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < LMAX; ++l) rv[l] = l < L ? __ldg(rt + l) : -1;
  }
}

// Bin of one valid draw: ties - 1 where class 0 attains the max, else -1.
// `mask` is the candidate's arm bitmask, the same for the whole block, so
// the branch on an arm's bit is uniform and unmasked arms cost one test.
template <int LMAX>
__device__ __forceinline__ int draw_bin(int (&rv)[LMAX], unsigned mask, const float (&w)[LMAX],
                                        float e, int K) {
#pragma unroll
  for (int l = 0; l < LMAX; ++l)       // the voter's class, or -1
    rv[l] = ((mask >> l) & 1u) && (unsigned)rv[l] < (unsigned)K ? rv[l] : -1;

  float s[LMAX];                       // the class sum at each class's first voter
  unsigned first = 0u;                 // bit l: l is the first voter of its class
  float mx = -INFINITY;
  float d0 = e;                        // class 0's displayed belief
  int voted = 0;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    s[l] = 0.0f;
    if (!((mask >> l) & 1u)) continue;
    bool is_first = rv[l] >= 0;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < LMAX; ++j) {
      const bool same = rv[j] == rv[l];
      if (j < l) {
        is_first = is_first && !same;
      } else if (same) {
        sum = sum + w[j];
      }
    }
    s[l] = sum;
    if (is_first) {
      first |= 1u << l;
      ++voted;
      mx = fmaxf(mx, sum);
      if (rv[l] == 0) d0 = sum;
    }
  }
  const bool empty_shown = voted < K;
  if (empty_shown) mx = fmaxf(mx, e);
  const float thr = mx - kTieTol;
  int ties = empty_shown && e >= thr ? K - voted : 0;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) ties += ((first >> l) & 1u) && s[l] >= thr ? 1 : 0;
  return d0 >= thr ? ties - 1 : -1;
}

// The cluster barrier in two halves (PTX): arrive, then wait for the rest.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// grid (cluster, C, G), cluster (cluster, 1, 1): one cluster per (g, c).
template <int LMAX>
__global__ void __launch_bounds__(max_threads(LMAX)) mc_tie_hist_kernel(
    const int* __restrict__ resp,      // (G, T, L) class ids
    const float* __restrict__ masks,   // (G, C, L) 0/1 subset indicators
    const float* __restrict__ w,       // (G, L) log weights
    const float* __restrict__ empty,   // (G,) empty-class belief
    const float* __restrict__ valid,   // (G, T) 0/1 draw mask, or null: every draw
    const float* __restrict__ theta,   // (G,) real draw counts, or null: T
    float* __restrict__ out,           // (G, C) xi
    int C, int T, int L, int K, int vec,
    unsigned long long lcm) {          // lcm(1..K), or 0 past 2^24
  constexpr int kMaxWarps = max_threads(LMAX) / 32;
  __shared__ unsigned int warp_hist[kMaxWarps][kMaxClasses];
  __shared__ unsigned int rank_hist[kMaxCluster][kMaxClasses];   // rank 0's: every rank's
  __shared__ unsigned long long scaled[kMaxClasses];
  __shared__ double credit[kMaxClasses];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int span = (int)cluster.num_blocks();
  const int c = blockIdx.y;
  const int g = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int threads = blockDim.x;      // whole warps
  cluster_arrive_relaxed();            // this block has started; waited on before the push

  // the first draw's row and valid flag, loaded before the mask and weights
  const int* rg = resp + (long long)g * T * L;
  const float* vg = valid ? valid + (long long)g * T : nullptr;
  int t = rank * threads + threadIdx.x;
  int rv[LMAX];
  bool take = t < T;
  if (take) {
    load_row<LMAX>(rg + (long long)t * L, vec != 0, L, rv);
    if (vg) take = vg[t] > 0.0f;
  }

  for (int j = lane; j < K; j += 32) warp_hist[warp][j] = 0u;
  const float* mk = masks + ((long long)g * C + c) * L;
  const unsigned mask = __ballot_sync(kFull, lane < L && mk[lane] > 0.0f);
  const float w_lane = lane < L ? w[(long long)g * L + lane] : 0.0f;
  float wr[LMAX];
#pragma unroll
  for (int l = 0; l < LMAX; ++l) wr[l] = __shfl_sync(kFull, w_lane, l);
  const float e = empty[g];
  __syncwarp();

  for (int base = rank * threads; base < T; base += span * threads) {
    if (base != rank * threads) {      // later draws of this thread, if any
      t = base + threadIdx.x;
      take = t < T;
      if (take) {
        load_row<LMAX>(rg + (long long)t * L, vec != 0, L, rv);
        if (vg) take = vg[t] > 0.0f;
      }
    }
    const int bin = take ? draw_bin<LMAX>(rv, mask, wr, e, K) : -1;
    unsigned pending = __ballot_sync(kFull, bin >= 0);
    while (pending) {                  // one round per distinct bin in the warp
      const int b = __shfl_sync(kFull, bin, __ffs(pending) - 1);
      const unsigned hits = __ballot_sync(kFull, bin == b);
      if (lane == 0) warp_hist[warp][b] += __popc(hits);
      pending &= ~hits;
    }
  }
  __syncthreads();
  cluster_wait_acquire();              // every block of the cluster has started
  unsigned int* dst = cluster.map_shared_rank(&rank_hist[rank][0], 0);
  for (int j = threadIdx.x; j < K; j += threads) {
    unsigned int h = 0;                // integers: exact in any order
#pragma unroll
    for (int v = 0; v < kMaxWarps; ++v) h += v < threads / 32 ? warp_hist[v][j] : 0u;
    dst[j] = h;                        // into rank 0's shared memory
  }
  cluster_arrive_release();            // this rank's histogram is pushed
  cluster_wait_acquire();              // and every other rank's
  if (rank != 0) return;
  for (int j = threadIdx.x; j < K; j += threads) {
    unsigned long long h = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) h += r < span ? rank_hist[r][j] : 0u;
    // the combine's terms, one class a thread: lcm / ties credit per draw
    // (an exact integer), or the chain's hist_j / (j + 1) in f64
    if (lcm != 0)
      scaled[j] = h * (unsigned)((unsigned)lcm / (unsigned)(j + 1));   // lcm < 2^24
    else
      credit[j] = (double)h / (double)(j + 1);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double th = theta ? (double)theta[g] : (double)T;
  double xi;
  if (lcm != 0) {
    unsigned long long sum = 0;
    for (int k = 0; k < K; ++k) sum += scaled[k];
    xi = (double)sum / (th * (double)lcm);
  } else {
    double acc = credit[0];            // hist_0 / 1: exact
    for (int k = 1; k < K; ++k) acc = acc + credit[k];
    xi = acc / th;
  }
  out[(long long)g * C + c] = (float)xi;   // round to nearest, as torch's .to(float32)
}

inline unsigned long long lcm_below_2_24(int K) {
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

// One cluster of `cluster` blocks per (g, c), each block sized to its share
// of the draws: ceil(T / cluster) threads in whole warps, up to the cap.
template <int LMAX>
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(int cluster, int G, int C, int T, cudaStream_t stream) {
    const int per_block = (T + cluster - 1) / cluster;
    const int threads = per_block >= max_threads(LMAX) ? max_threads(LMAX)
                                                       : ((per_block + 31) / 32) * 32;
    cfg.gridDim = dim3(cluster, C, G);
    cfg.blockDim = dim3(threads > 32 ? threads : 32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// cluster 0 picks the size: 16 blocks where all G * C clusters of 16 are
// resident on the card at once (cudaOccupancyMaxActiveClusters), else 8,
// the portable size. Measured on an H100 (PERF.md): 16 is faster at G=1
// C=3, 8 at C=12, where clusters of 16 run in two waves.
template <int LMAX>
cudaError_t launch_lmax(const int* resp, const float* masks, const float* w, const float* empty,
                        const float* valid, const float* theta, float* out, int G, int C, int T,
                        int L, int K, int cluster, cudaStream_t stream) {
  void (*kernel)(const int*, const float*, const float*, const float*, const float*,
                 const float*, float*, int, int, int, int, int, unsigned long long) =
      mc_tie_hist_kernel<LMAX>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (cluster == 0) {
    Launch<LMAX> wide(kMaxCluster, G, C, T, stream);
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &wide.cfg);
    if (err != cudaSuccess) return err;
    cluster = (long long)G * C <= resident ? kMaxCluster : 8;
  }
  Launch<LMAX> launch(cluster, G, C, T, stream);
  const int vec = L == LMAX && L % 4 == 0 && (reinterpret_cast<uintptr_t>(resp) % 16) == 0;
  err = cudaLaunchKernelEx(&launch.cfg, kernel, resp, masks, w, empty, valid, theta, out, C, T,
                           L, K, vec, lcm_below_2_24(K));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch on `stream`; `valid` and `theta` may be null (every draw valid,
// theta = T); `cluster` 0 picks the cluster size. Returns the launch's CUDA
// error, cudaErrorInvalidValue for arguments outside the kernel's range.
inline int tie_hist_launch(const void* resp, const void* masks, const void* w, const void* empty,
                           const void* valid, const void* theta, void* out, int G, int C, int T,
                           int L, int K, int cluster, void* stream) {
  if (G <= 0 || C <= 0) return 0;
  if (K < 1 || K > kMaxClasses || L < 0 || L > kMaxArms || T < 0 || C > 65535 || G > 65535 ||
      cluster < 0 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const int* r = (const int*)resp;
  const float *m = (const float*)masks, *wt = (const float*)w, *e = (const float*)empty;
  const float *v = (const float*)valid, *th = (const float*)theta;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (L <= 8) return (int)launch_lmax<8>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
  if (L <= 12) return (int)launch_lmax<12>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
  if (L <= 16) return (int)launch_lmax<16>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
  return (int)launch_lmax<32>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
}

}  // namespace mc
