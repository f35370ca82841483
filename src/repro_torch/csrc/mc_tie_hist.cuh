// The kernel body shared by `mc_correctness` and `mc_correctness_grouped`
// (Monte-Carlo correctness estimation, paper Lemma 4), written for Hopper
// (sm_90a). Both entry points compute the same function: the grouped plain
// version at G=1, with every draw valid and theta = T, is the single-pool
// one. The design note is in src/repro_torch/kernels/mc_correctness.py.
//
// One launch, one thread-block cluster per (group g, candidate c); no
// scratch tensor, and only integer partial sums, so the result is the plain
// version's (`_masked_xi_core`) bit for bit. Two kernels, chosen by an
// explicit branch on the arm count L (`tie_hist_launch`):
//
// L <= 32 (`mc_tie_hist_kernel<LMAX, FOLD>`, registers):
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
// 4. Each block sums its warps into its histogram and writes it into rank
//    0's shared memory (distributed shared memory), behind a cluster
//    barrier arrived at on entry (every block has started). One cluster
//    barrier (release / acquire) later, rank 0 sums the ranks' histograms
//    in 64-bit integers and does the plain version's f64 combine: the
//    lcm-scaled credit sum over theta * lcm when lcm(1..K) < 2^24 (K <= 18),
//    else the chain hist_0 + hist_1 / 2 + ... over theta; one rounding to
//    f32. No block reads another's shared memory, so the other ranks exit
//    at once.
//
// L > 32 (`mc_tie_hist_wide_kernel<Id, STAGED>`, shared memory; sized at
// launch):
// 1. The candidate's mask becomes a multi-word arm bitmask in shared
//    memory (one ballot per 32 arms), and the masked arms' indices and log
//    weights a list in ascending arm order (each arm's place is the
//    popcount of the mask below it).
// 2. Each warp takes 32 draws at a time: it stages their masked arms' class
//    ids in shared memory as Id (-1 for no vote), lanes along the arms
//    (a lane's 32 loads, one a draw, in flight together), then each lane
//    works out one draw's bin from its column over the masked arms only,
//    in ascending arm order, so each class sum is the same f32 chain as
//    above, twice (the max, then the tie count): class by class where
//    K <= n (`bin_by_class`, 2 K n steps, the same for every lane), else
//    from each class's first voter on (`bin_by_first_voter`, at most
//    2 n min(K, n) steps, but each lane's own). Measured on an H100
//    (PERF.md): each is the faster at L=64 K=4 and at L=40 K=1000.
//    Id is int16 where K <= 32767 and int32 past it, by an explicit branch
//    on K. Where one warp's staging (32 L ids) would pass kWideStageBytes,
//    STAGED is false, by an explicit branch on L and the id width: no
//    staging, and each lane reads its column straight from `resp` (the
//    same two loops over `GlobalCol`; the first-voter loop then finds a
//    class's earlier voters by a scan instead of marks).
// 3. Lanes count bins by ballot into the block's histogram (shared-memory
//    integer atomics); each block adds its histogram into rank 0's
//    (distributed shared-memory integer atomics) and warp 0 of rank 0 does
//    the same f64 combine. Integer counts: exact in any order.
//
// Bins fold into few slots. A draw's bin is ties - 1. Where the empty
// belief does not tie at the max, ties <= #voted <= n, so the bin is below
// n; where it does, ties >= K - #voted, so the bin is at least K - n - 1.
// With H >= n + 1 low slots and H high ones, bin b goes to slot b (b < H)
// or b - (K - S) (b >= H), S = min(K, 2H) slots in all: the identity for
// K <= 2H. The chain adds hist_b / (b + 1) for the bins of the slots in
// ascending order; the bins left out hold 0, and adding 0.0 to the chain
// leaves it as it is. H = L + 1 for the wide kernel. The L <= 32 kernels
// fold only past K = 128 (H = 64, their 128 static slots), in a template of
// their own: at K <= 128 the slot is the bin, with no fold instructions.
//
// No multiply feeds an add (and the build passes --fmad=false).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mc {

namespace cg = cooperative_groups;

constexpr int kSlots = 128;            // histogram slots of the L <= 32 kernels
constexpr int kLowSlots = 64;          // H of the L <= 32 kernels
constexpr int kRegArms = 32;           // the L <= 32 kernels: a 32-bit arm bitmask
constexpr int kShortClasses = 32767;   // past it the wide kernel stages class ids as int32
constexpr int kMaxCluster = 16;        // the non-portable limit on Hopper
constexpr int kWideWarps = 8;          // the wide kernel's most warps a block
constexpr int kWideStageBytes = 128 * 1024;   // its staging's most bytes a block
constexpr int kGridYZ = 65535;         // the most blocks along grid y and z
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
// FOLD: K > kSlots, bins folded into kSlots slots; else K <= kSlots slots.
template <int LMAX, bool FOLD>
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
  __shared__ unsigned int warp_hist[kMaxWarps][kSlots];
  __shared__ unsigned int rank_hist[kMaxCluster][kSlots];   // rank 0's: every rank's
  __shared__ unsigned long long scaled[kSlots];
  __shared__ double credit[kSlots];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int span = (int)cluster.num_blocks();
  const int c = blockIdx.y;
  const int g = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int threads = blockDim.x;      // whole warps
  const int S = FOLD ? kSlots : K;
  const int fold = K - S;              // FOLD: slot = bin - fold for bins >= kLowSlots
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

  for (int j = lane; j < S; j += 32) warp_hist[warp][j] = 0u;
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
    int bin = take ? draw_bin<LMAX>(rv, mask, wr, e, K) : -1;
    if (FOLD && bin >= kLowSlots) bin -= fold;
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
  for (int j = threadIdx.x; j < S; j += threads) {
    unsigned int h = 0;                // integers: exact in any order
#pragma unroll
    for (int v = 0; v < kMaxWarps; ++v) h += v < threads / 32 ? warp_hist[v][j] : 0u;
    dst[j] = h;                        // into rank 0's shared memory
  }
  cluster_arrive_release();            // this rank's histogram is pushed
  cluster_wait_acquire();              // and every other rank's
  if (rank != 0) return;
  for (int j = threadIdx.x; j < S; j += threads) {
    unsigned long long h = 0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) h += r < span ? rank_hist[r][j] : 0u;
    // the combine's terms, one slot a thread: lcm / ties credit per draw
    // (an exact integer; K <= 18, so S = K), or the chain's hist_b / (b + 1)
    // in f64 for the slot's bin b
    if (lcm != 0)
      scaled[j] = h * (unsigned)((unsigned)lcm / (unsigned)(j + 1));   // lcm < 2^24
    else
      credit[j] = (double)h / (double)((FOLD && j >= kLowSlots ? j + fold : j) + 1);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const double th = theta ? (double)theta[g] : (double)T;
  double xi;
  if (lcm != 0) {
    unsigned long long sum = 0;
    for (int k = 0; k < S; ++k) sum += scaled[k];
    xi = (double)sum / (th * (double)lcm);
  } else {
    double acc = credit[0];            // hist_0 / 1: exact
    for (int k = 1; k < S; ++k) acc = acc + credit[k];
    xi = acc / th;
  }
  out[(long long)g * C + c] = (float)xi;   // round to nearest, as torch's .to(float32)
}

// ---------------------------------------------------------------------------
// L > 32: the wide kernel
// ---------------------------------------------------------------------------

// A lane's column: col[i], i < n, is the class of the i-th masked arm of the
// lane's draw in ascending arm order, -1 for no vote.
// Staged in shared memory (the lane's ids 32 apart); marks may be written.
template <typename Id>
struct StagedCol {
  static constexpr bool kMarks = true;
  using Mark = Id;                     // a mark is stored as an id
  Id* p;
  // the Id itself, not an int: at int16 the loops then compile to the SASS
  // of a plain short* column (the wide kernel's before int32 ids came)
  __device__ __forceinline__ Id operator[](int i) const { return p[32 * i]; }
  __device__ __forceinline__ void mark(int i, int m) { p[32 * i] = (Id)m; }
};
// Read straight from the draw's row of `resp`; nothing is written.
struct GlobalCol {
  static constexpr bool kMarks = false;
  using Mark = int;
  const int* row;                      // the draw's L class ids
  const int* idx;                      // the masked arms' indices
  int K;
  __device__ __forceinline__ int operator[](int i) const {
    const int r = __ldg(row + idx[i]);
    return (unsigned)r < (unsigned)K ? r : -1;
  }
  __device__ __forceinline__ void mark(int, int) {}
};

// Bin of one valid draw from its column `col` and the masked arms' log
// weights `wm`, class by class: for each class k the chain over its voters
// in ascending arm order from 0.0f.
template <typename Col>
__device__ __forceinline__ int bin_by_class(const Col& col, int n, const float* wm, float e,
                                            int K) {
  float mx = -INFINITY;
  float d0 = e;
  int voted = 0;
  for (int k = 0; k < K; ++k) {
    float sum = 0.0f;
    bool hit = false;
    for (int i = 0; i < n; ++i) {
      if (col[i] == k) {
        sum = sum + wm[i];
        hit = true;
      }
    }
    if (hit) {
      ++voted;
      mx = fmaxf(mx, sum);
      if (k == 0) d0 = sum;
    }
  }
  const bool empty_shown = voted < K;
  if (empty_shown) mx = fmaxf(mx, e);
  const float thr = mx - kTieTol;
  int ties = empty_shown && e >= thr ? K - voted : 0;
  for (int k = 0; k < K; ++k) {        // the same chains again, against thr
    float sum = 0.0f;
    bool hit = false;
    for (int i = 0; i < n; ++i) {
      if (col[i] == k) {
        sum = sum + wm[i];
        hit = true;
      }
    }
    ties += hit && sum >= thr ? 1 : 0;
  }
  return d0 >= thr ? ties - 1 : -1;
}

// True if a voter before i in `col` voted `cls` (the columns without marks).
template <typename Col>
__device__ __forceinline__ bool voted_before(const Col& col, int i, int cls) {
  for (int j = 0; j < i; ++j)
    if (col[j] == cls) return true;
  return false;
}

// The same bin, first voter by first voter: each class's chain begun at
// its first voter i. In a staged column the class's later voters are
// marked -(k + 2) as they are added, so each arm is added once, and the tie
// pass takes the same chains again from the marks; each pass costs n steps
// per class that voted. The column is the lane's own until the warp stages
// again. A column without marks finds a voter's earlier voters by a scan.
template <typename Col>
__device__ __forceinline__ int bin_by_first_voter(Col& col, int n, const float* wm, float e,
                                                  int K) {
  float mx = -INFINITY;
  float d0 = e;
  int voted = 0;
  for (int i = 0; i < n; ++i) {
    const int cls = col[i];
    if (cls < 0) continue;             // no vote, or a later voter of its class
    if (!Col::kMarks && voted_before(col, i, cls)) continue;
    const typename Col::Mark mark = (typename Col::Mark)(-cls - 2);
    float sum = 0.0f;
    sum = sum + wm[i];
    for (int j = i + 1; j < n; ++j) {
      if (col[j] == cls) {
        sum = sum + wm[j];
        col.mark(j, mark);
      }
    }
    ++voted;
    mx = fmaxf(mx, sum);
    if (cls == 0) d0 = sum;
  }
  const bool empty_shown = voted < K;
  if (empty_shown) mx = fmaxf(mx, e);
  const float thr = mx - kTieTol;
  int ties = empty_shown && e >= thr ? K - voted : 0;
  for (int i = 0; i < n; ++i) {        // the first voters' chains again, against thr
    const int cls = col[i];
    if (cls < 0) continue;
    if (!Col::kMarks && voted_before(col, i, cls)) continue;
    const typename Col::Mark mark = (typename Col::Mark)(-cls - 2);
    float sum = 0.0f;
    sum = sum + wm[i];
    for (int j = i + 1; j < n; ++j)   // later voters read as the mark, unmarked as cls
      if (col[j] == (Col::kMarks ? (int)mark : cls)) sum = sum + wm[j];
    ties += sum >= thr ? 1 : 0;
  }
  return d0 >= thr ? ties - 1 : -1;
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// The wide kernel's dynamic shared memory, at byte offsets:
//   words[ceil(L/32)] unsigned  the candidate's arm bitmask
//   wm[L]  float    the masked arms' log weights, ascending arm order
//   idx[L] int      the masked arms' indices
//   hist[S], total[S] unsigned  the block's histogram; rank 0's: the cluster's
//   stage[warps][L][32] Id      each warp's 32 draws' masked class ids
//                               (id_bytes = sizeof(Id); 0 without staging)
struct WideLayout {
  int S;
  size_t wm, idx, hist, total, stage, bytes;
};

__host__ __device__ inline WideLayout wide_layout(int L, int K, int warps, int id_bytes) {
  WideLayout s;
  const int H = L + 1;
  s.S = K < 2 * H ? K : 2 * H;
  s.wm = align16(sizeof(unsigned) * ((L + 31) / 32));
  s.idx = s.wm + align16(sizeof(float) * L);
  s.hist = s.idx + align16(sizeof(int) * L);
  s.total = s.hist + align16(sizeof(unsigned) * s.S);
  s.stage = s.total + align16(sizeof(unsigned) * s.S);
  s.bytes = s.stage + (size_t)id_bytes * warps * L * 32;
  return s;
}

// Does one warp's staging of L ids of id_bytes fit kWideStageBytes?
__host__ __device__ inline bool wide_staged(int L, int id_bytes) {
  return (long long)L * 32 * id_bytes <= kWideStageBytes;
}

// The wide kernel's most warps a block at L arms: up to 8, as many as
// kWideStageBytes of staging hold (8 without staging).
__host__ __device__ inline int wide_warps(int L, int id_bytes) {
  if (!wide_staged(L, id_bytes)) return kWideWarps;
  const int w = kWideStageBytes / (L * 32 * id_bytes);
  return w < 1 ? 1 : w > kWideWarps ? kWideWarps : w;
}

// grid (cluster, C, G), cluster (cluster, 1, 1): one cluster per (g, c).
// Id: the staged class ids' type; STAGED: stage them (else read `resp`).
template <typename Id, bool STAGED>
__global__ void __launch_bounds__(kWideWarps * 32) mc_tie_hist_wide_kernel(
    const int* __restrict__ resp, const float* __restrict__ masks, const float* __restrict__ w,
    const float* __restrict__ empty, const float* __restrict__ valid,
    const float* __restrict__ theta, float* __restrict__ out, int C, int T, int L, int K,
    unsigned long long lcm) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int span = (int)cluster.num_blocks();
  const int c = blockIdx.y;
  const int g = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int threads = blockDim.x;      // whole warps
  const int warps = threads / 32;
  const WideLayout lay = wide_layout(L, K, warps, STAGED ? (int)sizeof(Id) : 0);
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  float* wm = reinterpret_cast<float*>(smem + lay.wm);
  int* idx = reinterpret_cast<int*>(smem + lay.idx);
  unsigned* hist = reinterpret_cast<unsigned*>(smem + lay.hist);
  unsigned* total = reinterpret_cast<unsigned*>(smem + lay.total);
  Id* stage = reinterpret_cast<Id*>(smem + lay.stage) + (size_t)warp * L * 32;
  const int S = lay.S;
  const int H = L + 1;
  const int fold = K - S;              // slot = bin - fold for bins >= H
  const int nw = (L + 31) / 32;

  // 1. zeroed histograms (rank 0's total before any rank adds into it), the
  //    arm bitmask (one ballot per 32 arms) and the masked-arm list
  for (int j = threadIdx.x; j < S; j += threads) {
    hist[j] = 0u;
    total[j] = 0u;
  }
  const float* mk = masks + ((long long)g * C + c) * L;
  for (int q = warp; q < nw; q += warps) {
    const int l = q * 32 + lane;
    const unsigned bits = __ballot_sync(kFull, l < L && mk[l] > 0.0f);
    if (lane == 0) words[q] = bits;
  }
  __syncthreads();
  int n = 0;                           // masked arms
  for (int q = 0; q < nw; ++q) n += __popc(words[q]);
  for (int l = threadIdx.x; l < L; l += threads) {
    const unsigned bit = 1u << (l % 32);
    if (words[l / 32] & bit) {
      int pos = __popc(words[l / 32] & (bit - 1u));
      for (int q = 0; q < l / 32; ++q) pos += __popc(words[q]);
      idx[pos] = l;
      wm[pos] = w[(long long)g * L + l];
    }
  }
  const float e = empty[g];
  __syncthreads();
  cluster_arrive_release();            // started, and rank 0's total is zero

  // 2. each warp's 32 draws at a time: stage, then one draw a lane
  const int* rg = resp + (long long)g * T * L;
  const float* vg = valid ? valid + (long long)g * T : nullptr;
  const bool by_class = K <= n;        // block-uniform
  for (int base = rank * threads; base < T; base += span * threads) {
    const int t0 = base + warp * 32;
    const int draws = T - t0;          // this warp's draws: min(32, draws)
    if (STAGED) {
      for (int i = lane; i < n; i += 32) {   // lanes along the arms of each draw
        const int* arm = rg + (long long)t0 * L + idx[i];
        int r[32];
#pragma unroll
        for (int d = 0; d < 32; ++d) r[d] = d < draws ? __ldg(arm + (long long)d * L) : -1;
#pragma unroll
        for (int d = 0; d < 32; ++d)
          stage[32 * i + d] = (unsigned)r[d] < (unsigned)K ? (Id)r[d] : (Id)-1;
      }
      __syncwarp();
    }
    const int t = t0 + lane;
    const bool take = t < T && (!vg || vg[t] > 0.0f);
    int bin = -1;
    if (take) {
      if (STAGED) {
        StagedCol<Id> col{stage + lane};
        bin = by_class ? bin_by_class(col, n, wm, e, K) : bin_by_first_voter(col, n, wm, e, K);
      } else {
        GlobalCol col{rg + (long long)t * L, idx, K};
        bin = by_class ? bin_by_class(col, n, wm, e, K) : bin_by_first_voter(col, n, wm, e, K);
      }
    }
    if (bin >= H) bin -= fold;
    unsigned pending = __ballot_sync(kFull, bin >= 0);
    while (pending) {                  // one round per distinct bin in the warp
      const int b = __shfl_sync(kFull, bin, __ffs(pending) - 1);
      const unsigned hits = __ballot_sync(kFull, bin == b);
      if (lane == 0) atomicAdd(hist + b, (unsigned)__popc(hits));
      pending &= ~hits;
    }
    __syncwarp();                      // the columns are done before they are staged again
  }

  // 3. the block's histogram into rank 0's, then rank 0's combine
  __syncthreads();
  cluster_wait_acquire();              // every block has started; rank 0's total is zero
  unsigned* dst = cluster.map_shared_rank(total, 0);
  for (int j = threadIdx.x; j < S; j += threads)
    if (hist[j] != 0u) atomicAdd(dst + j, hist[j]);   // integers: exact in any order
  cluster_arrive_release();            // this rank's histogram is added
  cluster_wait_acquire();              // and every other rank's
  if (rank != 0 || warp != 0) return;
  const double th = theta ? (double)theta[g] : (double)T;
  double xi;
  if (lcm != 0) {                      // K <= 18 < 2H: S = K, slot j is bin j
    unsigned long long part = 0;
    for (int j = lane; j < S; j += 32)
      part += (unsigned long long)total[j] * ((unsigned)lcm / (unsigned)(j + 1));
    for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(kFull, part, off);
    xi = (double)part / (th * (double)lcm);
  } else {
    // the chain in ascending bin order over the slots that hold a count
    double acc = (double)total[0];     // hist_0 / 1: exact
    for (int j0 = 1; j0 < S; j0 += 32) {
      const int j = j0 + lane;
      const unsigned h = j < S ? total[j] : 0u;
      const double term = (double)h / (double)((j < H ? j : j + fold) + 1);
      unsigned held = __ballot_sync(kFull, h != 0u);
      while (held) {
        acc = acc + __shfl_sync(kFull, term, __ffs(held) - 1);
        held &= held - 1u;
      }
    }
    xi = acc / th;
  }
  if (lane == 0) out[(long long)g * C + c] = (float)xi;
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
// of the draws: ceil(T / cluster) threads in whole warps, up to `cap`.
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(int cluster, int G, int C, int T, int cap, size_t smem, cudaStream_t stream) {
    const int per_block = (T + cluster - 1) / cluster;
    const int threads = per_block >= cap ? cap : ((per_block + 31) / 32) * 32;
    cfg.gridDim = dim3(cluster, C, G);
    cfg.blockDim = dim3(threads > 32 ? threads : 32);
    cfg.dynamicSmemBytes = smem;
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
template <typename Kernel>
cudaError_t pick_cluster(Kernel kernel, int G, int C, int T, int cap, size_t smem,
                         cudaStream_t stream, int* cluster) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess || *cluster != 0) return err;
  Launch wide(kMaxCluster, G, C, T, cap, smem, stream);
  int resident = 0;
  err = cudaOccupancyMaxActiveClusters(&resident, kernel, &wide.cfg);
  if (err != cudaSuccess) return err;
  *cluster = (long long)G * C <= resident ? kMaxCluster : 8;
  return cudaSuccess;
}

template <int LMAX>
cudaError_t launch_lmax(const int* resp, const float* masks, const float* w, const float* empty,
                        const float* valid, const float* theta, float* out, int G, int C, int T,
                        int L, int K, int cluster, cudaStream_t stream) {
  void (*kernel)(const int*, const float*, const float*, const float*, const float*,
                 const float*, float*, int, int, int, int, int, unsigned long long) =
      K <= kSlots ? mc_tie_hist_kernel<LMAX, false> : mc_tie_hist_kernel<LMAX, true>;
  cudaError_t err = pick_cluster(kernel, G, C, T, max_threads(LMAX), 0, stream, &cluster);
  if (err != cudaSuccess) return err;
  Launch launch(cluster, G, C, T, max_threads(LMAX), 0, stream);
  const int vec = L == LMAX && L % 4 == 0 && (reinterpret_cast<uintptr_t>(resp) % 16) == 0;
  err = cudaLaunchKernelEx(&launch.cfg, kernel, resp, masks, w, empty, valid, theta, out, C, T,
                           L, K, vec, lcm_below_2_24(K));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Id, bool STAGED>
cudaError_t launch_wide(const int* resp, const float* masks, const float* w, const float* empty,
                        const float* valid, const float* theta, float* out, int G, int C, int T,
                        int L, int K, int cluster, cudaStream_t stream) {
  void (*kernel)(const int*, const float*, const float*, const float*, const float*,
                 const float*, float*, int, int, int, int, unsigned long long) =
      mc_tie_hist_wide_kernel<Id, STAGED>;
  const int id_bytes = STAGED ? (int)sizeof(Id) : 0;
  const int cap = wide_warps(L, (int)sizeof(Id)) * 32;
  // the shared memory of the most warps a block may have; the launch below
  // takes its own block's
  const size_t most = wide_layout(L, K, cap / 32, id_bytes).bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return err;
  err = pick_cluster(kernel, G, C, T, cap, most, stream, &cluster);
  if (err != cudaSuccess) return err;
  Launch launch(cluster, G, C, T, cap, 0, stream);
  launch.cfg.dynamicSmemBytes = wide_layout(L, K, launch.cfg.blockDim.x / 32, id_bytes).bytes;
  err = cudaLaunchKernelEx(&launch.cfg, kernel, resp, masks, w, empty, valid, theta, out, C, T,
                           L, K, lcm_below_2_24(K));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One launch over G <= kGridYZ groups and C <= kGridYZ candidates, the
// kernel chosen by explicit branches on L, K and the staging's size.
inline cudaError_t launch_part(const int* r, const float* m, const float* wt, const float* e,
                               const float* v, const float* th, float* o, int G, int C, int T,
                               int L, int K, int cluster, cudaStream_t s) {
  if (L > kRegArms) {
    const bool int_ids = K > kShortClasses;
    if (!wide_staged(L, int_ids ? 4 : 2))
      return launch_wide<int, false>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
    if (int_ids) return launch_wide<int, true>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
    return launch_wide<short, true>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
  }
  if (L <= 8) return launch_lmax<8>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
  if (L <= 12) return launch_lmax<12>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
  if (L <= 16) return launch_lmax<16>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
  return launch_lmax<32>(r, m, wt, e, v, th, o, G, C, T, L, K, cluster, s);
}

// Launch on `stream`; `valid` and `theta` may be null (every draw valid,
// theta = T); `cluster` 0 picks the cluster size. One launch where G and C
// are at most kGridYZ (the grid's y and z limit); past it, launches in
// chunks along G (C whole), or, where C passes it, one group and at most
// kGridYZ candidates a launch, each at its pointers' offsets. Returns the
// first failed launch's CUDA error, cudaErrorInvalidValue for arguments
// outside the kernels' range.
inline int tie_hist_launch(const void* resp, const void* masks, const void* w, const void* empty,
                           const void* valid, const void* theta, void* out, int G, int C, int T,
                           int L, int K, int cluster, void* stream) {
  if (G <= 0 || C <= 0) return 0;
  if (K < 1 || L < 0 || T < 0 || cluster < 0 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const int* r = (const int*)resp;
  const float *m = (const float*)masks, *wt = (const float*)w, *e = (const float*)empty;
  const float *v = (const float*)valid, *th = (const float*)theta;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= kGridYZ) {
    for (int g0 = 0; g0 < G; g0 += kGridYZ) {
      const int n = G - g0 < kGridYZ ? G - g0 : kGridYZ;
      const cudaError_t err = launch_part(
          r + (long long)g0 * T * L, m + (long long)g0 * C * L, wt + (long long)g0 * L, e + g0,
          v ? v + (long long)g0 * T : nullptr, th ? th + g0 : nullptr, o + (long long)g0 * C, n,
          C, T, L, K, cluster, s);
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  for (int g = 0; g < G; ++g) {
    for (int c0 = 0; c0 < C; c0 += kGridYZ) {
      const int n = C - c0 < kGridYZ ? C - c0 : kGridYZ;
      const cudaError_t err = launch_part(
          r + (long long)g * T * L, m + ((long long)g * C + c0) * L, wt + (long long)g * L, e + g,
          v ? v + (long long)g * T : nullptr, th ? th + g : nullptr, o + (long long)g * C + c0,
          1, n, T, L, K, cluster, s);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace mc
