// Causal / sliding-window GQA attention for prefill self-attention, written
// for Hopper (sm_90a). Replaces the Pallas TPU kernel
// `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention.py; the design note, with the bound at
// the serving path's shapes, is in src/repro_torch/kernels/flash_attention.py.
//
// Layout as the JAX package's public function: q (B, S, H, HD), k and v
// (B, T, G, HD), out (B, S, H, HD) in q's type; query head h reads key/value
// head h / (H / G). Query i sees key j iff (!causal || j <= i) and
// (window == 0 || i - j < window).
//
// One block per (batch, head, tile of kRows query rows); one warp per query
// row. The block walks only the key tiles its rows can see — tiles wholly
// above the diagonal or below the window are never loaded — staging kTile
// keys and values of its kv head in shared memory as f32 (the load loop has
// a compile-time stride and is unrolled, so several loads are in flight per
// thread). Within a tile the lanes go over the keys: lane j forms the score
// of key j from the row's query (a shared-memory broadcast) and key row j
// (a padded stride, so the 32 lanes hit 32 banks); the warp then takes one
// online-softmax step for the whole tile in f32 — tile max and sum by
// butterfly shuffle, one exp per lane — and accumulates p_j v_j with lanes
// back over the head dims (HD/32 accumulators per lane, in registers). A row
// with no visible key ends with l = 0 and writes acc / max(l, 1e-30) = 0, as
// the Pallas kernel does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 8;     // query rows per block, one warp each
constexpr int kThreads = kRows * kWarp;
constexpr int kTile = kWarp; // keys per shared-memory tile: one per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int S, int H, int Tk, int G, int causal, int window) {
  constexpr int kPer = (HD + kWarp - 1) / kWarp;   // head dims per lane
  constexpr int kStride = HD + 1;                  // padded key row: conflict-free
  extern __shared__ float smem[];
  float* ks = smem;                      // (kTile, HD + 1) keys of the tile
  float* vs = ks + kTile * kStride;      // (kTile, HD) values of the tile
  float* qs = vs + kTile * HD;           // (kRows, HD) the block's query rows

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int g = h / (H / G);
  const int q0 = blockIdx.x * kRows;
  const int row = q0 + warp;
  const bool active = row < S;       // warp-uniform
  const float scale = 1.0f / sqrtf((float)HD);

  const long long q_off = (((long long)b * S + row) * H + h) * HD;
  float* qrow = qs + warp * HD;
  for (int d = lane; d < HD; d += kWarp) qrow[d] = active ? to_f32(q[q_off + d]) : 0.0f;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  float m = -INFINITY;
  float l = 0.0f;

  // keys any row of this block can see: [k_lo, k_hi)
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int t0 = k_lo; t0 < k_hi; t0 += kTile) {
    const int nt = min(kTile, k_hi - t0);
    __syncthreads();                 // the previous tile is consumed
#pragma unroll 8
    for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
      const int j = e / HD;
      const int d = e - j * HD;
      float kv = 0.0f, vv = 0.0f;
      if (j < nt) {
        const long long off = (((long long)b * Tk + t0 + j) * G + g) * HD + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[j * kStride + d] = kv;
      vs[e] = vv;
    }
    __syncthreads();
    if (!active) continue;
    const int kpos = t0 + lane;
    const bool vis = lane < nt && (!causal || kpos <= row) &&
                     (window == 0 || row - kpos < window);
    if (!__any_sync(0xffffffffu, vis)) continue;   // warp-uniform
    float s = -INFINITY;
    if (vis) {
      const float* krow = ks + lane * kStride;
      float dot = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(qrow[d], krow[d], dot);
      s = dot * scale;
    }
    float tile_max = s;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);        // finite: some key is visible
    const float alpha = expf(m - m_new);           // 0 on the first visible tile
    const float p = vis ? expf(s - m_new) : 0.0f;
    float p_sum = p;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2)
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
    l = fmaf(l, alpha, p_sum);
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= alpha;
    for (int j = 0; j < nt; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int d = lane + i * kWarp;
        if (d < HD) acc[i] = fmaf(pj, vs[j * HD + d], acc[i]);
      }
    }
    m = m_new;
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane + i * kWarp;
      if (d < HD) o[q_off + d] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int Tk, int G, int causal, int window,
                 cudaStream_t stream) {
  const size_t smem = (kTile * (HD + 1) + kTile * HD + kRows * HD) * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Tk, G, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
              int H, int Tk, int G, int hd, int causal, int window,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_typed<T, 16>(q, k, v, o, B, S, H, Tk, G, causal, window, stream);
    case 32: return launch_typed<T, 32>(q, k, v, o, B, S, H, Tk, G, causal, window, stream);
    case 64: return launch_typed<T, 64>(q, k, v, o, B, S, H, Tk, G, causal, window, stream);
    case 128: return launch_typed<T, 128>(q, k, v, o, B, S, H, Tk, G, causal, window, stream);
    case 256: return launch_typed<T, 256>(q, k, v, o, B, S, H, Tk, G, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, hd), k/v (B, T, G, hd), o (B, S, H, hd); all contiguous, all f32
// (is_bf16 == 0) or all bf16 (is_bf16 == 1). Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int H, int Tk, int G,
                                      int hd, int causal, int window, int is_bf16,
                                      void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (G <= 0 || H % G != 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, Tk, G, hd, causal, window,
                                    (cudaStream_t)stream);
  return launch_hd<float>(q, k, v, o, B, S, H, Tk, G, hd, causal, window,
                          (cudaStream_t)stream);
}
