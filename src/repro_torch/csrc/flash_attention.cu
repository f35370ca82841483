// Causal / sliding-window GQA attention for prefill self-attention, written
// for Hopper (sm_90a). Replaces the Pallas TPU kernel
// `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention.py; the design note, with the bound at
// the serving path's shapes, is in src/repro_torch/kernels/flash_attention.py.
//
// Layout as the JAX package's public function: q (B, S, H, HD), k and v
// (B, T, G, HD), out (B, S, H, HD) in q's type; query head h reads key/value
// head h / (H / G). Query i sees key j iff (!causal || j <= i) and
// (window == 0 || i - j < window). A row that sees no key writes 0, as the
// Pallas kernel does (acc / max(l, 1e-30) with l = 0). The kernels are
// instantiated at HD in {16, 32, 64, 128, 256}; the wrapper zero-pads any
// other head dim up to the next of those (zero q and k columns add nothing
// to a score, zero v columns give zero output columns, sliced off) and
// passes the true head dim's softmax scale, 1 / sqrt(hd) in f32.
//
// Two kernels, chosen by dtype in flash_attention_launch:
//
// v3, bf16 (the LM arms' serving path): both products on the tensor cores
// by wgmma.mma_async (bf16 x bf16 -> f32). One block, one warpgroup (4
// warps), per (batch, head, 64 query rows). Q (64 rows) and K/V tiles of
// kKeys keys are staged in shared memory as bf16 by cp.async, in the
// layout wgmma reads with a 128-byte swizzle (32 and 64 bytes at hd 16 and
// 32); K/V tiles are double-buffered, so tile j+1 loads while tile j is
// multiplied. The block walks only the key tiles its rows can see. Per
// tile, S = Q K^T is one chain of m64 x kKeys x 16 wgmmas with both
// operands in shared memory (K-major); one online-softmax step runs on
// the accumulator fragments in registers (row max and sum over the four
// threads that share a row, by shuffles; exp2 on scores pre-scaled by
// scale * log2(e)); P is rounded to bf16, as the TPU kernel rounds p to
// v's dtype, and fed from registers as the A operand of O += P V
// (m64 x hd x 16 wgmmas, V N-major in shared memory). O is rescaled by
// alpha per tile, multiplied by 1 / max(l, 1e-30) at the end and staged
// through shared memory for 16-byte coalesced stores. The grid runs the
// query tiles of one head, then the heads of one batch row, so all blocks
// that read one (batch, kv head)'s K/V run together and find it in L2.
//
// v2, f32 (the f32 checks and the f32 one-unit models): products on the
// CUDA cores. One block per (batch, head, 8 query rows), one warp per row;
// 32-key tiles staged as f32; lanes over keys for the scores, one
// online-softmax step per tile, lanes over head dims for p_j v_j.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// v3: bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace v3 {

constexpr int kRows = 64;          // query rows per block: one wgmma M tile
constexpr int kThreads = 128;      // one warpgroup; warp w owns rows 16w .. 16w + 15

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (and nothing read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads through the async one
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving other accesses of d across a wgmma fence or wait
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// two f32 -> one register of two bf16 (round to nearest), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The tiles' shared-memory layout, the one wgmma reads with a kW-byte
// swizzle (kW = 128 for hd >= 64, else 2 hd): a tile of R rows x HD bf16
// is HD / (kW / 2) column blocks, each R rows of kW bytes; the 16-byte
// piece index within a row is XORed with address bits [7, 7 + log2(kW/16)),
// as the hardware does. Blocks start on 1024 bytes, so those address bits
// are the offset's own.
template <int HD>
struct Tile {
  static constexpr int kW = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kCols = kW / 2;                                   // bf16 per block row
  static constexpr uint64_t kMode = kW == 128 ? 1 : (kW == 64 ? 2 : 3);  // descriptor swizzle
  // byte offset of element (r, c) in a tile of R rows
  static __device__ __forceinline__ uint32_t at(int R, int r, int c) {
    const uint32_t o = r * kW + (c % kCols) * 2;
    return (c / kCols) * R * kW + (o ^ (((o >> 7) & (kW / 16 - 1)) << 4));
  }
};

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle mode
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

// wgmma.mma_async bf16 x bf16 -> f32 at M = 64. ss: A and B K-major in
// shared memory (S = Q K^T); rs: A from registers, B N-major in shared
// memory (O += P V). d[4j + e] holds row 16 w + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2 of warp w's lane.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (64 x 16) += A (64 x 16, bf16 registers) * B (16 x 16, N-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32) (+)= A (64 x 16, K-major in shared memory) * B (16 x 32, K-major)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 32) += A (64 x 16, bf16 registers) * B (16 x 32, N-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64) (+)= A (64 x 16, K-major in shared memory) * B (16 x 64, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d (64 x 64) += A (64 x 16, bf16 registers) * B (16 x 64, N-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128) += A (64 x 16, bf16 registers) * B (16 x 128, N-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

template <>
struct Wgmma<256> {
  // d (64 x 256) += A (64 x 16, bf16 registers) * B (16 x 256, N-major in shared memory)
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
};

// at most 128 registers for hd <= 64 (four blocks an SM), 255 above (two)
template <int HD, int kKeys>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int S, int H, int Tk, int G, int causal, int window, float scale_log2) {
  using L = Tile<HD>;
  constexpr int kPieces = HD / 8;                    // 16-byte pieces per row
  constexpr uint32_t kQBytes = kRows * HD * 2;
  constexpr uint32_t kKVBytes = kKeys * HD * 2;
  constexpr uint32_t kSbo = 8 * L::kW;               // from one 8-row group to the next
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;         // Q: kRows x HD
  const uint32_t ks = qs + kQBytes;                  // K: 2 stages of kKeys x HD
  const uint32_t vs = ks + 2 * kKVBytes;             // V: 2 stages of kKeys x HD
  unsigned char* const q_ptr = smem_raw + (qs - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int g = h / (H / G);
  const int q0 = blockIdx.x * kRows;

  // keys any row of this block can see: [k_lo, k_hi)
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_hi = causal ? min(Tk, q_last + 1) : Tk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  const long long q_rs = (long long)H * HD;            // elements from one query row to the next
  const long long kv_rs = (long long)G * HD;
  const __nv_bfloat16* qb = q + ((long long)b * S * H + h) * HD;
  __nv_bfloat16* ob = o + ((long long)b * S * H + h) * HD;
  const __nv_bfloat16* kb = k + ((long long)b * Tk * G + g) * HD;
  const __nv_bfloat16* vb = v + ((long long)b * Tk * G + g) * HD;

  for (int e = tid; e < kRows * kPieces; e += kThreads) {
    const int r = e / kPieces;
    const int c = (e - r * kPieces) * 8;
    const bool ok = q0 + r < S;
    cp_async16(qs + L::at(kRows, r, c), qb + (ok ? (q0 + r) * q_rs : 0) + c, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    const int t0 = k_lo + tile * kKeys;
    for (int e = tid; e < kKeys * kPieces; e += kThreads) {
      const int r = e / kPieces;
      const int c = (e - r * kPieces) * 8;
      const bool ok = t0 + r < k_hi;   // rows past k_hi are zeros: p = 0 there, and v finite
      const long long off = (ok ? (t0 + r) * kv_rs : 0) + c;
      const uint32_t at = stage * kKVBytes + L::at(kKeys, r, c);
      cp_async16(ks + at, kb + off, ok);
      cp_async16(vs + at, vb + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();                   // Q and the first K/V tile

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows r0 and r0 + 8, in log2 units
  float l_run[2] = {0.0f, 0.0f};             // this thread's share of each row's sum
  const int r0 = q0 + warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane % 4);             // and its column pair in each 8-column group
  int key_min[2], key_max[2];                // ... which see keys [key_min, key_max]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_max[r] = causal ? min(k_hi - 1, r0 + 8 * r) : k_hi - 1;
    key_min[r] = window > 0 ? r0 + 8 * r - window + 1 : 0;
  }

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile it (and Q) have landed, for this thread
    fence_async_shared();              // ... are visible to wgmma
    __syncthreads();                   // ... for every thread's pieces
    const uint32_t kt = ks + (it & 1) * kKVBytes;
    const uint32_t vt = vs + (it & 1) * kKVBytes;
    const int t0 = k_lo + it * kKeys;

    // S = Q K^T: 64 rows x kKeys keys, K = hd in steps of 16 (32 bytes
    // within a 128-byte row, then the next column block)
    float s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.0f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int cb = kk * 16 / L::kCols;
      const uint32_t in_row = (kk * 16 % L::kCols) * 2;
      Wgmma<kKeys>::ss(s, desc(qs + cb * kRows * L::kW + in_row, 16, kSbo, L::kMode),
                       desc(kt + cb * kKeys * L::kW + in_row, 16, kSbo, L::kMode), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    // online softmax on the accumulator fragments
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + j * 8 + c0 + (e & 1);
        const int r = e >> 1;
        float& x = s[4 * j + e];
        x = key >= key_min[r] && key <= key_max[r] ? x * scale_log2 : -INFINITY;
        m_tile[r] = fmaxf(m_tile[r], x);
      }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;    // no key seen yet: p = 0, alpha = 0
      alpha[r] = fast_exp2(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      s[i] = fast_exp2(s[i] - m_use[(i >> 1) & 1]);
      l_run[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: A = P (64 rows x 16 keys) from the score registers, rounded
    // to bf16 as the TPU kernel rounds p; B = V's 16 keys x hd, N-major
    // (column blocks kKeys * kW bytes apart, 8-key groups kSbo apart)
    uint32_t p[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      Wgmma<HD>::rs(acc, p[kk], desc(vt + kk * 16 * L::kW, kKeys * L::kW, kSbo, L::kMode));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
    __syncthreads();                   // this stage is consumed before it is loaded again
  }
  cp_async_wait<0>();                  // Q's copy is done even when no tile was walked
  __syncthreads();

  // out = acc / max(l, 1e-30), as acc times one reciprocal per row, staged
  // through this warp's own rows of Q's tile for 16-byte coalesced stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / fmaxf(l, 1e-30f);
  }
  const int wr = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = j * 8 + c0;
    *reinterpret_cast<uint32_t*>(q_ptr + L::at(kRows, wr, col)) =
        pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_ptr + L::at(kRows, wr + 8, col)) =
        pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * kPieces; e += 32) {
    const int r = e / kPieces;
    const int c = (e - r * kPieces) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(ob + row * q_rs + c) =
          *reinterpret_cast<const uint4*>(q_ptr + L::at(kRows, warp * 16 + r, c));
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int Tk, int G, int causal, int window, float scale, cudaStream_t stream) {
  // 64-key tiles; 32 at hd=256, so that Q and two K/V stages (96 KB) leave
  // room for two blocks on an SM; 1 KB more to align the tiles on 1024
  constexpr int kKeys = HD == 256 ? 32 : 64;
  constexpr size_t smem = (size_t)(kRows + 4 * kKeys) * HD * sizeof(__nv_bfloat16) + 1024;
  auto kernel = flash_attention_kernel<HD, kKeys>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, S, H, Tk, G, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace v3

// ---------------------------------------------------------------------------
// v2: f32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace v2 {

constexpr int kWarp = 32;
constexpr int kRows = 8;     // query rows per block, one warp each
constexpr int kThreads = kRows * kWarp;
constexpr int kTile = kWarp; // keys per shared-memory tile: one per lane

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int H, int Tk, int G, int causal, int window, float scale) {
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

  const long long q_off = (((long long)b * S + row) * H + h) * HD;
  float* qrow = qs + warp * HD;
  for (int d = lane; d < HD; d += kWarp) qrow[d] = active ? q[q_off + d] : 0.0f;
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
        kv = k[off];
        vv = v[off];
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
      if (d < HD) o[q_off + d] = acc[i] / denom;
    }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int Tk, int G, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = (kTile * (HD + 1) + kTile * HD + kRows * HD) * sizeof(float);
  auto kernel = flash_attention_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, Tk, G, causal, window,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace v2

template <bool kBf16>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int Tk,
           int G, int hd, int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
#define FLASH_CASE(HD)                                                                     \
  case HD:                                                                                 \
    return kBf16 ? v3::launch_hd<HD>(q, k, v, o, B, S, H, Tk, G, causal, window, scale, st) \
                 : v2::launch_hd<HD>(q, k, v, o, B, S, H, Tk, G, causal, window, scale, st);
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
#undef FLASH_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, hd), k/v (B, T, G, hd), o (B, S, H, hd); all contiguous, all
// bf16 (is_bf16 == 1: v3, tensor cores) or all f32 (is_bf16 == 0: v2, CUDA
// cores); hd one of the template head dims (the wrapper zero-pads any other
// hd up to the next one) and scale the scores' factor, 1 / sqrt(true hd) in
// f32. Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int H, int Tk, int G,
                                      int hd, int causal, int window, int is_bf16,
                                      float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (G <= 0 || H % G != 0 || window < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<true>(q, k, v, o, B, S, H, Tk, G, hd, causal, window, scale, st)
                 : launch<false>(q, k, v, o, B, S, H, Tk, G, hd, causal, window, scale, st);
}
