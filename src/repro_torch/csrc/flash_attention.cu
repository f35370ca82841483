// Causal / sliding-window GQA attention for prefill self-attention, written
// for Hopper (sm_90a). Replaces the Pallas TPU kernel
// `flash_attention_pallas` (body `_kernel`) in
// src/repro/kernels/flash_attention.py; the design note, with the bound at
// the serving path's shapes, what the timeline shows and the shape rules,
// is in src/repro_torch/kernels/flash_attention.py.
//
// Layout as the JAX package's public function: q (B, S, H, hd), k and v
// (B, T, G, hd), out (B, S, H, hd) in q's type; query head h reads key/value
// head h / R, R = H / G. Query i sees key j iff (!causal || j <= i) and
// (window == 0 || i - j < window). A row that sees no key writes 0, as the
// Pallas kernel does (acc / max(l, 1e-30) with l = 0). Every kernel takes
// the caller's hd as the row stride: they are instantiated at the template
// head dims HD in {16, 32, 64, 128, 256}, fill the columns hd .. HD - 1 of
// their tiles with zeros (zero q and k columns add nothing to a score, zero
// v columns give output columns that are never stored) and store only the
// real columns. The bf16 kernels copy 16-byte pieces, so they take hd a
// multiple of 8 (the wrapper pads any other hd to the next multiple of 8);
// the f32 kernel takes any hd. The scores' factor is the true head dim's,
// 1 / sqrt(hd) in f32.
//
// Three kernels, one per `design` of flash_attention_launch, which the
// wrapper's `tiling` chooses by an explicit shape rule: f32 -> v2; bf16 at
// group ratios R <= 3 -> v3; bf16 at R >= 4 -> v4.
//
// Both bf16 kernels run the two products on the tensor cores by
// wgmma.mma_async (bf16 x bf16 -> f32), with Q and K/V tiles in shared
// memory in the layout wgmma reads with a 128-byte swizzle (32 and 64 bytes
// at HD 16 and 32). Per K/V tile of kKeys keys (64; 32 at HD = 256), S =
// Q K^T is one chain of m64 x kKeys x 16 wgmmas with both operands in shared
// memory (K-major); one online-softmax step runs on the accumulator
// fragments in registers (row max and sum over the four threads that share
// a row, by shuffles; exp2 of scores scaled by scale * log2(e)); P is
// rounded to bf16, as the TPU kernel rounds p to v's dtype, and fed from
// registers as the A operand of O += P V (m64 x HD x 16 wgmmas, V N-major).
//
// v3 (R <= 3: smollm-135m, moonshot-v1-16b-a3b, training): one block, one
// warpgroup, per (batch, query head, 64 rows); Q and two stages of K/V
// tiles brought in by cp.async (zero-filled past the ragged edge and past
// hd), the next K/V tile loading while one is multiplied; O staged through
// Q's tile for 16-byte coalesced stores. Each K/V tile comes into shared
// memory once per query head, R times per group.
//
// v4 (R >= 4: the GQA families): each K/V tile in shared memory serves
// every query head of its group. A block takes one (batch, kv head) and a
// chunk of positions [p0, p1); its M tiles pack `rb` heads of `pb`
// consecutive positions position-major (Packing: R heads of 64 / R
// positions), so the rows of one position are contiguous in q and out. All
// copies are TMA boxes of the caller's tensors (zeros outside them; stores
// clipped to them), issued by one thread a warpgroup and reported to
// mbarriers: Q with an evict-first L2 policy into q_bufs buffers a
// warpgroup (a buffer takes the Q of the M tile q_bufs ahead once the
// current tile's last PV product is done), K/V with evict-last, O staged by
// stmatrix into an O buffer and stored by TMA with evict-first. When the
// chunk's keys fit the block's K/V slots (resident: every chunk at 127
// tokens) they are loaded once and serve all the chunk's M tiles;
// otherwise (long prompts) each warpgroup streams its tiles through two
// slots. One warpgroup a block, two blocks an SM; two warpgroups sharing
// the resident keys where those leave room for one block an SM (HD = 256,
// or hd 64 at 512 tokens). The grid is (G, B, chunks), the last (heaviest
// under a causal mask) chunk first. A wait on an mbarrier past about ten
// seconds traps, so a fault in a byte count cannot hang the card.
//
// v2, f32 (the f32 checks and the f32 one-unit models): products on the
// CUDA cores. One block per (batch, head, 8 query rows), one warp per row;
// 32-key tiles staged as f32; lanes over keys for the scores, one
// online-softmax step per tile, lanes over head dims for p_j v_j.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: what v3 and v4 share
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kRows = 64;          // query rows of an M tile: one wgmma M

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
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// one arrival that also tells the mbarrier to expect `bytes` more from TMA
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` of the mbarrier has completed.
// A wait past about ten seconds of SM clock traps (a launch error), so a
// fault in the byte count cannot hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > 20000000000LL) __trap();
  }
}
// TMA: a box of the tensor map at coordinates c (innermost first) into
// shared memory at dst, reported to the mbarrier bar; and a box from shared
// memory at src to the tensor map (a bulk group of this thread). Elements
// outside the tensor are read as zeros and never written.
// L2 policies: Q and O stream through once, K and V are read by a block
// and may be met again by the next chunk's
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n"
      ::"r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, int c4, uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3, %4, %5, %6}], [%7], %8;\n"
      ::"r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(bar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_store5(const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                           int c4, uint32_t src, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.tile.bulk_group.L2::cache_hint"
      " [%0, {%1, %2, %3, %4, %5}], [%6], %7;\n"
      ::"l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(src), "l"(policy) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// this thread's bulk stores have read their shared memory (it may be reused)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
// the 128 threads of warpgroup w meet (named barrier 1 + w)
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// shared-memory stores and cp.async go through the generic proxy; wgmma and
// the TMA store read through the async one
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

// four 8 x 8 bf16 matrices from registers to shared memory: lanes 8k .. 8k
// + 7 give the row addresses of matrix k; r_k holds row lane / 4, columns
// 2 (lane % 4), + 1 of matrix k (the accumulator fragment's own layout)
__device__ __forceinline__ void stmatrix4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                          uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
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

}  // namespace tc

// ---------------------------------------------------------------------------
// v3: bf16, one block per (batch, query head, 64 rows) (group ratios 1-3)
// ---------------------------------------------------------------------------
namespace v3 {
using namespace tc;

constexpr int kThreads = 128;      // one warpgroup; warp w owns rows 16w .. 16w + 15

// at most 128 registers for hd <= 64 (four blocks an SM), 255 above (two)
template <int HD, int kKeys>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int S, int H, int Tk, int G, int hd, int causal, int window,
                       float scale_log2) {
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

  const long long q_rs = (long long)H * hd;            // elements from one query row to the next
  const long long kv_rs = (long long)G * hd;
  const __nv_bfloat16* qb = q + ((long long)b * S * H + h) * hd;
  __nv_bfloat16* ob = o + ((long long)b * S * H + h) * hd;
  const __nv_bfloat16* kb = k + ((long long)b * Tk * G + g) * hd;
  const __nv_bfloat16* vb = v + ((long long)b * Tk * G + g) * hd;

  for (int e = tid; e < kRows * kPieces; e += kThreads) {
    const int r = e / kPieces;
    const int c = (e - r * kPieces) * 8;
    const bool ok = q0 + r < S && c < hd;     // columns past hd are zeros
    cp_async16(qs + L::at(kRows, r, c), qb + (ok ? (q0 + r) * q_rs + c : 0), ok);
  }
  auto load_kv = [&](int tile, int stage) {
    const int t0 = k_lo + tile * kKeys;
    for (int e = tid; e < kKeys * kPieces; e += kThreads) {
      const int r = e / kPieces;
      const int c = (e - r * kPieces) * 8;
      const bool ok = t0 + r < k_hi && c < hd;   // rows past k_hi are zeros: p = 0 there
      const long long off = ok ? (t0 + r) * kv_rs + c : 0;
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
    if (row < S && c < hd)
      *reinterpret_cast<uint4*>(ob + row * q_rs + c) =
          *reinterpret_cast<const uint4*>(q_ptr + L::at(kRows, warp * 16 + r, c));
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int Tk, int G, int hd, int causal, int window, float scale, cudaStream_t stream) {
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
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;   // grid y, z
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, S, H, Tk, G, hd, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace v3

// ---------------------------------------------------------------------------
// v4: bf16, one block per (batch, kv head, chunk of positions) (ratios >= 4)
// ---------------------------------------------------------------------------
namespace v4 {
using namespace tc;

constexpr int kMaxQBufs = 2;       // Q buffers a warpgroup, at most

// Shared memory of one block: q_bufs Q tiles and o_bufs (0 or 1) O tiles a
// warpgroup, `slots` K tiles, `slots` V tiles, each on 1024 bytes; 1024
// bytes more to align the start, which also hold the kMaxQBufs mbarriers a
// warpgroup and the one a slot (before the tiles or after them, wherever
// the alignment left room). The wrapper's `tiling` computes the same.
template <int HD, int kKeys>
constexpr size_t smem_bytes(int wgs, int slots, int q_bufs, int o_bufs) {
  return 1024 + (size_t)wgs * (q_bufs + o_bufs) * kRows * HD * 2 +
         (size_t)2 * slots * kKeys * HD * 2;
}

// The keys [k_lo, k_hi) any row of positions [pa, pb] can see.
__device__ __host__ __forceinline__ void key_range(int pa, int pb, int Tk, int causal, int window,
                                                   int& k_lo, int& k_hi) {
  k_hi = causal && pb + 1 < Tk ? pb + 1 : Tk;
  k_lo = window > 0 && pa - window + 1 > 0 ? pa - window + 1 : 0;
}

// An M tile packs `rb` heads of `pb` consecutive positions (rb pb <= 64
// rows): rb = R, pb = 64 / R when R <= 64; else rb = 64, pb = 1, and a
// position's heads take ceil(R / 64) M tiles (`hb`).
struct Packing {
  int rb, pb, hb;
  __device__ __host__ explicit Packing(int R)
      : rb(R <= kRows ? R : kRows), pb(R <= kRows ? kRows / R : 1), hb((R + rb - 1) / rb) {}
};

// kWG warpgroups a block (1 or 2, the wrapper's choice): with one, two
// blocks an SM (four at HD <= 64)
template <int HD, int kKeys, int kWG>
__global__ void __launch_bounds__(128 * kWG, kWG == 2 ? 1 : (HD <= 64 ? 4 : 2))
flash_attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, int S, int H, int Tk, int G,
                       int causal, int window, float scale_log2, int chunk_pos, int slots,
                       int q_bufs, int o_bufs) {
  using L = Tile<HD>;
  constexpr uint32_t kQBytes = kRows * HD * 2;
  constexpr uint32_t kKVBytes = kKeys * HD * 2;
  constexpr uint32_t kSbo = 8 * L::kW;               // from one 8-row group to the next
  constexpr int kBlocks = HD / L::kCols;             // column blocks of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t os = base + kWG * q_bufs * kQBytes; // O: o_bufs a warpgroup
  const uint32_t ks = os + kWG * o_bufs * kQBytes;   // K: slots x (kKeys x HD)
  const uint32_t vs = ks + slots * kKVBytes;         // V: slots x (kKeys x HD)
  const uint32_t bar_bytes = 8 * (kMaxQBufs * kWG + slots);
  const uint32_t q_bar = base - raw >= bar_bytes ? raw : vs + slots * kKVBytes;  // Q landed
  const uint32_t kv_bar = q_bar + 8 * kMaxQBufs * kWG;   // one a slot: K/V slot landed

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int wtid = tid % 128;
  const bool leader = wtid == 0;                     // issues the warpgroup's TMA copies
  const int warp = wtid / 32;                        // within the warpgroup
  const int lane = tid % 32;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int R = H / G;
  const Packing pk(R);
  const int p0 = (gridDim.z - 1 - blockIdx.z) * chunk_pos;   // the last chunk first
  const int p1 = min(S, p0 + chunk_pos);
  const int n_m = (p1 - p0 + pk.pb - 1) / pk.pb * pk.hb;     // the chunk's M tiles
  int k_lo, k_hi;                                    // keys any row of the chunk sees
  key_range(p0, p1 - 1, Tk, causal, window, k_lo, k_hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;
  const bool resident = n_tiles <= slots;            // block-uniform

  const uint64_t stream_pol = evict_first(), kv_pol = evict_last();
  if (tid == 0) {
    for (int i = 0; i < kMaxQBufs * kWG + slots; ++i) mbar_init(q_bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // M tile m: its first position and head
  auto origin = [&](int m, int& pos, int& head) {
    pos = p0 + m / pk.hb * pk.pb;
    head = m % pk.hb * pk.rb;
  };
  // (leader) Q of M tile m into this warpgroup's buffer `buf`
  auto load_q = [&](int m, int buf) {
    int pos, head;
    origin(m, pos, head);
    const uint32_t dst = base + (wg * q_bufs + buf) * kQBytes;
    const uint32_t bar = q_bar + 8 * (kMaxQBufs * wg + buf);
    mbar_expect(bar, kBlocks * L::kCols * pk.rb * pk.pb * 2);
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load5(dst + cb * kRows * L::kW, &tm_q, cb * L::kCols, head, g, pos, b, bar, stream_pol);
  };
  // (leader) K/V tile t (keys k_lo + t kKeys ...) into slot `slot`; keys
  // past T are zeros, keys past k_hi are masked in the softmax
  auto load_kv = [&](int t, int slot) {
    const uint32_t bar = kv_bar + 8 * slot;
    mbar_expect(bar, 2 * kKVBytes);
    for (int cb = 0; cb < kBlocks; ++cb) {
      const uint32_t at = slot * kKVBytes + cb * kKeys * L::kW;
      tma_load4(ks + at, &tm_k, cb * L::kCols, g, k_lo + t * kKeys, b, bar, kv_pol);
      tma_load4(vs + at, &tm_v, cb * L::kCols, g, k_lo + t * kKeys, b, bar, kv_pol);
    }
  };
  // the K/V tiles [ta, tb) M tile m's rows can see
  auto tiles_of = [&](int m, int& ta, int& tb) {
    int pos, head, lo, hi;
    origin(m, pos, head);
    key_range(pos, min(pos + pk.pb, p1) - 1, Tk, causal, window, lo, hi);
    ta = hi > lo ? (lo - k_lo) / kKeys : 0;
    tb = hi > lo ? (hi - k_lo + kKeys - 1) / kKeys : 0;
  };
  // streaming: the next (M tile lm, K/V tile lt) this warpgroup loads;
  // lm >= n_m when none is left
  int lm = n_m, lt = 0, ltb = 0;
  auto seek = [&](int m) {                 // the first of M tiles m, m + kWG, ... that sees a key
    for (lm = m; lm < n_m; lm += kWG) {
      tiles_of(lm, lt, ltb);
      if (lt < ltb) return;
    }
  };
  auto advance = [&]() {
    if (++lt >= ltb) seek(lm + kWG);
  };

  if (leader) {                            // Q first: it is needed first
    for (int i = 0; i < q_bufs && wg + i * kWG < n_m; ++i) load_q(wg + i * kWG, i);
    if (resident && wg == 0)
      for (int t = 0; t < n_tiles; ++t) load_kv(t, t);
  }
  if (!resident) {
    seek(wg);
    if (lm < n_m) {
      if (leader) load_kv(lt, 2 * wg);
      advance();
    }
  }

  const int quad = lane % 4;               // this thread's column pair in each 8-column group
  int step = 0;                            // this warpgroup's K/V tiles walked so far (streaming)
  // a Q buffer takes the Q of the M tile q_bufs ahead once its last S
  // product has read it; when O is staged in it (o_bufs == 0), only once
  // the O store has read it too, which is waited for in the next M tile
  int refill_m = -1, refill_buf = 0;
  auto refill = [&]() {
    if (refill_m < 0) return;
    if (leader) {
      if (!o_bufs) bulk_wait_read();
      load_q(refill_m, refill_buf);
    }
    refill_m = -1;
  };
  int it = 0;
  for (int m = wg; m < n_m; m += kWG, ++it) {
    int ta, tb, pos0, head0;
    tiles_of(m, ta, tb);
    origin(m, pos0, head0);
    // this thread's rows: warp * 16 + lane / 4 and 8 more, seeing keys
    // [key_min, key_max]; every real row sees keys [full_lo, full_hi]
    int key_min[2], key_max[2];
    int full_lo, full_hi;
    key_range(min(pos0 + pk.pb, p1) - 1, pos0, Tk, causal, window, full_lo, full_hi);
    full_hi = min(full_hi, k_hi) - 1;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + lane / 4 + 8 * r;
      const int pos = pos0 + row / pk.rb;
      const bool live = row < pk.rb * pk.pb && pos < p1 && head0 + row % pk.rb < R;
      key_max[r] = !live ? -1 : (causal ? min(k_hi - 1, pos) : k_hi - 1);
      key_min[r] = window > 0 ? pos - window + 1 : 0;
    }
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};   // in log2 units
    float l_run[2] = {0.0f, 0.0f};             // this thread's share of each row's sum
    const int buf = it % q_bufs;               // Q tile it is in buffer it % q_bufs
    const uint32_t qs = base + (wg * q_bufs + buf) * kQBytes;
    const uint32_t stage = o_bufs ? os + wg * kQBytes : qs;   // O is staged here
    const int m_next = m + q_bufs * kWG;       // the M tile whose Q takes this buffer next

    mbar_wait(q_bar + 8 * (kMaxQBufs * wg + buf), (it / q_bufs) & 1);

    for (int t = ta; t < tb; ++t, ++step) {
      int slot;
      if (resident) {
        slot = t;
        mbar_wait(kv_bar + 8 * slot, 0);
      } else {
        if (lm < n_m) {                        // the next tile into the other slot
          if (leader) load_kv(lt, 2 * wg + ((step + 1) & 1));
          advance();
        }
        slot = 2 * wg + (step & 1);
        mbar_wait(kv_bar + 8 * slot, (step >> 1) & 1);
      }
      const uint32_t kt = ks + slot * kKVBytes;
      const uint32_t vt = vs + slot * kKVBytes;
      const int t0 = k_lo + t * kKeys;

      // S = Q K^T: 64 rows x kKeys keys, K = HD in steps of 16 (32 bytes
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
      if (!o_bufs && t == ta) refill();       // the previous O store has had an S product's time

      // online softmax on the accumulator fragments; a tile every real row
      // sees whole needs no mask (rows past the chunk or the group are
      // computed but never stored)
      // (the max is taken on the raw scores: scale_log2 > 0 keeps their order)
      float m_tile[2] = {-INFINITY, -INFINITY};
      if (t0 >= full_lo && t0 + kKeys - 1 <= full_hi) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) m_tile[(i >> 1) & 1] = fmaxf(m_tile[(i >> 1) & 1], s[i]);
      } else {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t0 + j * 8 + 2 * quad + (e & 1);
            const int r = e >> 1;
            float& x = s[4 * j + e];
            x = key >= key_min[r] && key <= key_max[r] ? x : -INFINITY;
            m_tile[r] = fmaxf(m_tile[r], x);
          }
      }
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
        m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
        const float m_new = fmaxf(m_run[r], m_tile[r] * scale_log2);
        m_use[r] = m_new == -INFINITY ? 0.0f : m_new;    // no key seen yet: p = 0, alpha = 0
        alpha[r] = fast_exp2(m_run[r] - m_use[r]);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {          // p = 2^(s scale_log2 - m), one rounding
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -m_use[(i >> 1) & 1]));
        l_run[(i >> 1) & 1] += s[i];
      }
      if (t > ta)                              // (acc is still zero on the first tile)
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P V: A = P (64 rows x 16 keys) from the score registers, rounded
      // to bf16 as the TPU kernel rounds p; B = V's 16 keys x HD, N-major
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
      // the last PV product is done: every warp's S products have read Q
      if (o_bufs && t == tb - 1 && m_next < n_m) {
        refill_m = m_next;
        refill_buf = buf;
        refill();
      }
      if (!resident) wg_sync(wg);              // this slot is consumed before it is loaded again
    }
    if (ta >= tb && o_bufs && m_next < n_m) {  // an M tile that saw no key
      wg_sync(wg);
      refill_m = m_next;
      refill_buf = buf;
    }
    refill();

    // out = acc / max(l, 1e-30), as acc times one reciprocal per row, staged
    // in this warpgroup's O buffer (once the previous store has read it) or
    // in this M tile's Q buffer (its products are done), and stored by TMA,
    // which writes only the real rows and columns
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.0f / fmaxf(l, 1e-30f);
    }
    if (o_bufs && leader) bulk_wait_read();
    wg_sync(wg);                               // every warp's products have read Q
    // column groups j and j + 1 of the warp's 16 rows, four 8 x 8 matrices
    // a stmatrix: lane addresses row lane % 8 of matrix lane / 8
    const int st_row = warp * 16 + (lane / 8 % 2) * 8 + lane % 8;
    const int st_col = lane / 16 * 8;
#pragma unroll
    for (int j = 0; j < HD / 8; j += 2)
      stmatrix4(stage + L::at(kRows, st_row, j * 8 + st_col),
                pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]),
                pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]),
                pack_bf16(acc[4 * j + 4] * inv[0], acc[4 * j + 5] * inv[0]),
                pack_bf16(acc[4 * j + 6] * inv[1], acc[4 * j + 7] * inv[1]));
    fence_async_shared();
    wg_sync(wg);
    if (leader) {
      for (int cb = 0; cb < kBlocks; ++cb)
        tma_store5(&tm_o, cb * L::kCols, head0, g, pos0, b, stage + cb * kRows * L::kW,
                   stream_pol);
      bulk_commit();
    }
    if (!o_bufs && m_next < n_m) {             // with two Q buffers during the next M tile
      refill_m = m_next;
      refill_buf = buf;
      if (q_bufs == 1) refill();
    }
  }
  if (leader) bulk_wait();                     // the stores have read shared memory
}

// libcuda's tensor-map encoder (cuTensorMapEncodeTiled), looked up once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1 ..), boxes `box`, the tiles' swizzle, zeros outside the tensor
template <int HD>
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swz = Tile<HD>::kW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Tile<HD>::kW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int kWG>
int launch_wg(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int Tk, int G, int hd, int causal, int window, float scale, int chunk_pos,
              int slots, int q_bufs, int o_bufs, int smem, cudaStream_t stream) {
  // 64-key tiles; 32 at HD = 256, so that the keys of a 127-token prompt
  // fit in 4 slots beside a Q tile a warpgroup
  constexpr int kKeys = HD == 256 ? 32 : 64;
  constexpr int kCols = Tile<HD>::kCols;
  const Packing pk(H / G);
  if (chunk_pos < 1 || (chunk_pos % pk.pb && chunk_pos < S) || slots < 1 || slots > 48 ||
      q_bufs < 1 || q_bufs > kMaxQBufs || o_bufs < 0 || o_bufs > 1 ||
      (size_t)smem != smem_bytes<HD, kKeys>(kWG, slots, q_bufs, o_bufs))
    return (int)cudaErrorInvalidValue;
  const int chunks = (S + chunk_pos - 1) / chunk_pos;
  // a chunk whose keys do not fit its slots streams through two slots a warpgroup
  if (slots < 2 * kWG)
    for (int c = 0; c < chunks; ++c) {
      int lo, hi;
      key_range(c * chunk_pos, min(S, (c + 1) * chunk_pos) - 1, Tk, causal, window, lo, hi);
      if (hi > lo && (hi - lo + kKeys - 1) / kKeys > slots) return (int)cudaErrorInvalidValue;
    }
  if (B > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;   // grid y, z
  // q and out: (hd, R, G, S, B), a box of rb heads x pb positions; k and v:
  // (hd, G, T, B), a box of kKeys keys; each box kCols columns wide
  const int R = H / G;
  const cuuint64_t e = 2;                  // bytes of a bf16
  const cuuint64_t q_dims[5] = {(cuuint64_t)hd, (cuuint64_t)R, (cuuint64_t)G, (cuuint64_t)S,
                                (cuuint64_t)B};
  const cuuint64_t q_strides[4] = {hd * e, (cuuint64_t)R * hd * e, (cuuint64_t)H * hd * e,
                                   (cuuint64_t)S * H * hd * e};
  const cuuint32_t q_box[5] = {(cuuint32_t)kCols, (cuuint32_t)pk.rb, 1, (cuuint32_t)pk.pb, 1};
  const cuuint64_t kv_dims[4] = {(cuuint64_t)hd, (cuuint64_t)G, (cuuint64_t)Tk, (cuuint64_t)B};
  const cuuint64_t kv_strides[3] = {hd * e, (cuuint64_t)G * hd * e, (cuuint64_t)Tk * G * hd * e};
  const cuuint32_t kv_box[4] = {(cuuint32_t)kCols, 1, (cuuint32_t)kKeys, 1};
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!encode<HD>(&tm_q, q, 5, q_dims, q_strides, q_box) ||
      !encode<HD>(&tm_o, o, 5, q_dims, q_strides, q_box) ||
      !encode<HD>(&tm_k, k, 4, kv_dims, kv_strides, kv_box) ||
      !encode<HD>(&tm_v, v, 4, kv_dims, kv_strides, kv_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel<HD, kKeys, kWG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid(G, B, chunks);
  kernel<<<grid, 128 * kWG, smem, stream>>>(tm_q, tm_k, tm_v, tm_o, S, H, Tk, G, causal, window,
                                           scale_log2, chunk_pos, slots, q_bufs, o_bufs);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int Tk, int G, int hd, int causal, int window, float scale, int chunk_pos,
              int slots, int q_bufs, int o_bufs, int wgs, int smem, cudaStream_t stream) {
  if (wgs == 1)
    return launch_wg<HD, 1>(q, k, v, o, B, S, H, Tk, G, hd, causal, window, scale, chunk_pos,
                            slots, q_bufs, o_bufs, smem, stream);
  if (wgs == 2)
    return launch_wg<HD, 2>(q, k, v, o, B, S, H, Tk, G, hd, causal, window, scale, chunk_pos,
                            slots, q_bufs, o_bufs, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace v4

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
                       int S, int H, int Tk, int G, int hd, int causal, int window, float scale) {
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

  // columns hd .. HD - 1 of the tiles are zeros
  const long long q_off = (((long long)b * S + row) * H + h) * hd;
  float* qrow = qs + warp * HD;
  for (int d = lane; d < HD; d += kWarp) qrow[d] = active && d < hd ? q[q_off + d] : 0.0f;
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
      if (j < nt && d < hd) {
        const long long off = (((long long)b * Tk + t0 + j) * G + g) * hd + d;
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
      if (d < hd) o[q_off + d] = acc[i] / denom;
    }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int Tk, int G, int hd, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = (kTile * (HD + 1) + kTile * HD + kRows * HD) * sizeof(float);
  auto kernel = flash_attention_kernel<HD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H, Tk, G, hd, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace v2

// the smallest template head dim that holds hd
int template_hd(int hd) {
  for (int t = 16; t <= 256; t *= 2)
    if (hd <= t) return t;
  return 0;
}

}  // namespace

// q (B, S, H, hd), k/v (B, T, G, hd), o (B, S, H, hd); all contiguous, all
// bf16 (design 3 or 4: v3 or v4 on the tensor cores; hd a multiple of 8,
// every pointer on 16 bytes) or all f32 (design 2: v2, CUDA cores); 1 <= hd
// <= 256; scale the scores' factor, 1 / sqrt(true hd) in f32. For v4, chunk_pos (the
// positions a block takes), slots (its K/V slots), q_bufs and o_bufs (its Q
// buffers, 1 to 4, and O buffers, 0 or 1, a warpgroup), wgs (its
// warpgroups, 1 or 2) and smem (its dynamic shared memory, checked against
// the layout) come from the wrapper's `tiling`; v2 and v3 ignore them.
// Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int B, int S, int H, int Tk, int G,
                                      int hd, int causal, int window, int design,
                                      float scale, int chunk_pos, int slots, int q_bufs,
                                      int o_bufs, int wgs, int smem, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (G <= 0 || H % G != 0 || window < 0 || hd < 1 || hd > 256 || design < 2 || design > 4 ||
      (design > 2 && hd % 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (template_hd(hd)) {
#define FLASH_CASE(HD)                                                                       \
  case HD:                                                                                   \
    return design == 4   ? v4::launch_hd<HD>(q, k, v, o, B, S, H, Tk, G, hd, causal, window,  \
                                           scale, chunk_pos, slots, q_bufs, o_bufs, wgs,     \
                                           smem, st)                                         \
           : design == 3 ? v3::launch_hd<HD>(q, k, v, o, B, S, H, Tk, G, hd, causal, window,  \
                                           scale, st)                                        \
                         : v2::launch_hd<HD>(q, k, v, o, B, S, H, Tk, G, hd, causal, window,  \
                                           scale, st);
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
#undef FLASH_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
