// Hopper (sm_90a) building blocks: shared-memory barriers (mbarrier),
// TMA tile loads and stores, per-thread asynchronous copies (cp.async),
// register reallocation between warpgroups, the warpgroup matrix
// multiply (wgmma) on bf16 operands with f32 sums, the warp-level
// mma.sync on TF32 operands with the hi/lo split of 3xTF32 and on bf16
// operands, and ldmatrix.
//
// Layout contract between TMA and wgmma.  A tile is loaded as column
// boxes of 64 bf16 (128 bytes) by rows, with the 128-byte swizzle: row r
// of a box lands at byte r * 128 of it, its 16-byte groups permuted by
// r % 8.  Boxes start at 1024-byte boundaries.  That is the wgmma
// "128B" layout:
//   * K-major operand (Q, K: the reduction runs along a row): 8-row
//     groups 1024 bytes apart (SBO); one k16 step is 32 bytes along the
//     row, so step kk of a box starts (kk % 4) * 32 bytes in, and box
//     kk / 4 holds it.
//   * MN-major operand (V as stored, [kv rows, d columns]: the reduction
//     runs down the rows): 8-row groups 1024 bytes apart (SBO), 64-column
//     boxes LBO bytes apart; one k16 step is 16 rows, 2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to
// the TMA unit; a __syncthreads() follows it.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of parity `parity`.
// A wait of more than about ten seconds traps, so a deadlock ends the
// kernel with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1LL << 34)) __trap();
}

// ---- TMA ----------------------------------------------------------------

// Loads the box at element coordinates (c0 innermost, c1, c2) of `map`
// into shared memory at `dst`; completes its bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Stores the box at element coordinates (c0, c1, c2) of `map` from shared
// memory at `src` (bulk group; elements outside the tensor are left out).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed bulk stores have read their shared
// memory (Read) or completed.
template <bool Read>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (Read)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's writes to shared memory before later TMA (async
// proxy) reads of it; a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- cp.async (per-thread asynchronous copies) --------------------------

// Copies `bytes` (at most Vec) from global `src` to shared `dst` and
// zero-fills the rest of the Vec-byte chunk; both addresses aligned to
// Vec (16, 8 or 4).  bytes = 0 reads nothing.
template <int Vec>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  static_assert(Vec == 16 || Vec == 8 || Vec == 4, "cp.async takes 4, 8, 16");
  if constexpr (Vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(Vec), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until this thread's committed copies have all landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are still
// in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- named barriers -----------------------------------------------------

// Waits at barrier `id` (1 to 15; 0 is __syncthreads) until `threads`
// threads have arrived or synced there.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- register reallocation (all four warps of a warpgroup) -------------

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- wgmma --------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma operand
// register across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Shared-memory matrix descriptor of the 128-byte swizzled layout; lbo
// and sbo in bytes.
__device__ __forceinline__ uint64_t desc_b128(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(smem) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// Wgmma<N>: m64 x nN x k16, bf16 operands, f32 accumulator d[N / 2] in the
// wgmma fragment (thread t of the warpgroup holds rows 16 (t / 32) + t % 32
// / 4 and that + 8, columns 8 j + 2 (t % 4) and that + 1: d[4 j], d[4 j + 1]
// for the first row, d[4 j + 2], d[4 j + 3] for the second).
//   ss: A and B from shared memory, both K-major;
//   rs: A from registers (four bf16 pairs in the accumulator's layout of
//       a 16-column slice), B MN-major from shared memory.
// rs and ss add to d; ss_first overwrites it, so d's old values are dead
// before the product (they hold no registers across the loop).  The
// register lists are spelled out per N (inline asm takes no operand
// packs).
template <int N>
struct Wgmma;

#define REPRO_WG_F8(c, i)                                                  \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), \
  c(d[i + 6]), c(d[i + 7])
#define REPRO_WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define REPRO_WG_O8(c) REPRO_WG_F8(c, 0)
#define REPRO_WG_R16 REPRO_WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define REPRO_WG_O16(c) REPRO_WG_O8(c), REPRO_WG_F8(c, 8)
#define REPRO_WG_R24 REPRO_WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define REPRO_WG_O24(c) REPRO_WG_O16(c), REPRO_WG_F8(c, 16)
#define REPRO_WG_R32 REPRO_WG_R24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define REPRO_WG_O32(c) REPRO_WG_O24(c), REPRO_WG_F8(c, 24)
#define REPRO_WG_R40 REPRO_WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define REPRO_WG_O40(c) REPRO_WG_O32(c), REPRO_WG_F8(c, 32)
#define REPRO_WG_R48 REPRO_WG_R40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define REPRO_WG_O48(c) REPRO_WG_O40(c), REPRO_WG_F8(c, 40)
#define REPRO_WG_R56 REPRO_WG_R48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define REPRO_WG_O56(c) REPRO_WG_O48(c), REPRO_WG_F8(c, 48)
#define REPRO_WG_R64 REPRO_WG_R56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define REPRO_WG_O64(c) REPRO_WG_O56(c), REPRO_WG_F8(c, 56)
#define REPRO_WG_R72 REPRO_WG_R64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define REPRO_WG_O72(c) REPRO_WG_O64(c), REPRO_WG_F8(c, 64)
#define REPRO_WG_R80 REPRO_WG_R72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define REPRO_WG_O80(c) REPRO_WG_O72(c), REPRO_WG_F8(c, 72)
#define REPRO_WG_R88 REPRO_WG_R80 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define REPRO_WG_O88(c) REPRO_WG_O80(c), REPRO_WG_F8(c, 80)
#define REPRO_WG_R96 REPRO_WG_R88 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define REPRO_WG_O96(c) REPRO_WG_O88(c), REPRO_WG_F8(c, 88)
#define REPRO_WG_R104 REPRO_WG_R96 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define REPRO_WG_O104(c) REPRO_WG_O96(c), REPRO_WG_F8(c, 96)
#define REPRO_WG_R112 REPRO_WG_R104 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define REPRO_WG_O112(c) REPRO_WG_O104(c), REPRO_WG_F8(c, 104)
#define REPRO_WG_R120 REPRO_WG_R112 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define REPRO_WG_O120(c) REPRO_WG_O112(c), REPRO_WG_F8(c, 112)
#define REPRO_WG_R128 REPRO_WG_R120 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define REPRO_WG_O128(c) REPRO_WG_O120(c), REPRO_WG_F8(c, 120)

#define REPRO_WG_RW(x) "+f"(x)
#define REPRO_WG_W(x) "=f"(x)
#define REPRO_WG_SS(N, REGS, I0, I1, I2)                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #I2 ", 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "              \
  "{" REGS "}, %" #I0 ", %" #I1 ", p, 1, 1, 0, 0;\n}\n"
#define REPRO_WGMMA(N, REGS, OPS, I0, I1, I2, I3, I4, I5)                   \
  template <>                                                              \
  struct Wgmma<N> {                                                        \
    __device__ __forceinline__ static void ss(float (&d)[N / 2],           \
                                              uint64_t desc_a,             \
                                              uint64_t desc_b) {           \
      asm volatile(REPRO_WG_SS(N, REGS, I0, I1, I2)                         \
                   : OPS(REPRO_WG_RW) : "l"(desc_a), "l"(desc_b), "r"(1)); \
    }                                                                      \
    __device__ __forceinline__ static void ss_first(float (&d)[N / 2],     \
                                                    uint64_t desc_a,       \
                                                    uint64_t desc_b) {     \
      asm volatile(REPRO_WG_SS(N, REGS, I0, I1, I2)                         \
                   : OPS(REPRO_WG_W) : "l"(desc_a), "l"(desc_b), "r"(0));  \
    }                                                                      \
    __device__ __forceinline__ static void rs(float (&d)[N / 2],           \
                                              const uint32_t (&a)[4],      \
                                              uint64_t desc_b) {           \
      asm volatile(                                                        \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #I5 ", 0;\n"                \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "      \
          "{" REGS "}, {%" #I0 ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #I4    \
          ", p, 1, 1, 1;\n}\n"                                             \
          : OPS(REPRO_WG_RW) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), \
            "l"(desc_b), "r"(1));                                          \
    }                                                                      \
  };

REPRO_WGMMA(16, REPRO_WG_R8, REPRO_WG_O8, 8, 9, 10, 11, 12, 13)
REPRO_WGMMA(32, REPRO_WG_R16, REPRO_WG_O16, 16, 17, 18, 19, 20, 21)
REPRO_WGMMA(48, REPRO_WG_R24, REPRO_WG_O24, 24, 25, 26, 27, 28, 29)
REPRO_WGMMA(64, REPRO_WG_R32, REPRO_WG_O32, 32, 33, 34, 35, 36, 37)
REPRO_WGMMA(80, REPRO_WG_R40, REPRO_WG_O40, 40, 41, 42, 43, 44, 45)
REPRO_WGMMA(96, REPRO_WG_R48, REPRO_WG_O48, 48, 49, 50, 51, 52, 53)
REPRO_WGMMA(112, REPRO_WG_R56, REPRO_WG_O56, 56, 57, 58, 59, 60, 61)
REPRO_WGMMA(128, REPRO_WG_R64, REPRO_WG_O64, 64, 65, 66, 67, 68, 69)
REPRO_WGMMA(144, REPRO_WG_R72, REPRO_WG_O72, 72, 73, 74, 75, 76, 77)
REPRO_WGMMA(160, REPRO_WG_R80, REPRO_WG_O80, 80, 81, 82, 83, 84, 85)
REPRO_WGMMA(176, REPRO_WG_R88, REPRO_WG_O88, 88, 89, 90, 91, 92, 93)
REPRO_WGMMA(192, REPRO_WG_R96, REPRO_WG_O96, 96, 97, 98, 99, 100, 101)
REPRO_WGMMA(208, REPRO_WG_R104, REPRO_WG_O104, 104, 105, 106, 107, 108, 109)
REPRO_WGMMA(224, REPRO_WG_R112, REPRO_WG_O112, 112, 113, 114, 115, 116, 117)
REPRO_WGMMA(240, REPRO_WG_R120, REPRO_WG_O120, 120, 121, 122, 123, 124, 125)
REPRO_WGMMA(256, REPRO_WG_R128, REPRO_WG_O128, 128, 129, 130, 131, 132, 133)

#undef REPRO_WGMMA
#undef REPRO_WG_SS
#undef REPRO_WG_W
#undef REPRO_WG_RW
#undef REPRO_WG_F8

// ---- mma.sync on TF32 ---------------------------------------------------

// x rounded to TF32 (10 mantissa bits), ties away from zero, as a b32
// register holding the TF32 value (mma.sync's tf32 operand): the rounding
// of cvt.rna.tf32.f32, which ptxas compiles to these two integer
// operations behind a test for inf and NaN.  Here inf stays inf and a NaN
// stays a NaN or becomes inf; split_tf32's lo is then NaN, so a NaN input
// still gives a NaN product.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi): x to about 2^-22
// |x| in two TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 operands, f32 sums: a [16 x 8] row-major, b
// [8 x 8] column-major.  Lane (g, t) = (lane / 4, lane % 4) holds a0 (row
// g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, col
// g), b1 (t + 4, g); d0, d1 (row g, cols 2t, 2t + 1), d2, d3 (row g + 8,
// the same).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 from split operands (split_tf32): lo hi, hi lo, then
// hi hi, the small terms first.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// ---- mma.sync on bf16, ldmatrix ----------------------------------------

// Two floats rounded to bf16 (to nearest even) as one b32 register: lo in
// the low half, the operand element of the lower row or column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b, m16n8k16, bf16 operands, f32 sums: a [16 x 16] row-major, b
// [16 x 8] column-major, each register a pair of bf16 (pack_bf16).  Lane
// (g, t) = (lane / 4, lane % 4) holds a0 (row g, k 2t and 2t + 1), a1 (g
// + 8, the same), a2 (g, k 2t + 8 and 2t + 9), a3 (g + 8, the same); b0
// (k 2t and 2t + 1, col g), b1 (k 2t + 8 and 2t + 9, col g); d as
// mma_tf32's.  The accumulator fragment of two n8 tiles side by side,
// packed pair by pair, is the a fragment of their 16 columns.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 tiles of 16-bit elements from shared memory: lane l gives
// the address of row l % 8 of tile l / 8 (16 bytes, 16-byte aligned).
// Register i receives, of tile i, row l / 4 at columns 2 (l % 4) and
// 2 (l % 4) + 1; with .trans, column l / 4 at rows 2 (l % 4) and
// 2 (l % 4) + 1 (the lower row or column in the low half).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// ---- host: TMA descriptors ----------------------------------------------

// A contiguous tensor [outer, rows, cols] of `elem_bytes`-byte elements
// as a TMA map of boxes of box_cols x box_rows (x 1), with the given
// swizzle; elements past `cols`, `rows` or `outer` read as zero, and a
// store leaves them out.  Needs a 16-byte aligned base and a row pitch
// cols * elem_bytes that is a multiple of 16.  cuTensorMapEncodeTiled is
// reached through the runtime, so nothing links libcuda.
inline cudaError_t tma_map_3d(CUtensorMap* map, CUtensorMapDataType type,
                              int elem_bytes, const void* base, int cols,
                              int rows, int outer, int box_cols, int box_rows,
                              CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const cuuint64_t pitch = static_cast<cuuint64_t>(cols) * elem_bytes;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {pitch, pitch * rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A contiguous bf16 tensor [outer, rows, cols] as a TMA map of boxes of 64
// columns by `box_rows` rows with the 128-byte swizzle (the row pitch
// cols * 2 is a multiple of 16 for cols a multiple of 8).
inline cudaError_t tma_map_bf16_3d(CUtensorMap* map, const void* base,
                                   int cols, int rows, int outer,
                                   int box_rows) {
  return tma_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols,
                    rows, outer, 64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90
}  // namespace repro
