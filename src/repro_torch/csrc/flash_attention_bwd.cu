// flash_attention_bwd: the gradient of flash_attention, dQ, dK and dV from
// q, k, v, the forward's output O, its row log-sum-exp lse and dO.
//
// Replaces no TPU kernel.  The reference trains through chunked_attention,
// whose backward is XLA code (src/repro/models/attention.py:180-266,
// _chunked_attention_bwd, under the custom_vjp _flash_vjp at :269-285).
// The port's forward on the card is a hand-written kernel
// (flash_attention.cu), so its gradient comes from the card too, through a
// torch.autograd.Function (kernels/flash_attention/ops.py).
//
// Semantics, as _chunked_attention_bwd's: s = (q . k) * scale in f32; p =
// exp(s - lse), 0 where masked (key >= Skv, or key > q_offset + row when
// causal) and on a row with no valid key (lse = finfo(float32).min); dV =
// p^T dO with p rounded to v's type first; dP = dO V^T; delta = rowsum(dO
// * O) in f32 from O and dO in their own type; dS = p (dP - delta) * scale,
// rounded to q's type; dQ = dS K and dK = dS^T Q; every sum in f32, each
// result in its input's type.  Query head h reads kv head h / g, so dK and
// dV sum over the g query heads of their group.
//
// Bound: five products of 2 D flops per unmasked (query, key) pair and
// query head (S, dP, dV, dQ, dK) against (4 Sq + 4 Skv / g) D elements
// moved per query head: at internlm2's training shape (Sq = Skv = 512,
// D 128, g 2) about 210 flops per byte in bf16, near the H100's ridge of
// ~295 bf16 tensor-core flops per byte, so the tensor cores' rate bounds
// it; in float32, 3xTF32's rate (a third of 495 T op/s).  The two-kernel
// split below spends seven products (S and dP are computed in both
// kernels), 14 D flops per pair.
//
// Both types run two kernels, launched in order on one stream by one C
// call: a dQ kernel (query-major; it also computes delta and stores it)
// and a dK/dV kernel (key-major; it owns its keys and walks the query
// heads of its group, so dK and dV need no atomics and no second pass,
// and every sum runs in one fixed order: two calls on the same inputs
// give the same bits).
//
// bfloat16: mma.sync m16n8k16 (bf16 operands, f32 sums) on tiles that
// cp.async copies into shared memory (rows DN + 8 elements apart, so the
// eight rows of an ldmatrix tile fall on distinct banks), the next tile's
// copies in flight while the current one is computed.  A warp owns 16
// rows; P and dS never leave its registers: the accumulator fragments of
// S and dP become p and dS in place (p = 2^(s scale log2e - lse log2e),
// one FMA and one MUFU ex2 an element), and pairs of them, packed to bf16
// (the reference's rounding of p to v's type and of dS to q's), are the
// A fragments of the next product.  Both grids put the tiles of the most
// work (the long causal rows, the first keys) in blockIdx.y, which the
// card schedules slowest, so they start first.
// * flash_attention_bwd_dq_mma_kernel: one CTA of 4 warps per (b, query
//   head, 64 queries).  It copies its q and dO rows once, computes delta
//   (a warp per row of its 16), then walks the k/v tiles of 32 keys that
//   the causal mask leaves: S = Q K^T and dP = dO V^T (A from q and dO by
//   ldmatrix, B from the k and v rows as stored), dS in registers, dQ +=
//   dS K (K through ldmatrix.trans).
// * flash_attention_bwd_dkdv_mma_kernel<DN>: one CTA of 4 warps per
//   (b, kv head, tile of keys).  A warp holds 16 key rows by 32 queries
//   of S^T (64 up to DN 64) and its columns of dK and dV: all of them up
//   to DN 128, half at DN 192 and 256 (their dK and dV do not fit one
//   warp's registers, so two warps share 16 key rows by columns).  Two
//   warps share 16 key rows by the two halves of each q tile and add
//   their sums through shared memory at the end, so that the causal tail
//   (the first key tiles see every query) runs on twice the warps.  For
//   each query head of the group and each q tile that the causal mask
//   does not skip: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
//   registers from lse and delta per column, then dV += P^T dO and dK +=
//   dS^T Q with dO and Q through ldmatrix.trans.
// A warp whose 16 rows see no key (or query) of a tile skips its
// products; the barriers stay uniform.
//
// float32 (the train-check's, and every reduced config's): the same two
// kernels' shape on mma.sync m16n8k8 in 3xTF32, as the f32 forward
// (flash_attention.cu): each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (split_tf32, hopper.cuh) and each product is three mma.sync
// with f32 sums, small terms first (lo hi, hi lo, hi hi: mma_tf32x3), which
// keeps a product to about 2^-20.4 of |a b|; one TF32 product alone misses
// float32's checks.  All five products run so.  In f32 the roundings of p
// to v's type and of dS to q's are identities; p = exp(s scale - lse) by
// expf of one FMA.  ldmatrix.trans moves 16-bit elements and cannot
// transpose float32, so the tiles land raw by cp.async (rows DN + 4 floats
// apart, 4 mod 8: every fragment read, a row-major or a transposed one,
// falls on 32 distinct banks) and each operand is split as it is read:
// one raw tile per operand serves both of its layouts, where
// fragment-ordered hi/lo tiles would take 2x the raw tile for each layout
// (at DN 128 dQ holds 101 KB a CTA and dK/dV 202 KB; with every B tile
// pre-split, 194 KB and over 320 KB, past the 227 KB a CTA may hold).
// Only dK/dV's K and V, the same A operands for every q tile, are split
// once per CTA, into fragments laid out as a lane reads them (hi and lo,
// 16 bytes a lane each).  The accumulator
// fragments of S and dP (S^T and dP^T) become p and dS in registers and
// are the A operands of the next products as they stand: lane (g, t) holds
// columns 2t and 2t + 1 of each 8, taken as k-indices t and t + 4, and the
// B operand of that product reads its rows in the same order (tf_b_cols),
// so nothing is shuffled or written back.
// * flash_attention_bwd_dq_tf32x3_kernel: one CTA of 4 warps per (b,
//   query head, 32 queries, 64 from DN 192; the long causal rows first),
//   16 rows a warp: delta (a warp a row, a lane per 8 columns, FMA in
//   order, an xor butterfly), then for each k/v tile of 32 keys (16 from
//   DN 192) S and dP, dS in registers, dQ += dS K.  Up to DN 128 two warps
//   share 16 rows, each taking 16 keys of every tile, and add their dQ in
//   shared memory at the end: twice the CTAs of one warp a row group, two
//   or more on an SM (one warp alone on a scheduler stalls on its own mma
//   and load chains), and the longest causal tile half as long.
// * flash_attention_bwd_dkdv_tf32x3_kernel: one CTA per (b, kv head, tile
//   of keys), as the bf16 kernel, a warp holding 16 key rows by 16
//   queries of each q tile: up to DN 128, 8 warps, two key row groups
//   each split four ways by the queries of a 64-query tile; at DN 192 and
//   256, 4 warps, one key row group split two ways by queries and two by
//   the columns of dK and dV (their dK and dV do not fit one warp's
//   registers).  The query parts' sums meet in shared memory at the end,
//   added in order.
//
// DN is D rounded up to 16, 32, 64, 80, 96, 128, 192 or 256.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm = repro::sm90;

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr float kLog2e = 1.4426950408889634f;

// Is (query qi, key kj) unmasked, on a row whose lse says it has a key?
__device__ __forceinline__ bool valid(int qi, int kj, int sq, int skv,
                                      float lse, int q_offset, int causal) {
  return qi < sq && kj < skv && lse > 0.5f * kNegInf &&
         (!causal || kj <= qi + q_offset);
}

// ---- bfloat16: mma.sync ---------------------------------------------------

using bf16 = __nv_bfloat16;

// 2^x on the MUFU unit (ex2.approx; a subnormal result flushes to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DN>
struct MmaTile {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = DN + 8;        // row stride in elements
  // dQ kernel: 16 query rows a warp, k/v tiles of kBK keys.
  static constexpr int kQRows = 16 * kWarps;
  static constexpr int kBK = 32;
  static_assert(DN % 16 == 0, "tiles of 16 columns");
};

// dK/dV kernel: a warp holds 16 key rows by kWQ queries of S^T and kCols
// columns of dK and dV.  kCSplit warps share 16 key rows by columns (DN
// 192 and 256), two by the queries of a q tile (kBQ = 2 kWQ); the two
// partial sums of dK and dV meet in shared memory at the end.
template <int DN>
struct DkdvTile : MmaTile<DN> {
  static constexpr int kCSplit = DN <= 128 ? 1 : 2;
  static constexpr int kQSplit = 2;
  static constexpr int kKRows =
      16 * MmaTile<DN>::kWarps / (kCSplit * kQSplit);
  static constexpr int kCols = DN / kCSplit;
  static constexpr int kWQ = DN <= 64 ? 64 : 32;
  static constexpr int kBQ = kQSplit * kWQ;
  static_assert(kCols % 16 == 0, "tiles of 16 columns");
  static_assert(kKRows >= 16, "at least one 16-row key group");
};

// Rows [row0, row0 + R) of a row-major [n_rows, d] matrix of E (bf16 or
// float) into dst [R][DN + W] by cp.async, W = 16 / sizeof(E) elements (16
// bytes) a copy: zeros past n_rows and past d (a multiple of 8).
template <int R, int DN, int Threads, typename E>
__device__ __forceinline__ void copy_tile(E* dst, const E* src, int row0,
                                          int n_rows, int d) {
  constexpr int kW = 16 / sizeof(E);
  constexpr int kChunks = DN / kW;
  for (int i = threadIdx.x; i < R * kChunks; i += Threads) {
    const int r = i / kChunks, c = i % kChunks * kW;
    const bool in = row0 + r < n_rows && c < d;
    sm::cp_async<16>(dst + r * (DN + kW) + c,
                     in ? src + static_cast<long long>(row0 + r) * d + c : src,
                     in ? 16 : 0);
  }
}

// src[i0, i0 + R) into dst[R] by cp.async, zeros past n.
template <int R, int Threads>
__device__ __forceinline__ void copy_vec(float* dst, const float* src, int i0,
                                         int n) {
  for (int i = threadIdx.x; i < R; i += Threads) {
    const bool in = i0 + i < n;
    sm::cp_async<4>(dst + i, in ? src + i0 + i : src, in ? 4 : 0);
  }
}

// The A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile
// with row stride LD (ldmatrix: lane l gives row r0 + l % 16, column c0
// + l / 16 * 8).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  sm::ldmatrix_x4(a, tile + (r0 + lane % 16) * LD + c0 + lane / 16 * 8);
}

// The B fragments of two n8 tiles from a tile stored n-major ([n][k],
// rows n0 .. n0 + 15, columns k0 .. k0 + 15): b[0], b[1] for rows n0 ..
// n0 + 7, b[2], b[3] for the next 8.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int k0, int lane) {
  const int i = lane / 8;
  sm::ldmatrix_x4(b, tile + (n0 + i / 2 * 8 + lane % 8) * LD + k0 + i % 2 * 8);
}

// The B fragments of two n8 tiles from a tile stored k-major ([k][n],
// rows k0 .. k0 + 15, columns n0 .. n0 + 15), through ldmatrix.trans:
// b[0], b[1] for columns n0 .. n0 + 7, b[2], b[3] for the next 8.
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int k0, int n0,
                                             int lane) {
  const int i = lane / 8;
  sm::ldmatrix_x4_trans(b, tile + (k0 + i % 2 * 8 + lane % 8) * LD + n0 +
                               i / 2 * 8);
}

// The A fragment of the 16 columns [16 j, 16 j + 16) of accumulator tiles
// x[2 j] and x[2 j + 1], rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[N][4],
                                     int j) {
  a[0] = sm::pack_bf16(x[2 * j][0], x[2 * j][1]);
  a[1] = sm::pack_bf16(x[2 * j][2], x[2 * j][3]);
  a[2] = sm::pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
  a[3] = sm::pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
}

// Stores the accumulator tiles x[N] of rows r0 + g and r0 + g + 8,
// columns c0 + 8 n + 2t, + 1, as bf16 pairs into a row-major [rows, d]
// matrix: rows past n_rows and columns past d are left out.
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&x)[N][4],
                                           int r0, int c0, int n_rows, int d,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<long long>(r) *
                                                     d + c) =
            __floats2bfloat162_rn(x[n][2 * h], x[n][2 * h + 1]);
    }
  }
}

template <int DN>
__global__ void __launch_bounds__(MmaTile<DN>::kThreads)
    flash_attention_bwd_dq_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ out,
        const bf16* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ delta, bf16* __restrict__ dq, int hq, int hkv,
        int sq, int skv, int d, int q_offset, int causal, float scale) {
  using P = MmaTile<DN>;
  constexpr int LD = P::kLd, QR = P::kQRows, BK = P::kBK, T = P::kThreads;
  constexpr int NT = BK / 8, NK = DN / 16, ND = DN / 8;
  extern __shared__ float4 mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [QR][LD]
  bf16* dos = qs + QR * LD;                       // [QR][LD]
  bf16* ks = dos + QR * LD;                       // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                    // [2][BK][LD]
  float* deltas = reinterpret_cast<float*>(vs + 2 * BK * LD);  // [QR]

  // The long causal rows start first: blockIdx.y runs slowest.
  const int bh = blockIdx.x;
  const long long kvh = bh / hq * hkv + bh % hq / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long row_base = static_cast<long long>(bh) * sq;
  const bf16* kh = k + kvh * skv * d;
  const bf16* vh = v + kvh * skv * d;
  const int k_end = causal ? min(skv, q0 + QR + q_offset) : skv;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  copy_tile<QR, DN, T>(qs, q + row_base * d, q0, sq, d);
  copy_tile<QR, DN, T>(dos, dout + row_base * d, q0, sq, d);
  sm::cp_async_commit();
  if (n_tiles > 0) {
    copy_tile<BK, DN, T>(ks, kh, 0, skv, d);
    copy_tile<BK, DN, T>(vs, vh, 0, skv, d);
  }
  sm::cp_async_commit();
  sm::cp_async_wait<1>();  // q and dO have landed
  __syncthreads();

  // delta = rowsum(dO * O) of the warp's 16 rows: a lane per 8 columns.
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int qi = q0 + r, c = lane * 8;
    float acc = 0.0f;
    if (qi < sq && c < d) {
      const uint4 o = *reinterpret_cast<const uint4*>(out + (row_base + qi) *
                                                                d + c);
      const uint4 e = *reinterpret_cast<const uint4*>(dos + r * LD + c);
      const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&o);
      const __nv_bfloat162* eh = reinterpret_cast<const __nv_bfloat162*>(&e);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(oh[j]);
        const float2 ef = __bfloat1622float2(eh[j]);
        acc = fmaf(of.x, ef.x, acc);
        acc = fmaf(of.y, ef.y, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      deltas[r] = acc;
      if (qi < sq) delta[row_base + qi] = acc;
    }
  }
  __syncwarp();

  // This lane's rows q0 + warp * 16 + g and + 8: lse in log2 units,
  // delta, and whether the row has a key.
  const int qr = q0 + warp * 16 + g;
  float nl2[2], dl[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qr + 8 * h;
    const float l = qi < sq ? lse[row_base + qi] : kNegInf;
    row_ok[h] = qi < sq && l > 0.5f * kNegInf;
    nl2[h] = -l * kLog2e;
    dl[h] = deltas[warp * 16 + g + 8 * h];
  }
  const float sl2 = scale * kLog2e;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    sm::cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's readers are done
    if (j + 1 < n_tiles) {
      copy_tile<BK, DN, T>(ks + (j + 1) % 2 * BK * LD, kh, (j + 1) * BK, skv,
                           d);
      copy_tile<BK, DN, T>(vs + (j + 1) % 2 * BK * LD, vh, (j + 1) * BK, skv,
                           d);
    }
    sm::cp_async_commit();
    const int kt0 = j * BK;
    // No key of the tile is visible to the warp's rows.
    if (causal && kt0 > q0 + warp * 16 + 15 + q_offset) continue;
    const bf16* kt = ks + j % 2 * BK * LD;
    const bf16* vt = vs + j % 2 * BK * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t aq[4], ad[4];
      load_a<LD>(aq, qs, warp * 16, kk * 16, lane);
      load_a<LD>(ad, dos, warp * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bk[4], bv[4];
        load_b<LD>(bk, kt, n * 8, kk * 16, lane);
        load_b<LD>(bv, vt, n * 8, kk * 16, lane);
        sm::mma_bf16(s[n], aq, bk[0], bk[1]);
        sm::mma_bf16(s[n + 1], aq, bk[2], bk[3]);
        sm::mma_bf16(dp[n], ad, bv[0], bv[1]);
        sm::mma_bf16(dp[n + 1], ad, bv[2], bv[3]);
      }
    }

    // dS = p (dP - delta) scale in place of dP.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, qi = qr + 8 * h;
        const int kj = kt0 + n * 8 + 2 * t + e % 2;
        const bool ok =
            row_ok[h] && kj < skv && (!causal || kj <= qi + q_offset);
        const float p = ok ? ex2(fmaf(s[n][e], sl2, nl2[h])) : 0.0f;
        dp[n][e] = p * (dp[n][e] - dl[h]) * scale;
      }

#pragma unroll
    for (int kq = 0; kq < NT / 2; ++kq) {
      uint32_t a[4];
      to_a<NT>(a, dp, kq);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];
        load_b_trans<LD>(b, kt, kq * 16, n * 8, lane);
        sm::mma_bf16(acc[n], a, b[0], b[1]);
        sm::mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
  }
  store_rows<ND>(dq + row_base * d, acc, q0 + warp * 16, 0, sq, d, lane);
}

template <int DN>
__global__ void __launch_bounds__(MmaTile<DN>::kThreads)
    flash_attention_bwd_dkdv_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const bf16* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int hq, int hkv,
        int sq, int skv, int d, int q_offset, int causal, float scale) {
  using P = DkdvTile<DN>;
  constexpr int LD = P::kLd, KR = P::kKRows, BQ = P::kBQ, WQ = P::kWQ;
  constexpr int T = P::kThreads, CS = P::kCSplit, QS = P::kQSplit;
  constexpr int NT = WQ / 8, NK = DN / 16, NC = P::kCols / 8;
  extern __shared__ float4 mma_smem[];
  bf16* ks = reinterpret_cast<bf16*>(mma_smem);  // [KR][LD]
  bf16* vs = ks + KR * LD;                        // [KR][LD]
  bf16* qs = vs + KR * LD;                        // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                   // [2][BQ][LD]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* deltas = lses + 2 * BQ;                              // [2][BQ]

  // The key tiles of the most queries (the first, when causal) start
  // first: blockIdx.y runs slowest.
  const int bkv = blockIdx.x;
  const int b = bkv / hkv, grp = hq / hkv;
  const int k0 = blockIdx.y * KR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = warp / (CS * QS) * 16;       // the warp's key rows in the tile
  const int c0 = warp % CS * P::kCols;        // its columns of dK and dV
  const int wq = warp / CS % QS * WQ;         // its queries in a q tile
  const long long kv_base = static_cast<long long>(bkv) * skv;
  // Query rows before k0 - q_offset see none of this tile's keys.
  const int y_start = causal ? max(0, k0 - q_offset) / BQ * BQ : 0;
  const int n_q = y_start < sq ? (sq - y_start + BQ - 1) / BQ : 0;
  const int n_total = grp * n_q;

  const auto load = [&](int it) {
    const int stage = it % 2, y0 = y_start + it % n_q * BQ;
    const long long row_base =
        (static_cast<long long>(b) * hq + bkv % hkv * grp + it / n_q) * sq;
    copy_tile<BQ, DN, T>(qs + stage * BQ * LD, q + row_base * d, y0, sq, d);
    copy_tile<BQ, DN, T>(dos + stage * BQ * LD, dout + row_base * d, y0, sq,
                         d);
    copy_vec<BQ, T>(lses + stage * BQ, lse + row_base, y0, sq);
    copy_vec<BQ, T>(deltas + stage * BQ, delta + row_base, y0, sq);
  };
  copy_tile<KR, DN, T>(ks, k + kv_base * d, k0, skv, d);
  copy_tile<KR, DN, T>(vs, v + kv_base * d, k0, skv, d);
  if (n_total > 0) load(0);
  sm::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc_k[NC][4], acc_v[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  for (int it = 0; it < n_total; ++it) {
    sm::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1's readers are done
    if (it + 1 < n_total) load(it + 1);
    sm::cp_async_commit();
    const int y0 = y_start + it % n_q * BQ + wq;  // the warp's first query
    // No query of the warp's part of the tile sees its keys.
    if (causal && k0 + kw > y0 + WQ - 1 + q_offset) continue;
    const bf16* qt = qs + it % 2 * BQ * LD + wq * LD;
    const bf16* dt = dos + it % 2 * BQ * LD + wq * LD;
    const float* lt = lses + it % 2 * BQ + wq;
    const float* dlt = deltas + it % 2 * BQ + wq;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ak[4], av[4];
      load_a<LD>(ak, ks, kw, kk * 16, lane);
      load_a<LD>(av, vs, kw, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bq[4], bd[4];
        load_b<LD>(bq, qt, n * 8, kk * 16, lane);
        load_b<LD>(bd, dt, n * 8, kk * 16, lane);
        sm::mma_bf16(s[n], ak, bq[0], bq[1]);
        sm::mma_bf16(s[n + 1], ak, bq[2], bq[3]);
        sm::mma_bf16(dp[n], av, bd[0], bd[1]);
        sm::mma_bf16(dp[n + 1], av, bd[2], bd[3]);
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T: lse and delta per
    // column (query).
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int yl = n * 8 + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(lt + yl);
      const float2 dd = *reinterpret_cast<const float2*>(dlt + yl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float le = e % 2 ? l.y : l.x, de = e % 2 ? dd.y : dd.x;
        const int kj = k0 + kw + g + 8 * (e / 2);
        const float p =
            valid(y0 + yl + e % 2, kj, sq, skv, le, q_offset, causal)
                ? ex2(fmaf(s[n][e], sl2, -le * kLog2e))
                : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - de) * scale;
      }
    }

#pragma unroll
    for (int kq = 0; kq < NT / 2; ++kq) {
      uint32_t ap[4], ads[4];
      to_a<NT>(ap, s, kq);
      to_a<NT>(ads, dp, kq);
#pragma unroll
      for (int n = 0; n < NC; n += 2) {
        uint32_t bd[4], bq[4];
        load_b_trans<LD>(bd, dt, kq * 16, c0 + n * 8, lane);
        load_b_trans<LD>(bq, qt, kq * 16, c0 + n * 8, lane);
        sm::mma_bf16(acc_v[n], ap, bd[0], bd[1]);
        sm::mma_bf16(acc_v[n + 1], ap, bd[2], bd[3]);
        sm::mma_bf16(acc_k[n], ads, bq[0], bq[1]);
        sm::mma_bf16(acc_k[n + 1], ads, bq[2], bq[3]);
      }
    }
  }

  // The warps of the later queries hand their sums to those of the
  // first, through the q tiles' buffers, register by register (each
  // lane its own word): acc (first queries) + acc (later ones).
  static_assert(T / 32 / QS * 2 * NC * 4 * 32 * sizeof(float) <=
                    2 * 2 * BQ * LD * sizeof(bf16),
                "the partial sums fit the q tiles' buffers");
  float* part = reinterpret_cast<float*>(qs) +
                (warp / (CS * QS) * CS + warp % CS) * (2 * NC * 4 * 32);
  sm::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the q tiles
  if (wq != 0) {
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[((0 * NC + n) * 4 + e) * 32 + lane] = acc_k[n][e];
        part[((1 * NC + n) * 4 + e) * 32 + lane] = acc_v[n][e];
      }
  }
  __syncthreads();
  if (wq != 0) return;
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[n][e] += part[((0 * NC + n) * 4 + e) * 32 + lane];
      acc_v[n][e] += part[((1 * NC + n) * 4 + e) * 32 + lane];
    }
  store_rows<NC>(dk + kv_base * d, acc_k, k0 + kw, c0, skv, d, lane);
  store_rows<NC>(dv + kv_base * d, acc_v, k0 + kw, c0, skv, d, lane);
}

template <int DN>
cudaError_t launch_dkdv(const bf16* q, const bf16* k, const bf16* v,
                        const bf16* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int batch,
                        int hq, int hkv, int sq, int skv, int d, int q_offset,
                        int causal, float scale, cudaStream_t stream) {
  using P = DkdvTile<DN>;
  constexpr size_t kSmem = sizeof(bf16) * (2 * P::kKRows + 4 * P::kBQ) *
                               P::kLd + sizeof(float) * 4 * P::kBQ;
  static size_t allowed = 48 * 1024;
  const cudaError_t err = repro::allow_smem(
      flash_attention_bwd_dkdv_mma_kernel<DN>, kSmem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * hkv, (skv + P::kKRows - 1) / P::kKRows);
  flash_attention_bwd_dkdv_mma_kernel<DN>
      <<<grid, P::kThreads, kSmem, stream>>>(
          q, k, v, dout, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), hq, hkv, sq, skv, d, q_offset, causal,
          scale);
  return cudaGetLastError();
}

template <int DN>
int launch_mma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int batch, int hq, int hkv, int sq,
               int skv, int d, int q_offset, int causal, float scale,
               cudaStream_t stream) {
  using P = MmaTile<DN>;
  constexpr size_t kDqSmem = sizeof(bf16) * (2 * P::kQRows + 4 * P::kBK) *
                                 P::kLd + sizeof(float) * P::kQRows;
  static size_t dq_allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(flash_attention_bwd_dq_mma_kernel<DN>,
                                      kDqSmem, dq_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  if (sq > 0) {
    const dim3 grid(batch * hq, (sq + P::kQRows - 1) / P::kQRows);
    flash_attention_bwd_dq_mma_kernel<DN>
        <<<grid, P::kThreads, kDqSmem, stream>>>(
            qt, kt, vt, static_cast<const bf16*>(out), dot, lse, delta,
            static_cast<bf16*>(dq), hq, hkv, sq, skv, d, q_offset, causal,
            scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (skv > 0)
    err = launch_dkdv<DN>(qt, kt, vt, dot, lse, delta, dk, dv, batch, hq,
                          hkv, sq, skv, d, q_offset, causal, scale, stream);
  return static_cast<int>(err);
}

// ---- float32: 3xTF32 on mma.sync ------------------------------------------

// The float32 tiles: raw rows DN + 4 floats apart (4 mod 8), so that every
// fragment read below (a lane's element at row g, 8 + g or 2t + i, column
// t, t + 4 or g of an 8 x 8 block) falls on 32 distinct banks; each operand
// is split into TF32 hi and lo as it is read.
// dQ kernel: 16 query rows a warp, k/v tiles of kBK keys, 4 warps.  Up to
// DN 128 two warps share 16 rows, each taking half of every tile's keys
// (kWK), and add their sums of dQ through shared memory at the end, so a
// CTA holds 32 rows: twice the CTAs of 64 rows, two or more resident on
// an SM, and the longest causal row tile half as long.  From DN 192 a
// warp takes all the keys of its 16 rows, and a CTA holds 64.
template <int DN>
struct Tf3Dq {
  static constexpr int kKSplit = DN <= 128 ? 2 : 1;
  static constexpr int kRowGroups = 4 / kKSplit;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = DN + 4;
  static constexpr int kQRows = 16 * kRowGroups;
  static constexpr int kBK = DN <= 128 ? 32 : 16;
  static constexpr int kWK = kBK / kKSplit;
  static constexpr size_t kSmem =
      sizeof(float) * ((2 * kQRows + 4 * kBK) * kLd + kQRows);
  static_assert(4 * kBK * kLd >= (kKSplit - 1) * kRowGroups * DN / 8 * 128,
                "the partial sums fit the k/v tiles' buffers");
};

// dK/dV kernel: as DkdvTile, a warp holding 16 key rows by kWQ queries of
// each q tile: up to DN 128, 8 warps, two key row groups each split four
// ways by the queries of a q tile; from DN 192, 4 warps, one key row group
// split two ways by queries and two by the columns of dK and dV.  The
// query splits' partial sums of dK and dV meet in shared memory at the
// end, added in order.
template <int DN>
struct Tf3Dkdv {
  static constexpr int kCSplit = DN <= 128 ? 1 : 2;
  static constexpr int kQSplit = DN <= 128 ? 4 : 2;
  static constexpr int kWarps = DN <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLd = DN + 4;
  static constexpr int kKRows = 16 * kWarps / (kCSplit * kQSplit);
  static constexpr int kCols = DN / kCSplit;
  static constexpr int kWQ = 16;
  static constexpr int kBQ = kQSplit * kWQ;
  // K's and V's A fragments (hi and lo, 8 bytes an element each), then
  // the q tiles raw.
  static constexpr size_t kSmem =
      16 * kKRows * DN + sizeof(float) * (4 * kBQ * kLd + 4 * kBQ);
  static_assert(kCols % 8 == 0, "tiles of 8 columns");
};

// The TF32 hi and lo parts (sm::split_tf32) of a fragment's N registers.
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

// The A fragment of rows r0 + g and r0 + g + 8 of a raw tile, k-indices t
// and t + 4 at columns c0 + t and c0 + t + 4.
template <int LD>
__device__ __forceinline__ Split<4> tf_a(const float* tile, int r0, int c0,
                                         int g, int t) {
  const float* p = tile + (r0 + g) * LD + c0 + t;
  Split<4> a;
  sm::split_tf32(p[0], a.hi[0], a.lo[0]);
  sm::split_tf32(p[8 * LD], a.hi[1], a.lo[1]);
  sm::split_tf32(p[4], a.hi[2], a.lo[2]);
  sm::split_tf32(p[8 * LD + 4], a.hi[3], a.lo[3]);
  return a;
}

// The A fragment of rows r0 + g and r0 + g + 8 of a row-major [n_rows, d]
// matrix in device memory, k-indices t and t + 4 at columns 8 kk + t and
// 8 kk + t + 4 (zeros past n_rows and d), split once into frag[kk]: hi
// and lo, 16 bytes a lane each, in the order a lane reads them.
__device__ __forceinline__ void split_a_rows(uint4* frag, const float* src,
                                             int r0, int n_rows, int d,
                                             int kk, int lane) {
  const int g = lane / 4, t = lane % 4;
  Split<4> a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + g + 8 * (i % 2), c = 8 * kk + t + 4 * (i / 2);
    const float x =
        r < n_rows && c < d ? src[static_cast<long long>(r) * d + c] : 0.0f;
    sm::split_tf32(x, a.hi[i], a.lo[i]);
  }
  frag[(kk * 2) * 32 + lane] = make_uint4(a.hi[0], a.hi[1], a.hi[2], a.hi[3]);
  frag[(kk * 2 + 1) * 32 + lane] =
      make_uint4(a.lo[0], a.lo[1], a.lo[2], a.lo[3]);
}

// The A fragment split_a_rows stored for k-step kk.
__device__ __forceinline__ Split<4> tf_a_frag(const uint4* frag, int kk,
                                              int lane) {
  const uint4 h = frag[(kk * 2) * 32 + lane];
  const uint4 l = frag[(kk * 2 + 1) * 32 + lane];
  return {{h.x, h.y, h.z, h.w}, {l.x, l.y, l.z, l.w}};
}

// The B fragment of the tile transposed: n-index g is row n0 + g, k-indices
// t and t + 4 are columns c0 + t and c0 + t + 4.
template <int LD>
__device__ __forceinline__ Split<2> tf_b_rows(const float* tile, int n0,
                                              int c0, int g, int t) {
  const float* p = tile + (n0 + g) * LD + c0 + t;
  Split<2> b;
  sm::split_tf32(p[0], b.hi[0], b.lo[0]);
  sm::split_tf32(p[4], b.hi[1], b.lo[1]);
  return b;
}

// The B fragment of the tile as it stands, rows in the accumulator's
// order: k-indices t and t + 4 are rows k0 + 2t and k0 + 2t + 1, n-index g
// is column c0 + g.
template <int LD>
__device__ __forceinline__ Split<2> tf_b_cols(const float* tile, int k0,
                                              int c0, int g, int t) {
  const float* p = tile + (k0 + 2 * t) * LD + c0 + g;
  Split<2> b;
  sm::split_tf32(p[0], b.hi[0], b.lo[0]);
  sm::split_tf32(p[LD], b.hi[1], b.lo[1]);
  return b;
}

// The accumulator tile x (rows g and g + 8, columns 2t and 2t + 1) as the A
// fragment of the next product, columns 2t and 2t + 1 as k-indices t and
// t + 4: no shuffle.
__device__ __forceinline__ Split<4> tf_acc_a(const float (&x)[4]) {
  Split<4> a;
  sm::split_tf32(x[0], a.hi[0], a.lo[0]);
  sm::split_tf32(x[2], a.hi[1], a.lo[1]);
  sm::split_tf32(x[1], a.hi[2], a.lo[2]);
  sm::split_tf32(x[3], a.hi[3], a.lo[3]);
  return a;
}

__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a,
                                     const Split<2>& b) {
  sm::mma_tf32x3(d, a.hi, a.lo, b.hi, b.lo);
}

// store_rows of float32 accumulators, as float2 pairs.
template <int N>
__device__ __forceinline__ void store_rows(float* dst, const float (&x)[N][4],
                                           int r0, int c0, int n_rows, int d,
                                           int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (c < d)
        *reinterpret_cast<float2*>(dst + static_cast<long long>(r) * d + c) =
            make_float2(x[n][2 * h], x[n][2 * h + 1]);
    }
  }
}

// One CTA an SM as the bound ptxas plans registers for: left to its
// default it held dq<192> to 168 registers and spilled.
template <int DN>
__global__ void __launch_bounds__(Tf3Dq<DN>::kThreads, 1)
    flash_attention_bwd_dq_tf32x3_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ out,
        const float* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ delta, float* __restrict__ dq, int hq, int hkv,
        int sq, int skv, int d, int q_offset, int causal, float scale) {
  using P = Tf3Dq<DN>;
  constexpr int LD = P::kLd, QR = P::kQRows, BK = P::kBK, T = P::kThreads;
  constexpr int WK = P::kWK, NT = WK / 8, NK = DN / 8;
  extern __shared__ float4 tf3_smem[];
  float* qs = reinterpret_cast<float*>(tf3_smem);  // [QR][LD]
  float* dos = qs + QR * LD;                        // [QR][LD]
  float* ks = dos + QR * LD;                        // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;                     // [2][BK][LD]
  float* deltas = vs + 2 * BK * LD;                 // [QR]

  // The long causal rows start first: blockIdx.y runs slowest.
  const int bh = blockIdx.x;
  const long long kvh = bh / hq * hkv + bh % hq / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // The warp's first row and its first key in a k/v tile.
  const int w0 = (P::kKSplit > 1 ? warp % P::kRowGroups : warp) * 16;
  const int wk = P::kKSplit > 1 ? warp / P::kRowGroups * WK : 0;
  const long long row_base = static_cast<long long>(bh) * sq;
  const float* kh = k + kvh * skv * d;
  const float* vh = v + kvh * skv * d;
  const int k_end = causal ? min(skv, q0 + QR + q_offset) : skv;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  copy_tile<QR, DN, T>(qs, q + row_base * d, q0, sq, d);
  copy_tile<QR, DN, T>(dos, dout + row_base * d, q0, sq, d);
  sm::cp_async_commit();
  if (n_tiles > 0) {
    copy_tile<BK, DN, T>(ks, kh, 0, skv, d);
    copy_tile<BK, DN, T>(vs, vh, 0, skv, d);
  }
  sm::cp_async_commit();
  sm::cp_async_wait<1>();  // q and dO have landed
  __syncthreads();

  // delta = rowsum(dO * O), a warp per row: a lane per 8 columns, one FMA
  // each in column order, then the lanes by an xor butterfly.
  for (int r = warp; r < QR; r += P::kWarps) {
    const int qi = q0 + r, c = lane * 8;
    float acc = 0.0f;
    if (qi < sq && c < d) {
      const float4* o =
          reinterpret_cast<const float4*>(out + (row_base + qi) * d + c);
      const float4* e = reinterpret_cast<const float4*>(dos + r * LD + c);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 x = o[j], y = e[j];
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      deltas[r] = acc;
      if (qi < sq) delta[row_base + qi] = acc;
    }
  }
  __syncthreads();

  // This lane's rows q0 + w0 + g and + 8: -lse, delta, and whether the
  // row has a key.
  const int qr = q0 + w0 + g;
  float nl[2], dl[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qr + 8 * h;
    const float l = qi < sq ? lse[row_base + qi] : kNegInf;
    row_ok[h] = qi < sq && l > 0.5f * kNegInf;
    nl[h] = -l;
    dl[h] = deltas[w0 + g + 8 * h];
  }

  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    sm::cp_async_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's readers are done
    if (j + 1 < n_tiles) {
      copy_tile<BK, DN, T>(ks + (j + 1) % 2 * BK * LD, kh, (j + 1) * BK, skv,
                           d);
      copy_tile<BK, DN, T>(vs + (j + 1) % 2 * BK * LD, vh, (j + 1) * BK, skv,
                           d);
    }
    sm::cp_async_commit();
    const int kt0 = j * BK + wk;  // the warp's first key
    // The warp's rows lie past Sq, or see none of its keys.
    if (q0 + w0 >= sq || (causal && kt0 > q0 + w0 + 15 + q_offset)) continue;
    const float* kt = ks + j % 2 * BK * LD;
    const float* vt = vs + j % 2 * BK * LD;

    // S = Q K^T and dP = dO V^T, D in k8 steps.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const Split<4> aq = tf_a<LD>(qs, w0, kk * 8, g, t);
      const Split<4> ad = tf_a<LD>(dos, w0, kk * 8, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(s[n], aq, tf_b_rows<LD>(kt, wk + n * 8, kk * 8, g, t));
        mma3(dp[n], ad, tf_b_rows<LD>(vt, wk + n * 8, kk * 8, g, t));
      }
    }

    // dS = p (dP - delta) scale in place of dP, p = exp(s scale - lse).
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, qi = qr + 8 * h;
        const int kj = kt0 + n * 8 + 2 * t + e % 2;
        const bool ok =
            row_ok[h] && kj < skv && (!causal || kj <= qi + q_offset);
        const float p = ok ? expf(fmaf(s[n][e], scale, nl[h])) : 0.0f;
        dp[n][e] = p * (dp[n][e] - dl[h]) * scale;
      }

    // dQ += dS K, the keys in k8 steps: dS's fragment as it stands.
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      const Split<4> a = tf_acc_a(dp[kc]);
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mma3(acc[n], a, tf_b_cols<LD>(kt, wk + kc * 8, n * 8, g, t));
    }
  }

  if constexpr (P::kKSplit > 1) {
    // The warps of the later keys hand their sums to those of the first,
    // through the k/v tiles' buffers, register by register (each lane its
    // own word).
    float* part = ks + warp % P::kRowGroups * (NK * 4 * 32);
    sm::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the k/v tiles
    if (wk != 0) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(n * 4 + e) * 32 + lane] = acc[n][e];
    }
    __syncthreads();
    if (wk != 0) return;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[(n * 4 + e) * 32 + lane];
  }
  store_rows<NK>(dq + row_base * d, acc, q0 + w0, 0, sq, d, lane);
}

template <int DN>
__global__ void __launch_bounds__(Tf3Dkdv<DN>::kThreads)
    flash_attention_bwd_dkdv_tf32x3_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
        int sq, int skv, int d, int q_offset, int causal, float scale) {
  using P = Tf3Dkdv<DN>;
  constexpr int LD = P::kLd, KR = P::kKRows, BQ = P::kBQ, WQ = P::kWQ;
  constexpr int T = P::kThreads, CS = P::kCSplit, QS = P::kQSplit;
  constexpr int NT = WQ / 8, NK = DN / 8, NC = P::kCols / 8;
  constexpr int kFrags = KR / 16 * NK * 2 * 32;  // a matrix's A fragments
  extern __shared__ float4 tf3_smem[];
  uint4* kf = reinterpret_cast<uint4*>(tf3_smem);  // [KR / 16][NK][2][32]
  uint4* vf = kf + kFrags;                          // [KR / 16][NK][2][32]
  float* qs = reinterpret_cast<float*>(vf + kFrags);  // [2][BQ][LD]
  float* dos = qs + 2 * BQ * LD;                      // [2][BQ][LD]
  float* lses = dos + 2 * BQ * LD;                  // [2][BQ]
  float* deltas = lses + 2 * BQ;                    // [2][BQ]

  // The key tiles of the most queries (the first, when causal) start
  // first: blockIdx.y runs slowest.
  const int bkv = blockIdx.x;
  const int b = bkv / hkv, grp = hq / hkv;
  const int k0 = blockIdx.y * KR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = warp / (CS * QS) * 16;       // the warp's key rows in the tile
  const int c0 = warp % CS * P::kCols;        // its columns of dK and dV
  const int qj = warp / CS % QS;              // its part of a q tile,
  const int wq = qj * WQ;                     // whose first query
  const long long kv_base = static_cast<long long>(bkv) * skv;
  // Query rows before k0 - q_offset see none of this tile's keys.
  const int y_start = causal ? max(0, k0 - q_offset) / BQ * BQ : 0;
  const int n_q = y_start < sq ? (sq - y_start + BQ - 1) / BQ : 0;
  const int n_total = grp * n_q;

  const auto load = [&](int it) {
    const int stage = it % 2, y0 = y_start + it % n_q * BQ;
    const long long row_base =
        (static_cast<long long>(b) * hq + bkv % hkv * grp + it / n_q) * sq;
    copy_tile<BQ, DN, T>(qs + stage * BQ * LD, q + row_base * d, y0, sq, d);
    copy_tile<BQ, DN, T>(dos + stage * BQ * LD, dout + row_base * d, y0, sq,
                         d);
    copy_vec<BQ, T>(lses + stage * BQ, lse + row_base, y0, sq);
    copy_vec<BQ, T>(deltas + stage * BQ, delta + row_base, y0, sq);
  };
  if (n_total > 0) load(0);
  sm::cp_async_commit();
  // K's and V's rows, the A operands of every q tile, split once into
  // fragments: the warps of a key row group take its k-steps in turn.
  uint4* kfw = kf + kw / 16 * NK * 2 * 32;
  uint4* vfw = vf + kw / 16 * NK * 2 * 32;
  for (int kk = warp % (CS * QS); kk < NK; kk += CS * QS) {
    split_a_rows(kfw, k + kv_base * d, k0 + kw, skv, d, kk, lane);
    split_a_rows(vfw, v + kv_base * d, k0 + kw, skv, d, kk, lane);
  }

  float acc_k[NC][4], acc_v[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  for (int it = 0; it < n_total; ++it) {
    sm::cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1's readers are done
    if (it + 1 < n_total) load(it + 1);
    sm::cp_async_commit();
    const int y0 = y_start + it % n_q * BQ + wq;  // the warp's first query
    // The warp's keys lie past Skv, its queries past Sq, or none of its
    // queries sees its keys.
    if (k0 + kw >= skv || y0 >= sq ||
        (causal && k0 + kw > y0 + WQ - 1 + q_offset))
      continue;
    const float* qt = qs + it % 2 * BQ * LD + wq * LD;
    const float* dt = dos + it % 2 * BQ * LD + wq * LD;
    const float* lt = lses + it % 2 * BQ + wq;
    const float* dlt = deltas + it % 2 * BQ + wq;

    // S^T = K Q^T and dP^T = V dO^T, D in k8 steps.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const Split<4> ak = tf_a_frag(kfw, kk, lane);
      const Split<4> av = tf_a_frag(vfw, kk, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma3(s[n], ak, tf_b_rows<LD>(qt, n * 8, kk * 8, g, t));
        mma3(dp[n], av, tf_b_rows<LD>(dt, n * 8, kk * 8, g, t));
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T: lse and delta per
    // column (query).
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int yl = n * 8 + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(lt + yl);
      const float2 dd = *reinterpret_cast<const float2*>(dlt + yl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float le = e % 2 ? l.y : l.x, de = e % 2 ? dd.y : dd.x;
        const int kj = k0 + kw + g + 8 * (e / 2);
        const float p =
            valid(y0 + yl + e % 2, kj, sq, skv, le, q_offset, causal)
                ? expf(fmaf(s[n][e], scale, -le))
                : 0.0f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - de) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, the queries in k8 steps: the two
    // fragments as they stand.
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      const Split<4> ap = tf_acc_a(s[kc]);
      const Split<4> ads = tf_acc_a(dp[kc]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        mma3(acc_v[n], ap, tf_b_cols<LD>(dt, kc * 8, c0 + n * 8, g, t));
        mma3(acc_k[n], ads, tf_b_cols<LD>(qt, kc * 8, c0 + n * 8, g, t));
      }
    }
  }

  // The warps of the later queries hand their sums to those of the
  // first, through the q tiles' buffers, register by register (each
  // lane its own word): acc (part 0) + acc (part 1) + ..., in order.
  constexpr int kPart = 2 * NC * 4 * 32;
  static_assert(T / 32 / QS * (QS - 1) * kPart <= 2 * 2 * BQ * LD,
                "the partial sums fit the q tiles' buffers");
  float* part = qs + (warp / (CS * QS) * CS + warp % CS) * (QS - 1) * kPart;
  sm::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the q tiles
  if (qj != 0) {
    float* mine = part + (qj - 1) * kPart;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[((0 * NC + n) * 4 + e) * 32 + lane] = acc_k[n][e];
        mine[((1 * NC + n) * 4 + e) * 32 + lane] = acc_v[n][e];
      }
  }
  __syncthreads();
  if (qj != 0) return;
  for (int j = 0; j < QS - 1; ++j)
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_k[n][e] += part[j * kPart + ((0 * NC + n) * 4 + e) * 32 + lane];
        acc_v[n][e] += part[j * kPart + ((1 * NC + n) * 4 + e) * 32 + lane];
      }
  store_rows<NC>(dk + kv_base * d, acc_k, k0 + kw, c0, skv, d, lane);
  store_rows<NC>(dv + kv_base * d, acc_v, k0 + kw, c0, skv, d, lane);
}

template <int DN>
int launch_tf32x3(const void* q, const void* k, const void* v,
                  const void* out, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, int batch,
                  int hq, int hkv, int sq, int skv, int d, int q_offset,
                  int causal, float scale, cudaStream_t stream) {
  using Q = Tf3Dq<DN>;
  using P = Tf3Dkdv<DN>;
  static size_t dq_allowed = 48 * 1024, dkv_allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(
      flash_attention_bwd_dq_tf32x3_kernel<DN>, Q::kSmem, dq_allowed);
  if (err == cudaSuccess)
    err = repro::allow_smem(flash_attention_bwd_dkdv_tf32x3_kernel<DN>,
                            P::kSmem, dkv_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  if (sq > 0) {
    const dim3 grid(batch * hq, (sq + Q::kQRows - 1) / Q::kQRows);
    flash_attention_bwd_dq_tf32x3_kernel<DN>
        <<<grid, Q::kThreads, Q::kSmem, stream>>>(
            qt, kt, vt, static_cast<const float*>(out), dot, lse, delta,
            static_cast<float*>(dq), hq, hkv, sq, skv, d, q_offset, causal,
            scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (skv > 0) {
    const dim3 grid(batch * hkv, (skv + P::kKRows - 1) / P::kKRows);
    flash_attention_bwd_dkdv_tf32x3_kernel<DN>
        <<<grid, P::kThreads, P::kSmem, stream>>>(
            qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
            static_cast<float*>(dv), hq, hkv, sq, skv, d, q_offset, causal,
            scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out, dout and dq [batch, hq, sq, d]; k, v, dk and dv [batch, hkv, skv,
// d]; all contiguous and 16-byte aligned, of one type: dtype 0 = float32
// (3xTF32 on mma.sync), 1 = bfloat16 (mma.sync).  lse [batch, hq, sq]
// float32 from flash_attention_launch; delta [batch, hq, sq] float32
// scratch (written by the first kernel, read by the second).  hq a
// multiple of hkv; d a multiple of 8, at most 256.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int sq, int skv, int d,
    int q_offset, int causal, float scale, int dtype, void* stream) {
  if (batch == 0 || hq == 0 || d == 0) return 0;
  if (d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
#define REPRO_FLASH_BWD_ARGS                                                  \
  q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, batch, hq, hkv, sq, skv, d, \
      q_offset, causal, scale, s
#define REPRO_FLASH_BWD_CASE(N)                                               \
  if (d <= N)                                                                 \
    return dtype == 1 ? launch_mma<N>(REPRO_FLASH_BWD_ARGS)                   \
                      : launch_tf32x3<N>(REPRO_FLASH_BWD_ARGS);
  REPRO_FLASH_BWD_CASE(16)
  REPRO_FLASH_BWD_CASE(32)
  REPRO_FLASH_BWD_CASE(64)
  REPRO_FLASH_BWD_CASE(80)
  REPRO_FLASH_BWD_CASE(96)
  REPRO_FLASH_BWD_CASE(128)
  REPRO_FLASH_BWD_CASE(192)
  REPRO_FLASH_BWD_CASE(256)
#undef REPRO_FLASH_BWD_CASE
#undef REPRO_FLASH_BWD_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
