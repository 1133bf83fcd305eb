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
// it.  The two-kernel split below spends seven products (S and dP are
// computed in both kernels), 14 D flops per pair.
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
// float32 (the train-check's, exact f32 like the 3xTF32 forward): the
// first kernel pair, f32 FMA on CUDA cores from float32 tiles in shared
// memory (zero past D, Sq and Skv).
// * flash_attention_bwd_dq_fma_kernel: one CTA per (b, query head, tile
//   of BX queries; the long causal rows first): delta, then for each k/v
//   tile of BY keys S and dP, dS into shared memory, dQ += dS K.
// * flash_attention_bwd_dkdv_fma_kernel: one CTA per (b, kv head, tile of
//   BX keys): for each query head of the group and each q tile of BY
//   queries, S and dP, p and dS into shared memory, dV += p^T dO and dK
//   += dS^T Q in registers.
// For S and dP a thread owns one x (a key, or a query) and BY / (256 /
// BX) of the tile's y rows: its x row is read as float4 from a tile whose
// row stride DN + 4 spreads a quarter-warp over all 32 banks, and the y
// rows are the same for the whole warp (broadcast).  For the
// accumulation a thread owns BX / 16 consecutive rows x and DN / 16
// columns c strided by 16.  BX = 64 up to DN 128, else 32; BY = 32.
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

// Rows [row0, row0 + R) of a row-major bf16 [n_rows, d] matrix into dst
// [R][DN + 8] by cp.async, 16 bytes a copy: zeros past n_rows and past d
// (a multiple of 8).
template <int R, int DN, int Threads>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          int row0, int n_rows, int d) {
  constexpr int kChunks = DN / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += Threads) {
    const int r = i / kChunks, c = i % kChunks * 8;
    const bool in = row0 + r < n_rows && c < d;
    sm::cp_async<16>(dst + r * (DN + 8) + c,
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

// ---- float32: FMA on CUDA cores -------------------------------------------

constexpr int kFmaThreads = 256;

template <int DN>
struct FmaTile {
  static constexpr int kBX = DN <= 128 ? 64 : 32;  // rows a CTA owns
  static constexpr int kBY = 32;                   // rows of a loop tile
  static constexpr int kLd = DN + 4;               // row stride in floats
  static constexpr int kRY = kBY / (kFmaThreads / kBX);  // y rows a thread
  static constexpr int kRX = kBX / 16;             // x rows a thread
  static constexpr int kCols = DN / 16;            // columns a thread
};

// Rows [row0, row0 + R) of a row-major float32 [n_rows, d] matrix into
// dst [R][DN + 4]: zeros past n_rows and past d (a multiple of 8).
template <int R, int DN>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n_rows, int d) {
  constexpr int kChunks = DN / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kFmaThreads) {
    const int r = i / kChunks, c = i % kChunks * 8;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (row0 + r < n_rows && c < d) {
      const float* p = src + static_cast<long long>(row0 + r) * d + c;
      a = *reinterpret_cast<const float4*>(p);
      b = *reinterpret_cast<const float4*>(p + 4);
    }
    float* o = dst + r * (DN + 4) + c;
    *reinterpret_cast<float4*>(o) = a;
    *reinterpret_cast<float4*>(o + 4) = b;
  }
}

__device__ __forceinline__ float dot4(float acc, const float4 a,
                                      const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// s[r] = xa . yb[r] and dp[r] = xc . yd[r] over DN columns: xa and xc are
// this thread's x rows, yb and yd the first of its RY y rows (stride DN +
// 4, the same for the whole warp).
template <int DN, int RY>
__device__ __forceinline__ void dots(const float* xa, const float* xc,
                                     const float* yb, const float* yd,
                                     float (&s)[RY], float (&dp)[RY]) {
#pragma unroll
  for (int r = 0; r < RY; ++r) s[r] = dp[r] = 0.0f;
#pragma unroll 2
  for (int c = 0; c < DN; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(xa + c);
    const float4 e = *reinterpret_cast<const float4*>(xc + c);
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      s[r] = dot4(s[r], a,
                  *reinterpret_cast<const float4*>(yb + r * (DN + 4) + c));
      dp[r] = dot4(dp[r], e,
                   *reinterpret_cast<const float4*>(yd + r * (DN + 4) + c));
    }
  }
}

// RX consecutive floats of a shared row (RX 4: 16-byte aligned; RX 2: 8).
template <int RX>
__device__ __forceinline__ void load_rx(const float* p, float (&w)[RX]) {
  if constexpr (RX == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    w[0] = x.x, w[1] = x.y;
  }
}

template <int DN>
__global__ void __launch_bounds__(kFmaThreads, 1)
    flash_attention_bwd_dq_fma_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ out,
        const float* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ delta, float* __restrict__ dq, int hq, int hkv,
        int sq, int skv, int d, int q_offset, int causal, float scale) {
  using B = FmaTile<DN>;
  constexpr int BX = B::kBX, BY = B::kBY, LD = B::kLd, RY = B::kRY;
  constexpr int RX = B::kRX, NC = B::kCols;
  extern __shared__ float4 bwd_smem[];
  float* qs = reinterpret_cast<float*>(bwd_smem);  // [BX][LD]
  float* dos = qs + BX * LD;                        // [BX][LD]
  float* ks = dos + BX * LD;                        // [BY][LD]
  float* vs = ks + BY * LD;                         // [BY][LD]
  float* dss = vs + BY * LD;                        // [BY][BX], dS transposed
  float* lses = dss + BY * BX;                      // [BX]
  float* deltas = lses + BX;                        // [BX]

  const int bh = blockIdx.y;
  const long long kvh = bh / hq * hkv + bh % hq / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BX;
  const int tid = threadIdx.x;
  const long long row_base = static_cast<long long>(bh) * sq;
  load_tile<BX, DN>(qs, q + row_base * d, q0, sq, d);
  load_tile<BX, DN>(dos, dout + row_base * d, q0, sq, d);
  __syncthreads();

  // delta = rowsum(dO * O) and lse of the tile's rows: a warp per row, a
  // lane per 8 columns.
  for (int r = tid / 32; r < BX; r += kFmaThreads / 32) {
    const int qi = q0 + r, c = tid % 32 * 8;
    float acc = 0.0f;
    if (qi < sq && c < d) {
      const float* o = out + (row_base + qi) * d + c;
      const float* g = dos + r * LD + c;
      acc = dot4(dot4(0.0f, *reinterpret_cast<const float4*>(o),
                      *reinterpret_cast<const float4*>(g)),
                 *reinterpret_cast<const float4*>(o + 4),
                 *reinterpret_cast<const float4*>(g + 4));
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (tid % 32 == 0) {
      deltas[r] = acc;
      lses[r] = qi < sq ? lse[row_base + qi] : kNegInf;
      if (qi < sq) delta[row_base + qi] = acc;
    }
  }

  const int k_end = causal ? min(skv, q0 + BX + q_offset) : skv;
  const int n_tiles = k_end > 0 ? (k_end + BY - 1) / BY : 0;
  const int x = tid % BX, y_first = tid / BX * RY;  // S and dP roles
  const int ax = tid / 16 * RX, ac = tid % 16;      // accumulation roles
  float acc[RX][NC];
#pragma unroll
  for (int r = 0; r < RX; ++r)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc[r][m] = 0.0f;

  const float* kh = k + kvh * skv * d;
  const float* vh = v + kvh * skv * d;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the last tile's readers are done; delta is in
    load_tile<BY, DN>(ks, kh, j * BY, skv, d);
    load_tile<BY, DN>(vs, vh, j * BY, skv, d);
    __syncthreads();
    float s[RY], dp[RY];
    dots<DN, RY>(qs + x * LD, dos + x * LD, ks + y_first * LD,
                 vs + y_first * LD, s, dp);
    const float l = lses[x], dl = deltas[x];
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int kj = j * BY + y_first + r;
      const float p = valid(q0 + x, kj, sq, skv, l, q_offset, causal)
                          ? expf(s[r] * scale - l)
                          : 0.0f;
      dss[(y_first + r) * BX + x] = p * (dp[r] - dl) * scale;
    }
    __syncthreads();
#pragma unroll 4
    for (int y = 0; y < BY; ++y) {
      float w[RX];
      load_rx<RX>(dss + y * BX + ax, w);
#pragma unroll
      for (int m = 0; m < NC; ++m) {
        const float kv = ks[y * LD + ac + 16 * m];
#pragma unroll
        for (int r = 0; r < RX; ++r) acc[r][m] = fmaf(w[r], kv, acc[r][m]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const int qi = q0 + ax + r;
    if (qi >= sq) continue;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = ac + 16 * m;
      if (c < d) dq[(row_base + qi) * d + c] = acc[r][m];
    }
  }
}

template <int DN>
__global__ void __launch_bounds__(kFmaThreads, 1)
    flash_attention_bwd_dkdv_fma_kernel(
        const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int hq, int hkv,
        int sq, int skv, int d, int q_offset, int causal, float scale) {
  using B = FmaTile<DN>;
  constexpr int BX = B::kBX, BY = B::kBY, LD = B::kLd, RY = B::kRY;
  constexpr int RX = B::kRX, NC = B::kCols;
  extern __shared__ float4 bwd_smem[];
  float* ks = reinterpret_cast<float*>(bwd_smem);  // [BX][LD]
  float* vs = ks + BX * LD;                         // [BX][LD]
  float* qs = vs + BX * LD;                         // [BY][LD]
  float* dos = qs + BY * LD;                        // [BY][LD]
  float* ps = dos + BY * LD;                        // [BY][BX]
  float* dss = ps + BY * BX;                        // [BY][BX]
  float* lses = dss + BY * BX;                      // [BY]
  float* deltas = lses + BY;                        // [BY]

  const int bkv = blockIdx.y;
  const int b = bkv / hkv, g = hq / hkv;
  const int k0 = blockIdx.x * BX;
  const int tid = threadIdx.x;
  const long long kv_base = static_cast<long long>(bkv) * skv;
  load_tile<BX, DN>(ks, k + kv_base * d, k0, skv, d);
  load_tile<BX, DN>(vs, v + kv_base * d, k0, skv, d);

  // Query rows before k0 - q_offset see none of this tile's keys.
  const int y_start = causal ? max(0, k0 - q_offset) / BY * BY : 0;
  const int x = tid % BX, y_first = tid / BX * RY;  // S and dP roles
  const int ax = tid / 16 * RX, ac = tid % 16;      // accumulation roles
  float acc_k[RX][NC], acc_v[RX][NC];
#pragma unroll
  for (int r = 0; r < RX; ++r)
#pragma unroll
    for (int m = 0; m < NC; ++m) acc_k[r][m] = acc_v[r][m] = 0.0f;

  for (int gi = 0; gi < g; ++gi) {
    const long long row_base =
        (static_cast<long long>(b) * hq + bkv % hkv * g + gi) * sq;
    for (int y0 = y_start; y0 < sq; y0 += BY) {
      __syncthreads();  // the last tile's readers are done
      load_tile<BY, DN>(qs, q + row_base * d, y0, sq, d);
      load_tile<BY, DN>(dos, dout + row_base * d, y0, sq, d);
      if (tid < BY) {
        const int qi = y0 + tid;
        lses[tid] = qi < sq ? lse[row_base + qi] : kNegInf;
        deltas[tid] = qi < sq ? delta[row_base + qi] : 0.0f;
      }
      __syncthreads();
      float s[RY], dp[RY];
      dots<DN, RY>(ks + x * LD, vs + x * LD, qs + y_first * LD,
                   dos + y_first * LD, s, dp);
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        const int yl = y_first + r;
        const float l = lses[yl];
        const float p = valid(y0 + yl, k0 + x, sq, skv, l, q_offset, causal)
                            ? expf(s[r] * scale - l)
                            : 0.0f;
        ps[yl * BX + x] = p;
        dss[yl * BX + x] = p * (dp[r] - deltas[yl]) * scale;
      }
      __syncthreads();
#pragma unroll 4
      for (int y = 0; y < BY; ++y) {
        float pw[RX], dw[RX];
        load_rx<RX>(ps + y * BX + ax, pw);
        load_rx<RX>(dss + y * BX + ax, dw);
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const float o = dos[y * LD + ac + 16 * m];
          const float qv = qs[y * LD + ac + 16 * m];
#pragma unroll
          for (int r = 0; r < RX; ++r) {
            acc_v[r][m] = fmaf(pw[r], o, acc_v[r][m]);
            acc_k[r][m] = fmaf(dw[r], qv, acc_k[r][m]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const int kj = k0 + ax + r;
    if (kj >= skv) continue;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = ac + 16 * m;
      if (c < d) {
        dk[(kv_base + kj) * d + c] = acc_k[r][m];
        dv[(kv_base + kj) * d + c] = acc_v[r][m];
      }
    }
  }
}

template <int DN>
int launch_fma(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int batch, int hq, int hkv, int sq,
               int skv, int d, int q_offset, int causal, float scale,
               cudaStream_t stream) {
  using B = FmaTile<DN>;
  constexpr int BX = B::kBX, BY = B::kBY, LD = B::kLd;
  constexpr size_t kDqSmem = sizeof(float) * (2 * (BX + BY) * LD + BY * BX +
                                              2 * BX);
  constexpr size_t kDkvSmem = sizeof(float) * (2 * (BX + BY) * LD +
                                               2 * BY * BX + 2 * BY);
  static size_t dq_allowed = 48 * 1024, dkv_allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(flash_attention_bwd_dq_fma_kernel<DN>,
                                      kDqSmem, dq_allowed);
  if (err == cudaSuccess)
    err = repro::allow_smem(flash_attention_bwd_dkdv_fma_kernel<DN>,
                            kDkvSmem, dkv_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  if (sq > 0) {
    const dim3 grid((sq + BX - 1) / BX, batch * hq);
    flash_attention_bwd_dq_fma_kernel<DN>
        <<<grid, kFmaThreads, kDqSmem, stream>>>(
            qt, kt, vt, static_cast<const float*>(out), dot, lse, delta,
            static_cast<float*>(dq), hq, hkv, sq, skv, d, q_offset, causal,
            scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (skv > 0) {
    const dim3 grid((skv + BX - 1) / BX, batch * hkv);
    flash_attention_bwd_dkdv_fma_kernel<DN>
        <<<grid, kFmaThreads, kDkvSmem, stream>>>(
            qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
            static_cast<float*>(dv), hq, hkv, sq, skv, d, q_offset, causal,
            scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out, dout and dq [batch, hq, sq, d]; k, v, dk and dv [batch, hkv, skv,
// d]; all contiguous and 16-byte aligned, of one type: dtype 0 = float32
// (f32 FMA), 1 = bfloat16 (mma.sync).  lse [batch, hq, sq] float32 from
// flash_attention_launch; delta [batch, hq, sq] float32 scratch (written
// by the first kernel, read by the second).  hq a multiple of hkv; d a
// multiple of 8, at most 256.
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
                      : launch_fma<N>(REPRO_FLASH_BWD_ARGS);
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
