// ssm_scan_bwd_chunked: the gradient of the selective scan (ssm_scan.cu)
// for Mamba-2's per-head decay, dt[b, t, d] = dt_h[b, t, head(d)] and
// A[d, :] = a_h[head(d)], in the chunked (SSD) form on tensor cores.
//
// Per batch row, 64-step chunk and head, with steps t, s of the chunk
// (a ragged last chunk padded with dt 0, the identity, and x, B, C, dy 0),
// h0 the forward's checkpoint at the chunk's start [P, N] and G the
// gradient of the chunk's end state [P, N]:
//   cum_t = sum_{k <= t} dt_k a,  L[t, s] = exp(cum_t - cum_s) for t >= s
//   (else 0),  w_s = exp(cum_Q - cum_s) (cum_Q the chunk's last),
//   u = dt x,  CB = C B^T,  M = CB o L
//   du   = M^T dy + diag(w) B G^T          dx = du dt + dy D
//   dM~  = (dy u^T) o L                    Z  = dM~ o CB
//   dC  += dM~ B + diag(exp cum) dy h0     (summed over heads)
//   dB  += dM~^T C + diag(w) u G           (summed over heads)
//   dcum_t = sum_s Z[t, s] - sum_s Z[s, t] + C_t . (diag(exp cum) dy h0)_t
//            - u_t . (diag(w) B G^T)_t, and at the last step also
//            exp(cum_Q) <G, h0> + sum_s u_s . (diag(w) B G^T)_s
//   ds = the reverse cumulative sum of dcum,  d dt_h = a ds + sum_p du x,
//   d a_h = sum ds dt,  dD = sum dy x,
//   G of the chunk before = exp(cum_Q) G + dy^T diag(exp cum) C
// (kernels/ssm_scan/ref.py: ssm_scan_heads_bwd_ref, the arbiter).  Every
// exponent is of a non-positive difference within a chunk; no state is
// got by dividing by a decay.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the lax.scan in scan_chunked (src/repro/models/ssm.py); its
// chunk-parallel forward, ssd_chunked, closes the same recurrence into
// the same per-chunk products.  This kernel computes what XLA's autodiff
// of scan_chunked gives, through the broadcast of dt_h and a_h.
//
// Bound: operations.  Per (batch row, chunk, head) at Q = P = N = 64 the
// gradient needs four products of 64 x 64 x 64 in full (dy h0, dy^T C,
// B G^T, x G; the first two not in the first chunk, the last two not in
// the last one when no final-state gradient is given) and four at their
// lower triangle (M^T dy, dy x^T, dM~ B, dM~^T C), and C B^T, at its
// lower triangle, once per (batch row, chunk) for all heads.  At zamba2's
// training shape that takes 0.0413 ms at 3xTF32's 165 T op/s on an H100
// with a bf16 x (exact in TF32, so its two products take two TF32
// products each), 0.0450 with x f32 (chip_smoke.py: heads_bwd_ops); its
// bytes (x, dy, the checkpoints and dx once each) take 0.039 ms with a
// bf16 x, and 0.051 with x f32, which then bound it.  The kernel does
// more: dy x^T, C B^T (once a block) and the products of the first and
// last chunks in full.
//
// Design.
//   * Products.  3xTF32 on mma.sync m16n8k8 (hopper.cuh: split_tf32,
//     mma_tf32x3): each operand is split into a TF32 hi and lo part as it
//     is read from shared memory, and each k8 step adds lo hi, hi lo and
//     hi hi, the small terms first: float32 to about 2^-22 relative, where
//     one TF32 product alone misses the 1e-4 tolerance.  A block has 8
//     warps; each computes a 16-row slab and a 32-column half of every
//     64 x 64 product, so its sums live in registers in the mma fragment,
//     and row and column sums over a fragment go through quad or column
//     shuffles and a small array per warp, added in a fixed order.  The
//     triangular products (M^T dy, dM~ B, dM~^T C) skip the k steps that
//     the mask zeroes.  The operand reads and their splits cost about as
//     much as the products (on an H100 80GB HBM3 at 700 W, the kernel with
//     its products dropped took 0.47 of the time, with one TF32 product a
//     step 0.78), so a scale by row or column (w, exp cum, dt) is applied
//     to a product's sums, not to its operands, where the math allows it,
//     and a bf16 x (exact in TF32, lo 0) leaves out its lo products
//     (1.05x on the same card).
//   * Tiles.  x (in its own type), dy, the checkpoint and G of a head are
//     double-buffered in shared memory with 16-byte cp.async copies,
//     zero-filled past T: the next head's tiles are in flight while one
//     is worked on.  B, C and C B^T of a chunk stay while the block takes
//     the chunk's heads.  Rows are 68 floats (72 bf16) apart.  N below 64
//     (a multiple of 4) is padded with zero states in shared memory,
//     which add nothing to any sum.
//   * Grid.  A first kernel per (batch row, head) walks the chunks from
//     the last, carrying G in registers (one product a chunk), and stores
//     G of every chunk in a scratch [batch, chunks, di, N]; then the
//     backward runs one block per (chunk, group of kGroup heads, batch
//     row).  A grid of blocks that each walk the chunks of two heads, G
//     in shared memory, took 1.5x as long at zamba2's training shape on
//     the same card: 160 blocks on 132 SMs.  Five heads a block (512
//     blocks, four waves of five heads) took 0.87 of the time of eight
//     (320 blocks, three waves of eight); ten were 3% faster there and
//     1.7x slower on a ragged [2, 200, 640].
//   * Determinism.  No atomics.  dB and dC are summed over a block's heads
//     in registers and written as partial sums per group of heads
//     [groups, batch, T, N]; dA per (batch row, chunk, head) and dD per
//     (batch row, chunk, channel); the caller adds them with torch.sum.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "ssm_scan.cuh"

namespace {

namespace sm = repro::sm90;
using repro::ssm::to_f32;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kQ = 64;               // steps per chunk
constexpr int kP = 64;               // channels per head
constexpr int kN = 64;               // states, at most (zeros past N)
constexpr int kLd = 68;              // row stride of a float tile
constexpr int kTile = kQ * kLd;      // floats of a tile
constexpr int kThreads = 256;        // 8 warps: 4 row slabs x 2 halves
constexpr int kGroup = 5;            // heads per block
static_assert(kQ == repro::ssm::kChunk, "a chunk is a checkpoint's span");
static_assert(kQ == kP && kP == kN, "every tile is 64 x 64");

// Shared memory of the backward's block, in floats: B, C, C B^T and M
// (then dM~) of the chunk; two buffers of a head's tiles (x, dy, h0, G);
// then vectors of kQ floats.
template <typename TX>
struct Layout {
  static constexpr int kLdX = sizeof(TX) == 4 ? kLd : 72;
  static constexpr int kXFloats = kQ * kLdX * static_cast<int>(sizeof(TX)) / 4;
  static constexpr int kItem = kXFloats + 3 * kTile;
  static constexpr int kB = 0, kC = kTile, kCB = 2 * kTile, kM = 3 * kTile;
  static constexpr int kItems = 4 * kTile;
  static constexpr int kDt = kItems + 2 * kItem, kCum = kDt + kQ;
  static constexpr int kEcum = kCum + kQ;
  static constexpr int kW = kEcum + kQ;
  static constexpr int kZr = kW + kQ;         // [2][kQ] row sums of Z
  static constexpr int kZc = kZr + 2 * kQ;    // [4][kQ] column sums of Z
  static constexpr int kEc = kZc + 4 * kQ;    // [2][kQ] C . (e dy h0)
  static constexpr int kRr = kEc + 2 * kQ;    // [2][kQ] u . (w B G^T)
  static constexpr int kDux = kRr + 2 * kQ;   // [2][kQ] du . x
  static constexpr int kDd = kDux + 2 * kQ;   // [4][kQ] dy . x by slab
  static constexpr int kRed = kDd + 4 * kQ;   // [7] <G, h0> by warp
  static constexpr int kFloats = kRed + 8;
  static_assert(kXFloats % 4 == 0 && kItem % 4 == 0, "16-byte tiles");
  static_assert(kFloats * 4 <= 232448, "at most 227 KB of shared memory");
};

// The first kernel: two dy and C buffers, then ecum and dt.
constexpr int kDstateFloats = 4 * kTile + 2 * kQ;

// A warp's place in every 64 x 64 product: rows m0 .. m0 + 15 and
// columns n0 .. n0 + 31; lane (g, q) = (lane / 4, lane % 4) holds rows
// m0 + g and m0 + g + 8 of columns n0 + 8 j + 2 q and + 1, j < 4.
struct Warp {
  int m0, n0, g, q;
};

__device__ __forceinline__ Warp warp_pos() {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {16 * (w & 3), 32 * (w >> 2), lane >> 2, lane & 3};
}

// acc += A[m0 .. m0 + 15, k_lo .. k_hi) B[k_lo .. k_hi, n0 .. n0 + 31]
// in 3xTF32, with A(m, k) = fa(m, k) and B(k, n) = fb(k, n) (k_lo and
// k_hi multiples of 8).  kExactA (kExactB): every value of A (B) is a
// TF32 value, so its lo part is 0 and its lo product, which would add
// exact zeros, is left out (a bf16 x).
template <bool kExactA = false, bool kExactB = false, typename FA,
          typename FB>
__device__ __forceinline__ void mma_slab(float (&acc)[4][4], const Warp& wp,
                                         int k_lo, int k_hi, FA fa, FB fb) {
#pragma unroll 2
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    uint32_t ah[4], al[4];
    sm::split_tf32(fa(wp.m0 + wp.g, k0 + wp.q), ah[0], al[0]);
    sm::split_tf32(fa(wp.m0 + wp.g + 8, k0 + wp.q), ah[1], al[1]);
    sm::split_tf32(fa(wp.m0 + wp.g, k0 + wp.q + 4), ah[2], al[2]);
    sm::split_tf32(fa(wp.m0 + wp.g + 8, k0 + wp.q + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wp.n0 + 8 * j + wp.g;
      uint32_t bh[2], bl[2];
      sm::split_tf32(fb(k0 + wp.q, n), bh[0], bl[0]);
      sm::split_tf32(fb(k0 + wp.q + 4, n), bh[1], bl[1]);
      if constexpr (kExactA) {
        sm::mma_tf32(acc[j], ah, bl);
        sm::mma_tf32(acc[j], ah, bh);
      } else if constexpr (kExactB) {
        sm::mma_tf32(acc[j], al, bh);
        sm::mma_tf32(acc[j], ah, bh);
      } else {
        sm::mma_tf32x3(acc[j], ah, al, bh, bl);
      }
    }
  }
}

// Calls f(row, column, value) for each of the lane's 16 sums.
template <typename F>
__device__ __forceinline__ void for_frag(float (&acc)[4][4], const Warp& wp,
                                         F f) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f(wp.m0 + wp.g + 8 * (e >> 1), wp.n0 + 8 * j + 2 * wp.q + (e & 1),
        acc[j][e]);
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// dst[half][row] = sum over the warp's 32 columns of f(row, col, acc),
// for the lane's two rows (the quad's lanes add in a fixed order).
template <typename F>
__device__ __forceinline__ void row_sums(float (&acc)[4][4], const Warp& wp,
                                         float* dst, F f) {
  float r[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[e >> 1] += f(wp.m0 + wp.g + 8 * (e >> 1),
                     wp.n0 + 8 * j + 2 * wp.q + (e & 1), acc[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] += __shfl_xor_sync(kAll, r[i], 1);
    r[i] += __shfl_xor_sync(kAll, r[i], 2);
  }
  if (wp.q == 0) {
    dst[(wp.n0 / 32) * kQ + wp.m0 + wp.g] = r[0];
    dst[(wp.n0 / 32) * kQ + wp.m0 + wp.g + 8] = r[1];
  }
}

// dst[slab][col] = sum over the warp's 16 rows of v(row, col) for its 32
// columns (the lanes of a column add in a fixed order).
__device__ __forceinline__ void col_sums(const float (&v)[4][4],
                                         const Warp& wp, float* dst) {
  float cs[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cs[j][i] = v[j][i] + v[j][2 + i];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        cs[j][i] += __shfl_xor_sync(kAll, cs[j][i], off);
    }
  if (wp.g == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        dst[(wp.m0 / 16) * kQ + wp.n0 + 8 * j + 2 * wp.q + i] = cs[j][i];
  }
}

// Copies rows [0, rows) x columns [0, cols) of a 64 x 64 tile of T from
// src (row stride `stride` elements) to dst (row stride ld) with 16-byte
// cp.async, the rest of the tile zero-filled (cols a multiple of 16
// bytes).
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           long long stride, int rows,
                                           int cols = 64) {
  constexpr int kPer = 16 / sizeof(T), kCpr = 64 / kPer;
  for (int i = threadIdx.x; i < kQ * kCpr; i += kThreads) {
    const int r = i / kCpr, col = (i % kCpr) * kPer;
    const bool ok = r < rows && col < cols;
    sm::cp_async<16>(dst + r * ld + col, ok ? src + r * stride + col : src,
                     ok ? 16 : 0);
  }
}

// Warp 0: cum (the inclusive prefix sum of dt a over the chunk), exp(cum)
// and w = exp(cum_Q - cum) into shared memory (two steps a lane).
__device__ __forceinline__ void chunk_decay(const float* dts, float a,
                                            float* cum, float* ecum,
                                            float* w) {
  const int lane = threadIdx.x & 31;
  const float s0 = dts[2 * lane] * a, s1 = dts[2 * lane + 1] * a;
  float v = s0 + s1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kAll, v, off);
    if (lane >= off) v += y;
  }
  float before = __shfl_up_sync(kAll, v, 1);
  if (lane == 0) before = 0.f;
  const float c0 = before + s0, c1 = c0 + s1;
  const float cq = __shfl_sync(kAll, c1, 31);
  if (cum != nullptr) {
    cum[2 * lane] = c0;
    cum[2 * lane + 1] = c1;
  }
  ecum[2 * lane] = __expf(c0);
  ecum[2 * lane + 1] = __expf(c1);
  if (w != nullptr) {
    w[2 * lane] = __expf(cq - c0);
    w[2 * lane + 1] = __expf(cq - c1);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The first kernel, one block per (head, batch row): walks
// the chunks from the last with G (the gradient of the chunk's end state,
// dh at the last) in registers, stores it for every chunk into g_chunks
// [batch, chunks, di, N], then G <- exp(cum_Q) G + dy^T diag(exp cum) C.
__global__ void __launch_bounds__(kThreads)
    ssm_scan_heads_dstate_kernel(const float* __restrict__ dt_h,
                                 const float* __restrict__ a_h,
                                 const float* __restrict__ Cm,
                                 const float* __restrict__ dy,
                                 const float* __restrict__ dh, int T, int H,
                                 int N, float* __restrict__ g_chunks) {
  extern __shared__ __align__(128) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int nc = (T + kQ - 1) / kQ, di = H * kP;
  const Warp wp = warp_pos();
  const int tid = threadIdx.x;
  float* ecum = smem + 4 * kTile;
  float* dts = ecum + kQ;
  const float a = a_h[h];
  float g[4][4];
  for_frag(g, wp, [&](int r, int col, float& v) {
    v = dh == nullptr || col >= N
            ? 0.f
            : dh[(static_cast<long long>(b) * di + h * kP + r) * N + col];
  });
  auto stage = [&](int c, int buf) {
    const int t0 = c * kQ, rows = min(kQ, T - t0);
    const long long row0 = static_cast<long long>(b) * T + t0;
    stage_tile<float>(smem + buf * 2 * kTile, kLd, dy + row0 * di + h * kP, di,
                      rows);
    stage_tile<float>(smem + buf * 2 * kTile + kTile, kLd, Cm + row0 * N, N,
                      rows, N);
  };
  auto dt_of = [&](int c) {  // an item ahead, as the backward does
    const int t = c * kQ + tid;
    return t < T ? dt_h[(static_cast<long long>(b) * T + t) * H + h] : 0.f;
  };
  stage(nc - 1, 0);
  sm::cp_async_commit();
  float dt_next = tid < kQ ? dt_of(nc - 1) : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int buf = (nc - 1 - c) & 1;
    if (c > 0) {
      stage(c - 1, buf ^ 1);
      sm::cp_async_commit();
      sm::cp_async_wait<1>();
    } else {
      sm::cp_async_wait_all();
    }
    if (tid < kQ) {
      dts[tid] = dt_next;
      if (c > 0) dt_next = dt_of(c - 1);
    }
    float* gc = g_chunks +
                ((static_cast<long long>(b) * nc + c) * di + h * kP) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = wp.n0 + 8 * j + 2 * wp.q;
        if (col < N)
          store2(gc + (wp.m0 + wp.g + 8 * i) * N + col, g[j][2 * i],
                 g[j][2 * i + 1]);
      }
    __syncthreads();
    if (tid < 32) chunk_decay(dts, a, nullptr, ecum, nullptr);
    __syncthreads();
    const float* DY = smem + buf * 2 * kTile;
    const float* Cs = DY + kTile;
    float s[4][4];
    zero(s);
    mma_slab(s, wp, 0, kQ,
             [&](int m, int k) { return ecum[k] * DY[k * kLd + m]; },
             [&](int k, int n) { return Cs[k * kLd + n]; });
    const float eq = ecum[kQ - 1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) g[j][e] = eq * g[j][e] + s[j][e];
    __syncthreads();
  }
}

// The backward proper: one block per (chunk, group of heads, batch row),
// taking its heads one after another.
template <typename TX>
__global__ void __launch_bounds__(kThreads, 1)
    ssm_scan_heads_bwd_kernel(const TX* __restrict__ x,
                              const float* __restrict__ dt_h,
                              const float* __restrict__ a_h,
                              const float* __restrict__ Bm,
                              const float* __restrict__ Cm,
                              const float* __restrict__ Dv,
                              const float* __restrict__ h_chunks,
                              const float* __restrict__ dy,
                              const float* __restrict__ g_chunks, int T, int H,
                              int N, TX* __restrict__ dx,
                              float* __restrict__ ddt_h,
                              float* __restrict__ dBp, float* __restrict__ dCp,
                              float* __restrict__ dAp,
                              float* __restrict__ dDp) {
  using L = Layout<TX>;
  constexpr bool kBf16 = sizeof(TX) == 2;  // x exact in TF32
  extern __shared__ __align__(128) float smem[];
  const int nc = (T + kQ - 1) / kQ, di = H * kP;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int batch = gridDim.z;
  const int h_first = grp * kGroup;
  const int nh = min(kGroup, H - h_first);
  const int t0 = c * kQ, rows = min(kQ, T - t0);
  const long long row0 = static_cast<long long>(b) * T + t0;
  const Warp wp = warp_pos();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* Bs = smem + L::kB;
  float* Cs = smem + L::kC;
  float* CBs = smem + L::kCB;
  float* Ms = smem + L::kM;
  float* dts = smem + L::kDt;
  float* cum = smem + L::kCum;
  float* ecum = smem + L::kEcum;
  float* wv = smem + L::kW;
  float* zr = smem + L::kZr;
  float* zc = smem + L::kZc;
  float* ecp = smem + L::kEc;
  float* rrp = smem + L::kRr;
  float* dux = smem + L::kDux;
  float* ddp = smem + L::kDd;
  float* red = smem + L::kRed;

  auto buf_of = [&](int j) { return smem + L::kItems + (j & 1) * L::kItem; };
  auto stage_head = [&](int j) {  // x, dy, h0 and G of the chunk's head j
    const int h = h_first + j;
    const long long hc = ((static_cast<long long>(b) * nc + c) * di + h * kP) *
                         N;
    float* buf = buf_of(j);
    stage_tile<TX>(reinterpret_cast<TX*>(buf), L::kLdX,
                   x + row0 * di + h * kP, di, rows);
    stage_tile<float>(buf + L::kXFloats, kLd, dy + row0 * di + h * kP, di,
                      rows);
    stage_tile<float>(buf + L::kXFloats + kTile, kLd, h_chunks + hc, N, kP, N);
    stage_tile<float>(buf + L::kXFloats + 2 * kTile, kLd, g_chunks + hc, N, kP,
                      N);
  };
  // dt of head j for thread tid < kQ (0 past T), loaded a head ahead.
  auto dt_of = [&](int j) {
    return tid < rows ? dt_h[(row0 + tid) * H + h_first + j] : 0.f;
  };
  float dC[4][4], dB[4][4];
  zero(dC);
  zero(dB);
  stage_head(0);
  stage_tile<float>(Bs, kLd, Bm + row0 * N, N, rows, N);
  stage_tile<float>(Cs, kLd, Cm + row0 * N, N, rows, N);
  sm::cp_async_commit();
  float dt_next = tid < kQ ? dt_of(0) : 0.f;
  for (int j = 0; j < nh; ++j) {
    const int h = h_first + j;
    if (j + 1 < nh) {
      stage_head(j + 1);
      sm::cp_async_commit();
      sm::cp_async_wait<1>();
    } else {
      sm::cp_async_wait_all();
    }
    float* buf = buf_of(j);
    const TX* Xs = reinterpret_cast<const TX*>(buf);
    const float* DYs = buf + L::kXFloats;
    const float* H0s = DYs + kTile;
    const float* Gs = H0s + kTile;
    auto X = [&](int r, int col) { return to_f32(Xs[r * L::kLdX + col]); };
    const float a = a_h[h];
    if (tid < kQ) {
      dts[tid] = dt_next;
      if (j + 1 < nh) dt_next = dt_of(j + 1);
    }
    __syncthreads();
    float acc[4][4];
    if (j == 0) {  // C B^T, shared by the chunk's heads
      zero(acc);
      mma_slab(acc, wp, 0, kN, [&](int m, int k) { return Cs[m * kLd + k]; },
               [&](int k, int n) { return Bs[n * kLd + k]; });
      for_frag(acc, wp, [&](int r, int col, float v) {
        CBs[r * kLd + col] = v;
      });
    }
    if (warp == 0) {
      chunk_decay(dts, a, cum, ecum, wv);
    } else {  // <G, h0>
      float s = 0.f;
      for (int e = tid - 32; e < kP * kN; e += kThreads - 32) {
        const int r = e / kN, col = e % kN;
        s += Gs[r * kLd + col] * H0s[r * kLd + col];
      }
      s = warp_sum(s);
      if (lane == 0) red[warp - 1] = s;
    }
    __syncthreads();
    for (int e = tid; e < kQ * kQ; e += kThreads) {  // M = C B^T o L
      const int t = e / kQ, s = e % kQ;
      Ms[t * kLd + s] =
          t >= s ? CBs[t * kLd + s] * __expf(cum[t] - cum[s]) : 0.f;
    }
    __syncthreads();
    // du = diag(w) B G^T (its row dot with u kept for dcum) + M^T dy.
    zero(acc);
    mma_slab(acc, wp, 0, kN, [&](int m, int k) { return Bs[m * kLd + k]; },
             [&](int k, int n) { return Gs[n * kLd + k]; });
    for_frag(acc, wp, [&](int r, int, float& v) { v *= wv[r]; });
    row_sums(acc, wp, rrp, [&](int r, int col, float v) {
      return dts[r] * X(r, col) * v;
    });
    mma_slab(acc, wp, wp.m0, kQ,
             [&](int m, int k) { return Ms[k * kLd + m]; },
             [&](int k, int n) { return DYs[k * kLd + n]; });
    {  // dx = du dt + dy D; dy x summed over the slab's rows for dD
      const float* dcol = Dv + h * kP;
      float yx[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int r = wp.m0 + wp.g + 8 * ii;
          const int col = wp.n0 + 8 * jj + 2 * wp.q;
          const float y0 = DYs[r * kLd + col], y1 = DYs[r * kLd + col + 1];
          yx[jj][2 * ii] = y0 * X(r, col);
          yx[jj][2 * ii + 1] = y1 * X(r, col + 1);
          if (r < rows)
            store2(dx + (row0 + r) * di + h * kP + col,
                   acc[jj][2 * ii] * dts[r] + y0 * dcol[col],
                   acc[jj][2 * ii + 1] * dts[r] + y1 * dcol[col + 1]);
        }
      col_sums(yx, wp, ddp);
    }
    row_sums(acc, wp, dux, [&](int r, int col, float v) {
      return v * X(r, col);
    });
    __syncthreads();  // every read of M is done
    // dM~ = (dy u^T) o L into Ms; Z = dM~ o C B^T summed by row and column.
    zero(acc);
    if (wp.n0 <= wp.m0 + 15)
      mma_slab<false, kBf16>(acc, wp, 0, kP,
                             [&](int m, int k) { return DYs[m * kLd + k]; },
                             [&](int k, int n) { return X(n, k); });
    for_frag(acc, wp, [&](int t, int s, float& v) {
      v = t >= s ? v * dts[s] * __expf(cum[t] - cum[s]) : 0.f;
      Ms[t * kLd + s] = v;
    });
    {
      float z[4][4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = wp.m0 + wp.g + 8 * (e >> 1);
          const int s = wp.n0 + 8 * jj + 2 * wp.q + (e & 1);
          z[jj][e] = t >= s ? acc[jj][e] * CBs[t * kLd + s] : 0.f;
        }
      row_sums(z, wp, zr, [](int, int, float v) { return v; });
      col_sums(z, wp, zc);
    }
    __syncthreads();  // dM~ is whole
    // dC += diag(exp cum) dy h0 (its row dot with C kept) + dM~ B.
    zero(acc);
    mma_slab(acc, wp, 0, kP, [&](int m, int k) { return DYs[m * kLd + k]; },
             [&](int k, int n) { return H0s[k * kLd + n]; });
    for_frag(acc, wp, [&](int r, int, float& v) { v *= ecum[r]; });
    row_sums(acc, wp, ecp, [&](int r, int col, float v) {
      return v * Cs[r * kLd + col];
    });
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) dC[jj][e] += acc[jj][e];
    mma_slab(dC, wp, 0, wp.m0 + 16,
             [&](int m, int k) { return Ms[m * kLd + k]; },
             [&](int k, int n) { return Bs[k * kLd + n]; });
    // dB += dM~^T C + diag(w) u G.
    mma_slab(dB, wp, wp.m0, kQ,
             [&](int m, int k) { return Ms[k * kLd + m]; },
             [&](int k, int n) { return Cs[k * kLd + n]; });
    zero(acc);
    mma_slab<kBf16>(acc, wp, 0, kP, [&](int m, int k) { return X(m, k); },
                    [&](int k, int n) { return Gs[k * kLd + n]; });
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wp.m0 + wp.g + 8 * (e >> 1);
        dB[jj][e] += wv[r] * dts[r] * acc[jj][e];
      }
    __syncthreads();  // the row and column sums are whole
    if (warp == 0) {
      float d[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        d[k] = zr[t] + zr[kQ + t] -
               (zc[t] + zc[kQ + t] + zc[2 * kQ + t] + zc[3 * kQ + t]) +
               ecp[t] + ecp[kQ + t] - (rrp[t] + rrp[kQ + t]);
      }
      const float rr = warp_sum(rrp[2 * lane] + rrp[kQ + 2 * lane] +
                                rrp[2 * lane + 1] + rrp[kQ + 2 * lane + 1]);
      if (lane == 31)
        d[1] += rr + ecum[kQ - 1] * (red[0] + red[1] + red[2] + red[3] +
                                     red[4] + red[5] + red[6]);
      float v = d[0] + d[1];  // ds_t = sum over t' >= t of dcum_t'
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_down_sync(kAll, v, off);
        if (lane + off < 32) v += y;
      }
      float after = __shfl_down_sync(kAll, v, 1);
      if (lane == 31) after = 0.f;
      const float ds1 = after + d[1], ds0 = ds1 + d[0];
      const int t = 2 * lane;
      if (t < rows)
        ddt_h[(row0 + t) * H + h] = a * ds0 + dux[t] + dux[kQ + t];
      if (t + 1 < rows)
        ddt_h[(row0 + t + 1) * H + h] =
            a * ds1 + dux[t + 1] + dux[kQ + t + 1];
      const float da = warp_sum(ds0 * dts[t] + ds1 * dts[t + 1]);
      if (lane == 0) dAp[(static_cast<long long>(b) * nc + c) * H + h] = da;
    } else if (warp <= 2) {  // dD of the head's channels
      const int p = tid - 32;
      dDp[(static_cast<long long>(b) * nc + c) * di + h * kP + p] =
          ddp[p] + ddp[kQ + p] + ddp[2 * kQ + p] + ddp[3 * kQ + p];
    }
    if (j == nh - 1) {  // this block's sums of dB and dC over its heads
      const long long base =
          ((static_cast<long long>(grp) * batch + b) * T + t0) * N;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const int r = wp.m0 + wp.g + 8 * ii;
          const int col = wp.n0 + 8 * jj + 2 * wp.q;
          if (r < rows && col < N) {
            store2(dCp + base + r * N + col, dC[jj][2 * ii],
                   dC[jj][2 * ii + 1]);
            store2(dBp + base + r * N + col, dB[jj][2 * ii],
                   dB[jj][2 * ii + 1]);
          }
        }
    }
    __syncthreads();  // before the next head's tiles reuse the buffers
  }
}

template <typename TX>
int launch(const void* x, const float* dt_h, const float* a_h,
           const float* Bm, const float* Cm, const float* Dv,
           const float* h_chunks, const float* dy, const float* dh,
           float* g_chunks, int batch, int T, int H, int N, void* dx,
           float* ddt_h, float* dBp, float* dCp, float* dAp, float* dDp,
           cudaStream_t stream) {
  const int groups = (H + kGroup - 1) / kGroup;
  const int nc = (T + kQ - 1) / kQ;
  constexpr size_t smem1 = kDstateFloats * 4;
  static size_t allowed1 = 48 * 1024;
  cudaError_t err =
      repro::allow_smem(ssm_scan_heads_dstate_kernel, smem1, allowed1);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_scan_heads_dstate_kernel<<<dim3(H, batch), kThreads, smem1, stream>>>(
      dt_h, a_h, Cm, dy, dh, T, H, N, g_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem2 = Layout<TX>::kFloats * 4;
  static size_t allowed2 = 48 * 1024;
  err = repro::allow_smem(ssm_scan_heads_bwd_kernel<TX>, smem2, allowed2);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_scan_heads_bwd_kernel<TX>
      <<<dim3(nc, groups, batch), kThreads, smem2, stream>>>(
          static_cast<const TX*>(x), dt_h, a_h, Bm, Cm, Dv, h_chunks, dy,
          g_chunks, T, H, N, static_cast<TX*>(dx), ddt_h, dBp, dCp, dAp,
          dDp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Heads per block of the backward (the partial sums of dB and dC have
// ceil(H / that) rows).
extern "C" int ssm_scan_heads_bwd_group() { return kGroup; }

// The forward's inputs for a per-head decay (x [batch, T, H P] float32
// (x_bf16 0) or bfloat16 (x_bf16 1); dt_h [batch, T, H], a_h [H], Bm, Cm
// [batch, T, N], Dv [H P] float32), its checkpoints h_chunks [batch,
// ceil(T / 64), H P, N], dy [batch, T, H P] and dh [batch, H P, N] (or
// null: 0), float32, all contiguous and 16-byte aligned; g_chunks: a
// scratch like h_chunks (the gradient of every chunk's end state).
// Outputs dx [batch, T, H P] in x's type, ddt_h [batch, T, H] and partial
// sums, float32: dBp, dCp [groups, batch, T, N] (groups
// ceil(H / ssm_scan_heads_bwd_group())), dAp [batch, chunks, H], dDp
// [batch, chunks, H P].  Takes P = 64 and N a multiple of 4 up to 64
// (the states past N are zeros in shared memory); batch and groups at
// most 65535.
extern "C" int ssm_scan_heads_bwd_launch(
    const void* x, const float* dt_h, const float* a_h, const float* Bm,
    const float* Cm, const float* Dv, const float* h_chunks, const float* dy,
    const float* dh, float* g_chunks, int batch, int T, int H, int P, int N,
    int x_bf16, void* dx, float* ddt_h, float* dBp, float* dCp, float* dAp,
    float* dDp, void* stream) {
  if (P != kP || N <= 0 || N > kN || N % 4 != 0 || batch > 65535 ||
      H <= 0 || (H + kGroup - 1) / kGroup > 65535 || g_chunks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, dt_h, a_h, Bm, Cm, Dv, h_chunks,
                                        dy, dh, g_chunks, batch, T, H, N, dx,
                                        ddt_h, dBp, dCp, dAp, dDp, s)
                : launch<float>(x, dt_h, a_h, Bm, Cm, Dv, h_chunks, dy, dh,
                                g_chunks, batch, T, H, N, dx, ddt_h, dBp,
                                dCp, dAp, dDp, s);
}
