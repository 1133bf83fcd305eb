// ssd_chunked: the chunk-parallel SSD scan of Mamba-2 (per-head scalar
// decay) on tensor cores, forward only.
//
// Replaces no TPU kernel: the reference's ssd_chunked
// (src/repro/models/ssm.py:118-193) is XLA code, a lax.scan over chunks
// whose body is three einsums with a [B, L, L, H] decay matrix.  Its
// semantics, per batch row, chunk of l = min(chunk, T) steps (the time
// axis padded with dt = 0 to a multiple of l) and head of P = 64
// channels, with s = dt a_h and cum its cumulative sum over the chunk:
//   decay[t, s] = exp(cum_t - cum_s) (t >= s, else 0), cb = C B^T,
//   dtx = dt x, y = (decay o cb) dtx + exp(cum_t) C h^T, then + x D;
//   h <- exp(cum_last) h + x^T diag(w) B, w_s = exp(cum_last - cum_s) dt_s.
// Types as the reference's: bf16 x makes x, B, C, D (op_in) and decay,
// cb, dtx, w, y (op_dt) bf16; f32 x keeps all in f32; cum, exp and the
// state are f32 throughout.
//
// Three kernels, one launcher call:
//   1. ssd_state_kernel, a block per (chunk, head, row): the chunk's
//      end state from zero, dH = (x diag(w))^T B [P, N], on tensor cores
//      (64 x 64 over the chunk's steps), and its exp(cum_last) exponent;
//   2. ssd_pass_kernel, a thread per state element of a (head, row): walks
//      the chunks in order, h <- exp(cum_last) h + dH, and overwrites each
//      dH with the chunk's start state (h0 for the first); the final state
//      is the kernel's h_final;
//   3. ssd_scan_kernel, a block of 8 warps per (chunk, head, row): each warp
//      owns 16-row groups of the chunk (groups g and 15 - g, so the
//      causal triangle's work is even), starts its accumulator with the
//      inter-chunk term exp(cum_t) C_t h^T, then walks the key blocks up to
//      its diagonal as flash attention walks keys: S = C B^T of the block
//      on tensor cores, M = decay o S formed in registers (the decay's
//      exponentials computed there, one per (t, s) pair and head, never
//      factored into exp(cum_t) exp(-cum_s)), and y += M dtx; the warp
//      stages its rows in its own rows of C (free once loaded) and stores
//      y + x D coalesced.
// Number routes:
//   * bf16 (mma.sync m16n8k16, f32 sums): C, B, dtx are exact bf16
//     operands.  M = bf16(decay) bf16(cb) is an exact float32 product of
//     two bf16 values (16 significant bits), which the reference keeps in
//     float32; here it is split into hi = bf16(M) and lo = bf16(M - hi),
//     which hold M exactly, and multiplies dtx in two products.  The same
//     for x w in the state (x and w bf16) and for the float32 state h in
//     the inter term (hi + lo keep h to 2^-17 of itself: a rounding the
//     reference does not make, far below y's own bf16 rounding).
//   * float32 (mma.sync m16n8k8 in 3xTF32: split_tf32, mma_tf32x3): every
//     operand split into hi and lo TF32 values, three products each.
// Bound: bytes.  At [1, 32768, 5120] (80 heads of 64, N 64, chunk 256,
// x bf16) x and y move 671 MB, dt_h, B and C 27 MB: 0.21 ms at 3.35 TB/s;
// the products need about 1.1e11 operations (0.11 ms at 989 T op/s) and
// the decay 3.4e8 exponentials (0.08 ms at 16 a clock on 132 SMs).  The
// start states make a round trip through device memory ([B, chunks, H, 64,
// N] float32, 168 MB at that shape, written, read and rewritten, then
// read): the price of three simple passes; a later design keeps them on
// chip.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm = repro::sm90;

constexpr int kP = 64;        // channels per head
constexpr int kMaxN = 64;     // states (N padded to 64 with zeros)
constexpr int kMaxL = 256;    // steps per chunk
constexpr int kScanWarps = 8;
constexpr int kStateWarps = 4;
constexpr int kPassThreads = 128;

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float lo_bf(uint32_t pair) {
  return __uint_as_float(pair << 16);
}

__device__ __forceinline__ float hi_bf(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// hi and lo bf16 pairs of two float32 values: v = bf16(v) + bf16(v -
// bf16(v)), exact where v has at most 16 significant bits.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = sm::pack_bf16(v0, v1);
  lo = sm::pack_bf16(v0 - lo_bf(hi), v1 - hi_bf(hi));
}

// The shared-memory layout and operand type of each route.
template <typename XT>
struct Route;

template <>
struct Route<__nv_bfloat16> {
  using S = __nv_bfloat16;        // operands in shared memory
  static constexpr int kK = 16;   // mma.sync m16n8k16
  static constexpr int kLdc = 72;   // C and B rows [step][state]
  static constexpr int kLdt = 264;  // x and B [channel or state][step]
  static constexpr int kLdu = 264;  // dtx [channel][step]
  static constexpr int kLdh = 72;   // the start state [channel][state], f32
  static __device__ __forceinline__ float op(float v) { return bf(v); }
  static __device__ __forceinline__ S store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float load(S v) {
    return __bfloat162float(v);
  }
};

template <>
struct Route<float> {
  using S = float;
  static constexpr int kK = 8;    // mma.sync m16n8k8 (TF32)
  static constexpr int kLdc = 68;
  static constexpr int kLdt = 260;
  static constexpr int kLdu = 264;
  static constexpr int kLdh = 68;
  static __device__ __forceinline__ float op(float v) { return v; }
  static __device__ __forceinline__ S store(float v) { return v; }
  static __device__ __forceinline__ float load(S v) { return v; }
};

template <typename XT>
constexpr int state_smem() {
  using R = Route<XT>;
  return 2 * kP * R::kLdt * static_cast<int>(sizeof(typename R::S)) +
         3 * kMaxL * 4;
}

template <typename XT>
constexpr int scan_smem() {
  using R = Route<XT>;
  return (2 * kMaxL * R::kLdc + kP * R::kLdu) *
             static_cast<int>(sizeof(typename R::S)) +
         kP * R::kLdh * 4 + 2 * kMaxL * 4;
}

// cum[r] (in place) = s[0] + ... + s[r] over kMaxL entries, by one warp:
// each lane sums its 8 in order, then the lanes' totals are scanned.
__device__ __forceinline__ void warp_cumsum(float* cum) {
  const int lane = threadIdx.x % 32;
  float v[8], run = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    run += cum[8 * lane + k];
    v[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += y;
  }
  float excl = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) excl = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) cum[8 * lane + k] = excl + v[k];
}

// dt of the chunk's steps for head h into ds, s = dt a into cum (0 past the
// chunk or T).
__device__ __forceinline__ void load_dt(const float* __restrict__ dt,
                                        const float* __restrict__ a, float* ds,
                                        float* cum, int b, int t, int nh,
                                        int h, int t0, int lc) {
  const float ah = a[h];
  for (int r = threadIdx.x; r < kMaxL; r += blockDim.x) {
    const bool in = r < lc && t0 + r < t;
    const float v =
        in ? dt[(static_cast<long long>(b) * t + t0 + r) * nh + h] : 0.0f;
    ds[r] = v;
    cum[r] = v * ah;
  }
}

// ---- 1. the chunk's end state from zero -----------------------------------

template <typename XT>
__global__ void __launch_bounds__(32 * kStateWarps) ssd_state_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ dstate, float* __restrict__ cum_last, int t, int nh,
    int n, int chunk) {
  using R = Route<XT>;
  using S = typename R::S;
  constexpr int LDT = R::kLdt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* xt = reinterpret_cast<S*>(smem_raw);  // [p][step]: x
  S* bt = xt + kP * LDT;                   // [state][step]: B
  float* ds = reinterpret_cast<float*>(bt + kP * LDT);
  float* cum = ds + kMaxL;
  float* ws = cum + kMaxL;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = c * chunk;
  const int lc = min(chunk, t - t0);         // valid steps of this chunk
  const int l16 = (min(chunk, kMaxL) + 15) / 16 * 16;
  const int di = nh * kP;
  load_dt(dt, a, ds, cum, b, t, nh, h, t0, chunk);
  for (int i = threadIdx.x; i < l16 * kP; i += blockDim.x) {
    const int r = i / kP, p = i % kP;
    const bool in = r < lc;
    const long long row = static_cast<long long>(b) * t + t0 + r;
    xt[p * LDT + r] = in ? x[row * di + h * kP + p] : R::store(0.0f);
    bt[p * LDT + r] =
        R::store(in && p < n ? bm[row * n + p] : 0.0f);
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(cum);
  __syncthreads();
  const float last = cum[min(chunk, kMaxL) - 1];
  for (int r = threadIdx.x; r < kMaxL; r += blockDim.x)
    ws[r] = r < lc ? R::op(expf(last - cum[r]) * ds[r]) : 0.0f;
  if (threadIdx.x == 0)
    cum_last[(static_cast<long long>(b) * nc + c) * nh + h] = last;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int p0 = 16 * warp;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int s0 = 0; s0 < l16; s0 += R::kK) {
    if constexpr (R::kK == 16) {
      // A (p, step) = x w: two bf16 factors, so exact in hi + lo.
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = p0 + g + 8 * (k & 1);
        const int col = s0 + 2 * q + 8 * (k >> 1);
        const uint32_t xv = ld32(xt + row * LDT + col);
        split_bf16(lo_bf(xv) * ws[col], hi_bf(xv) * ws[col + 1], a_hi[k],
                   a_lo[k]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* bp = bt + (8 * j + g) * LDT + s0 + 2 * q;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
        sm::mma_bf16(acc[j], a_lo, b0, b1);
        sm::mma_bf16(acc[j], a_hi, b0, b1);
      }
    } else {
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = p0 + g + 8 * (k & 1);
        const int col = s0 + q + 4 * (k >> 1);
        sm::split_tf32(R::load(xt[row * LDT + col]) * ws[col], a_hi[k],
                       a_lo[k]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const S* bp = bt + (8 * j + g) * LDT + s0 + q;
        uint32_t b_hi[2], b_lo[2];
        sm::split_tf32(R::load(bp[0]), b_hi[0], b_lo[0]);
        sm::split_tf32(R::load(bp[4]), b_hi[1], b_lo[1]);
        sm::mma_tf32x3(acc[j], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }
  float* out = dstate + ((static_cast<long long>(b) * nc + c) * nh + h) *
                            kP * n;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e >> 1), k = 8 * j + 2 * q + (e & 1);
      if (k < n) out[p * n + k] = acc[j][e];
    }
}

// ---- 2. the start states, chunk by chunk -----------------------------------

__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(
    float* __restrict__ dstate, const float* __restrict__ cum_last,
    const float* __restrict__ h0, float* __restrict__ h_final, int nc, int nh,
    int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int size = kP * n;
  if (e >= size) return;
  const long long head = (static_cast<long long>(b) * nh + h) * size + e;
  float state = h0 != nullptr ? h0[head] : 0.0f;
  constexpr int kAhead = 4;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float dh[kAhead], dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long cell =
          (static_cast<long long>(b) * nc + c0 + k) * nh + h;
      const bool in = c0 + k < nc;
      dh[k] = in ? dstate[cell * size + e] : 0.0f;
      dec[k] = in ? expf(cum_last[cell]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k >= nc) break;
      const long long cell =
          (static_cast<long long>(b) * nc + c0 + k) * nh + h;
      dstate[cell * size + e] = state;
      state = __fadd_rn(__fmul_rn(dec[k], state), dh[k]);
    }
  }
  h_final[head] = state;
}

// ---- 3. the outputs --------------------------------------------------------

template <typename XT>
__global__ void __launch_bounds__(32 * kScanWarps) ssd_scan_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dvec,
    const float* __restrict__ hstart, XT* __restrict__ y, int t, int nh,
    int n, int chunk) {
  using R = Route<XT>;
  using S = typename R::S;
  constexpr int LDC = R::kLdc, LDT = R::kLdu, LDH = R::kLdh, K = R::kK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* cs = reinterpret_cast<S*>(smem_raw);  // [step][state]: C
  S* bs = cs + kMaxL * LDC;                // [step][state]: B
  S* ut = bs + kMaxL * LDC;                // [p][step]: dtx
  float* hs = reinterpret_cast<float*>(ut + kP * LDT);  // [p][state]
  float* ds = hs + kP * LDH;
  float* cum = ds + kMaxL;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = c * chunk;
  const int lc = min(chunk, t - t0);
  const int l16 = (min(chunk, kMaxL) + 15) / 16 * 16;
  const int di = nh * kP;
  load_dt(dt, a, ds, cum, b, t, nh, h, t0, chunk);
  for (int i = threadIdx.x; i < l16 * kMaxN; i += blockDim.x) {
    const int r = i / kMaxN, k = i % kMaxN;
    const bool in = r < lc && k < n;
    const long long at = (static_cast<long long>(b) * t + t0 + r) * n + k;
    cs[r * LDC + k] = R::store(in ? cm[at] : 0.0f);
    bs[r * LDC + k] = R::store(in ? bm[at] : 0.0f);
  }
  const float* hp =
      hstart + ((static_cast<long long>(b) * nc + c) * nh + h) * kP * n;
  for (int i = threadIdx.x; i < kP * kMaxN; i += blockDim.x) {
    const int p = i / kMaxN, k = i % kMaxN;
    hs[p * LDH + k] = k < n ? hp[p * n + k] : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x < 32) warp_cumsum(cum);
  for (int i = threadIdx.x; i < l16 * kP; i += blockDim.x) {
    const int r = i / kP, p = i % kP;
    const float xv =
        r < lc ? static_cast<float>(
                     R::load(x[(static_cast<long long>(b) * t + t0 + r) * di +
                               h * kP + p]))
               : 0.0f;
    ut[p * LDT + r] = R::store(ds[r] * xv);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int groups = l16 / 16;
  for (int pass = 0; pass < 2; ++pass) {
    const int rg = pass == 0 ? warp : 2 * kScanWarps - 1 - warp;
    if (rg >= groups) continue;
    const int r0 = 16 * rg;
    const int row0 = r0 + g, row1 = r0 + g + 8;
    const float cum0 = cum[row0], cum1 = cum[row1];
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;

    if constexpr (K == 16) {
      // C's A fragments for the 4 k16 steps over the states.
      uint32_t ca[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ca[ks][k] = ld32(cs + (r0 + g + 8 * (k & 1)) * LDC + 16 * ks +
                           2 * q + 8 * (k >> 1));
      // The inter-chunk term, C h^T with h in hi + lo bf16, times exp(cum).
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* hrow = hs + (8 * j + g) * LDH + 16 * ks + 2 * q;
          const float2 h01 = *reinterpret_cast<const float2*>(hrow);
          const float2 h89 = *reinterpret_cast<const float2*>(hrow + 8);
          uint32_t hi0, lo0, hi1, lo1;
          split_bf16(h01.x, h01.y, hi0, lo0);
          split_bf16(h89.x, h89.y, hi1, lo1);
          sm::mma_bf16(o[j], ca[ks], lo0, lo1);
          sm::mma_bf16(o[j], ca[ks], hi0, hi1);
        }
      const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][0] *= e0, o[j][1] *= e0;
        o[j][2] *= e1, o[j][3] *= e1;
      }
      // The intra-chunk term over the key blocks up to the diagonal.
      for (int s0 = 0; s0 <= r0 + 15 && s0 < l16; s0 += 16) {
        float sc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const __nv_bfloat16* bp =
                bs + (s0 + 8 * j + g) * LDC + 16 * ks + 2 * q;
            sm::mma_bf16(sc[j], ca[ks], ld32(bp), ld32(bp + 8));
          }
        // M = bf16(decay) bf16(cb), exact in float32, as hi + lo: the
        // accumulator of two n8 tiles is the A fragment of their 16 keys.
        uint32_t m_hi[4], m_lo[4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = hr ? row1 : row0;
            const float crow = hr ? cum1 : cum0;
            float m[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int s = s0 + 8 * j + 2 * q + e;
              const float dec = s <= row ? bf(__expf(crow - cum[s])) : 0.0f;
              m[e] = dec * bf(sc[j][2 * hr + e]);
            }
            split_bf16(m[0], m[1], m_hi[2 * j + hr], m_lo[2 * j + hr]);
          }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* up = ut + (8 * j + g) * LDT + s0 + 2 * q;
          const uint32_t b0 = ld32(up), b1 = ld32(up + 8);
          sm::mma_bf16(o[j], m_lo, b0, b1);
          sm::mma_bf16(o[j], m_hi, b0, b1);
        }
      }
    } else {
      // C's A fragments for the 8 k8 steps over the states, split once.
      uint32_t c_hi[8][4], c_lo[8][4];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sm::split_tf32(R::load(cs[(r0 + g + 8 * (k & 1)) * LDC + 8 * ks +
                                    q + 4 * (k >> 1)]),
                         c_hi[ks][k], c_lo[ks][k]);
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* hrow = hs + (8 * j + g) * LDH + 8 * ks + q;
          uint32_t b_hi[2], b_lo[2];
          sm::split_tf32(hrow[0], b_hi[0], b_lo[0]);
          sm::split_tf32(hrow[4], b_hi[1], b_lo[1]);
          sm::mma_tf32x3(o[j], c_hi[ks], c_lo[ks], b_hi, b_lo);
        }
      const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][0] *= e0, o[j][1] *= e0;
        o[j][2] *= e1, o[j][3] *= e1;
      }
      for (int s0 = 0; s0 <= r0 + 15 && s0 < l16; s0 += 8) {
        float sc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          const S* bp = bs + (s0 + g) * LDC + 8 * ks + q;
          uint32_t b_hi[2], b_lo[2];
          sm::split_tf32(R::load(bp[0]), b_hi[0], b_lo[0]);
          sm::split_tf32(R::load(bp[4]), b_hi[1], b_lo[1]);
          sm::mma_tf32x3(sc, c_hi[ks], c_lo[ks], b_hi, b_lo);
        }
        // sc[e]: row r0 + g + 8 (e / 2), key s0 + 2q + e % 2, taken as
        // k-indices q and q + 4 of M's A fragment (dtx split in that key
        // order below).
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1, s = s0 + 2 * q + (e & 1);
          m[e] = s <= row ? expf((e < 2 ? cum0 : cum1) - cum[s]) * sc[e]
                          : 0.0f;
        }
        uint32_t m_hi[4], m_lo[4];
        sm::split_tf32(m[0], m_hi[0], m_lo[0]);
        sm::split_tf32(m[2], m_hi[1], m_lo[1]);
        sm::split_tf32(m[1], m_hi[2], m_lo[2]);
        sm::split_tf32(m[3], m_hi[3], m_lo[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 u = *reinterpret_cast<const float2*>(
              ut + (8 * j + g) * LDT + s0 + 2 * q);
          uint32_t b_hi[2], b_lo[2];
          sm::split_tf32(u.x, b_hi[0], b_lo[0]);
          sm::split_tf32(u.y, b_hi[1], b_lo[1]);
          sm::mma_tf32x3(o[j], m_hi, m_lo, b_hi, b_lo);
        }
      }
    }

    // y in op_dt, staged in this warp's own rows of C (no other warp reads
    // them), then y + x D stored by rows: two channels a lane.
    S* ys = cs + r0 * LDC;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ys[(g + 8 * (e >> 1)) * LDC + 8 * j + 2 * q + (e & 1)] =
            R::store(o[j][e]);
    __syncwarp();
    const int p = 2 * lane;
    const float d0 = R::op(dvec[h * kP + p]), d1 = R::op(dvec[h * kP + p + 1]);
    for (int r = 0; r < 16; ++r) {
      if (r0 + r >= lc) break;
      const long long at =
          (static_cast<long long>(b) * t + t0 + r0 + r) * di + h * kP + p;
      const float y0 = R::load(ys[r * LDC + p]);
      const float y1 = R::load(ys[r * LDC + p + 1]);
      const float x0 = R::load(x[at]), x1 = R::load(x[at + 1]);
      y[at] = R::store(R::op(__fadd_rn(y0, R::op(__fmul_rn(x0, d0)))));
      y[at + 1] = R::store(R::op(__fadd_rn(y1, R::op(__fmul_rn(x1, d1)))));
    }
    __syncwarp();
  }
}

template <typename XT>
int launch(const void* x, const float* dt, const float* a, const float* bm,
           const float* cm, const float* dvec, const float* h0, float* dstate,
           float* cum_last, int batch, int t, int nh, int n, int chunk,
           void* y, float* h_final, cudaStream_t stream) {
  const int nc = (t + chunk - 1) / chunk;
  const XT* xp = static_cast<const XT*>(x);
  static size_t allowed_state = 48 * 1024, allowed_scan = 48 * 1024;
  cudaError_t err = repro::allow_smem(ssd_state_kernel<XT>, state_smem<XT>(),
                                      allowed_state);
  if (err == cudaSuccess)
    err = repro::allow_smem(ssd_scan_kernel<XT>, scan_smem<XT>(),
                            allowed_scan);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nc, nh, batch);
  ssd_state_kernel<XT><<<grid, 32 * kStateWarps, state_smem<XT>(), stream>>>(
      xp, dt, a, bm, dstate, cum_last, t, nh, n, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pass_grid((kP * n + kPassThreads - 1) / kPassThreads, nh, batch);
  ssd_pass_kernel<<<pass_grid, kPassThreads, 0, stream>>>(
      dstate, cum_last, h0, h_final, nc, nh, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<XT><<<grid, 32 * kScanWarps, scan_smem<XT>(), stream>>>(
      xp, dt, a, bm, cm, dvec, dstate, static_cast<XT*>(y), t, nh, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [batch, t, nh * 64] (x_bf16: bfloat16, else float32), dt [batch, t,
// nh], a [nh], bm and cm [batch, t, n], dvec [nh * 64] and h0 [batch, nh *
// 64, n] (null: zeros) float32, all contiguous; n at most 64, chunk 1 to
// 256.  dstate ([batch, chunks, nh, 64, n]) and cum_last ([batch, chunks,
// nh]) float32 scratch; y like x; h_final [batch, nh * 64, n] float32.
extern "C" int ssd_chunked_launch(const void* x, const void* dt,
                                  const void* a, const void* bm,
                                  const void* cm, const void* dvec,
                                  const void* h0, void* dstate,
                                  void* cum_last, int batch, int t, int nh,
                                  int p, int n, int chunk, int x_bf16,
                                  void* y, void* h_final, void* stream) {
  if (batch == 0 || t == 0 || nh == 0) return 0;
  if (p != kP || n <= 0 || n > kMaxN || chunk <= 0 || chunk > kMaxL ||
      nh > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(dt),
                      static_cast<const float*>(a),
                      static_cast<const float*>(bm),
                      static_cast<const float*>(cm),
                      static_cast<const float*>(dvec),
                      static_cast<const float*>(h0)};
  float* ds = static_cast<float*>(dstate);
  float* cl = static_cast<float*>(cum_last);
  float* hf = static_cast<float*>(h_final);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, f[0], f[1], f[2], f[3], f[4], f[5], ds,
                                 cl, batch, t, nh, n, chunk, y, hf, s);
  return launch<float>(x, f[0], f[1], f[2], f[3], f[4], f[5], ds, cl, batch,
                       t, nh, n, chunk, y, hf, s);
}
