// flash_attention: causal (or full) grouped-query attention with an online
// softmax, never materialising the [Sq, Skv] score matrix.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, _kernel).  The TPU kernel
// walked a sequential grid axis over k/v blocks with (m, l, acc) in VMEM
// scratch, and its wrapper padded Sq and Skv to 128.  Here one CTA owns
// one (batch * q head, q tile) and loops over k/v tiles itself; the
// ragged edges (any Sq, Skv) are masked inside the kernel, so nothing is
// padded.  The q head h reads kv head h / group (GQA) straight from the
// k/v layout; no repeated copy of k and v exists.  q tiles run in
// reverse order, so the long causal rows start first.
//
// Semantics, as the TPU kernel's: scores s = (q . k) * scale in f32;
// masked entries (col >= Skv, or col > q_offset + row when causal) are
// finfo(float32).min, not -inf; m_new = max(m, rowmax(s)); a row whose
// maximum is still that minimum uses 0 in its place; p = exp(s - m_new),
// set to 0 where masked; alpha = exp(m - m_new) (0 while m is the
// minimum); l = alpha * l + sum(p); acc = alpha * acc + p . v; out = acc
// / l, with l = 0 (a row with no valid key) giving 0.  k tiles wholly
// after the causal diagonal of the q tile are skipped.  The output has
// the input's type.
//
// Bound: operations, 4 * D per unmasked (query, key) pair and head
// against 2 (Sq + 2 Skv) D bytes per head: at the prefill shapes (Sq =
// Skv = 2048) some 500 operations per byte, above the H100's ~295 bf16
// tensor-core operations per byte of device memory.  Two designs, chosen
// by the type alone:
//
// * bfloat16: tensor cores (flash_attention_wgmma_kernel).  One CTA per
//   128-row q tile: two consumer warpgroups of 64 rows and one producer
//   warpgroup (setmaxnreg moves registers from it to the consumers).  The
//   producer's one thread loads the q tile once and streams k and v
//   tiles through a ring of three stages in shared memory (two for DN >
//   192) with TMA; k and v have full and empty mbarriers of their own, so
//   QK^T starts before v lands and a k slot refills before its v is
//   consumed.  Tiles are column boxes of 64 (128 bytes) with the 128-byte
//   swizzle (hopper.cuh); columns past D and rows past Sq or Skv arrive
//   as zeros from TMA.  S = Q K^T is wgmma m64 x nBK x k16 with both
//   operands in shared memory, DN / 16 steps, DN = D rounded up to 16
//   (the zero columns add nothing); BK = 128 keys for DN <= 80, else 64
//   (at 128 the live S, P and O of the overlap below would spill).  The
//   online softmax runs on the accumulator fragment in registers: row
//   max and sum over the quad of lanes that holds a row, four partial
//   maxima and sums per row to keep dependent chains short, exp2 (one
//   MUFU instruction) with scale * log2(e) folded into the scores, masks
//   only on tiles that cross the causal diagonal or the Skv edge, and l
//   kept per thread until the end.  P is rounded to bf16 in registers and
//   is wgmma's A operand (register-sourced) for O += P V, with V as
//   loaded ([BK, D] rows, MN-major, the transpose bit) and N = DN; O stays
//   in f32 registers.  Two overlaps hide the softmax, which costs as much
//   as the products: inside a warpgroup, tile j's QK^T and tile j - 1's
//   PV are issued together and tile j's softmax waits only for the first
//   (FlashAttention-3's schedule); between the two warpgroups, named
//   barriers make them take turns to issue, so one's softmax runs under
//   the other's products.  The epilogue stores O / l as bf16 pairs for
//   rows below Sq.  The one deliberate change of arithmetic: P multiplies
//   V in bf16, as the JAX model's chunked_attention (p.astype(v.dtype))
//   and torch's SDPA do, while l sums the f32 p.  The kernel then lies
//   within 2^-8 |want| + 2^-8 max|v| of the f32 plain version (half an
//   ulp of the output, plus P's rounding, at most 2^-9 sum(p |v|) / l,
//   doubled as l is summed from unrounded p).
// * float32: CUDA cores (flash_attention_kernel), kept for the f32
//   checks, where tensor cores would not keep float32's digits.  Each of
//   the 256 threads owns a 4 x 4 block of the 64 x 64 score tile (rows
//   ty + 16 i, cols tx + 16 j) and the same 4 rows of the output, cols tx
//   + 16 j (j < NJ = ceil(D / 16), in registers); row maxima and sums
//   reduce over the 16 lanes of a half-warp with shuffles.  q and k tiles
//   sit in shared memory with an odd row stride (D + 1), so the 16 lanes
//   reading 16 k rows hit 16 banks.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;  // score rows per thread
constexpr int kCols = kBK / kTX;  // score cols per thread
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = kTX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = kTX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int hq, int hkv, int sq, int skv, int d,
    int q_offset, int causal, float scale) {
  extern __shared__ float smem[];
  const int ds = d + 1;
  float* qs = smem;              // [kBQ][ds]
  float* ks = qs + kBQ * ds;     // [kBK][ds]
  float* vs = ks + kBK * ds;     // [kBK][d]
  float* ps = vs + kBK * d;      // [kBQ][kBK]

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int kvh = b * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const T* qp = q + static_cast<long long>(bh) * sq * d;
  const T* kp = k + static_cast<long long>(kvh) * skv * d;
  const T* vp = v + static_cast<long long>(kvh) * skv * d;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    qs[r * ds + c] = q0 + r < sq
        ? to_f32(qp[static_cast<long long>(q0 + r) * d + c]) : 0.0f;
  }

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // Causal skip: k tiles starting after the q tile's last row.
  const int k_end = causal ? min(skv, q0 + q_offset + kBQ) : skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int kn = min(kBK, skv - k0);
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const long long src = static_cast<long long>(k0 + r) * d + c;
      ks[r * ds + c] = r < kn ? to_f32(kp[src]) : 0.0f;
      vs[r * d + c] = r < kn ? to_f32(vp[src]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    for (int e = 0; e < d; ++e) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kTY * i) * ds + e];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = ks[(tx + kTX * j) * ds + e];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + kTY * i + q_offset;
      bool ok[kCols];
      float m_cur = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + kTX * j;
        ok[j] = col < skv && (!causal || row >= col);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        m_cur = fmaxf(m_cur, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(m_cur));
      const float safe = m_new == kNegInf ? 0.0f : m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(s[i][j] - safe) : 0.0f;
        ps[(ty + kTY * i) * kBK + tx + kTX * j] = p;
        rs += p;
      }
      const float alpha = m[i] == kNegInf ? 0.0f : expf(m[i] - safe);
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kn; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + kTY * i) * kBK + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + kTX * j;
        if (c < d) {
          const float vv = vs[kk * d + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* op = out + static_cast<long long>(bh) * sq * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + kTY * i;
    if (r >= sq) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + kTX * j;
      if (c < d) store(&op[static_cast<long long>(r) * d + c], acc[i][j] / l_safe);
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int hq, int hkv, int sq, int skv, int d, int q_offset, int causal,
           float scale, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ + kBK) * (d + 1) + kBK * d + kBQ * kBK);
  cudaError_t err = repro::allow_smem(flash_attention_kernel<T, NJ>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * hq);
  flash_attention_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, sq, skv, d, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int batch,
             int hq, int hkv, int sq, int skv, int d, int q_offset, int causal,
             float scale, cudaStream_t stream) {
  const int nj = (d + kTX - 1) / kTX;
#define REPRO_FLASH_CASE(N)                                                   \
  if (nj <= N)                                                               \
    return launch<T, N>(q, k, v, out, batch, hq, hkv, sq, skv, d, q_offset,   \
                        causal, scale, stream);
  REPRO_FLASH_CASE(1)
  REPRO_FLASH_CASE(2)
  REPRO_FLASH_CASE(4)
  REPRO_FLASH_CASE(5)
  REPRO_FLASH_CASE(8)
  REPRO_FLASH_CASE(16)
#undef REPRO_FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---- bfloat16: wgmma on TMA-fed tiles ------------------------------------

namespace sm = repro::sm90;

constexpr int kWgRows = 64;                   // q rows per consumer warpgroup
constexpr int kWgBQ = 2 * kWgRows;            // q rows per CTA
constexpr int kConsumers = 2 * 128;           // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kBox = 64;                      // columns per TMA box
constexpr int kBoxRowBytes = kBox * 2;        // 128: the swizzle span
constexpr float kLog2e = 1.4426950408889634f;

template <int DN>
struct WgTile {
  static constexpr int kBK = DN <= 80 ? 128 : 64;
  static constexpr int kBoxes = (DN + kBox - 1) / kBox;
  static constexpr int kQBytes = kBoxes * kWgBQ * kBoxRowBytes;
  static constexpr int kKVBytes = kBoxes * kBK * kBoxRowBytes;  // k or v tile
  // Three k/v stages where they fit in the 227 KB a block may use (with
  // room for the alignment slack and the barriers), else two.
  static constexpr int kStages =
      kQBytes + 6 * kKVBytes + 2048 <= 232448 ? 3 : 2;
  // 1024 bytes of slack to align the swizzled tiles.
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x in one MUFU instruction (denormal results flush to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DN>
__global__ void __launch_bounds__(kWgThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out, int hq, int hkv, int sq, int skv, int d,
    int q_offset, int causal, float scale) {
  using T = WgTile<DN>;
  constexpr int BK = T::kBK;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + 4 * kStages];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  unsigned char* ks = qs + T::kQBytes;            // [stage][box][BK][128 B]
  unsigned char* vs = ks + kStages * T::kKVBytes;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int bh = blockIdx.y;
  const int kvh = bh / hq * hkv + bh % hq / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int k_end = causal ? min(skv, q0 + q_offset + kWgBQ) : skv;
  const int n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    sm::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm::mbar_init(k_full + s, 1);
      sm::mbar_init(v_full + s, 1);
      sm::mbar_init(k_empty + s, kConsumers);
      sm::mbar_init(v_empty + s, kConsumers);
    }
    sm::mbar_fence_init();
  }
  __syncthreads();

  // The role is uniform over each warp (a shuffle from lane 0), so ptxas
  // sees two register budgets, one per branch.
  const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (warpgroup == kConsumers / 128) {  // the producer warpgroup
    sm::reg_dealloc<24>();
    if (threadIdx.x == kConsumers) {
      sm::mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kBoxes; ++c)
        sm::tma_load_3d(qs + c * kWgBQ * kBoxRowBytes, &q_map, q_full,
                        c * kBox, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = (j / kStages - 1) & 1;
        unsigned char* kt = ks + s * T::kKVBytes;
        unsigned char* vt = vs + s * T::kKVBytes;
        if (j >= kStages) sm::mbar_wait(k_empty + s, parity);
        sm::mbar_expect_tx(k_full + s, T::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          sm::tma_load_3d(kt + c * BK * kBoxRowBytes, &k_map, k_full + s,
                          c * kBox, j * BK, kvh);
        if (j >= kStages) sm::mbar_wait(v_empty + s, parity);
        sm::mbar_expect_tx(v_full + s, T::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          sm::tma_load_3d(vt + c * BK * kBoxRowBytes, &v_map, v_full + s,
                          c * kBox, j * BK, kvh);
      }
    }
  } else {
    // A consumer warpgroup: 64 q rows; thread t holds rows `row` and row + 8
    // of the fragment, columns `col` and col + 1 of each 8-column block.
    // Tile j's S = Q K^T and tile j - 1's O += P V are in flight together
    // while the softmax of tile j waits only for S.
    sm::reg_alloc<240>();
    const int wg = warpgroup;
    const int lane = threadIdx.x % 32;
    const int row = q0 + wg * kWgRows + (threadIdx.x / 32) % 4 * 16 + lane / 4;
    const int col = lane % 4 * 2;
    const int first_pos = q0 + wg * kWgRows + q_offset;
    const float scale_log2 = scale * kLog2e;
    const uint64_t q_desc = sm::desc_b128(qs + wg * kWgRows * kBoxRowBytes,
                                          16, 1024);
    const uint64_t k_desc = sm::desc_b128(ks, 16, 1024);
    const uint64_t v_desc = sm::desc_b128(vs, BK * kBoxRowBytes, 1024);

    float o[DN / 2], s[BK / 2], alpha[2];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) o[i] = 0.0f;

    // S = Q K^T of tile j over DN / 16 steps of 16 columns (issued, not
    // waited for).
    auto issue_qk = [&](int j) {
      const int stage = j % kStages;
      sm::mbar_wait(k_full + stage, (j / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < DN / 16; ++kk) {
        const uint32_t in_box = kk % 4 * 32;
        const uint64_t qd =
            q_desc + ((kk / 4 * kWgBQ * kBoxRowBytes + in_box) >> 4);
        const uint64_t kd =
            k_desc + ((stage * T::kKVBytes + kk / 4 * BK * kBoxRowBytes +
                       in_box) >> 4);
        if (kk == 0)
          sm::Wgmma<BK>::ss_first(s, qd, kd);
        else
          sm::Wgmma<BK>::ss(s, qd, kd);
      }
      sm::wgmma_commit();
    };
    // O += P V of tile j over BK / 16 steps of 16 keys (issued).
    auto issue_pv = [&](int j) {
      const int stage = j % kStages;
      sm::mbar_wait(v_full + stage, (j / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm::Wgmma<DN>::rs(
            o, p[kk],
            v_desc + ((stage * T::kKVBytes + kk * 16 * kBoxRowBytes) >> 4));
      sm::wgmma_commit();
    };
    // The online softmax of tile j on S: scores in the log2 domain, masks
    // only where the tile crosses the causal diagonal of this
    // warpgroup's rows or the Skv edge; leaves p (f32) in s, updates m
    // and l, and sets alpha.
    auto softmax = [&](int j) {
      const int k0 = j * BK;
      // Four partial maxima and sums per row, so no dependent chain is
      // longer than BK / 32 steps.
      float mx[2][4], rs[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int g = 0; g < 4; ++g) mx[h][g] = kNegInf, rs[h][g] = 0.0f;
      if (k0 + BK > skv || (causal && k0 + BK - 1 > first_pos)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int c = k0 + i / 4 * 8 + col + i % 2;
          const int pos = row + i / 2 % 2 * 8 + q_offset;
          s[i] = c >= skv || (causal && c > pos) ? kNegInf : s[i] * scale_log2;
          mx[i / 2 % 2][i / 4 % 4] = fmaxf(mx[i / 2 % 2][i / 4 % 4], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] *= scale_log2;
          mx[i / 2 % 2][i / 4 % 4] = fmaxf(mx[i / 2 % 2][i / 4 % 4], s[i]);
        }
      }
      float safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_tile = fmaxf(fmaxf(mx[h][0], mx[h][1]),
                                   fmaxf(mx[h][2], mx[h][3]));
        const float m_new = fmaxf(m[h], quad_max(m_tile));
        safe[h] = m_new == kNegInf ? 0.0f : m_new;
        alpha[h] = m[h] == kNegInf ? 0.0f : fast_exp2(m[h] - safe[h]);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = fast_exp2(s[i] - safe[i / 2 % 2]);  // 0 where masked
        rs[i / 2 % 2][i / 4 % 4] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = alpha[h] * l[h] +
               ((rs[h][0] + rs[h][1]) + (rs[h][2] + rs[h][3]));
    };
    // P in bf16, in the A-fragment layout of wgmma (that of its
    // accumulator, two 8-column blocks per 16-key step).
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    };

    // The two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so one's softmax runs under the other's wgmma.
    auto turn_wait = [&]() { sm::bar_sync(1 + wg, kConsumers); };
    auto turn_pass = [&](bool last) {
      if (!(last && wg == 1)) sm::bar_arrive(2 - wg, kConsumers);
    };
    if (wg == 0) sm::bar_arrive(1, kConsumers);  // warpgroup 0 goes first

    sm::mbar_wait(q_full, 0);
    turn_wait();
    sm::wgmma_fence();
    issue_qk(0);
    turn_pass(false);
    sm::wgmma_wait<0>();
    sm::fence_regs(s);
    sm::mbar_arrive(k_empty);
    softmax(0);
    pack_p();
    for (int j = 1; j < n_tiles; ++j) {
      sm::fence_regs(o);
      turn_wait();
      sm::wgmma_fence();
      issue_qk(j);
      issue_pv(j - 1);
      turn_pass(false);
      sm::wgmma_wait<1>();
      sm::fence_regs(s);
      sm::mbar_arrive(k_empty + j % kStages);
      softmax(j);
      sm::wgmma_wait<0>();
      sm::fence_regs(o);
      sm::mbar_arrive(v_empty + (j - 1) % kStages);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) o[i] *= alpha[i / 2 % 2];
      pack_p();
    }
    sm::fence_regs(o);
    turn_wait();
    sm::wgmma_fence();
    issue_pv(n_tiles - 1);
    turn_pass(true);
    sm::wgmma_wait<0>();
    sm::fence_regs(o);

    __nv_bfloat16* op = out + static_cast<long long>(bh) * sq * d;
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
#pragma unroll
    for (int i = 0; i < DN / 2; i += 2) {
      const int h = i / 2 % 2;
      const int r = row + 8 * h;
      const int c = i / 4 * 8 + col;
      if (r < sq && c < d) {
        const bool none = l[h] == 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(
            &op[static_cast<long long>(r) * d + c]) = __floats2bfloat162_rn(
            none ? 0.0f : o[i] / l[h], none ? 0.0f : o[i + 1] / l[h]);
      }
    }
  }
}

template <int DN>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int batch, int hq, int hkv, int sq, int skv, int d,
                 int q_offset, int causal, float scale, cudaStream_t stream) {
  using T = WgTile<DN>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = sm::tma_map_bf16_3d(&q_map, q, d, sq, batch * hq, kWgBQ);
  if (err == cudaSuccess)
    err = sm::tma_map_bf16_3d(&k_map, k, d, skv, batch * hkv, T::kBK);
  if (err == cudaSuccess)
    err = sm::tma_map_bf16_3d(&v_map, v, d, skv, batch * hkv, T::kBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  static size_t allowed = 48 * 1024;
  err = repro::allow_smem(flash_attention_wgmma_kernel<DN>, T::kSmem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kWgBQ - 1) / kWgBQ, batch * hq);
  flash_attention_wgmma_kernel<DN><<<grid, kWgThreads, T::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), hq, hkv, sq, skv,
      d, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* out,
                   int batch, int hq, int hkv, int sq, int skv, int d,
                   int q_offset, int causal, float scale,
                   cudaStream_t stream) {
  if (skv == 0)  // no key: every row has l = 0, so every output is 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(__nv_bfloat16) * batch * hq * sq * d, stream));
  const int dn = (d + 15) / 16 * 16;
#define REPRO_FLASH_WG_CASE(N)                                               \
  if (dn == N)                                                               \
    return launch_wgmma<N>(q, k, v, out, batch, hq, hkv, sq, skv, d,          \
                           q_offset, causal, scale, stream);
  REPRO_FLASH_WG_CASE(16)
  REPRO_FLASH_WG_CASE(32)
  REPRO_FLASH_WG_CASE(48)
  REPRO_FLASH_WG_CASE(64)
  REPRO_FLASH_WG_CASE(80)
  REPRO_FLASH_WG_CASE(96)
  REPRO_FLASH_WG_CASE(112)
  REPRO_FLASH_WG_CASE(128)
  REPRO_FLASH_WG_CASE(144)
  REPRO_FLASH_WG_CASE(160)
  REPRO_FLASH_WG_CASE(176)
  REPRO_FLASH_WG_CASE(192)
  REPRO_FLASH_WG_CASE(208)
  REPRO_FLASH_WG_CASE(224)
  REPRO_FLASH_WG_CASE(240)
  REPRO_FLASH_WG_CASE(256)
#undef REPRO_FLASH_WG_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

// q [batch, hq, sq, d], k and v [batch, hkv, skv, d], out like q, all
// contiguous, of one type: dtype 0 = float32 (the CUDA-core kernel), 1 =
// bfloat16 (the tensor-core kernel; q, k and v 16-byte aligned for TMA).
// hq a multiple of hkv; d a multiple of 8, at most 256.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int batch, int hq,
    int hkv, int sq, int skv, int d, int q_offset, int causal, float scale,
    int dtype, void* stream) {
  if (batch == 0 || hq == 0 || sq == 0 || d == 0) return 0;
  if (d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, batch, hq, hkv, sq, skv, d, q_offset,
                           causal, scale, s);
  if (dtype == 1)
    return dispatch_wgmma(q, k, v, out, batch, hq, hkv, sq, skv, d, q_offset,
                          causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
