// flash_attention: causal (or full) grouped-query attention with an online
// softmax, never materialising the [Sq, Skv] score matrix.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/kernel.py, _kernel).  The TPU kernel
// walked a sequential grid axis over k/v blocks with (m, l, acc) in VMEM
// scratch, and its wrapper padded Sq and Skv to 128.  Here one CTA owns
// one (batch * q head, 64-row q tile) and loops over 64-row k/v tiles
// itself; the ragged edges (any Sq, Skv) are masked inside the kernel, so
// nothing is padded.  The q head h reads kv head h / group (GQA) straight
// from the k/v layout; no repeated copy of k and v exists.
//
// Semantics, as the TPU kernel's: scores s = (q . k) * scale in f32;
// masked entries (col >= Skv, or col > q_offset + row when causal) are
// finfo(float32).min, not -inf; m_new = max(m, rowmax(s)); a row whose
// maximum is still that minimum uses 0 in its place; p = exp(s - m_new),
// set to 0 where masked; alpha = exp(m - m_new) (0 while m is the
// minimum); l = alpha * l + sum(p); acc = alpha * acc + p . v with v in
// f32; out = acc / l, with l = 0 (a row with no valid key) giving 0.  k
// tiles wholly after the causal diagonal of the q tile are skipped.  The
// output has the input's type (f32 or bf16); all arithmetic is f32.
//
// Bound: operations.  4 * Sq * Skv * D flops per head (half with the
// causal skip) against (3 Sq + ...) * D elements moved; at the prefill
// shapes the tensor-core rate would bound it, but this first kernel runs
// f32 FMAs on the CUDA cores.  Design: each of the 256 threads owns a 4 x
// 4 block of the 64 x 64 score tile (rows ty + 16 i, cols tx + 16 j) and
// the same 4 rows of the output, cols tx + 16 j (j < NJ = ceil(D / 16),
// in registers); row maxima and sums reduce over the 16 lanes of a
// half-warp with shuffles.  q and k tiles sit in shared memory with an
// odd row stride (D + 1), so the 16 lanes reading 16 k rows hit 16
// banks.  q tiles run in reverse order, so the long causal rows start
// first.  wgmma and TMA are later work.
#include <cuda_bf16.h>

#include "common.cuh"

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

}  // namespace

// q [batch, hq, sq, d], k and v [batch, hkv, skv, d], out like q, all
// contiguous, of one type: dtype 0 = float32, 1 = bfloat16.  hq a
// multiple of hkv; d a multiple of 8, at most 256.
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
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, hq, hkv, sq, skv, d,
                                   q_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
