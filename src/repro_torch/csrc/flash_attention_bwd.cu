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
// ~295 bf16 tensor-core flops per byte; this design spends seven products
// (S and dP are recomputed in both kernels) on CUDA cores, so the f32 rate
// bounds it.
//
// Design: a first, simple kernel pair.  Tiles are float32 in shared memory
// (zero past D, Sq and Skv) and every product is FMA on CUDA cores in
// f32, which is exact f32 accumulation and so also keeps the accuracy of
// the f32 forward's 3xTF32; mma.sync, wgmma and TMA are for a later PR.
// * flash_attention_bwd_dq_kernel: one CTA per (b, query head, tile of BX
//   queries; the long causal rows first).  It loads its q and dO rows
//   once, computes delta from O and dO (and stores it for the second
//   kernel), then walks the k/v tiles of BY keys that the causal mask
//   leaves: S and dP, then dS into shared memory, then dQ += dS K, dQ in
//   registers.
// * flash_attention_bwd_dkdv_kernel: one CTA per (b, kv head, tile of BX
//   keys), launched after the first on the same stream.  It loads its k
//   and v rows once, then walks the g query heads of its group and, in
//   each, the q tiles of BY queries that the causal mask does not skip: S
//   and dP, then p and dS into shared memory, then dV += p^T dO and dK +=
//   dS^T Q, both in registers: no atomics, no second pass.
// Both share one thread layout.  For S and dP a thread owns one x (a key,
// or a query) and BY / (256 / BX) of the tile's y rows: its x row is read
// as float4 from a tile whose row stride DN + 4 spreads a quarter-warp
// over all 32 banks, and the y rows are the same for the whole warp
// (broadcast).  For the accumulation a thread owns BX / 16 consecutive
// rows x and DN / 16 columns c strided by 16, so a half-warp reads 16
// consecutive floats of a row.  DN is D rounded up to 16, 32, 64, 80, 96,
// 128, 192 or 256; BX = 64 up to DN 128, else 32; BY = 32.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min
constexpr int kThreads = 256;

template <int DN>
struct BwdTile {
  static constexpr int kBX = DN <= 128 ? 64 : 32;  // rows a CTA owns
  static constexpr int kBY = 32;                   // rows of a loop tile
  static constexpr int kLd = DN + 4;               // row stride in floats
  static constexpr int kRY = kBY / (kThreads / kBX);  // y rows a thread
  static constexpr int kRX = kBX / 16;             // x rows a thread
  static constexpr int kCols = DN / 16;            // columns a thread
};

// Conversions between an element type and float32.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  // Eight consecutive elements (32-byte aligned).
  static __device__ __forceinline__ void load8(const float* p, float4& a,
                                               float4& b) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  // Eight consecutive elements (16-byte aligned).
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                               float4& a, float4& b) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    a = make_float4(f0.x, f0.y, f1.x, f1.y);
    b = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
  // x rounded to bf16 (to nearest even, as astype and .to do), as float.
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
};

// Rows [row0, row0 + R) of a row-major [n_rows, d] matrix into dst [R][DN
// + 4] as float32: zeros past n_rows and past d (a multiple of 8).
template <typename T, int R, int DN>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int n_rows, int d) {
  constexpr int kChunks = DN / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks * 8;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (row0 + r < n_rows && c < d)
      Elem<T>::load8(src + static_cast<long long>(row0 + r) * d + c, a, b);
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

// Is (query qi, key kj) unmasked, on a row whose lse says it has a key?
__device__ __forceinline__ bool valid(int qi, int kj, int sq, int skv,
                                      float lse, int q_offset, int causal) {
  return qi < sq && kj < skv && lse > 0.5f * kNegInf &&
         (!causal || kj <= qi + q_offset);
}

template <typename T, int DN>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    T* __restrict__ dq, int hq, int hkv, int sq, int skv, int d, int q_offset,
    int causal, float scale) {
  using B = BwdTile<DN>;
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
  load_tile<T, BX, DN>(qs, q + row_base * d, q0, sq, d);
  load_tile<T, BX, DN>(dos, dout + row_base * d, q0, sq, d);
  __syncthreads();

  // delta = rowsum(dO * O) and lse of the tile's rows: a warp per row, a
  // lane per 8 columns.
  for (int r = tid / 32; r < BX; r += kThreads / 32) {
    const int qi = q0 + r, c = tid % 32 * 8;
    float acc = 0.0f;
    if (qi < sq && c < d) {
      float4 a, b;
      Elem<T>::load8(out + (row_base + qi) * d + c, a, b);
      const float* g = dos + r * LD + c;
      acc = dot4(dot4(0.0f, a, *reinterpret_cast<const float4*>(g)), b,
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

  const T* kh = k + kvh * skv * d;
  const T* vh = v + kvh * skv * d;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the last tile's readers are done; delta is in
    load_tile<T, BY, DN>(ks, kh, j * BY, skv, d);
    load_tile<T, BY, DN>(vs, vh, j * BY, skv, d);
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
      dss[(y_first + r) * BX + x] = Elem<T>::round(p * (dp[r] - dl) * scale);
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
      if (c < d) dq[(row_base + qi) * d + c] = Elem<T>::from(acc[r][m]);
    }
  }
}

template <typename T, int DN>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int hq, int hkv, int sq, int skv, int d, int q_offset, int causal,
    float scale) {
  using B = BwdTile<DN>;
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
  load_tile<T, BX, DN>(ks, k + kv_base * d, k0, skv, d);
  load_tile<T, BX, DN>(vs, v + kv_base * d, k0, skv, d);

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
      load_tile<T, BY, DN>(qs, q + row_base * d, y0, sq, d);
      load_tile<T, BY, DN>(dos, dout + row_base * d, y0, sq, d);
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
        ps[yl * BX + x] = Elem<T>::round(p);
        dss[yl * BX + x] = Elem<T>::round(p * (dp[r] - deltas[yl]) * scale);
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
        dk[(kv_base + kj) * d + c] = Elem<T>::from(acc_k[r][m]);
        dv[(kv_base + kj) * d + c] = Elem<T>::from(acc_v[r][m]);
      }
    }
  }
}

template <typename T, int DN>
int launch_bwd(const void* q, const void* k, const void* v, const void* out,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int batch, int hq, int hkv, int sq,
               int skv, int d, int q_offset, int causal, float scale,
               cudaStream_t stream) {
  using B = BwdTile<DN>;
  constexpr int BX = B::kBX, BY = B::kBY, LD = B::kLd;
  constexpr size_t kDqSmem = sizeof(float) * (2 * (BX + BY) * LD + BY * BX +
                                              2 * BX);
  constexpr size_t kDkvSmem = sizeof(float) * (2 * (BX + BY) * LD +
                                               2 * BY * BX + 2 * BY);
  static size_t dq_allowed = 48 * 1024, dkv_allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(flash_attention_bwd_dq_kernel<T, DN>,
                                      kDqSmem, dq_allowed);
  if (err == cudaSuccess)
    err = repro::allow_smem(flash_attention_bwd_dkdv_kernel<T, DN>, kDkvSmem,
                            dkv_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  if (sq > 0) {
    const dim3 grid((sq + BX - 1) / BX, batch * hq);
    flash_attention_bwd_dq_kernel<T, DN><<<grid, kThreads, kDqSmem, stream>>>(
        qt, kt, vt, static_cast<const T*>(out), dot, lse, delta,
        static_cast<T*>(dq), hq, hkv, sq, skv, d, q_offset, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (skv > 0) {
    const dim3 grid((skv + BX - 1) / BX, batch * hkv);
    flash_attention_bwd_dkdv_kernel<T, DN>
        <<<grid, kThreads, kDkvSmem, stream>>>(
            qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
            static_cast<T*>(dv), hq, hkv, sq, skv, d, q_offset, causal,
            scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int batch, int hq, int hkv, int sq,
                 int skv, int d, int q_offset, int causal, float scale,
                 cudaStream_t stream) {
#define REPRO_FLASH_BWD_CASE(N)                                               \
  if (d <= N)                                                                 \
    return launch_bwd<T, N>(q, k, v, out, dout, lse, delta, dq, dk, dv,       \
                            batch, hq, hkv, sq, skv, d, q_offset, causal,     \
                            scale, stream);
  REPRO_FLASH_BWD_CASE(16)
  REPRO_FLASH_BWD_CASE(32)
  REPRO_FLASH_BWD_CASE(64)
  REPRO_FLASH_BWD_CASE(80)
  REPRO_FLASH_BWD_CASE(96)
  REPRO_FLASH_BWD_CASE(128)
  REPRO_FLASH_BWD_CASE(192)
  REPRO_FLASH_BWD_CASE(256)
#undef REPRO_FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out, dout and dq [batch, hq, sq, d]; k, v, dk and dv [batch, hkv, skv,
// d]; all contiguous and 16-byte aligned, of one type: dtype 0 = float32,
// 1 = bfloat16.  lse [batch, hq, sq] float32 from flash_attention_launch;
// delta [batch, hq, sq] float32 scratch (written by the first kernel, read
// by the second).  hq a multiple of hkv; d a multiple of 8, at most 256.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int sq, int skv, int d,
    int q_offset, int causal, float scale, int dtype, void* stream) {
  if (batch == 0 || hq == 0 || d == 0) return 0;
  if (d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0)
    return dispatch_bwd<float>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv,
                               batch, hq, hkv, sq, skv, d, q_offset, causal,
                               scale, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, lse_f, delta_f, dq,
                                       dk, dv, batch, hq, hkv, sq, skv, d,
                                       q_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
