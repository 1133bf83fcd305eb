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
// after the causal diagonal of the q tile are skipped.  A sliding window
// (window > 0, zamba2's long-context path; the reference masks it in XLA,
// models/attention.py:147) also masks col <= q_offset + row - window, and
// each q tile starts its k loop at the first tile that meets the window
// of its first row, so a windowed prefill costs O(Sq window), not O(Sq
// Skv); tiles are masked only where they cross a window's edge.  Without
// the causal mask a row can see no key at all: it gives 0, as an empty
// row does.  The output has
// the input's type.  Handed an lse pointer (training), each design also
// writes every row's log-sum-exp in natural-log units, the backward's
// residual (flash_attention_bwd.cu): m + log l, or (m + log2 l) ln 2 from
// the bf16 design, whose scores are in the log2 domain; the minimum for a
// row with no valid key.  Serving passes a null pointer.
//
// Bound: operations, 4 * D per unmasked (query, key) pair and head
// against 2 (Sq + 2 Skv) D bytes per head: at the prefill shapes (Sq =
// Skv = 2048) some 500 operations per byte, above the H100's ~295 bf16
// tensor-core operations per byte of device memory; in float32 some 250
// per byte, above the ~49 of 3xTF32 (a third of the 495 T op/s of TF32).
// Two designs, chosen by the type alone:
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
// * float32: tensor cores in 3xTF32 (flash_attention_tf32x3_kernel<DN>,
//   DN = D rounded up to 16, 32, 64, 80, 96, 128, 192 or 256; columns past
//   D are zeros in shared memory, so the loops carry no runtime bound and
//   each product chain interleaves with the next).  A TF32 product keeps
//   11 bits of each factor, too few for float32's checks, so each operand
//   x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna's
//   rounding, hopper.cuh) and each product is three mma.sync m16n8k8 with
//   f32 sums, small terms first: lo hi, hi lo, hi hi (x kept to about
//   2^-22 |x|; the lo lo term and lo's own rounding are below that).  One
//   CTA of four warps owns 64 q rows, 16 per warp (FlashAttention-2's
//   split: nothing is exchanged between warps).  Each warp splits its q
//   rows once into A fragments in shared memory.  k and v tiles of BK keys
//   (32 for DN <= 80, 16 to 128, else 8: two CTAs on an SM up to DN 96)
//   land raw by cp.async, the next tile's copies in flight during this
//   one's products; the CTA then splits each tile once for its four warps
//   into B fragments laid out as a lane reads them, hi, hi, lo, lo in 16
//   bytes, so each three-product step is one shared load.  S = Q K^T runs
//   DN / 8 k-steps whose columns are permuted alike in Q and K (k-index t
//   is column 2t, t + 4 is 2t + 1), so a lane's raw k pair is one 8-byte
//   read; raw k rows are DN | 8 floats apart and raw v rows DN + 4 (the
//   split's reads hit 32 banks per half-warp).  The online softmax runs on
//   the S fragment in registers: row max and sum over the quad of lanes
//   that holds a row, masks only on tiles that cross the causal diagonal
//   or the Skv edge, expf as the plain version, l kept per thread until
//   the end.  The fragment is then P's A operand for O += P V as it
//   stands: lane (g, t) holds keys 2t and 2t + 1 of each 8, taken as
//   k-indices t and t + 4, and v's fragments are split in that key order,
//   so P needs no shuffle and no trip through shared memory.  A warp whose
//   rows all lie before a tile's first key, or past Sq, skips the tile's
//   products.  O stays in f32 registers (DN / 2 a thread); the epilogue
//   stores O / l as float2 for rows below Sq and columns below D.
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__global__ void fill_kernel(float* __restrict__ x, long long n, float value) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) x[i] = value;
}

// Skv = 0: every row has l = 0, so every output is 0 and every lse the
// minimum.
int no_key(void* out, size_t elem, float* lse, int batch, int hq, int sq,
           int d, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, elem * batch * hq * sq * static_cast<size_t>(d), stream);
  if (err != cudaSuccess || lse == nullptr) return static_cast<int>(err);
  const long long n = static_cast<long long>(batch) * hq * sq;
  fill_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      lse, n, kNegInf);
  return static_cast<int>(cudaGetLastError());
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
constexpr float kLn2 = 0.6931471805599453f;

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
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int hq,
    int hkv, int sq, int skv, int d, int q_offset, int causal, float scale,
    int window) {
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
  // The first tile that meets the window of the CTA's first row; a CTA
  // whose rows see no key at all (no causal mask) still runs its last
  // tile, wholly masked, so that every row gives 0.
  const int j0 =
      window > 0 ? min(max(0, q0 + q_offset - window + 1) / BK, n_tiles - 1)
                 : 0;

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
      for (int j = j0; j < n_tiles; ++j) {
        const int jj = j - j0;  // the ring counts tiles from j0
        const int s = jj % kStages;
        const uint32_t parity = (jj / kStages - 1) & 1;
        unsigned char* kt = ks + s * T::kKVBytes;
        unsigned char* vt = vs + s * T::kKVBytes;
        if (jj >= kStages) sm::mbar_wait(k_empty + s, parity);
        sm::mbar_expect_tx(k_full + s, T::kKVBytes);
        for (int c = 0; c < T::kBoxes; ++c)
          sm::tma_load_3d(kt + c * BK * kBoxRowBytes, &k_map, k_full + s,
                          c * kBox, j * BK, kvh);
        if (jj >= kStages) sm::mbar_wait(v_empty + s, parity);
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
      const int stage = (j - j0) % kStages;
      sm::mbar_wait(k_full + stage, ((j - j0) / kStages) & 1);
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
      const int stage = (j - j0) % kStages;
      sm::mbar_wait(v_full + stage, ((j - j0) / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm::Wgmma<DN>::rs(
            o, p[kk],
            v_desc + ((stage * T::kKVBytes + kk * 16 * kBoxRowBytes) >> 4));
      sm::wgmma_commit();
    };
    // The online softmax of tile j on S: scores in the log2 domain, masks
    // only where the tile crosses the causal diagonal of this
    // warpgroup's rows, a window's edge or the Skv edge; leaves p (f32)
    // in s, updates m and l, and sets alpha.
    auto softmax = [&](int j) {
      const int k0 = j * BK;
      // Four partial maxima and sums per row, so no dependent chain is
      // longer than BK / 32 steps.
      float mx[2][4], rs[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int g = 0; g < 4; ++g) mx[h][g] = kNegInf, rs[h][g] = 0.0f;
      if (k0 + BK > skv || (causal && k0 + BK - 1 > first_pos) ||
          (window > 0 && k0 <= first_pos + kWgRows - 1 - window)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int c = k0 + i / 4 * 8 + col + i % 2;
          const int pos = row + i / 2 % 2 * 8 + q_offset;
          s[i] = c >= skv || (causal && c > pos) ||
                         (window > 0 && pos - c >= window)
                     ? kNegInf
                     : s[i] * scale_log2;
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
    issue_qk(j0);
    turn_pass(false);
    sm::wgmma_wait<0>();
    sm::fence_regs(s);
    sm::mbar_arrive(k_empty);
    softmax(j0);
    pack_p();
    for (int j = j0 + 1; j < n_tiles; ++j) {
      sm::fence_regs(o);
      turn_wait();
      sm::wgmma_fence();
      issue_qk(j);
      issue_pv(j - 1);
      turn_pass(false);
      sm::wgmma_wait<1>();
      sm::fence_regs(s);
      sm::mbar_arrive(k_empty + (j - j0) % kStages);
      softmax(j);
      sm::wgmma_wait<0>();
      sm::fence_regs(o);
      sm::mbar_arrive(v_empty + (j - 1 - j0) % kStages);
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
    // The scores were in the log2 domain: lse = (m + log2 l) ln 2.
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (row + 8 * h < sq)
          lse[static_cast<long long>(bh) * sq + row + 8 * h] =
              l[h] == 0.0f ? kNegInf : (m[h] + log2f(l[h])) * kLn2;
    }
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
                 float* lse, int batch, int hq, int hkv, int sq, int skv,
                 int d, int q_offset, int causal, float scale, int window,
                 cudaStream_t stream) {
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
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, hq, hkv, sq,
      skv, d, q_offset, causal, scale, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int hq, int hkv, int sq, int skv,
                   int d, int q_offset, int causal, float scale, int window,
                   cudaStream_t stream) {
  if (skv == 0)  // no key: every row has l = 0, so every output is 0
    return no_key(out, sizeof(__nv_bfloat16), lse, batch, hq, sq, d, stream);
  const int dn = (d + 15) / 16 * 16;
#define REPRO_FLASH_WG_CASE(N)                                               \
  if (dn == N)                                                               \
    return launch_wgmma<N>(q, k, v, out, lse, batch, hq, hkv, sq, skv, d,     \
                           q_offset, causal, scale, window, stream);
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

// ---- float32: 3xTF32 on mma.sync -----------------------------------------

constexpr int kTfWarps = 4;
constexpr int kTfBQ = 16 * kTfWarps;  // q rows per CTA, 16 per warp
constexpr int kTfThreads = 32 * kTfWarps;

// A lane's 16 bytes of a split fragment: hi, hi, lo, lo of two values, or
// the four hi (or lo) values of an A fragment.
struct alignas(16) TfFrag {
  uint32_t x[4];
};

template <int DN>
struct TfTile {
  static constexpr int kNT = DN / 8;  // column blocks of 8
  // Keys per k/v tile: as many as keep two CTAs on an SM up to DN 96 (at
  // DN 80, BK 64 leaves room for one and ran slower).
  static constexpr int kBK = DN <= 80 ? 32 : DN <= 128 ? 16 : 8;
  static constexpr int kLdk = DN | 8;  // raw k row stride, 8 mod 16
  static constexpr int kLdv = DN + 4;  // raw v row stride, 4 mod 8
  // Shared memory, in TfFrag: q's A fragments [warp][kk][hi, lo][lane],
  // k's B fragments [kk][n][lane], v's [kc][n][lane], then the raw k and
  // v tiles as cp.async lands them.
  static constexpr int kQFrags = kTfWarps * kNT * 2 * 32;
  static constexpr int kKFrags = kNT * (kBK / 8) * 32;
  static constexpr int kRawFloats = kBK * (kLdk + kLdv);
  static constexpr int kSmem =
      16 * (kQFrags + 2 * kKFrags) + 4 * kRawFloats;
};

template <int DN>
__global__ void __launch_bounds__(kTfThreads) flash_attention_tf32x3_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int hq, int hkv, int sq, int skv, int d,
    int q_offset, int causal, float scale, int window) {
  using T = TfTile<DN>;
  constexpr int NT = T::kNT;
  constexpr int BK = T::kBK;
  extern __shared__ TfFrag tf_smem[];
  TfFrag* qf = tf_smem;
  TfFrag* kf = qf + T::kQFrags;
  TfFrag* vf = kf + T::kKFrags;
  float* kraw = reinterpret_cast<float*>(vf + T::kKFrags);
  float* vraw = kraw + BK * T::kLdk;

  const int bh = blockIdx.y;
  const int kvh = bh / hq * hkv + bh % hq / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTfBQ;
  const int k_end = causal ? min(skv, q0 + q_offset + kTfBQ) : skv;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;
  // The first tile that meets the window of the CTA's first row.
  const int j0 = window > 0 ? max(0, q0 + q_offset - window + 1) / BK : 0;
  const int nt = d / 8;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int first = q0 + 16 * warp;  // the warp's first row
  const int row = first + g;         // this thread's rows: row, row + 8
  const float* kp = k + static_cast<long long>(kvh) * skv * d;
  const float* vp = v + static_cast<long long>(kvh) * skv * d;

  // The raw k and v rows of tile j, DN columns: zeros past Skv and past
  // d (their source clamped to an element that exists).
  auto load_kv = [&](int j) {
#pragma unroll
    for (int i0 = 0; i0 < BK * DN / 4; i0 += kTfThreads) {
      const int i = i0 + tid;
      if (i >= BK * DN / 4) break;
      const int r = i / (DN / 4), c = 4 * (i % (DN / 4));
      const bool in = j * BK + r < skv && c < d;
      const long long src =
          static_cast<long long>(min(j * BK + r, skv - 1)) * d + (in ? c : 0);
      sm::cp_async<16>(kraw + r * T::kLdk + c, kp + src, in ? 16 : 0);
      sm::cp_async<16>(vraw + r * T::kLdv + c, vp + src, in ? 16 : 0);
    }
    sm::cp_async_commit();
  };
  if (j0 < n_tiles) load_kv(j0);

  // Each warp splits its own q rows once, into A fragments: k-step kk
  // takes columns 8 kk + 2t and + 1 as k-indices t and t + 4 (k is
  // permuted alike below, so the product is unchanged); zeros past d.
  for (int kk = 0; kk < NT; ++kk) {
    float2 qv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qv[h] = row + 8 * h < sq && kk < nt
          ? *reinterpret_cast<const float2*>(
                q + (static_cast<long long>(bh) * sq + row + 8 * h) * d +
                8 * kk + 2 * t)
          : make_float2(0.0f, 0.0f);
    TfFrag hi, lo;
    sm::split_tf32(qv[0].x, hi.x[0], lo.x[0]);
    sm::split_tf32(qv[1].x, hi.x[1], lo.x[1]);
    sm::split_tf32(qv[0].y, hi.x[2], lo.x[2]);
    sm::split_tf32(qv[1].y, hi.x[3], lo.x[3]);
    qf[((warp * NT + kk) * 2) * 32 + lane] = hi;
    qf[((warp * NT + kk) * 2 + 1) * 32 + lane] = lo;
  }

  float o[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int j = j0; j < n_tiles; ++j) {
    sm::cp_async_wait_all();
    __syncthreads();  // raw tile j has landed; every warp is done with j - 1
    // Split the tile once for all four warps, into the B fragments as a
    // lane reads them (one 16-byte load for the three products).  k: lane
    // (g, t) of block (kk, n) holds key 8n + g, columns 8 kk + 2t, + 1.
    // v: lane (g, t) of block (kc, n) holds keys 8 kc + 2t, + 1 (P's
    // permuted k-indices t, t + 4), column 8n + g.
#pragma unroll
    for (int r0 = 0; r0 < BK / 8 * NT; r0 += kTfWarps) {
      const int r = r0 + warp;
      if (r >= BK / 8 * NT) break;
      const int n = r / NT, kk = r % NT;
      const float2 kv = *reinterpret_cast<const float2*>(
          kraw + (8 * n + g) * T::kLdk + 8 * kk + 2 * t);
      TfFrag f;
      sm::split_tf32(kv.x, f.x[0], f.x[2]);
      sm::split_tf32(kv.y, f.x[1], f.x[3]);
      kf[(kk * (BK / 8) + n) * 32 + lane] = f;
      const float* vr = vraw + (8 * n + 2 * t) * T::kLdv + 8 * kk + g;
      sm::split_tf32(vr[0], f.x[0], f.x[2]);
      sm::split_tf32(vr[T::kLdv], f.x[1], f.x[3]);
      vf[(n * NT + kk) * 32 + lane] = f;
    }
    __syncthreads();  // the fragments are in; the raw tile is free
    if (j + 1 < n_tiles) load_kv(j + 1);
    const int k0 = j * BK;
    // A tile wholly after the warp's rows or before their windows, or a
    // warp wholly past Sq.
    if (first >= sq || (causal && k0 > first + 15 + q_offset) ||
        (window > 0 && k0 + BK - 1 <= first + q_offset - window))
      continue;

    // S = Q K^T.
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const TfFrag a_hi = qf[((warp * NT + kk) * 2) * 32 + lane];
      const TfFrag a_lo = qf[((warp * NT + kk) * 2 + 1) * 32 + lane];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const TfFrag b = kf[(kk * (BK / 8) + n) * 32 + lane];
        sm::mma_tf32x3(s[n], a_hi.x, a_lo.x, {b.x[0], b.x[1]},
                       {b.x[2], b.x[3]});
      }
    }

    // The online softmax on the fragment: s[n][e] is row row + 8 (e / 2),
    // key k0 + 8n + 2t + e % 2; p = exp(s - safe) is 0 where masked.
    const bool edge =
        k0 + BK > skv || (causal && k0 + BK - 1 > first + q_offset) ||
        (window > 0 && k0 <= first + 15 + q_offset - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * n + 2 * t + e % 2;
        const int pos = row + 8 * (e / 2) + q_offset;
        const bool ok = !edge || (c < skv && (!causal || c <= pos) &&
                                  (window <= 0 || pos - c < window));
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
        mx[e / 2] = fmaxf(mx[e / 2], s[n][e]);
      }
    float safe[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      safe[h] = m_new == kNegInf ? 0.0f : m_new;
      alpha[h] = m[h] == kNegInf ? 0.0f : expf(m[h] - safe[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - safe[e / 2]);
        l[e / 2] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];

    // O += P V: P's A fragment is the S fragment as it stands (keys 2t and
    // 2t + 1 of chunk kc as k-indices t and t + 4).
#pragma unroll
    for (int kc = 0; kc < BK / 8; ++kc) {
      uint32_t a_hi[4], a_lo[4];
      sm::split_tf32(s[kc][0], a_hi[0], a_lo[0]);
      sm::split_tf32(s[kc][2], a_hi[1], a_lo[1]);
      sm::split_tf32(s[kc][1], a_hi[2], a_lo[2]);
      sm::split_tf32(s[kc][3], a_hi[3], a_lo[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const TfFrag b = vf[(kc * NT + n) * 32 + lane];
        sm::mma_tf32x3(o[n], a_hi, a_lo, {b.x[0], b.x[1]}, {b.x[2], b.x[3]});
      }
    }
  }

  float* op = out + static_cast<long long>(bh) * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    const int r = row + 8 * h;
    if (r >= sq) continue;
    const bool none = l[h] == 0.0f;
    if (lse != nullptr && t == 0)
      lse[static_cast<long long>(bh) * sq + r] =
          none ? kNegInf : m[h] + logf(l[h]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nt)
        *reinterpret_cast<float2*>(&op[static_cast<long long>(r) * d + 8 * n +
                                       2 * t]) =
            make_float2(none ? 0.0f : o[n][2 * h] / l[h],
                        none ? 0.0f : o[n][2 * h + 1] / l[h]);
  }
}

template <int DN>
int launch_tf32x3(const void* q, const void* k, const void* v, void* out,
                  float* lse, int batch, int hq, int hkv, int sq, int skv,
                  int d, int q_offset, int causal, float scale, int window,
                  cudaStream_t stream) {
  using T = TfTile<DN>;
  static size_t allowed = 48 * 1024;
  cudaError_t err =
      repro::allow_smem(flash_attention_tf32x3_kernel<DN>, T::kSmem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTfBQ - 1) / kTfBQ, batch * hq);
  flash_attention_tf32x3_kernel<DN><<<grid, kTfThreads, T::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, hq, hkv,
      sq, skv, d, q_offset, causal, scale, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tf32x3(const void* q, const void* k, const void* v, void* out,
                    float* lse, int batch, int hq, int hkv, int sq, int skv,
                    int d, int q_offset, int causal, float scale, int window,
                    cudaStream_t stream) {
  if (skv == 0)  // no key: every row has l = 0, so every output is 0
    return no_key(out, sizeof(float), lse, batch, hq, sq, d, stream);
#define REPRO_FLASH_TF_CASE(N)                                               \
  if (d <= N)                                                                \
    return launch_tf32x3<N>(q, k, v, out, lse, batch, hq, hkv, sq, skv, d,    \
                            q_offset, causal, scale, window, stream);
  REPRO_FLASH_TF_CASE(16)
  REPRO_FLASH_TF_CASE(32)
  REPRO_FLASH_TF_CASE(64)
  REPRO_FLASH_TF_CASE(80)
  REPRO_FLASH_TF_CASE(96)
  REPRO_FLASH_TF_CASE(128)
  REPRO_FLASH_TF_CASE(192)
  REPRO_FLASH_TF_CASE(256)
#undef REPRO_FLASH_TF_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

// q [batch, hq, sq, d], k and v [batch, hkv, skv, d], out like q, all
// contiguous, of one type: dtype 0 = float32 (3xTF32 on mma.sync; q, k
// and v 16-byte aligned for cp.async), 1 = bfloat16 (wgmma; q, k and v
// 16-byte aligned for TMA).
// hq a multiple of hkv; d a multiple of 8, at most 256.  lse, when not
// null, receives each row's log-sum-exp of the scaled scores in natural
// log units, float32 [batch, hq, sq] (finfo(float32).min for a row with
// no valid key): the residual of the backward (flash_attention_bwd.cu).
// window > 0: query row i (position q_offset + i) sees keys j with
// q_offset + i - j < window only; 0: no window.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int hq, int hkv, int sq, int skv, int d, int q_offset,
    int causal, float scale, int dtype, int window, void* stream) {
  if (batch == 0 || hq == 0 || sq == 0 || d == 0) return 0;
  if (d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch_tf32x3(q, k, v, out, lse_f, batch, hq, hkv, sq, skv, d,
                           q_offset, causal, scale, window, s);
  if (dtype == 1)
    return dispatch_wgmma(q, k, v, out, lse_f, batch, hq, hkv, sq, skv, d,
                          q_offset, causal, scale, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
