// ssm_scan_bwd: the gradient of the selective-SSM scan (ssm_scan.cu),
//   h_t = e_t * h_{t-1} + u_t B_t,  e_t = exp(dt_t A),  u_t = dt_t x_t,
//   y_t = h_t . C_t + D * x_t,                        h_0 = 0,
// given dy [B, T, di] and, optionally, dh_T [B, di, N].  Walking back in
// time with g_t = dL/dh_t:
//   g_t = C_t dy_t + e_{t+1} * g_{t+1}          (g past the end: dh_T)
//   dC_t[n] = sum_d dy_t[d] h_t[d, n]    dB_t[n] = sum_d u_t[d] g_t[d, n]
//   du_t[d] = sum_n g_t[d, n] B_t[n]     q_t = g_t * h_{t-1} * e_t
//   ddt_t[d] = du_t[d] x_t[d] + sum_n q_t[d, n] A[d, n]
//   dx_t[d] = du_t[d] dt_t[d] + dy_t[d] D[d]
//   dA[d, n] = sum_{b,t} q_t[d, n] dt_t[d]     dD[d] = sum_{b,t} dy_t x_t
// (kernels/ssm_scan/ref.py: ssm_scan_bwd_ref).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the lax.scan in scan_chunked (src/repro/models/ssm.py), and this kernel
// computes what that gives.
//
// Bound: operations.  Per state element and step the backward recomputes
// h (FMUL, FFMA) and then updates g (FMUL, FFMA) and sums q dt, q A, g B,
// u g and dy h (an FMUL and five FFMA): 17 operations; a general row of A
// adds dt A, its exp and two products (chip_smoke.py counts 21 N + 7 a
// channel and step).  At falcon-mamba-7b's training shape that is 0.086
// ms of the H100's FP32 rate, about what its bytes take; the chunk form
// reaches about 0.14 of it there, the walk form 0.047 (PERF.md, row 9b).
//
// Two forms, routed by N (kernels/ssm_scan/ops.py: ssm_scan_bwd):
//
// The chunk form (N <= 64; ssm_scan_bwd_chunks_launch).  Chunk-parallel
// over the forward's checkpoints (h_chunks, the state before every
// kChunk = 64 steps).  Within chunk c (steps t0 .. t1 - 1) g is the
// chunk's own part, walked back from a zero carry, plus the carry K_c =
// e_{t1} g_{t1} passed through the chunk's decays:
//   g_t = gl_t + (prod_{t < r < t1} e_r) K_c,
//   K_{c-1} = L_c + M_c K_c,  K_{last} = dh_T (or 0), where
//   L_c = sum_{t0 <= s < t1} (prod_{t0 <= r <= s} e_r) C_s dy_s,
//   M_c = exp(A sum_{t0 <= s < t1} dt_s).
//   * The carry kernel: a block per (group of channels, chunk c >= 1,
//     batch row) runs forward over its chunk once, with the prefix product
//     of e, and writes L_c [B, chunks, di, N] and the chunk's sum of dt
//     [B, chunks, di].  One exponential a state element and step.
//   * The chunk kernel: a block per (group of channels, chunk, batch row)
//     folds the summaries of the chunks after its own, from the last, in
//     that fixed order (one exponential and one FMA a state and chunk),
//     into g at its chunk's end.  It runs forward from the checkpoint over
//     its chunk's tiles of kTB = 8 steps but the last, keeping each tile's
//     start in shared memory; then, from the last tile to the first, it
//     recomputes the tile's 8 states h_{t-1} and their e_t into registers
//     and walks the tile back with them: the walk takes no exponential of
//     its own.  No state is got by dividing by e (e underflows where dt A
//     is very negative).  The exponentials are 2^(dt (A log2 e)) by
//     ex2.approx.ftz (kExp2 below).
//   * Lanes.  A lane holds 4 states (n = 4 g + j) of one channel, G = Np /
//     4 lanes a channel (Np: N padded to 4, 8, 16, 32 or 64), 8 warps a
//     block (64 channels up to N 16, then 32 and 16; two and four warps of
//     64 channels at N <= 4 and 8), so that two blocks, 16 warps, are
//     resident on an SM at falcon's N 16 (shared memory and 128 registers a
//     thread allow it).  The chunk's x (in its own type), dt, dy, B and C
//     are copied into shared memory with cp.async at the start (zero-filled
//     past T and di: a ragged chunk's padded steps are the identity).
//   * Sums.  dB_t and dC_t: per step a lane's 8 products are
//     reduce-scattered over the warp's channel groups (7 shuffles at N 16),
//     and every kR steps the block's warps' sums are added in warp order
//     from shared memory (two buffers, one barrier) and written as this
//     block's partial sums [ceil(di / channels), B, T, N].  du and sum_n q
//     A over the G lanes of a channel (xor shuffles); dx and ddt are
//     written by the channel's first lane.  dA and dD are summed over the
//     chunk's steps in registers and written as partial sums per (batch
//     row, chunk).
//
// The walk form (N > 64; ssm_scan_bwd_launch; the form every N took
// before the chunk form): a block per (group of channels, batch row) walks
// all T steps back, the lanes of the forward (ssm_scan.cuh: 2 channels x 8
// states a lane up to N 256, 16 states of one channel above), the tile
// starts of each chunk in a global scratch of its own (see the design
// notes at BwdShape below).
//
// Both forms: no atomics; the partial sums are added in a fixed order by
// the caller (torch.sum over their leading axes), so two calls give the
// same bits; every float operation on the data path is an explicit
// __fmul_rn / __fmaf_rn / __fadd_rn, so a bf16 x gives bitwise the
// gradients of its float32 upcast.
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "ssm_scan.cuh"

namespace {

namespace sm = repro::sm90;
using namespace repro::ssm;

constexpr unsigned kWarp = 0xffffffffu;

constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

constexpr int kTB = 8;                   // steps per tile of the backward
constexpr int kChunkTB = kChunk / kTB;   // its tiles per checkpoint chunk
static_assert(kChunk % kTB == 0, "a chunk is whole tiles");

struct Plan {
  int vx, vdt, vbc;
};

// One level of a reduce-scatter over lanes lane ^ M: each lane keeps half
// of its N values (the upper half where its bit M is set, `base` moving
// up by N / 2) and adds its partner's; then the levels M * 2 .. up to
// MEnd.  A level per template instance, so every index is a constant and
// `part` stays in registers.
template <int M, int MEnd, int N, int V>
__device__ __forceinline__ void reduce_scatter(float (&part)[V], int& base,
                                               int lane) {
  if constexpr (M < MEnd) {
    const bool up = lane & M;
    if (up) base += N / 2;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = up ? part[j] : part[j + N / 2];
      const float keep = up ? part[j + N / 2] : part[j];
      part[j] = __fadd_rn(keep, __shfl_xor_sync(kWarp, send, M));
    }
    reduce_scatter<M * 2, MEnd, N / 2, V>(part, base, lane);
  }
}

// ---- the chunk form (N <= 64) ---------------------------------------------

constexpr int kChunkMaxN = 64;

// The chunk form's exponentials: with kExp2, e = 2^(dt (A log2 e)) by
// ex2.approx.ftz (one MUFU.EX2, 2 ulp; a result below 2^-126, which adds
// nothing at the tolerance, flushed to 0), A scaled once a lane (and
// sum_n q A times ln 2 once a channel and step); else expf(dt A).  At
// falcon-mamba's training shape on an H100 80GB HBM3 at 700 W the chunk
// form took 0.86 of expf's time with exp2f (its subnormal handling
// around the MUFU.EX2 included), and 0.95 of exp2f's with ex2.approx.ftz.
constexpr bool kExp2 = true;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// A lane's A as decay() takes it.
__device__ __forceinline__ float lane_a(float a) {
  return kExp2 ? __fmul_rn(a, kLog2e) : a;
}

// exp(dt A) from a = lane_a(A).
__device__ __forceinline__ float decay(float dt, float a) {
  if constexpr (kExp2) {
    float e;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(__fmul_rn(dt, a)));
    return e;
  }
  return expf(__fmul_rn(dt, a));
}

// The chunk form's block for G lanes a channel (4 states each).
template <int G>
struct ChunkShape {
  static constexpr int kNp = 4 * G;  // states, padded
  static constexpr int kCh = G >= 4 ? 256 / G : 64;  // channels a block
  static constexpr int kThreads = kCh * G;
  static constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0, "whole warps");
  // Registers for 16 resident warps an SM (128 a thread).
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kR = G >= 8 ? 4 : kTB;  // steps a dB/dC reduction
  // dB and dC of a lane (4 each), reduce-scattered over the warp's P
  // channel groups in L levels (lane masks G .. M / 2), all-reduced over
  // the masks M .. 16 that are left; VL sums a lane after it.
  static constexpr int kP = 32 / G;
  static constexpr int kV = 8;
  static constexpr int kL = ilog2(kP < kV ? kP : kV);
  static constexpr int kM = G << kL;
  static constexpr int kVL = kV >> kL;
  // Shared memory, in floats: the chunk's inputs, then the tile starts
  // (float4 a lane), the warps' dB and dC, and x (in its own type).
  static constexpr int kDts = 0;                        // [kChunk][kCh]
  static constexpr int kDys = kDts + kChunk * kCh;      // [kChunk][kCh]
  static constexpr int kBs = kDys + kChunk * kCh;       // [kChunk][kNp]
  static constexpr int kCs = kBs + kChunk * kNp;        // [kChunk][kNp]
  static constexpr int kStarts = kCs + kChunk * kNp;    // [kChunkTB][threads]
  static constexpr int kRed = kStarts + kChunkTB * kThreads * 4;
  static constexpr int kRedW = kR * 2 * kNp;  // one warp's sums of a group
  static constexpr int kXs = kRed + 2 * kWarps * kRedW;  // [kChunk][kCh]
  // The carry kernel's: dt, dy, and C in the B slot.
  static constexpr int kCarryFloats = kBs + kChunk * kNp;
};

template <typename TX, int G>
constexpr size_t chunk_smem() {
  using Sh = ChunkShape<G>;
  return Sh::kXs * 4 + kChunk * Sh::kCh * sizeof(TX);
}

// L_c and the chunk's sum of dt for chunks c >= 1 (blockIdx.y = c - 1):
// forward over the chunk with P = prod e (from 1) and L += P C dy.
template <int G>
__global__ void __launch_bounds__(ChunkShape<G>::kThreads)
    ssm_scan_bwd_carry_kernel(const float* __restrict__ dt,
                              const float* __restrict__ A,
                              const float* __restrict__ Cm,
                              const float* __restrict__ dy, int T, int di,
                              int N, Plan pl, float* __restrict__ g_sum,
                              float* __restrict__ dt_sum) {
  using Sh = ChunkShape<G>;
  constexpr int CH = Sh::kCh, NP = Sh::kNp, THREADS = Sh::kThreads;
  extern __shared__ __align__(128) float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  float* dts = sf + Sh::kDts;
  float* dys = sf + Sh::kDys;
  float* cs = sf + Sh::kBs;
  const int c = blockIdx.y + 1, b = blockIdx.z, d0 = blockIdx.x * CH;
  const int nc = (T + kChunk - 1) / kChunk;
  const int t0 = c * kChunk, rows = min(kChunk, T - t0);
  const int cols = min(CH, di - d0);
  const long long row0 = static_cast<long long>(b) * T + t0;
  stage_box<CH, THREADS, float, kChunk>(dts, dt + row0 * di + d0, di, rows,
                                        cols, pl.vdt);
  stage_box<CH, THREADS, float, kChunk>(dys, dy + row0 * di + d0, di, rows,
                                        cols, pl.vdt);
  stage_box<NP, THREADS, float, kChunk>(cs, Cm + row0 * N, N, rows, N,
                                        pl.vbc);
  sm::cp_async_commit();

  const int g = threadIdx.x % G, ch = threadIdx.x / G, d = d0 + ch;
  const bool live = d < di;
  float a[4], p[4], l[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int n = 4 * g + s;
    a[s] = live && n < N ? lane_a(A[static_cast<long long>(d) * N + n])
                         : 0.0f;
    p[s] = 1.0f;
    l[s] = 0.0f;
  }
  float sd = 0.0f;
  sm::cp_async_wait_all();
  __syncthreads();
#pragma unroll 4
  for (int tt = 0; tt < rows; ++tt) {
    const float dtv = dts[tt * CH + ch], dyv = dys[tt * CH + ch];
    const float4 cv = reinterpret_cast<const float4*>(cs + tt * NP)[g];
    const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      p[s] = __fmul_rn(p[s], decay(dtv, a[s]));
      l[s] = __fmaf_rn(p[s], __fmul_rn(cc[s], dyv), l[s]);
    }
    sd = __fadd_rn(sd, dtv);
  }
  if (!live) return;
  const long long o = (static_cast<long long>(b) * nc + c) * di + d;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (4 * g + s < N) g_sum[o * N + 4 * g + s] = l[s];
  if (g == 0) dt_sum[o] = sd;
}

// The gradient over one chunk (blockIdx.y) of one batch row (blockIdx.z)
// for the block's channels, from the carry of the chunks after it.
template <typename TX, int G>
__global__ void __launch_bounds__(ChunkShape<G>::kThreads,
                                  ChunkShape<G>::kMinBlocks)
    ssm_scan_bwd_chunk_kernel(
        const TX* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const float* __restrict__ Bm,
        const float* __restrict__ Cm, const float* __restrict__ Dv,
        const float* __restrict__ h_chunks, const float* __restrict__ dy,
        const float* __restrict__ dh, const float* __restrict__ g_sum,
        const float* __restrict__ dt_sum, int batch, int T, int di, int N,
        Plan pl, TX* __restrict__ dx, float* __restrict__ ddt,
        float* __restrict__ dBp, float* __restrict__ dCp,
        float* __restrict__ dAp, float* __restrict__ dDp) {
  using Sh = ChunkShape<G>;
  constexpr int CH = Sh::kCh, NP = Sh::kNp, THREADS = Sh::kThreads;
  constexpr int R = Sh::kR, W = Sh::kWarps;
  extern __shared__ __align__(128) float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  float* dts = sf + Sh::kDts;
  float* dys = sf + Sh::kDys;
  float* bs = sf + Sh::kBs;
  float* cs = sf + Sh::kCs;
  float* red = sf + Sh::kRed;
  TX* xs = reinterpret_cast<TX*>(sf + Sh::kXs);
  const int c = blockIdx.y, b = blockIdx.z, d0 = blockIdx.x * CH;
  const int nc = (T + kChunk - 1) / kChunk;
  const int t0 = c * kChunk, rows = min(kChunk, T - t0);
  const int cols = min(CH, di - d0);
  const long long row0 = static_cast<long long>(b) * T + t0;
  {
    const long long at = row0 * di + d0;
    stage_box<CH, THREADS, TX, kChunk>(xs, x + at, di, rows, cols, pl.vx);
    stage_box<CH, THREADS, float, kChunk>(dts, dt + at, di, rows, cols,
                                          pl.vdt);
    stage_box<CH, THREADS, float, kChunk>(dys, dy + at, di, rows, cols,
                                          pl.vdt);
    stage_box<NP, THREADS, float, kChunk>(bs, Bm + row0 * N, N, rows, N,
                                          pl.vbc);
    stage_box<NP, THREADS, float, kChunk>(cs, Cm + row0 * N, N, rows, N,
                                          pl.vbc);
    sm::cp_async_commit();
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid % G, ch = tid / G, d = d0 + ch;
  const bool live = d < di;
  const long long o = (static_cast<long long>(b) * nc + c) * di + d;
  // While the copies fly: this lane's row of A, the checkpoint, and g at
  // the chunk's end from dh_T and the summaries of the chunks after it.
  float a[4], gg[4], h[4], dA[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int n = 4 * g + s;
    const bool in = live && n < N;
    a[s] = in ? lane_a(A[static_cast<long long>(d) * N + n]) : 0.0f;
    h[s] = in ? h_chunks[o * N + n] : 0.0f;
    gg[s] = in && dh ? dh[(static_cast<long long>(b) * di + d) * N + n]
                     : 0.0f;
    dA[s] = 0.0f;
  }
  for (int k = nc - 1; k > c; --k) {
    const long long ok = (static_cast<long long>(b) * nc + k) * di + d;
    const float sd = live ? dt_sum[ok] : 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * g + s;
      const float lv = live && n < N ? g_sum[ok * N + n] : 0.0f;
      gg[s] = __fmaf_rn(decay(sd, a[s]), gg[s], lv);
    }
  }
  const float dv = live ? Dv[d] : 0.0f;
  float dD = 0.0f;
  sm::cp_async_wait_all();
  __syncthreads();

  // Step i of the chunk forward: h = e h + u B, as the forward computes
  // it; e into ev.
  auto advance = [&](float (&hh)[4], float (&ev)[4], int i) {
    const float dtv = dts[i * CH + ch];
    const float u = __fmul_rn(dtv, to_f32(xs[i * CH + ch]));
    const float4 bv = reinterpret_cast<const float4*>(bs + i * NP)[g];
    const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      ev[s] = decay(dtv, a[s]);
      hh[s] = __fmaf_rn(ev[s], hh[s], __fmul_rn(u, bb[s]));
    }
  };

  // The tile starts: slot j holds the state before the chunk's step j kTB.
  const int nt = (rows + kTB - 1) / kTB;
  float4* starts = reinterpret_cast<float4*>(sf + Sh::kStarts) + tid;
  starts[0] = make_float4(h[0], h[1], h[2], h[3]);
  for (int j = 0; j + 1 < nt; ++j) {
#pragma unroll
    for (int tt = 0; tt < kTB; ++tt) {
      float ev[4];
      advance(h, ev, j * kTB + tt);
    }
    starts[(j + 1) * THREADS] = make_float4(h[0], h[1], h[2], h[3]);
  }

  int buf = 0;
  for (int j = nt - 1; j >= 0; --j) {
    // The tile's states before each step, and e of each step.
    float hs[kTB][4], es[kTB][4], hc[4];
    {
      const float4 st = starts[j * THREADS];
      hc[0] = st.x, hc[1] = st.y, hc[2] = st.z, hc[3] = st.w;
    }
#pragma unroll
    for (int tt = 0; tt < kTB; ++tt) {
#pragma unroll
      for (int s = 0; s < 4; ++s) hs[tt][s] = hc[s];
      advance(hc, es[tt], j * kTB + tt);
    }
    // e of the step after the tile: 1 past the chunk's end, else what the
    // tile after left in its start's slot (carried in registers instead,
    // it made 4 of the 10 instances spill at 128 registers a thread).
    float en[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (j + 1 < nt) {
      const float4 e4 = starts[(j + 1) * THREADS];
      en[0] = e4.x, en[1] = e4.y, en[2] = e4.z, en[3] = e4.w;
    }
    // Walk the tile back from hc = h_t of its last step, R steps a group.
#pragma unroll
    for (int top = kTB - 1; top >= 0; top -= R, buf ^= 1) {
      float* redw = red + (buf * W + warp) * Sh::kRedW;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int tt = top - rr, i = j * kTB + tt;
        const float dyv = dys[i * CH + ch], dtv = dts[i * CH + ch];
        const float xv = to_f32(xs[i * CH + ch]);
        const float u = __fmul_rn(dtv, xv);
        const float4 bv = reinterpret_cast<const float4*>(bs + i * NP)[g];
        const float4 cv = reinterpret_cast<const float4*>(cs + i * NP)[g];
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
        float du = 0.0f, sq = 0.0f, part[Sh::kV];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          gg[s] = __fmaf_rn(en[s], gg[s], __fmul_rn(cc[s], dyv));
          const float q = __fmul_rn(__fmul_rn(gg[s], hs[tt][s]), es[tt][s]);
          sq = __fmaf_rn(q, a[s], sq);
          dA[s] = __fmaf_rn(q, dtv, dA[s]);
          du = __fmaf_rn(gg[s], bb[s], du);
          part[s] = __fmul_rn(u, gg[s]);
          part[4 + s] = __fmul_rn(dyv, hc[s]);
          en[s] = es[tt][s];
          hc[s] = hs[tt][s];
        }
        // dB_t and dC_t over the warp's channels.
        int base = 0;
        reduce_scatter<G, Sh::kM, Sh::kV>(part, base, lane);
#pragma unroll
        for (int v = 0; v < Sh::kVL; ++v) {
#pragma unroll
          for (int m = Sh::kM; m < 32; m <<= 1)
            part[v] = __fadd_rn(part[v], __shfl_xor_sync(kWarp, part[v], m));
          if (lane < Sh::kM) {
            const int k = base + v;
            redw[rr * 2 * NP + k / 4 * NP + 4 * g + k % 4] = part[v];
          }
        }
        // du and sum_n q A over the channel's G lanes.
#pragma unroll
        for (int m = 1; m < G; m <<= 1) {
          du = __fadd_rn(du, __shfl_xor_sync(kWarp, du, m));
          sq = __fadd_rn(sq, __shfl_xor_sync(kWarp, sq, m));
        }
        if (g == 0 && live && i < rows) {
          const long long ot = (row0 + i) * di + d;
          const float dxv = __fmaf_rn(du, dtv, __fmul_rn(dyv, dv));
          if constexpr (std::is_same_v<TX, float>)
            dx[ot] = dxv;
          else
            dx[ot] = __float2bfloat16_rn(dxv);
          ddt[ot] = __fmaf_rn(du, xv, kExp2 ? __fmul_rn(sq, kLn2) : sq);
        }
        dD = __fmaf_rn(dyv, xv, dD);  // a padded step adds 0
      }
      __syncthreads();  // the group's dB and dC parts are in red[buf]
      const float* rb = red + buf * W * Sh::kRedW;
      for (int k = tid; k < Sh::kRedW; k += THREADS) {
        const int rr = k / (2 * NP), q = k / NP % 2, n = k % NP;
        const int i = j * kTB + top - rr;
        if (i >= rows || n >= N) continue;
        float sum = rb[k];
#pragma unroll
        for (int w = 1; w < W; ++w) sum = __fadd_rn(sum, rb[w * Sh::kRedW + k]);
        float* out = q ? dCp : dBp;
        out[((static_cast<long long>(blockIdx.x) * batch + b) * T + t0 + i) *
                N + n] = sum;
      }
    }
    starts[j * THREADS] = make_float4(en[0], en[1], en[2], en[3]);
  }

  if (!live) return;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (4 * g + s < N) dAp[o * N + 4 * g + s] = dA[s];
  if (g == 0) dDp[o] = dD;
}

// Sets the dynamic shared memory both kernels of the chunk form take, for
// x of type TX and G lanes a channel (once per instance).
template <typename TX, int G>
cudaError_t prepare_chunks() {
  static size_t allowed = 48 * 1024, allowed_carry = 48 * 1024;
  constexpr size_t smem = chunk_smem<TX, G>();
  static_assert(smem <= 232448, "at most 227 KB of shared memory a block");
  cudaError_t err =
      repro::allow_smem(ssm_scan_bwd_chunk_kernel<TX, G>, smem, allowed);
  if (err != cudaSuccess) return err;
  return repro::allow_smem(ssm_scan_bwd_carry_kernel<G>,
                           ChunkShape<G>::kCarryFloats * 4, allowed_carry);
}

template <typename TX, int G>
int launch_chunks(const void* x, const float* dt, const float* A,
                  const float* Bm, const float* Cm, const float* Dv,
                  const float* h_chunks, const float* dy, const float* dh,
                  float* g_sum, float* dt_sum, int batch, int T, int di,
                  int N, void* dx, float* ddt, float* dBp, float* dCp,
                  float* dAp, float* dDp, cudaStream_t stream) {
  using Sh = ChunkShape<G>;
  const int ex = sizeof(TX);
  Plan pl;
  pl.vx = chunk_bytes(x, 1LL * di * ex, Sh::kCh * ex);
  pl.vdt = std::min(chunk_bytes(dt, di * 4LL, Sh::kCh * 4LL),
                    chunk_bytes(dy, di * 4LL, Sh::kCh * 4LL));
  pl.vbc = std::min(chunk_bytes(Bm, N * 4LL, 0), chunk_bytes(Cm, N * 4LL, 0));
  const int nc = (T + kChunk - 1) / kChunk;
  const int blocks = (di + Sh::kCh - 1) / Sh::kCh;
  cudaError_t err = prepare_chunks<TX, G>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nc > 1) {
    ssm_scan_bwd_carry_kernel<G>
        <<<dim3(blocks, nc - 1, batch), Sh::kThreads,
           Sh::kCarryFloats * 4, stream>>>(dt, A, Cm, dy, T, di, N, pl, g_sum,
                                           dt_sum);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssm_scan_bwd_chunk_kernel<TX, G>
      <<<dim3(blocks, nc, batch), Sh::kThreads, chunk_smem<TX, G>(),
         stream>>>(static_cast<const TX*>(x), dt, A, Bm, Cm, Dv, h_chunks, dy,
                   dh, g_sum, dt_sum, batch, T, di, N, pl,
                   static_cast<TX*>(dx), ddt, dBp, dCp, dAp, dDp);
  return static_cast<int>(cudaGetLastError());
}

// The chunk form's lanes for N: calls fn(G) with G = ceil(N / 4) rounded
// up to a power of two as a template argument, or returns -1 past 64.
template <typename Fn>
int for_chunk_states(int N, Fn fn) {
  if (N <= 4) return fn(std::integral_constant<int, 1>{});
  if (N <= 8) return fn(std::integral_constant<int, 2>{});
  if (N <= 16) return fn(std::integral_constant<int, 4>{});
  if (N <= 32) return fn(std::integral_constant<int, 8>{});
  if (N <= kChunkMaxN) return fn(std::integral_constant<int, 16>{});
  return -1;
}

// ---- the walk form (N > 64) -------------------------------------------------

// Design of the walk form.
//   * Blocks.  As the forward: a batch row and a group of channels per
//     block, lanes holding 2 channels x 8 states up to N = 256 and 16
//     states of one channel above (ssm_scan.cuh), the same constant-row
//     test and the same two routes (one expf per channel and step on a
//     constant row of A, taken in the staging pass; one per state element
//     on a general row), in the same explicit __fmul_rn / __fmaf_rn order,
//     so a constant row gives bitwise what the general route gives it.
//     Fewer channels per block than the forward where N > 64, so that a
//     tile's states fit in shared memory (8 KB a step up to N = 128).
//   * States.  The block takes the chunks from the last to the first, in
//     tiles of kTB = 8 steps.  For each chunk it loads the checkpoint into
//     registers and runs the recurrence forward over the chunk's tiles but
//     the last, storing the state at each tile's start in a global scratch
//     of its own (L2-resident); then it takes the tiles from the last to
//     the first, recomputes the tile's 8 states h_{t-1} into shared memory
//     and walks the tile back with g in registers, h_t carried from the
//     step after.  A lane stores and reads only its own states (four
//     float4s a step, the warp's in one 512-byte run), so no barrier
//     guards them.
//   * The partial sums of dB and dC are reduce-scattered over the warp one
//     template instance a level (reduce_scatter), so their indices are
//     constants: as a loop, they went to local memory (a 64-byte stack
//     frame) and the kernel took 1.38x as long.
//   * Tiles.  x (in its own type, float32 or bfloat16), dt, dy, B and C of
//     a tile are double-buffered in shared memory with cp.async (16, 8 or
//     4-byte chunks, zero-filled past T and di): the tile of the next item
//     of the walk's schedule is in flight while one is worked on.
//   * Sums over the channels (dB, dC).  Per step a lane forms its part of
//     dB_t and dC_t over its channels, the warp reduce-scatters them over
//     its channel groups, and every R steps the warps' sums are added in
//     warp order from shared memory (two buffers, one barrier a group) and
//     written as this block's partial sums [blocks, B, T, N].  Sums over
//     the states (du, q . A) are all-reduced over the G lanes of a
//     channel; lane 0 of the group writes dx and ddt to a tile in shared
//     memory, stored after the tile.  dA and dD are summed over the
//     block's steps in registers and written as partial sums per batch
//     row.

// The backward's block for G lanes per channel group and K channels per
// lane (the forward's lanes, ssm_scan.cuh).
template <int G, int K>
struct BwdShape {
  using Fwd = Shape<G, K>;
  static constexpr int kS = Fwd::kS, kNp = Fwd::kNp;
  // States of one step of the block, CH * Np floats: 8 KB up to Np = 128,
  // then less, so that the B and C tiles fit beside them.
  static constexpr int kBudget = kNp <= 128 ? 2048 : 2048 * 128 / kNp;
  static constexpr int kCh =
      Fwd::kCh < kBudget / kNp ? Fwd::kCh : kBudget / kNp;
  static constexpr int kThreads = kCh / K * G;
  static constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0, "whole warps");
  static constexpr int kR = kNp >= 128 ? 2 : 4;  // steps per dB/dC reduction
  // dB and dC of a lane (S each), reduce-scattered over the warp's P
  // channel groups in L levels (lane masks G .. M / 2), all-reduced over
  // the masks M .. 16 that are left; VL sums per lane after it.
  static constexpr int kP = 32 / G;
  static constexpr int kV = 2 * kS;
  static constexpr int kL = ilog2(kP < kV ? kP : kV);
  static constexpr int kM = G << kL;
  static constexpr int kVL = kV >> kL;
  static constexpr int kStep = kThreads * 16;  // one step's states
  // The global scratch of a block: the tile-start states of a chunk.
  static constexpr int kScratch = (kChunkTB - 1) * kStep;
  // Shared memory layout, in floats.
  static constexpr int kTileS = kTB * kNp, kTileC = kTB * kCh;
  static constexpr int kHs = 0;                     // [kTB][kStep]
  static constexpr int kBs = kHs + kTB * kStep;     // [2][kTB][kNp]
  static constexpr int kCs = kBs + 2 * kTileS;
  static constexpr int kDts = kCs + 2 * kTileS;  // [2][kTB][kCh]
  static constexpr int kDys = kDts + 2 * kTileC;
  static constexpr int kUs = kDys + 2 * kTileC;  // [kTB][kCh]
  static constexpr int kEs = kUs + kTileC;
  static constexpr int kDxs = kEs + kTileC;
  static constexpr int kDdts = kDxs + kTileC;
  static constexpr int kRed = kDdts + kTileC;  // [2][warps][kR][2][kNp]
  static constexpr int kRedW = kR * 2 * kNp;   // one warp's sums of a group
  static constexpr int kChan = kRed + 2 * kWarps * kRedW;  // [kCh] a0, flag
  static constexpr int kXs = (kChan + 2 * kCh + 31) / 32 * 32;  // [2][tile]
  static constexpr int kXElems = 2 * kTileC;  // of x's type
};

// The walk's schedule.  Item i of a block: its tile, whether it walks the
// tile back (else it only advances the state over it), whether it is the
// first item of its chunk (which loads the checkpoint), the tile's index j
// in its chunk and the chunk's tiles tc.  Chunks from the last to the
// first; in each, tiles 0 .. tc - 2 forward, then tc - 1 .. 0 back.
struct Item {
  int tile, j, tc, chunk;
  bool walk, first;
};

__device__ __forceinline__ Item item_of(int i, int n_tiles) {
  const int nc = (n_tiles + kChunkTB - 1) / kChunkTB;
  const int last = n_tiles - kChunkTB * (nc - 1);  // tiles of chunk nc - 1
  const int lead = 2 * last - 1;
  constexpr int kPer = 2 * kChunkTB - 1;
  Item it;
  int local;
  if (i < lead) {
    it.chunk = nc - 1, it.tc = last, local = i;
  } else {
    it.chunk = nc - 2 - (i - lead) / kPer, it.tc = kChunkTB;
    local = (i - lead) % kPer;
  }
  it.first = local == 0;
  it.walk = local >= it.tc - 1;
  it.j = it.walk ? 2 * (it.tc - 1) - local : local;
  it.tile = it.chunk * kChunkTB + it.j;
  return it;
}

__device__ __forceinline__ int n_items(int n_tiles) {
  if (n_tiles == 0) return 0;
  const int nc = (n_tiles + kChunkTB - 1) / kChunkTB;
  return 2 * (n_tiles - kChunkTB * (nc - 1)) - 1 +
         (2 * kChunkTB - 1) * (nc - 1);
}

// A lane's 16 values [K][S] to and from its slot of one step's states
// ([4][threads] float4s: a warp's float4 q in one 512-byte run).
template <int K, int THREADS>
__device__ __forceinline__ void put_states(float* dst,
                                           const float (&h)[K][16 / K]) {
  constexpr int Q = 4 / K;  // float4s per channel
  float4* d4 = reinterpret_cast<float4*>(dst) + threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = q / Q, s = q % Q * 4;
    d4[q * THREADS] =
        make_float4(h[k][s], h[k][s + 1], h[k][s + 2], h[k][s + 3]);
  }
}

template <int K, int THREADS>
__device__ __forceinline__ void get_states(float (&h)[K][16 / K],
                                           const float* src) {
  constexpr int Q = 4 / K;
  const float4* s4 = reinterpret_cast<const float4*>(src) + threadIdx.x;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = q / Q, s = q % Q * 4;
    const float4 v = s4[q * THREADS];
    h[k][s] = v.x, h[k][s + 1] = v.y, h[k][s + 2] = v.z, h[k][s + 3] = v.w;
  }
}

// One step of one channel forward: h = e h + u B, as the forward computes
// it.  e is ev on a constant row, else expf(ev * a) per state.
template <int S, bool kUniform>
__device__ __forceinline__ void advance(float (&h)[S], const float (&a)[S],
                                        const float4 (&bv)[S / 4], float u,
                                        float ev) {
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float bb[4] = {bv[q].x, bv[q].y, bv[q].z, bv[q].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * q + j;
      const float e = kUniform ? ev : expf(__fmul_rn(ev, a[s]));
      h[s] = __fmaf_rn(e, h[s], __fmul_rn(u, bb[j]));
    }
  }
}

// One step of one channel back, on a lane's S states.  In: g = g_{t+1}
// and e_{t+1} (eu on a constant row, en per state else); out: g = g_t,
// e_t in eu / en, q dt added to dA, and the lane's parts of du_t and of
// sum_n q A (returned in du and sq).  ev: e_t on a constant row; dtv: dt_t.
template <int S, bool kUniform>
__device__ __forceinline__ void walk_channel(
    float (&g)[S], float (&en)[S], float& eu, float (&dA)[S],
    const float (&hprev)[S], const float (&a)[S], float a0,
    const float4 (&bv)[S / 4], const float4 (&cv)[S / 4], float dy, float ev,
    float dtv, float& du, float& sq) {
  float dua[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float sqa[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float ea_u = __fmul_rn(ev, a0), edt_u = __fmul_rn(ev, dtv);
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float bb[4] = {bv[q].x, bv[q].y, bv[q].z, bv[q].w};
    const float cc[4] = {cv[q].x, cv[q].y, cv[q].z, cv[q].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * q + j;
      const float e = kUniform ? ev : expf(__fmul_rn(dtv, a[s]));
      const float ea = kUniform ? ea_u : __fmul_rn(e, a[s]);
      const float edt = kUniform ? edt_u : __fmul_rn(e, dtv);
      g[s] = __fmaf_rn(kUniform ? eu : en[s], g[s], __fmul_rn(cc[j], dy));
      const float gh = __fmul_rn(g[s], hprev[s]);
      sqa[j] = __fmaf_rn(gh, ea, sqa[j]);
      dA[s] = __fmaf_rn(gh, edt, dA[s]);
      dua[j] = __fmaf_rn(g[s], bb[j], dua[j]);
      if (!kUniform) en[s] = e;
    }
  }
  if (kUniform) eu = ev;
  du = __fadd_rn(__fadd_rn(dua[0], dua[1]), __fadd_rn(dua[2], dua[3]));
  sq = __fadd_rn(__fadd_rn(sqa[0], sqa[1]), __fadd_rn(sqa[2], sqa[3]));
}

template <typename TX, int G, int K>
__global__ void __launch_bounds__(BwdShape<G, K>::kThreads, 1)
    ssm_scan_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ Dv,
                        const float* __restrict__ h_chunks,
                        const float* __restrict__ dy,
                        const float* __restrict__ dh,
                        float* __restrict__ scratch, int batch, int T,
                        int di, int N, Plan pl, TX* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ dBp,
                        float* __restrict__ dCp, float* __restrict__ dAp,
                        float* __restrict__ dDp) {
  using Sh = BwdShape<G, K>;
  constexpr int S = Sh::kS, CH = Sh::kCh, NP = Sh::kNp, R = Sh::kR;
  constexpr int THREADS = Sh::kThreads, STEP = Sh::kStep;
  constexpr int TILE_S = Sh::kTileS, TILE_C = Sh::kTileC;
  extern __shared__ __align__(128) float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  float* hs = sf + Sh::kHs;  // h_{t-1} of the tile's steps
  // The state at the start of the chunk's tiles 0 .. kChunkTB - 2.
  float* bnd = scratch + (static_cast<long long>(blockIdx.y) * gridDim.x +
                          blockIdx.x) * Sh::kScratch;
  float* bs = sf + Sh::kBs;
  float* cs = sf + Sh::kCs;
  float* dts = sf + Sh::kDts;
  float* dys = sf + Sh::kDys;
  float* us = sf + Sh::kUs;  // dt * x
  float* es = sf + Sh::kEs;  // exp(dt * a0) on a constant row, else dt
  float* dxs = sf + Sh::kDxs;
  float* ddts = sf + Sh::kDdts;
  float* red = sf + Sh::kRed;
  float* a0s = sf + Sh::kChan;
  int* unis = reinterpret_cast<int*>(a0s + CH);
  TX* xs = reinterpret_cast<TX*>(sf + Sh::kXs);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = threadIdx.x % G;
  const int c0 = threadIdx.x / G * K;  // this lane's channels c0 .. c0 + K - 1
  const int n_chunks = (T + kChunk - 1) / kChunk;

  // Is each channel's row of A constant?  Padded states do not count.
  const unsigned group =
      G == 32 ? kWarp : ((1u << G) - 1u) << (lane & ~(G - 1));
  float a[K][S], a0[K], dv[K];
  float gg[K][S], en[K][S], eu[K], dA[K][S], dD[K];
  bool uniform[K], all = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + c0 + k;
    const bool live = d < di;
    const float* arow = A + static_cast<long long>(d) * N;
    a0[k] = live ? arow[0] : 0.0f;
    dv[k] = live ? Dv[d] : 0.0f;
    bool same = true;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = state_n<G>(s, g);
      const bool in = live && n < N;
      a[k][s] = in ? arow[n] : 0.0f;
      same = same && (!in || a[k][s] == a0[k]);
      gg[k][s] = in && dh ? dh[(static_cast<long long>(b) * di + d) * N + n]
                          : 0.0f;
      en[k][s] = 1.0f;
      dA[k][s] = 0.0f;
    }
    eu[k] = 1.0f;
    dD[k] = 0.0f;
    uniform[k] = (__ballot_sync(kWarp, same) & group) == group;
    all = all && uniform[k];
    if (g == 0) {
      a0s[c0 + k] = a0[k];
      unis[c0 + k] = uniform[k];
    }
  }
  all = __all_sync(kWarp, all);
  __syncthreads();

  // In the staging pass this thread takes PASS (step, channel) pairs; where
  // the block's threads are a multiple of its channels, all of one channel.
  constexpr int PASS = (TILE_C + THREADS - 1) / THREADS;
  constexpr bool ONE = THREADS % CH == 0;
  const int pc = threadIdx.x % CH;
  const bool p_uniform = ONE && unis[pc];
  const float p_a0 = a0s[pc];

  const long long row0 = static_cast<long long>(b) * T;
  const int cols = min(CH, di - d0);
  // Issues the copies of tile `tile` into buffer p.
  auto stage = [&](int tile, int p) {
    const int t0 = tile * kTB, rows = min(kTB, T - t0);
    const long long at = (row0 + t0) * di + d0;
    stage_box<CH, THREADS, TX, kTB>(xs + p * TILE_C, x + at, di, rows, cols,
                                    pl.vx);
    stage_box<CH, THREADS, float, kTB>(dts + p * TILE_C, dt + at, di, rows,
                                       cols, pl.vdt);
    stage_box<CH, THREADS, float, kTB>(dys + p * TILE_C, dy + at, di, rows,
                                       cols, pl.vdt);
    stage_box<NP, THREADS, float, kTB>(bs + p * TILE_S, Bm + (row0 + t0) * N,
                                       N, rows, N, pl.vbc);
    stage_box<NP, THREADS, float, kTB>(cs + p * TILE_S, Cm + (row0 + t0) * N,
                                       N, rows, N, pl.vbc);
    sm::cp_async_commit();
  };

  // Steps 0 .. tn - 1 of a tile forward from h; with kStore, h_{t-1} of
  // each step into hs first.
  auto forward = [&](auto k_all, auto k_store, float(&h)[K][S],
                     const float* bsp, int tn) {
    for (int tt = 0; tt < tn; ++tt) {
      if constexpr (decltype(k_store)::value)
        put_states<K, THREADS>(hs + tt * STEP, h);
      const float4* b4 = reinterpret_cast<const float4*>(bsp + tt * NP) + g;
      float4 bv[S / 4];
#pragma unroll
      for (int q = 0; q < S / 4; ++q) bv[q] = b4[q * G];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float u = us[tt * CH + c0 + k], ev = es[tt * CH + c0 + k];
        if (decltype(k_all)::value || uniform[k])
          advance<S, true>(h[k], a[k], bv, u, ev);
        else
          advance<S, false>(h[k], a[k], bv, u, ev);
      }
    }
  };

  // Walks steps tn - 1 .. 0 of a tile back from hcur = h_{t0 + tn - 1}:
  // per step dB and dC into red, dx and ddt into the tile's shared arrays;
  // every R steps the warps' dB and dC are added and written out.  kFull:
  // the tile has all its steps, so every group of R steps is whole and
  // runs as straight code (the steps' chains may interleave).
  auto walk = [&](auto k_all, auto k_full, float(&hcur)[K][S], int p, int t0,
                  int tn) {
    const float* bsp = bs + p * TILE_S;
    const float* csp = cs + p * TILE_S;
    const float* dtp = dts + p * TILE_C;
    const float* dyp = dys + p * TILE_C;
    const TX* xp = xs + p * TILE_C;
    int buf = 0;
    for (int top = tn - 1; top >= 0; top -= R, buf ^= 1) {
      float* redw = red + (buf * Sh::kWarps + warp) * Sh::kRedW;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int tt = top - rr;
        if (!decltype(k_full)::value && tt < 0) break;
        const float4* b4 = reinterpret_cast<const float4*>(bsp + tt * NP) + g;
        const float4* c4 = reinterpret_cast<const float4*>(csp + tt * NP) + g;
        float4 bv[S / 4], cv[S / 4];
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          bv[q] = b4[q * G];
          cv[q] = c4[q * G];
        }
        float u[K], ev[K], dyv[K], dtv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int i = tt * CH + c0 + k;
          u[k] = us[i], ev[k] = es[i], dyv[k] = dyp[i], dtv[k] = dtp[i];
        }
        float hprev[K][S];
        get_states<K, THREADS>(hprev, hs + tt * STEP);
        float r[2 * K];  // du, then sum_n q A, of each channel
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (decltype(k_all)::value || uniform[k])
            walk_channel<S, true>(gg[k], en[k], eu[k], dA[k], hprev[k], a[k],
                                  a0[k], bv, cv, dyv[k], ev[k], dtv[k], r[k],
                                  r[K + k]);
          else
            walk_channel<S, false>(gg[k], en[k], eu[k], dA[k], hprev[k], a[k],
                                   a0[k], bv, cv, dyv[k], ev[k], dtv[k], r[k],
                                   r[K + k]);
        }
        // This lane's parts of dB_t (over its channels' u g) and dC_t (dy
        // h_t), reduce-scattered over the warp's channel groups.
        float part[Sh::kV];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          part[s] = __fmul_rn(u[0], gg[0][s]);
          part[S + s] = __fmul_rn(dyv[0], hcur[0][s]);
#pragma unroll
          for (int k = 1; k < K; ++k) {
            part[s] = __fmaf_rn(u[k], gg[k][s], part[s]);
            part[S + s] = __fmaf_rn(dyv[k], hcur[k][s], part[S + s]);
          }
        }
        int base = 0;
        reduce_scatter<G, Sh::kM, Sh::kV>(part, base, lane);
#pragma unroll
        for (int j = 0; j < Sh::kVL; ++j) {
#pragma unroll
          for (int m = Sh::kM; m < 32; m <<= 1)
            part[j] = __fadd_rn(part[j], __shfl_xor_sync(kWarp, part[j], m));
          if (lane < Sh::kM) {
            const int v = base + j, s = v % S;
            redw[rr * 2 * NP + v / S * NP + state_n<G>(s, g)] = part[j];
          }
        }
        // du and sum_n q A of each channel, over its G lanes.
#pragma unroll
        for (int m = 1; m < G; m <<= 1) {
#pragma unroll
          for (int j = 0; j < 2 * K; ++j)
            r[j] = __fadd_rn(r[j], __shfl_xor_sync(kWarp, r[j], m));
        }
        if (g == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int i = tt * CH + c0 + k;
            const float xv = to_f32(xp[i]);
            dxs[i] = __fmaf_rn(r[k], dtv[k], __fmul_rn(dyv[k], dv[k]));
            ddts[i] = __fmaf_rn(r[k], xv, r[K + k]);
            dD[k] = __fmaf_rn(dyv[k], xv, dD[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int s = 0; s < S; ++s) hcur[k][s] = hprev[k][s];
      }
      __syncthreads();  // the group's dB and dC parts are in red[buf]
      const float* rb = red + buf * Sh::kWarps * Sh::kRedW;
      for (int i = threadIdx.x; i < Sh::kRedW; i += THREADS) {
        const int rr = i / (2 * NP), q = i / NP % 2, n = i % NP;
        const int tt = top - rr;
        if (tt < 0 || n >= N) continue;
        float sum = rb[i];
#pragma unroll
        for (int w = 1; w < Sh::kWarps; ++w)
          sum = __fadd_rn(sum, rb[w * Sh::kRedW + i]);
        float* out = q ? dCp : dBp;
        out[((static_cast<long long>(blockIdx.x) * batch + b) * T + t0 + tt) *
                N + n] = sum;
      }
    }
    // The tile's dx and ddt (written before the last group's barrier).
    for (int i = threadIdx.x; i < TILE_C; i += THREADS) {
      const int tt = i / CH, c = i % CH;
      if (tt < tn && c < cols) {
        const long long o = (row0 + t0 + tt) * di + d0 + c;
        if constexpr (std::is_same_v<TX, float>)
          dx[o] = dxs[i];
        else
          dx[o] = __float2bfloat16_rn(dxs[i]);
        ddt[o] = ddts[i];
      }
    }
  };

  constexpr std::true_type yes{};
  constexpr std::false_type no{};
  const int n_tiles = (T + kTB - 1) / kTB;
  const int items = n_items(n_tiles);
  float h[K][S];
  if (items > 0) stage(item_of(0, n_tiles).tile, 0);
  for (int i = 0; i < items; ++i) {
    const Item it = item_of(i, n_tiles);
    const int p = i & 1, t0 = it.tile * kTB, tn = min(kTB, T - t0);
    sm::cp_async_wait_all();
    __syncthreads();  // item i's tile has landed; item i - 1 is done
    if (i + 1 < items) stage(item_of(i + 1, n_tiles).tile, p ^ 1);
    // The staging pass: (step, channel) pairs, channels fastest.
#pragma unroll 4
    for (int j = 0; j < PASS; ++j) {
      const int e = threadIdx.x + j * THREADS;
      if (TILE_C % THREADS != 0 && e >= TILE_C) break;
      const int c = e % CH;
      const float xv = to_f32(xs[p * TILE_C + e]);
      const float dtv = dts[p * TILE_C + e];
      const bool pu = ONE ? p_uniform : unis[c];
      us[e] = __fmul_rn(dtv, xv);
      es[e] = pu ? expf(__fmul_rn(dtv, ONE ? p_a0 : a0s[c])) : dtv;
    }
    if (it.first) {  // the checkpoint at the chunk's start
      const float* hc =
          h_chunks +
          (static_cast<long long>(b) * n_chunks + it.chunk) * di * N;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = d0 + c0 + k;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int n = state_n<G>(s, g);
          h[k][s] = d < di && n < N ? hc[static_cast<long long>(d) * N + n]
                                    : 0.0f;
        }
      }
    }
    __syncthreads();  // us and es are ready
    const float* bsp = bs + p * TILE_S;
    if (!it.walk) {
      put_states<K, THREADS>(bnd + it.j * STEP, h);
      all ? forward(yes, no, h, bsp, tn) : forward(no, no, h, bsp, tn);
    } else {
      if (it.j < it.tc - 1) get_states<K, THREADS>(h, bnd + it.j * STEP);
      if (all)
        forward(yes, yes, h, bsp, tn);
      else
        forward(no, yes, h, bsp, tn);
      if (tn == kTB)
        all ? walk(yes, yes, h, p, t0, tn) : walk(no, yes, h, p, t0, tn);
      else
        all ? walk(yes, no, h, p, t0, tn) : walk(no, no, h, p, t0, tn);
    }
  }

  store_states<G, K>(dA, dAp + static_cast<long long>(b) * di * N, d0 + c0,
                     di, N, g);
  if (g == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (d0 + c0 + k < di)
        dDp[static_cast<long long>(b) * di + d0 + c0 + k] = dD[k];
  }
}

template <typename TX, int G, int K>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* Dv, const float* h_chunks,
           const float* dy, const float* dh, float* scratch, int batch, int T,
           int di, int N, void* dx, float* ddt, float* dBp, float* dCp,
           float* dAp, float* dDp, cudaStream_t stream) {
  using Sh = BwdShape<G, K>;
  const int ex = sizeof(TX);
  Plan pl;
  pl.vx = chunk_bytes(x, 1LL * di * ex, Sh::kCh * ex);
  pl.vdt = std::min(chunk_bytes(dt, di * 4LL, Sh::kCh * 4LL),
                    chunk_bytes(dy, di * 4LL, Sh::kCh * 4LL));
  pl.vbc = std::min(chunk_bytes(Bm, N * 4LL, 0), chunk_bytes(Cm, N * 4LL, 0));
  constexpr size_t smem = Sh::kXs * 4 + Sh::kXElems * sizeof(TX);
  static_assert(smem <= 232448, "at most 227 KB of shared memory a block");
  static size_t allowed = 48 * 1024;
  cudaError_t err =
      repro::allow_smem(ssm_scan_bwd_kernel<TX, G, K>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((di + Sh::kCh - 1) / Sh::kCh, batch);
  ssm_scan_bwd_kernel<TX, G, K><<<grid, Sh::kThreads, smem, stream>>>(
      static_cast<const TX*>(x), dt, A, Bm, Cm, Dv, h_chunks, dy, dh, scratch,
      batch, T, di, N, pl, static_cast<TX*>(dx), ddt, dBp, dCp, dAp, dDp);
  return static_cast<int>(cudaGetLastError());
}

// The walk form's lanes for N > 64 (ssm_scan.cu's launch_for): two
// channels of 8 states per lane up to N = 256, one channel of 16 states
// above; calls fn(G, K) as template arguments, or returns -1 for N <= 64
// (the chunk form's) and past 512 states.
template <typename Fn>
int for_states(int N, Fn fn) {
  if (N <= kChunkMaxN) return -1;
  if (N <= 128) return fn(std::integral_constant<int, 16>{},
                          std::integral_constant<int, 2>{});
  if (N <= 256) return fn(std::integral_constant<int, 32>{},
                          std::integral_constant<int, 2>{});
  if (N <= 512) return fn(std::integral_constant<int, 32>{},
                          std::integral_constant<int, 1>{});
  return -1;
}

// Resident blocks an SM of `kernel` at `threads` a block and `smem` bytes
// of dynamic shared memory, times its warps: resident warps an SM.
template <typename Kernel>
int resident_warps(Kernel kernel, int threads, size_t smem) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, threads, smem);
  return err == cudaSuccess ? blocks * threads / 32 : -static_cast<int>(err);
}

}  // namespace

// Channels per block of the chunk form for N states (its partial sums of
// dB and dC have ceil(di / that) rows), or -1 past 64 states.
extern "C" int ssm_scan_bwd_chunks_channels(int N) {
  return for_chunk_states(
      N, [](auto G) { return ChunkShape<decltype(G)::value>::kCh; });
}

// Channels per block of the walk form for N states (the partial sums of
// dB and dC have ceil(di / that) rows), or -1 for N <= 64 and past 512.
extern "C" int ssm_scan_bwd_channels(int N) {
  return for_states(N, [](auto G, auto K) {
    return BwdShape<decltype(G)::value, decltype(K)::value>::kCh;
  });
}

// Floats of global scratch a block of the walk form needs for N states (a
// launch needs that times its blocks, batch x ceil(di / channels)).
extern "C" int ssm_scan_bwd_scratch(int N) {
  return for_states(N, [](auto G, auto K) {
    return BwdShape<decltype(G)::value, decltype(K)::value>::kScratch;
  });
}

// Resident warps an SM of the instance that N states and x's type
// (x_bf16) take: kernel 0 the chunk form's chunk kernel, 1 its carry
// kernel, 2 the walk form's kernel; -1 where the form does not take N,
// another negative value a CUDA error.
extern "C" int ssm_scan_bwd_resident_warps(int N, int x_bf16, int kernel) {
  if (kernel == 2) {
    return for_states(N, [&](auto G, auto K) {
      constexpr int g = decltype(G)::value, k = decltype(K)::value;
      using Sh = BwdShape<g, k>;
      constexpr size_t floats = Sh::kXs * 4;
      auto at = [](auto kernel, size_t smem) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        return err == cudaSuccess ? resident_warps(kernel, Sh::kThreads, smem)
                                  : -static_cast<int>(err);
      };
      return x_bf16 ? at(ssm_scan_bwd_kernel<__nv_bfloat16, g, k>,
                         floats + Sh::kXElems * 2)
                    : at(ssm_scan_bwd_kernel<float, g, k>,
                         floats + Sh::kXElems * 4);
    });
  }
  return for_chunk_states(N, [&](auto G) {
    constexpr int g = decltype(G)::value;
    using Sh = ChunkShape<g>;
    const cudaError_t err = x_bf16 ? prepare_chunks<__nv_bfloat16, g>()
                                   : prepare_chunks<float, g>();
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (kernel == 1)
      return resident_warps(ssm_scan_bwd_carry_kernel<g>, Sh::kThreads,
                            Sh::kCarryFloats * 4);
    return x_bf16
               ? resident_warps(ssm_scan_bwd_chunk_kernel<__nv_bfloat16, g>,
                                Sh::kThreads, chunk_smem<__nv_bfloat16, g>())
               : resident_warps(ssm_scan_bwd_chunk_kernel<float, g>,
                                Sh::kThreads, chunk_smem<float, g>());
  });
}

// The chunk form, N at most 64: the forward's inputs (x [batch, T, di]
// float32 (x_bf16 0) or bfloat16 (x_bf16 1); dt [batch, T, di], A [di, N],
// Bm, Cm [batch, T, N], Dv [di] float32), its checkpoints h_chunks [batch,
// chunks, di, N] (chunks = ceil(T / 64)), dy [batch, T, di] and dh [batch,
// di, N] (or null: 0), float32, all contiguous; scratch g_sum [batch,
// chunks, di, N] and dt_sum [batch, chunks, di] (the summaries of chunks
// 1 ..).  Outputs dx [batch, T, di] in x's type, ddt [batch, T, di], and
// partial sums, float32: dBp, dCp [blocks, batch, T, N] (a block's
// ssm_scan_bwd_chunks_channels(N) channels of di each), dAp [batch,
// chunks, di, N], dDp [batch, chunks, di].  batch and chunks at most 65535.
extern "C" int ssm_scan_bwd_chunks_launch(
    const void* x, const float* dt, const float* A, const float* Bm,
    const float* Cm, const float* Dv, const float* h_chunks, const float* dy,
    const float* dh, float* g_sum, float* dt_sum, int batch, int T, int di,
    int N, int x_bf16, void* dx, float* ddt, float* dBp, float* dCp,
    float* dAp, float* dDp, void* stream) {
  if (N < 0 || N > kChunkMaxN || batch > 65535 ||
      (T + kChunk - 1) / kChunk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || di == 0 || T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return for_chunk_states(N, [&](auto G) {
    constexpr int g = decltype(G)::value;
    return x_bf16 ? launch_chunks<__nv_bfloat16, g>(
                        x, dt, A, Bm, Cm, Dv, h_chunks, dy, dh, g_sum, dt_sum,
                        batch, T, di, N, dx, ddt, dBp, dCp, dAp, dDp, s)
                  : launch_chunks<float, g>(
                        x, dt, A, Bm, Cm, Dv, h_chunks, dy, dh, g_sum, dt_sum,
                        batch, T, di, N, dx, ddt, dBp, dCp, dAp, dDp, s);
  });
}

// The walk form, N from 65 to 512: the forward's inputs as above, its
// checkpoints, dy and dh; scratch: ssm_scan_bwd_scratch(N) floats for each
// block.  Outputs dx [batch, T, di] in x's type, ddt [batch, T, di], and
// partial sums, each a block's (rows: ssm_scan_bwd_channels(N) channels of
// di) or a batch row's: dBp, dCp [blocks, batch, T, N], dAp [batch, di,
// N], dDp [batch, di], float32.
extern "C" int ssm_scan_bwd_launch(const void* x, const float* dt,
                                   const float* A, const float* Bm,
                                   const float* Cm, const float* Dv,
                                   const float* h_chunks, const float* dy,
                                   const float* dh, float* scratch, int batch,
                                   int T, int di, int N, int x_bf16, void* dx,
                                   float* ddt,
                                   float* dBp, float* dCp, float* dAp,
                                   float* dDp, void* stream) {
  if (batch == 0 || di == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = for_states(N, [&](auto G, auto K) {
    constexpr int g = decltype(G)::value, k = decltype(K)::value;
    return x_bf16 ? launch<__nv_bfloat16, g, k>(x, dt, A, Bm, Cm, Dv,
                                                h_chunks, dy, dh, scratch,
                                                batch, T, di, N, dx, ddt, dBp,
                                                dCp, dAp, dDp, s)
                  : launch<float, g, k>(x, dt, A, Bm, Cm, Dv, h_chunks, dy,
                                        dh, scratch, batch, T, di, N, dx,
                                        ddt, dBp, dCp, dAp, dDp, s);
  });
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}
