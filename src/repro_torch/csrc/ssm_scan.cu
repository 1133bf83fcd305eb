// ssm_scan: the selective-SSM recurrence of a Mamba block over a whole
// sequence, from h = 0,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      h [di, N]
//   y_t = h_t . C_t + D * x_t,
// returning y [B, T, di] and the final state h_T [B, di, N], both f32.
//
// Replaces the TPU kernel ssm_scan_pallas
// (src/repro/kernels/ssm_scan/kernel.py, _kernel).  The TPU kernel walked
// a sequential grid axis over 128-step time tiles with h [128 channels,
// N] in VMEM scratch, and its wrapper padded T and di to 128.  Here the
// time loop runs inside the block, h lives in registers for the whole
// sequence, and the ragged edges are masked; the final state, which the
// TPU kernel kept to itself, is written out for the decode cache.
//
// Bound: operations.  Per state element and step the update is h = e h +
// u B and y += h C: three FP32 instructions (one FMUL, two FFMA), five
// operations, where e = exp(dt A[d, n]) and u = dt x.  Mamba-2 (zamba2)
// repeats one A per head over the head's channels and its N states, so a
// row of A is constant and e is one number per channel and step: 5 N + 5
// operations per channel and step, at the zamba2 prefill shape (2.7e9
// state updates) 0.20 ms of the H100's FP32 rate against 0.13 ms for the
// bytes (x in bf16, dt and y in f32).  On a general row (Mamba-1) e takes
// one accurate expf per state element (7 N + 3 operations), and the
// special-function units issue exp at an eighth of the FP32 rate.
//
// Design.
//   * Lanes.  G lanes of a warp share a group of K channels.  Up to N =
//     256 a lane holds 8 states of each of 2 channels (K = 2, G = N / 8
//     rounded up to a power of two), above that 16 states of one channel;
//     B_t and C_t are loaded once for both channels, which halves the
//     shared-memory reads per update.  Lane g's states are n = 4 (q G + g)
//     + j, so for each q the G lanes read neighbouring float4s (float4
//     loads, not one 4-byte load per state element: 2.6x faster at the
//     zamba2 shape on an H100 80GB HBM3 at 700 W).  N is padded to a
//     power of two with states whose B and C are 0 (the copies zero-fill
//     them), which stay 0.  A block holds 32 channels of one batch row
//     (128 threads at N = 64), so the zamba2 prefill is 640 blocks, 5 to
//     an SM (the launch bounds keep the registers to that): 97% of 132 SMs
//     in one wave.
//   * Constant rows.  At the start each channel compares its row of A
//     with == against A[d, 0] over its G lanes (a NaN makes the row
//     general; -0 equals +0, and exp of either is 1).  On a constant row
//     e = expf(dt A[d, 0]) is taken once per channel and step, in the
//     staging pass below; a general row keeps dt there and takes expf(dt
//     A[d, n]) per state element.  Both routes run the same update with
//     explicit __fmul_rn / __fmaf_rn and sum in the same order, so a
//     constant row gives bitwise what the general route would give it.  A
//     warp whose channels are all constant runs a loop without the
//     general route, and a tile of 16 steps one without tests of T.
//     expf is the accurate library exp on both.
//   * Tiles.  Tiles of 16 steps of x and dt (the block's channels) and of
//     B and C are double-buffered in shared memory: the next tile's copies
//     are in flight while a tile's recurrence runs.  Where every row is
//     16-byte aligned (di a multiple of 8 in bf16 or of 4 in f32, N a
//     multiple of 4 and the padded N at most 256) one thread loads a tile
//     with four TMA box copies on an mbarrier, the edges zero-filled by
//     TMA, and stores y with one TMA box store per tile.  Otherwise every
//     thread issues cp.async chunks of 16, 8 or 4 bytes with zero-fill (a
//     bf16 x whose rows are not 4-byte aligned is copied element by
//     element) and the threads store y.  Per-thread chunk copies of every
//     tile stalled the warps at the zamba2 shape; TMA took that off them.
//   * Staging pass.  After a tile lands the block turns (x, dt) into u =
//     dt x, e (or dt) and D x in shared memory, a few (step, channel)
//     pairs per thread, unrolled.
//   * Steps.  Per step a lane loads B_t, C_t, u and e, updates its 16
//     state elements and sums its part of each channel's h . C in four
//     chains.  Every 4 steps the G lanes combine their partial sums with a
//     reduce-scatter over the whole warp (at N = 64, 7 shuffles leave one
//     (channel, step) sum in each lane) and add them to y in shared
//     memory.  Shuffles with a partial mask inside the per-channel branch
//     were slower: the compiler guards each with a convergence test.
//   * x is read in its own type (float32 or bfloat16, a template instance
//     each); bf16 to f32 is exact, so the result is the one of the same x
//     in f32.
//   * Checkpoints for the backward (ssm_scan_bwd.cu).  Where h_chunks is
//     given, the instance with kStates writes the state from the registers
//     at the start of every kChunk = 64 steps (ssm_scan.cuh); the serve
//     path passes none and runs the instances without.
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

// The TMA maps of one launch (x, dt, B, C and y; used where `tma`) and
// the chunk bytes of its cp.async copies otherwise.
struct Maps {
  CUtensorMap x, dt, b, c, y;
};
struct Plan {
  int tma, vx, vdt, vbc;
};

// One step of one channel on a lane's S states: h = e h + u B, and the
// lane's part of h . C.  e is ev on a constant row, else expf(ev * a)
// per state.
template <int S, bool kUniform>
__device__ __forceinline__ float update(float (&h)[S], const float (&a)[S],
                                        const float4 (&bv)[S / 4],
                                        const float4 (&cv)[S / 4], float u,
                                        float ev) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float bb[4] = {bv[q].x, bv[q].y, bv[q].z, bv[q].w};
    const float cc[4] = {cv[q].x, cv[q].y, cv[q].z, cv[q].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * q + j;
      const float e = kUniform ? ev : expf(__fmul_rn(ev, a[s]));
      h[s] = __fmaf_rn(e, h[s], __fmul_rn(u, bb[j]));
      acc[j] = __fmaf_rn(h[s], cc[j], acc[j]);
    }
  }
  return __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
}

// Steps tt0 .. tt0 + R - 1 (those below tn) of a lane's K channels.  B_t
// and C_t are loaded once for the K channels (lane g's states are
// n = 4 (q G + g) + j, so the G lanes read neighbouring float4s).  The G
// lanes then sum their K R partial dot products with a reduce-scatter
// (each level halves the values a lane holds and sends the other half to
// its partner) and an all-reduce over the lanes that are left; lane g < W
// adds its sums to ys.  Every shuffle takes the whole warp: kAll says
// that every channel of the warp is constant, else each channel takes its
// own route and the warp meets again before the shuffles.  kFull: all R
// steps are below tn.
template <int G, int K, bool kAll, bool kFull>
__device__ __forceinline__ void scan_steps(float (&h)[K][16 / K],
                                           const float (&a)[K][16 / K],
                                           const bool (&uniform)[K],
                                           const float* bs, const float* cs,
                                           const float* us, const float* es,
                                           float* ys, int tt0, int tn,
                                           int c0, int g) {
  using Sh = Shape<G, K>;
  constexpr int S = Sh::kS, R = Sh::kR, V = Sh::kV, W = Sh::kW;
  constexpr int CH = Sh::kCh, NP = Sh::kNp;
  float part[V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int tt = tt0 + r;
#pragma unroll
    for (int k = 0; k < K; ++k) part[k * R + r] = 0.0f;
    if (kFull || tt < tn) {
      const float4* b4 = reinterpret_cast<const float4*>(bs + tt * NP) + g;
      const float4* c4 = reinterpret_cast<const float4*>(cs + tt * NP) + g;
      float4 bv[S / 4], cv[S / 4];
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        bv[q] = b4[q * G];
        cv[q] = c4[q * G];
      }
      float u[K], ev[K];
      if constexpr (K == 2) {
        const float2 u2 = *reinterpret_cast<const float2*>(us + tt * CH + c0);
        const float2 e2 = *reinterpret_cast<const float2*>(es + tt * CH + c0);
        u[0] = u2.x, u[1] = u2.y, ev[0] = e2.x, ev[1] = e2.y;
      } else {
        u[0] = us[tt * CH + c0], ev[0] = es[tt * CH + c0];
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        part[k * R + r] =
            kAll || uniform[k]
                ? update<S, true>(h[k], a[k], bv, cv, u[k], ev[k])
                : update<S, false>(h[k], a[k], bv, cv, u[k], ev[k]);
    }
  }
  int base = 0;
#pragma unroll
  for (int m = 1, n = V; m < W; m <<= 1, n >>= 1) {
    const bool up = g & m;
    if (up) base += n / 2;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const float send = up ? part[j] : part[j + n / 2];
      const float keep = up ? part[j + n / 2] : part[j];
      part[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, m));
    }
  }
#pragma unroll
  for (int j = 0; j < V / W; ++j) {
#pragma unroll
    for (int m = W; m < G; m <<= 1)
      part[j] = __fadd_rn(part[j], __shfl_xor_sync(0xffffffffu, part[j], m));
    const int v = base + j, r = v % R;
    if (g < W && (kFull || tt0 + r < tn)) {
      float* yp = ys + (tt0 + r) * CH + c0 + v / R;
      *yp = __fadd_rn(*yp, part[j]);
    }
  }
}

// kStates: also write the state at the start of every kChunk steps to
// h_chunks [batch, ceil(T / kChunk), di, N] (the serve path's instances
// have it false and are the same code as without checkpoints).
template <typename TX, int G, int K, bool kStates>
__global__ void __launch_bounds__(Shape<G, K>::kThreads,
                                  Shape<G, K>::kMinBlocks)
    ssm_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ Dv, int T, int di, int N,
                    const __grid_constant__ Maps maps, Plan pl,
                    float* __restrict__ y, float* __restrict__ h_out,
                    float* __restrict__ h_chunks) {
  using Sh = Shape<G, K>;
  constexpr int S = Sh::kS, CH = Sh::kCh, NP = Sh::kNp, R = Sh::kR;
  constexpr int THREADS = Sh::kThreads;
  constexpr int TILE_S = Sh::kTileS, TILE_C = Sh::kTileC;
  extern __shared__ __align__(128) float4 smem4[];
  float* sf = reinterpret_cast<float*>(smem4);
  float* bs = sf + Sh::kBs;
  float* cs = sf + Sh::kCs;
  float* dts = sf + Sh::kDts;
  float* us = sf + Sh::kUs;  // dt * x
  float* es = sf + Sh::kEs;  // exp(dt * a0) on a constant row, else dt
  float* ys = sf + Sh::kYs;  // D * x, then y
  float* a0s = sf + Sh::kChan;
  float* ds = a0s + CH;
  int* unis = reinterpret_cast<int*>(ds + CH);
  uint64_t* full = reinterpret_cast<uint64_t*>(sf + Sh::kBar);  // [2]
  TX* xs = reinterpret_cast<TX*>(sf + Sh::kXs);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int g = threadIdx.x % G;
  const int c0 = threadIdx.x / G * K;  // this lane's channels c0 .. c0 + K - 1

  // Is each channel's row of A constant?  Padded states do not count.
  const unsigned group =
      G == 32 ? 0xffffffffu
              : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  float h[K][S], a[K][S];
  bool uniform[K], all = true;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + c0 + k;
    const bool live = d < di;
    const float* arow = A + static_cast<long long>(d) * N;
    const float a0 = live ? arow[0] : 0.0f;
    bool same = true;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = 4 * (s / 4 * G + g) + s % 4;
      h[k][s] = 0.0f;
      const bool in = live && n < N;
      a[k][s] = in ? arow[n] : 0.0f;
      same = same && (!in || a[k][s] == a0);
    }
    uniform[k] = (__ballot_sync(0xffffffffu, same) & group) == group;
    all = all && uniform[k];
    if (g == 0) {
      a0s[c0 + k] = a0;
      ds[c0 + k] = live ? Dv[d] : 0.0f;
      unis[c0 + k] = uniform[k];
    }
  }
  all = __all_sync(0xffffffffu, all);
  if (threadIdx.x == 0 && pl.tma) {
    sm::mbar_init(full, 1);
    sm::mbar_init(full + 1, 1);
    sm::mbar_fence_init();
  }
  __syncthreads();

  // In the staging pass this thread takes PASS (step, channel) pairs; where
  // the block's threads are a multiple of its channels, all of one channel.
  constexpr int PASS = (TILE_C + THREADS - 1) / THREADS;
  constexpr bool ONE = THREADS % CH == 0;
  const int pc = threadIdx.x % CH;
  const bool p_uniform = ONE && unis[pc];
  const float p_a0 = a0s[pc], p_d = ds[pc];

  const long long row0 = static_cast<long long>(b) * T;
  const int cols = min(CH, di - d0);
  // Issues the copies of the tile at step t0 into buffer p.
  auto stage = [&](int t0, int p) {
    if (pl.tma) {
      if (threadIdx.x == 0) {
        constexpr uint32_t bytes =
            (2 * TILE_S + TILE_C) * 4 + TILE_C * sizeof(TX);
        sm::mbar_expect_tx(full + p, bytes);
        sm::tma_load_3d(xs + p * TILE_C, &maps.x, full + p, d0, t0, b);
        sm::tma_load_3d(dts + p * TILE_C, &maps.dt, full + p, d0, t0, b);
        sm::tma_load_3d(bs + p * TILE_S, &maps.b, full + p, 0, t0, b);
        sm::tma_load_3d(cs + p * TILE_S, &maps.c, full + p, 0, t0, b);
      }
      return;
    }
    const int rows = min(kTile, T - t0);
    const long long at = (row0 + t0) * di + d0;
    stage_box<CH, THREADS>(xs + p * TILE_C, x + at, di, rows, cols, pl.vx);
    stage_box<CH, THREADS>(dts + p * TILE_C, dt + at, di, rows, cols,
                           pl.vdt);
    stage_box<NP, THREADS>(bs + p * TILE_S, Bm + (row0 + t0) * N, N, rows, N,
                           pl.vbc);
    stage_box<NP, THREADS>(cs + p * TILE_S, Cm + (row0 + t0) * N, N, rows, N,
                           pl.vbc);
    sm::cp_async_commit();
  };

  const int tiles = (T + kTile - 1) / kTile;
  if (tiles > 0) stage(0, 0);
  for (int it = 0; it < tiles; ++it) {
    const int p = it & 1, t0 = it * kTile, tn = min(kTile, T - t0);
    float* ysp = ys + p * TILE_C;
    if constexpr (kStates) {
      // h is the state before step t0: a checkpoint every kChunk steps.
      if (it % kChunkTiles == 0) {
        const int nc = (T + kChunk - 1) / kChunk;
        store_states<G, K>(
            h, h_chunks + (static_cast<long long>(b) * nc + it / kChunkTiles) *
                              di * N,
            d0 + c0, di, N, g);
      }
    }
    if (pl.tma) {
      // ys[p] was last stored from at tile it - 2; the store must have read
      // it, and this thread's writes to ys[p ^ 1] must reach the TMA unit.
      if (threadIdx.x == 0) sm::bulk_wait_all<true>();
      sm::fence_proxy_async();
      sm::mbar_wait(full + p, (it >> 1) & 1);
    } else {
      sm::cp_async_wait_all();
    }
    __syncthreads();  // tile it has landed; tile it - 1's steps are done
    if (it + 1 < tiles) stage(t0 + kTile, p ^ 1);
    if (pl.tma && it > 0 && threadIdx.x == 0) {
      sm::tma_store_3d(&maps.y, ys + (p ^ 1) * TILE_C, d0, t0 - kTile, b);
      sm::bulk_commit();
    }
    // The staging pass: (step, channel) pairs, channels fastest, unrolled.
#pragma unroll 4
    for (int j = 0; j < PASS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      if (TILE_C % THREADS != 0 && i >= TILE_C) break;
      const int tt = i / CH, c = i % CH;
      if (!pl.tma && it > 0 && c < cols)  // tile it - 1 had kTile steps
        y[(row0 + t0 - kTile + tt) * di + d0 + c] = ys[(p ^ 1) * TILE_C + i];
      const float xv = to_f32(xs[p * TILE_C + i]);
      const float dtv = dts[p * TILE_C + i];
      const bool pu = ONE ? p_uniform : unis[c];
      us[i] = __fmul_rn(dtv, xv);
      es[i] = pu ? expf(__fmul_rn(dtv, ONE ? p_a0 : a0s[c])) : dtv;
      ysp[i] = __fmul_rn(ONE ? p_d : ds[c], xv);
    }
    __syncthreads();
    const float* bsp = bs + p * TILE_S;
    const float* csp = cs + p * TILE_S;
    // The step loop, specialised on whether every channel of the warp is
    // constant and whether the tile has all its steps.
    auto steps = [&](auto k_all, auto k_full) {
      for (int tt0 = 0; tt0 < tn; tt0 += R)
        scan_steps<G, K, decltype(k_all)::value, decltype(k_full)::value>(
            h, a, uniform, bsp, csp, us, es, ysp, tt0, tn, c0, g);
    };
    constexpr std::true_type yes{};
    constexpr std::false_type no{};
    if (tn == kTile)
      all ? steps(yes, yes) : steps(no, yes);
    else
      all ? steps(yes, no) : steps(no, no);
  }
  if (pl.tma) sm::fence_proxy_async();
  __syncthreads();
  if (tiles > 0) {
    const int t0 = (tiles - 1) * kTile, tn = T - t0;
    const float* ysp = ys + ((tiles - 1) & 1) * TILE_C;
    if (pl.tma) {
      if (threadIdx.x == 0) {
        sm::tma_store_3d(&maps.y, ysp, d0, t0, b);
        sm::bulk_commit();
        sm::bulk_wait_all<false>();
      }
    } else {
      for (int i = threadIdx.x; i < TILE_C; i += THREADS) {
        const int tt = i / CH, c = i % CH;
        if (tt < tn && c < cols) y[(row0 + t0 + tt) * di + d0 + c] = ysp[i];
      }
    }
  }

  store_states<G, K>(h, h_out + static_cast<long long>(b) * di * N, d0 + c0,
                     di, N, g);
}

template <typename TX, int G, int K, bool kStates>
int launch(const void* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* Dv, int batch, int T, int di, int N,
           float* y, float* h_out, float* h_chunks, cudaStream_t stream) {
  using Sh = Shape<G, K>;
  const int ex = sizeof(TX);
  Plan pl;
  pl.vx = chunk_bytes(x, 1LL * di * ex, Sh::kCh * ex);
  pl.vdt = chunk_bytes(dt, di * 4LL, Sh::kCh * 4LL);
  pl.vbc = std::min(chunk_bytes(Bm, N * 4LL, 0), chunk_bytes(Cm, N * 4LL, 0));
  // TMA where every row is 16-byte aligned and a B/C box row fits (at most
  // 256 elements); otherwise cp.async and plain stores.
  Maps maps;
  pl.tma = pl.vx == 16 && pl.vdt == 16 && pl.vbc == 16 &&
           chunk_bytes(y, di * 4LL, 0) == 16 && Sh::kNp <= 256 && T > 0;
  if (pl.tma) {
    const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
    const auto tx = ex == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : f32;
    cudaError_t err = sm::tma_map_3d(&maps.x, tx, ex, x, di, T, batch,
                                     Sh::kCh, kTile, none);
    if (err == cudaSuccess)
      err = sm::tma_map_3d(&maps.dt, f32, 4, dt, di, T, batch, Sh::kCh, kTile,
                           none);
    if (err == cudaSuccess)
      err = sm::tma_map_3d(&maps.b, f32, 4, Bm, N, T, batch, Sh::kNp, kTile,
                           none);
    if (err == cudaSuccess)
      err = sm::tma_map_3d(&maps.c, f32, 4, Cm, N, T, batch, Sh::kNp, kTile,
                           none);
    if (err == cudaSuccess)
      err = sm::tma_map_3d(&maps.y, f32, 4, y, di, T, batch, Sh::kCh, kTile,
                           none);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr size_t smem = Sh::kXs * 4 + Sh::kXElems * sizeof(TX);
  static size_t allowed = 48 * 1024;
  cudaError_t err =
      repro::allow_smem(ssm_scan_kernel<TX, G, K, kStates>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((di + Sh::kCh - 1) / Sh::kCh, batch);
  ssm_scan_kernel<TX, G, K, kStates><<<grid, Sh::kThreads, smem, stream>>>(
      static_cast<const TX*>(x), dt, A, Bm, Cm, Dv, T, di, N, maps, pl, y,
      h_out, h_chunks);
  return static_cast<int>(cudaGetLastError());
}

// Two channels of 8 states per lane up to N = 256 (G = N / 8 rounded up
// to a power of two), one channel of 16 states per lane above.
template <typename TX>
int launch_for(int N, const void* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, const float* Dv, int batch,
               int T, int di, float* y, float* h_out, float* h_chunks,
               cudaStream_t s) {
#define REPRO_SCAN(G, K)                                                     \
  h_chunks ? launch<TX, G, K, true>(x, dt, A, Bm, Cm, Dv, batch, T, di, N,   \
                                    y, h_out, h_chunks, s)                   \
           : launch<TX, G, K, false>(x, dt, A, Bm, Cm, Dv, batch, T, di, N, \
                                     y, h_out, nullptr, s)
  if (N <= 8) return REPRO_SCAN(1, 2);
  if (N <= 16) return REPRO_SCAN(2, 2);
  if (N <= 32) return REPRO_SCAN(4, 2);
  if (N <= 64) return REPRO_SCAN(8, 2);
  if (N <= 128) return REPRO_SCAN(16, 2);
  if (N <= 256) return REPRO_SCAN(32, 2);
  if (N <= 512) return REPRO_SCAN(32, 1);
#undef REPRO_SCAN
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [batch, T, di] float32 (x_bf16 0) or bfloat16 (x_bf16 1); dt
// [batch, T, di], A [di, N], Bm, Cm [batch, T, N] and Dv [di] float32; all
// contiguous.  Outputs y [batch, T, di] and h_out [batch, di, N], float32,
// and, unless h_chunks is null, the state at the start of every kChunk
// steps, h_chunks [batch, ceil(T / kChunk), di, N] float32.  N at most
// 16 * 32.
extern "C" int ssm_scan_launch(const void* x, const float* dt, const float* A,
                               const float* Bm, const float* Cm,
                               const float* Dv, int batch, int T, int di,
                               int N, int x_bf16, float* y, float* h_out,
                               float* h_chunks, void* stream) {
  if (batch == 0 || di == 0 || N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_for<__nv_bfloat16>(N, x, dt, A, Bm, Cm, Dv, batch, T,
                                            di, y, h_out, h_chunks, s)
                : launch_for<float>(N, x, dt, A, Bm, Cm, Dv, batch, T, di, y,
                                    h_out, h_chunks, s);
}
