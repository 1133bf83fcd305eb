// Pieces shared by the selective-scan forward (ssm_scan.cu) and its
// backward (ssm_scan_bwd.cu): the lane shape, the state checkpoints'
// spacing, and the cp.async staging of one tile of steps.
//
// * Lanes.  G lanes of a warp share a group of K channels; a lane holds
//   S = 16 / K states of each of its K channels, states n = 4 (q G + g)
//   + j of lane g (q < S / 4, j < 4), so for each q the G lanes read
//   neighbouring float4s of B_t and C_t.  N is padded to Np = S G.
// * Checkpoints.  On request the forward writes the state at the start
//   of every kChunk steps, h_chunks [batch, ceil(T / kChunk), di, N]
//   (the first is 0); the backward recomputes the states of a chunk from
//   it.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "hopper.cuh"

namespace repro {
namespace ssm {

constexpr int kMaxThreads = 512;
constexpr int kTile = 16;   // time steps per staged tile
constexpr int kChunk = 64;  // time steps per state checkpoint
constexpr int kChunkTiles = kChunk / kTile;
static_assert(kChunk % kTile == 0, "a chunk is whole tiles");

// The forward's block shape for G lanes per channel group and K channels
// per lane: S = 16 / K states of each of its K channels per lane, N padded
// to S G; 32 channels per block where that gives 32 to 512 threads; R
// steps whose K R partial sums one reduction across the G lanes takes
// together.
template <int G, int K>
struct Shape {
  static constexpr int kS = 16 / K;
  static constexpr int kNp = kS * G;
  static constexpr int kCh = 32 * G / K < 32 ? 32 * K / G
                             : 32 * G / K > kMaxThreads ? kMaxThreads * K / G
                                                        : 32;
  static constexpr int kThreads = kCh / K * G;
  static constexpr int kR = G / K < 1 ? 1 : G / K > 4 ? 4 : G / K;
  static constexpr int kV = K * kR;           // partial sums per lane
  static constexpr int kW = kV < G ? kV : G;  // lanes they scatter over
  // Registers for 20 resident warps per SM (640 threads).
  static constexpr int kMinBlocks = kThreads < 640 ? 640 / kThreads : 1;
  // Shared memory layout, in floats; every tile starts 128-byte aligned.
  static constexpr int kTileS = kTile * kNp, kTileC = kTile * kCh;
  static constexpr int kBs = 0, kCs = kBs + 2 * kTileS;  // [2][kTile][kNp]
  static constexpr int kDts = kCs + 2 * kTileS;          // [2][kTile][kCh]
  static constexpr int kUs = kDts + 2 * kTileC;          // [kTile][kCh]
  static constexpr int kEs = kUs + kTileC;               // [kTile][kCh]
  static constexpr int kYs = kEs + kTileC;               // [2][kTile][kCh]
  static constexpr int kChan = kYs + 2 * kTileC;  // [kCh] a0, D, flag
  static constexpr int kBar = kChan + 3 * kCh;    // two 8-byte mbarriers
  static constexpr int kXs = (kBar + 4 + 31) / 32 * 32;  // [2][kTile][kCh]
  static constexpr int kXElems = 2 * kTileC;             // of x's type
};

// The state index of a lane's s-th state slot.
template <int G>
__device__ __forceinline__ int state_n(int s, int g) {
  return 4 * (s / 4 * G + g) + s % 4;
}

// Writes a lane's values (states, or a sum per state) of its K channels
// (those below di and N) to the [di, N] block at `dst`.
template <int G, int K>
__device__ __forceinline__ void store_states(const float (&h)[K][16 / K],
                                             float* dst, int d, int di,
                                             int N, int g) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (d + k >= di) continue;
    float* hp = dst + static_cast<long long>(d + k) * N;
#pragma unroll
    for (int s = 0; s < 16 / K; ++s) {
      const int n = state_n<G>(s, g);
      if (n < N) hp[n] = h[k][s];
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One chunk of `vec` bytes, of which the first `bytes` come from src.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int vec,
                                           int bytes) {
  if (vec == 16) {
    sm90::cp_async<16>(dst, src, bytes);
  } else if (vec == 8) {
    sm90::cp_async<8>(dst, src, bytes);
  } else if (vec == 4) {
    sm90::cp_async<4>(dst, src, bytes);
  } else {  // a single bf16 (2 bytes), copied synchronously
    *reinterpret_cast<uint16_t*>(dst) =
        bytes ? *reinterpret_cast<const uint16_t*>(src) : 0;
  }
}

// Copies rows [0, rows) x columns [0, cols) of a [kRows][W] box from src
// (row stride `stride` elements) into dst (row stride W) with cp.async,
// in chunks of `vec` bytes (a power of two); the rest of the box is
// zero-filled.
template <int W, int kThreads, typename T, int kRows = kTile>
__device__ __forceinline__ void stage_box(T* dst, const T* src,
                                          long long stride, int rows,
                                          int cols, int vec) {
  const int lg = __ffs(max(vec / static_cast<int>(sizeof(T)), 1)) - 1;
  const int per = 1 << lg, cpr = W >> lg, shift = __ffs(cpr) - 1;
  for (int i = threadIdx.x; i < kRows * cpr; i += kThreads) {
    const int r = i >> shift, col = (i & (cpr - 1)) << lg;
    const int n = r < rows ? min(per, cols - col) : 0;
    const int bytes = max(n, 0) * static_cast<int>(sizeof(T));
    copy_chunk(dst + r * W + col, bytes ? src + r * stride + col : src, vec,
               bytes);
  }
}

// The widest chunk (16, 8, 4 or 2 bytes) at which every row of a tensor
// with `row_bytes` per row, starting `step_bytes` apart, is aligned.
inline int chunk_bytes(const void* base, long long row_bytes,
                       long long step_bytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(base) |
                         static_cast<uintptr_t>(row_bytes) |
                         static_cast<uintptr_t>(step_bytes);
  int v = 16;
  while (v > 2 && bits % v != 0) v >>= 1;
  return v;
}

}  // namespace ssm
}  // namespace repro
