// Device helpers shared by the pulse-communication kernels.
//
// * Integer arithmetic with the reference's semantics: jnp's // and %
//   floor where CUDA's / and % truncate, and int32 sums wrap.
// * block_stable_rank: the rank of each lane within its bucket in lane
//   order (a stable, FIFO rank), which atomicAdd slot assignment cannot
//   give.  Warps rank their own lanes with __match_any_sync + __popc;
//   per-warp bucket histograms in shared memory get an exclusive scan
//   over warps.
// * lif_update: one LIF step of one neuron, each operation rounded as
//   the reference and PyTorch's separate elementwise kernels round it.
// * bitonic_sort: a shared-memory bitonic network on unique composite
//   keys (sort key * n + lane in 32 bits, or key << 32 | lane in 64), so
//   the result is the stable order by key with the lane index as
//   tie-break.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kSentinel = -1;
constexpr int kTimeMask = 0xFF;
constexpr int kAddrMask = 0x3FFF;
constexpr int kAddrShift = 8;
constexpr int kTimeMod = 256;
constexpr int kHalfWindow = 128;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// Floor division and modulo for b > 0 (jnp semantics).
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One Euler step of a LIF neuron; returns whether it spiked.
//   decay = exp(-1 / tau); active = refrac <= 0;
//   v_int = active ? (v_rest + decay * (v - v_rest)) + current : v;
//   spike = active && v_int > v_th; v = spike ? v_reset : v_int;
//   refrac = spike ? refrac_period : max(refrac - 1, 0).
// The _rn intrinsics keep nvcc from contracting the product and the sum
// into one FMA (the reference rounds the product first), expf (not
// __expf) is the correctly rounded library exp, and -1.0f / tau stays in
// float.
__device__ __forceinline__ bool lif_update(float& v, int& refrac, float current,
                                           float tau, float v_th, float v_reset,
                                           float v_rest, int refrac_period) {
  const float decay = expf(__fdiv_rn(-1.0f, tau));
  const bool active = refrac <= 0;
  const float leak = __fadd_rn(v_rest, __fmul_rn(decay, __fsub_rn(v, v_rest)));
  const float v_int = active ? __fadd_rn(leak, current) : v;
  const bool spike = active && v_int > v_th;
  const int left = wrap_sub(refrac, 1);
  v = spike ? v_reset : v_int;
  refrac = spike ? refrac_period : (left > 0 ? left : 0);
  return spike;
}

// Sum of v over the warp, added to *dst in shared memory by lane 0.
__device__ __forceinline__ void warp_tally(int v, int* dst) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(dst, v);
}

// Stable rank of one tile of lanes (one lane per thread; every thread of
// the block calls this, blockDim.x a multiple of 32).
//   key     bucket the lane is ranked against, in [0, nb)
//   member  whether the lane counts towards bucket `key`
//   hist    shared, n_warps * nb ints (scratch)
//   running shared, nb ints: members of each bucket in earlier tiles;
//           updated to include this tile
// Returns the number of members of `key` before this lane, over all
// tiles so far.
__device__ int block_stable_rank(int key, bool member, int nb, int* hist,
                                 int* running) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < n_warps * nb; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const unsigned same = __match_any_sync(0xffffffffu, key);
  const unsigned members = __ballot_sync(0xffffffffu, member);
  const unsigned before = (1u << lane) - 1u;
  const int in_warp = __popc(same & members & before);
  if (lane == __ffs(same) - 1) hist[warp * nb + key] = __popc(same & members);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    int acc = running[b];
    for (int w = 0; w < n_warps; ++w) {
      const int c = hist[w * nb + b];
      hist[w * nb + b] = acc;
      acc += c;
    }
    running[b] = acc;
  }
  __syncthreads();
  const int rank = hist[warp * nb + key] + in_warp;
  __syncthreads();  // hist is cleared again by the next tile
  return rank;
}

// Ascending bitonic sort of a[0, n) in shared memory, n a power of two,
// K an unsigned integer type.  The caller synchronises before; the
// function synchronises after.
template <typename K>
__device__ void bitonic_sort(K* a, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const K x = a[i];
          const K y = a[ixj];
          const bool ascending = (i & k) == 0;
          if ((x > y) == ascending) {
            a[i] = y;
            a[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.  `allowed`
// (a static of the caller) remembers what was granted, so the attribute is
// set once per size and never inside a CUDA graph capture of later calls.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace repro

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
