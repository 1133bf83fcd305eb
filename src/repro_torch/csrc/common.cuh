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
// * word_key: the merge stage's wrap-aware sort key of a wire word,
//   (w - now + 128) & 255 for a valid word and 256 for any negative one,
//   shared by the word sort and the drain's merge.
// * counting_pass: one stable counting-sort pass over a row in one
//   group of whole warps (WarpGroup: the block, or warps that share a
//   named barrier, so several rows can be sorted at once).  Each warp
//   owns a contiguous run of whole 32-lane groups (warp_chunk), counts
//   its bins into its own column of the group's histogram (warp_count),
//   an exclusive scan in (bin, warp) order (exclusive_scan) gives every
//   (bin, warp) its first output position, and the warp walks its lanes
//   again in order, ranking each within its bin (warp_rank).  Lanes of
//   one bin find each other with __match_any_sync; the histogram's rows
//   are padded to n_warps + 1 columns, so the bins of one warp fall in
//   different banks, and the padding column holds each bin's end after
//   the scan.  No atomics, so the order is deterministic.
// * bit_extract: a software pext (the bits of x under a mask, packed
//   into the low bits in order of significance), which makes a radix
//   sort pass only over the key bits that vary in a row.
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

// The merge stage's sort key of wire word w at clock now: the deadline's
// distance from now + 128 modulo 256 for a valid word (w >= 0), 256 for a
// sentinel or any other negative word (events.word_sort_key).
__device__ __forceinline__ int word_key(int w, int now) {
  return w >= 0 ? wrap_add(wrap_sub(w, now), kHalfWindow) & kTimeMask
                : kTimeMod;
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
// lif_update_decay takes decay = expf(__fdiv_rn(-1.0f, tau)) computed
// once, for a neuron stepped several times.
__device__ __forceinline__ bool lif_update_decay(float& v, int& refrac, float current,
                                                 float decay, float v_th, float v_reset,
                                                 float v_rest, int refrac_period) {
  const bool active = refrac <= 0;
  const float leak = __fadd_rn(v_rest, __fmul_rn(decay, __fsub_rn(v, v_rest)));
  const float v_int = active ? __fadd_rn(leak, current) : v;
  const bool spike = active && v_int > v_th;
  const int left = wrap_sub(refrac, 1);
  v = spike ? v_reset : v_int;
  refrac = spike ? refrac_period : (left > 0 ? left : 0);
  return spike;
}

__device__ __forceinline__ bool lif_update(float& v, int& refrac, float current,
                                           float tau, float v_th, float v_reset,
                                           float v_rest, int refrac_period) {
  return lif_update_decay(v, refrac, current, expf(__fdiv_rn(-1.0f, tau)), v_th,
                          v_reset, v_rest, refrac_period);
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

// A set of whole warps that runs a counting pass together: thread `rank`
// of `size` (a multiple of 32), synchronised on barrier `bar` (0: the
// whole block, __syncthreads; 1 to 15: a named barrier of `size` threads).
struct WarpGroup {
  int rank;
  int size;
  int bar;
  __device__ __forceinline__ int warp() const { return rank >> 5; }
  __device__ __forceinline__ int warps() const { return size >> 5; }
  __device__ __forceinline__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(size) : "memory");
    }
  }
};

__device__ __forceinline__ WarpGroup whole_block() {
  return {static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x), 0};
}

// The lanes [lo, hi) of a row of n that the calling warp owns in a
// counting pass: whole 32-lane groups, contiguous, in lane order, so all
// of warp w's lanes precede warp w + 1's.
__device__ __forceinline__ void warp_chunk(const WarpGroup& g, int n, int& lo,
                                           int& hi) {
  const int groups = (((n + 31) >> 5) + g.warps() - 1) / g.warps();
  lo = min(n, g.warp() * groups * 32);
  hi = min(n, lo + groups * 32);
}

// Count one 32-lane step of the warp into col[bin * stride] (the warp's
// column of a group histogram).  bin < 0: the lane holds no element.
// Every lane of the warp calls.
__device__ __forceinline__ void warp_count(int bin, int* col, int stride) {
  const unsigned same = __match_any_sync(0xffffffffu, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(same) - 1)
    col[bin * stride] += __popc(same);
  __syncwarp();
}

// Stable position of one 32-lane step of the warp: col[bin * stride]
// holds the next free output position of each bin for this warp (the
// histogram after exclusive_scan); the lanes of one bin take consecutive
// positions in lane order and col advances past them.  Returns -1 where
// bin < 0.  Every lane of the warp calls.
__device__ __forceinline__ int warp_rank(int bin, int* col, int stride) {
  const unsigned same = __match_any_sync(0xffffffffu, bin);
  const int lane = threadIdx.x & 31;
  int pos = -1;
  if (bin >= 0) pos = col[bin * stride] + __popc(same & ((1u << lane) - 1u));
  __syncwarp();
  if (bin >= 0 && lane == __ffs(same) - 1) col[bin * stride] = pos + __popc(same);
  __syncwarp();
  return pos;
}

// Exclusive prefix sum of a[0, n) in shared memory, in place, by group g.
// Each thread sums a contiguous segment, warps scan the segment sums with
// shuffles, and the group's first warp scans the warp sums in scratch
// (shared, 32 ints).  The caller synchronises before; the function
// synchronises after.
__device__ void exclusive_scan(const WarpGroup& g, int* a, int n,
                               int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = g.warp();
  const int per = (n + g.size - 1) / g.size;
  const int lo = min(n, g.rank * per);
  const int hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  g.sync();
  if (warp == 0) {
    const int v = lane < g.warps() ? scratch[lane] : 0;
    int vi = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, vi, d);
      if (lane >= d) vi += y;
    }
    scratch[lane] = vi - v;
  }
  g.sync();
  int run = scratch[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  g.sync();
}

// One stable counting-sort pass over a row of n lanes by group g (every
// thread of the group calls):
//   bin_of(i)      the bin of lane i, in [0, nb)
//   place(i, pos)  lane i goes to position pos of the sorted row
//   hist           shared, nb * (g.warps() + 1) ints (scratch)
//   scratch        shared, 32 ints
//   ends           null, or shared nb ints: ends[b] receives the number
//                  of lanes in bins <= b
// Lanes of one bin keep their lane order.  The caller synchronises the
// group before (bin_of's inputs) and after (place's and ends' outputs).
template <typename BinOf, typename Place>
__device__ void counting_pass(const WarpGroup& g, int n, int nb, int* hist,
                              int* scratch, BinOf bin_of, Place place,
                              int* ends = nullptr) {
  const int stride = g.warps() + 1;
  const int warp = g.warp();
  const int lane = threadIdx.x & 31;
  for (int i = g.rank; i < nb * stride; i += g.size) hist[i] = 0;
  g.sync();
  int lo, hi;
  warp_chunk(g, n, lo, hi);
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    warp_count(i < hi ? bin_of(i) : -1, hist + warp, stride);
  }
  g.sync();
  exclusive_scan(g, hist, nb * stride, scratch);
  // The padding column counts nothing, so it holds the end of its bin.
  if (ends != nullptr)
    for (int b = g.rank; b < nb; b += g.size)
      ends[b] = hist[b * stride + stride - 1];
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const int pos = warp_rank(i < hi ? bin_of(i) : -1, hist + warp, stride);
    if (pos >= 0) place(i, pos);
  }
}

// The bits of x where mask is set, packed into the low bits in their
// order of significance (x86's pext), one run of set bits at a time.
__device__ __forceinline__ unsigned bit_extract(unsigned x, unsigned mask) {
  unsigned out = 0;
  int k = 0;
  while (mask != 0) {
    const int lo = __ffs(mask) - 1;
    const unsigned m = mask >> lo;
    const int len = ~m == 0 ? 32 : __ffs(~m) - 1;
    const unsigned ones = len == 32 ? 0xffffffffu : (1u << len) - 1u;
    out |= ((x >> lo) & ones) << k;
    k += len;
    mask &= ~(ones << lo);
  }
  return out;
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
