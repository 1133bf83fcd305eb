// fused_drain: the whole superstep drain phase (merge + ring deposit) of
// every chip in one launch.
//
// Replaces the TPU kernel fused_drain_pallas
// (src/repro/kernels/fused_drain/kernel.py, _kernel, _sort_row,
// _deposit).  The TPU kernel deposited with an outer-product MXU matmul
// of slot and column one-hots because it lacks a fast VMEM scatter; here
// the deposit is an integer atomicAdd into a shared-memory copy of the
// chip's [D, n_inputs] ring, which is bitwise safe because integer adds
// commute.
//
// One CTA per chip, looping over the B substeps, because the ring and
// the merge queue carry from one substep to the next.  Per substep k at
// now = t0 + k:
//   passthrough  the delivered row as it is;
//   sort         the row sorted stably by (w - now + 128) & 255 (invalid
//                words key 256), with the lane index as tie-break;
//   rate         queue + row + sentinels sorted to a power of two, emit
//                the first `rate` words, keep [rate, rate + depth) as the
//                queue, dropped = max(n_valid - emitted - depth, 0).
// The sort is bitonic_sort on composite keys key * n + lane.  Each
// emitted word w >= 0 with ahead = wrap8(w - now) deposits at
// ring[(now + ahead) mod D, clip(addr)] if min_ahead < ahead <= D and is
// counted in dep_expired otherwise.  A gated-off chip (pipeline empty
// carry) emits sentinels and keeps its queue.
//
// Bound: bytes.  The ring and queue are read and written once per block,
// each delivered word read once and each emitted word written once; the
// sort network runs in shared memory.
#include "common.cuh"

namespace {

using namespace repro;

enum Mode { kPassthrough = 0, kSort = 1, kRate = 2 };

__global__ void __launch_bounds__(1024) fused_drain_kernel(
    const int* __restrict__ delivered, const int* __restrict__ queue_in,
    const int* __restrict__ ring_in, const int* __restrict__ t0,
    const unsigned char* __restrict__ gate, int n_chips, int B, int L, int Q,
    int D, int NI, int mode, int rate, int extra_ahead, int sort_n,
    int* __restrict__ ring_out, int* __restrict__ words_out,
    int* __restrict__ queue_out, int* __restrict__ dep_expired,
    int* __restrict__ dropped) {
  extern __shared__ int smem_i[];
  int* ring = smem_i;                                 // D * NI
  int* src = ring + D * NI;                           // sort_n
  unsigned* keys = reinterpret_cast<unsigned*>(src + sort_n);  // sort_n
  int* queue = reinterpret_cast<int*>(keys + sort_n);  // Q
  int* tally = queue + Q;                             // expired, n_valid

  const int chip = blockIdx.x;
  const bool on = gate == nullptr || gate[chip] != 0;
  const int* ring_src = ring_in + static_cast<size_t>(chip) * D * NI;
  for (int i = threadIdx.x; i < D * NI; i += blockDim.x) ring[i] = ring_src[i];
  if (mode == kRate) {
    for (int i = threadIdx.x; i < Q; i += blockDim.x)
      queue[i] = queue_in[static_cast<size_t>(chip) * Q + i];
  }
  const int R = mode == kRate ? rate : L;

  for (int k = 0; k < B; ++k) {
    const int now = wrap_add(t0[chip], k);
    const int min_ahead = extra_ahead + B - 1 - k;
    const int* row = delivered + (static_cast<size_t>(chip) * B + k) * L;
    if (threadIdx.x < 2) tally[threadIdx.x] = 0;
    __syncthreads();

    if (mode != kPassthrough) {
      // src: the lanes to merge; keys: composite sort keys.
      const int n = sort_n;
      const int head = mode == kRate ? Q : 0;
      // Whole warps iterate together: warp_tally needs every lane.
      for (int base = 0; base < n; base += blockDim.x) {
        const int i = base + threadIdx.x;
        int w = kSentinel;
        if (i < head) {
          w = queue[i];
        } else if (i < head + L && on) {
          w = row[i - head];
        }
        if (i < n) {
          src[i] = w;
          const int key = w >= 0 ? wrap_add(wrap_sub(w, now), kHalfWindow) & kTimeMask
                                 : kTimeMod;
          keys[i] = static_cast<unsigned>(key) * static_cast<unsigned>(n) +
                    static_cast<unsigned>(i);
        }
        warp_tally(w >= 0, &tally[1]);
      }
      __syncthreads();
      bitonic_sort(keys, n);
      if (mode == kRate && on) {
        for (int i = threadIdx.x; i < Q; i += blockDim.x)
          queue[i] = src[keys[rate + i] & static_cast<unsigned>(n - 1)];
      }
    }

    int* out_row = words_out + (static_cast<size_t>(k) * n_chips + chip) * R;
    for (int base = 0; base < R; base += blockDim.x) {
      const int i = base + threadIdx.x;
      int w;
      if (i >= R) {
        w = kSentinel;
      } else if (mode == kPassthrough) {
        w = on ? row[i] : kSentinel;
      } else if (mode == kRate && !on) {
        w = kSentinel;
      } else {
        w = src[keys[i] & static_cast<unsigned>(sort_n - 1)];
      }
      if (i < R) out_row[i] = w;
      int expired = 0;
      if (w >= 0) {
        const int d8 = ((w & kTimeMask) - (now & kTimeMask)) & kTimeMask;
        const int ahead = d8 >= kHalfWindow ? d8 - kTimeMod : d8;
        if (ahead > min_ahead && ahead <= D) {
          const int slot = floor_mod(wrap_add(now, ahead), D);
          const int col = clamp_int(w >> kAddrShift, 0, NI - 1);
          atomicAdd(&ring[slot * NI + col], 1);
        } else {
          expired = 1;
        }
      }
      warp_tally(expired, &tally[0]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const size_t s = static_cast<size_t>(k) * n_chips + chip;
      dep_expired[s] = tally[0];
      int drop = 0;
      if (mode == kRate && on) {
        const int n_valid = tally[1];
        const int emitted = n_valid < rate ? n_valid : rate;
        drop = n_valid - emitted - Q;
        drop = drop > 0 ? drop : 0;
      }
      dropped[s] = drop;
    }
    __syncthreads();
  }

  int* ring_dst = ring_out + static_cast<size_t>(chip) * D * NI;
  for (int i = threadIdx.x; i < D * NI; i += blockDim.x) ring_dst[i] = ring[i];
  if (mode == kRate) {
    for (int i = threadIdx.x; i < Q; i += blockDim.x)
      queue_out[static_cast<size_t>(chip) * Q + i] = queue[i];
  }
}

}  // namespace

// delivered [n_chips, B, L]; queue [n_chips, Q] (rate mode, else null and
// Q = 0); ring [n_chips, D, NI]; t0 [n_chips]; gate [n_chips] bytes or
// null.  Outputs: ring [n_chips, D, NI]; words [B, n_chips, R] (R = rate
// in rate mode, else L); queue [n_chips, Q]; dep_expired and dropped
// [B, n_chips].  sort_n is the power-of-two sort length (0 in
// passthrough mode).
extern "C" int fused_drain_launch(
    const int* delivered, const int* queue_in, const int* ring_in,
    const int* t0, const unsigned char* gate, int n_chips, int B, int L,
    int Q, int D, int NI, int mode, int rate, int extra_ahead, int sort_n,
    int threads, long long smem_bytes, int* ring_out, int* words_out,
    int* queue_out, int* dep_expired, int* dropped, void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(fused_drain_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_drain_kernel<<<n_chips, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      delivered, queue_in, ring_in, t0, gate, n_chips, B, L, Q, D, NI, mode,
      rate, extra_ahead, sort_n, ring_out, words_out, queue_out, dep_expired,
      dropped);
  return static_cast<int>(cudaGetLastError());
}
