// fused_inject: the whole superstep inject phase of every chip in one
// launch.
//
// Replaces the TPU kernel fused_inject_pallas
// (src/repro/kernels/fused_inject/kernel.py, _events_kernel ->
// _inject_substep).  That kernel read the routing table with a one-hot
// MXU product and built the slab with a pick-matrix reduce because the
// TPU lacks a fast VMEM gather and scatter; here the LUT read is a direct
// gather and the slab a direct scatter into shared memory.
//
// One CTA per (chip, substep): within inject, substeps do not depend on
// each other.  Per lane of event row (k, chip), against clock t0 + k:
//   route (a negative address wraps once, then clamps, as JAX's gather),
//   admit B-1-k < deadline - now < 128 (else wrap_expired), bucket id
//   (full mode adds floor(deadline / time_window) mod bpc), stable rank
//   within the bucket (block_stable_rank; an out-of-range bucket is
//   ranked against the clipped one and counts towards none), overflow
//   past C, word (addr & 0x3FFF) << 8 | deadline & 0xFF, scatter to
//   slab[bucket, k, rank] (a negative bucket wraps once, past NB drops;
//   when two words land on one cell the later lane wins, as the
//   reference's XLA scatter does), counts, traffic and the scalar stats.
//
// Bound: bytes.  Each CTA reads one event row (9 B per lane) and one
// table entry per event (13 B), and writes NB * C words; the rank and the
// slab stay in shared memory, so device memory sees each byte once.
#include "common.cuh"

namespace {

using namespace repro;

__global__ void __launch_bounds__(1024) fused_inject_kernel(
    const int* __restrict__ addr, const int* __restrict__ time,
    const unsigned char* __restrict__ valid,
    const int* __restrict__ lut_chip, const int* __restrict__ lut_addr,
    const int* __restrict__ lut_delay,
    const unsigned char* __restrict__ lut_valid, const int* __restrict__ t0,
    int B, int n_chips, int E, int N, int bpc,
    int C, int full_mode, int time_window, int* __restrict__ slab,
    int* __restrict__ counts, int* __restrict__ sent,
    int* __restrict__ overflow, int* __restrict__ wrap_expired,
    int* __restrict__ traffic) {
  extern __shared__ unsigned long long smem[];
  const int nb = n_chips * bpc;
  const int n_warps = blockDim.x >> 5;
  // cell: (lane + 1) << 32 | word of the winning lane, 0 = empty.
  unsigned long long* cell = smem;
  int* hist = reinterpret_cast<int*>(cell + nb * C);
  int* running = hist + n_warps * nb;
  int* traffic_s = running + nb;
  int* tally = traffic_s + n_chips;  // sent, overflow, wrap_expired

  const int chip = blockIdx.x;
  const int k = blockIdx.y;
  for (int i = threadIdx.x; i < nb * C; i += blockDim.x) cell[i] = 0ull;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) running[i] = 0;
  for (int i = threadIdx.x; i < n_chips; i += blockDim.x) traffic_s[i] = 0;
  if (threadIdx.x < 3) tally[threadIdx.x] = 0;
  __syncthreads();

  const int now = wrap_add(t0[chip], k);
  const int defer = B - 1 - k;
  const int window = time_window > 1 ? time_window : 1;
  const size_t lut = static_cast<size_t>(chip) * N;
  const size_t row = (static_cast<size_t>(k) * n_chips + chip) * E;

  for (int base = 0; base < E; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const bool in = e < E;
    const bool ev_valid = in && valid[row + e] != 0;
    int a = ev_valid ? addr[row + e] : 0;
    if (a < 0) a += N;
    a = clamp_int(a, 0, N - 1);
    bool v = ev_valid && lut_valid[lut + a] != 0;
    const int dest_chip = v ? lut_chip[lut + a] : 0;
    const int dest_addr = v ? lut_addr[lut + a] : -1;
    const int deadline = wrap_add(in ? time[row + e] : 0, lut_delay[lut + a]);
    const int is_sent = v;
    const int diff = wrap_sub(deadline, now);
    const bool in_window = diff > defer && diff < kHalfWindow;
    const int is_expired = v && !in_window;
    v = v && in_window;
    int bid = wrap_mul(dest_chip, bpc);
    if (full_mode) bid = wrap_add(bid, floor_mod(floor_div(deadline, window), bpc));
    const bool member = v && bid >= 0 && bid < nb;
    const int slot =
        block_stable_rank(clamp_int(bid, 0, nb - 1), member, nb, hist, running);
    const bool keep = v && slot < C;
    const int is_overflow = v && slot >= C;
    const int word = ((dest_addr & kAddrMask) << kAddrShift) | (deadline & kTimeMask);
    const int b = bid < 0 ? bid + nb : bid;
    if (keep && b >= 0 && b < nb) {
      atomicMax(&cell[b * C + slot],
                (static_cast<unsigned long long>(e + 1) << 32) |
                    static_cast<unsigned>(word));
    }
    if (v && dest_chip >= 0 && dest_chip < n_chips) atomicAdd(&traffic_s[dest_chip], 1);
    warp_tally(is_sent, &tally[0]);
    warp_tally(is_overflow, &tally[1]);
    warp_tally(is_expired, &tally[2]);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nb * C; i += blockDim.x) {
    const int b = i / C;
    const int s = i - b * C;
    const unsigned long long c = cell[i];
    slab[((static_cast<size_t>(chip) * nb + b) * B + k) * C + s] =
        c ? static_cast<int>(static_cast<unsigned>(c & 0xffffffffull)) : kSentinel;
  }
  const size_t out = static_cast<size_t>(k) * n_chips + chip;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) counts[out * nb + b] = running[b];
  for (int j = threadIdx.x; j < n_chips; j += blockDim.x)
    traffic[out * n_chips + j] = traffic_s[j];
  if (threadIdx.x == 0) {
    sent[out] = tally[0];
    overflow[out] = tally[1];
    wrap_expired[out] = tally[2];
  }
}

}  // namespace

// Events are [B, n_chips, E] (valid as bytes); the table's dest_chip,
// dest_addr, delay and valid (bytes) are each [n_chips, N]; t0 is
// [n_chips].  Outputs: slab [n_chips, NB, B, C]; counts [B, n_chips,
// NB]; sent, overflow, wrap_expired [B, n_chips]; traffic [B, n_chips,
// n_chips].
extern "C" int fused_inject_launch(
    const int* addr, const int* time, const unsigned char* valid,
    const int* lut_chip, const int* lut_addr, const int* lut_delay,
    const unsigned char* lut_valid, const int* t0, int B, int n_chips,
    int E, int N, int bpc, int C, int full_mode, int time_window, int threads,
    long long smem_bytes, int* slab, int* counts, int* sent, int* overflow,
    int* wrap_expired, int* traffic, void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(fused_inject_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_chips, B);
  fused_inject_kernel<<<grid, threads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      addr, time, valid, lut_chip, lut_addr, lut_delay, lut_valid, t0, B,
      n_chips, E, N, bpc, C, full_mode, time_window, slab, counts, sent,
      overflow, wrap_expired, traffic);
  return static_cast<int>(cudaGetLastError());
}
