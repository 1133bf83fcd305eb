// fused_inject and fused_lif_inject: the whole superstep inject phase of
// every chip in one launch, and the same with the LIF update in front.
//
// Replaces the TPU kernels fused_inject_pallas and fused_lif_inject_pallas
// (src/repro/kernels/fused_inject/kernel.py, _events_kernel and
// _lif_kernel -> _inject_substep).  That kernel read the routing table
// with a one-hot MXU product and built the slab with a pick-matrix reduce
// because the TPU lacks a fast VMEM gather and scatter; here the LUT read
// is a direct gather and the slab a direct scatter into shared memory.
//
// inject_substep (one CTA, one chip, one substep k, against clock
// t0 + k), per event lane:
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
// fused_inject: one CTA per (chip, substep), the events of that row.
// Within inject, substeps do not depend on each other.
//
// fused_lif_inject: one CTA per chip, looping over the B substeps, since
// a neuron's membrane carries from one substep to the next.  Per
// substep: repro::lif_update on each neuron (the lif_step kernel's
// rounding), the spike mask compacted in lane order by a block-wide
// exclusive scan (block_stable_rank with one bucket) with the FPGA
// interface's cut rank < event_capacity, then inject_substep on the
// events addr = lane, time = now_k.  There are no health masks in the
// port yet, so nothing is culled as lost.
//
// Bound: bytes.  Each CTA reads its event row (9 B per lane) or its
// neurons' state and currents, and one table entry per event (13 B), and
// writes NB * C words per substep; the rank, the compaction and the slab
// stay in shared memory, so device memory sees each byte once.
#include "common.cuh"

namespace {

using namespace repro;

struct Lut {
  const int* chip;
  const int* addr;
  const int* delay;
  const unsigned char* valid;
};

struct InjectOut {
  int* slab;
  int* counts;
  int* sent;
  int* overflow;
  int* wrap_expired;
  int* traffic;
};

// Event lane e of a compacted event row.
struct RowEvents {
  const int* addr;
  const int* time;
  const unsigned char* valid;
  __device__ void operator()(int e, bool& v, int& a, int& t) const {
    v = valid[e] != 0;
    a = addr[e];
    t = time[e];
  }
};

// Event lane e of a dense spike row: neuron e fired (and made the cut).
struct SpikeEvents {
  const unsigned char* fired;
  int now;
  __device__ void operator()(int e, bool& v, int& a, int& t) const {
    v = fired[e] != 0;
    a = e;
    t = now;
  }
};

// One substep of the inject chain for one chip, every thread of the CTA
// taking part.  `smem` holds the scratch laid out below (the launchers'
// launch_plan counts it); the function synchronises before it returns.
template <class Events>
__device__ void inject_substep(Events events, int E, const Lut& lut, int chip,
                               int k, int B, int n_chips, int N, int bpc, int C,
                               int full_mode, int time_window, int now,
                               const InjectOut& out, unsigned long long* smem) {
  const int nb = n_chips * bpc;
  const int n_warps = blockDim.x >> 5;
  // cell: (lane + 1) << 32 | word of the winning lane, 0 = empty.
  unsigned long long* cell = smem;
  int* hist = reinterpret_cast<int*>(cell + nb * C);
  int* running = hist + n_warps * nb;
  int* traffic_s = running + nb;
  int* tally = traffic_s + n_chips;  // sent, overflow, wrap_expired

  for (int i = threadIdx.x; i < nb * C; i += blockDim.x) cell[i] = 0ull;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) running[i] = 0;
  for (int i = threadIdx.x; i < n_chips; i += blockDim.x) traffic_s[i] = 0;
  if (threadIdx.x < 3) tally[threadIdx.x] = 0;
  __syncthreads();

  const int defer = B - 1 - k;
  const int window = time_window > 1 ? time_window : 1;
  const size_t lut_row = static_cast<size_t>(chip) * N;

  for (int base = 0; base < E; base += blockDim.x) {
    const int e = base + threadIdx.x;
    bool ev_valid = false;
    int ev_addr = 0, ev_time = 0;
    if (e < E) events(e, ev_valid, ev_addr, ev_time);
    int a = ev_valid ? ev_addr : 0;
    if (a < 0) a += N;
    a = clamp_int(a, 0, N - 1);
    bool v = ev_valid && lut.valid[lut_row + a] != 0;
    const int dest_chip = v ? lut.chip[lut_row + a] : 0;
    const int dest_addr = v ? lut.addr[lut_row + a] : -1;
    const int deadline = wrap_add(ev_time, lut.delay[lut_row + a]);
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
    out.slab[((static_cast<size_t>(chip) * nb + b) * B + k) * C + s] =
        c ? static_cast<int>(static_cast<unsigned>(c & 0xffffffffull)) : kSentinel;
  }
  const size_t o = static_cast<size_t>(k) * n_chips + chip;
  for (int b = threadIdx.x; b < nb; b += blockDim.x) out.counts[o * nb + b] = running[b];
  for (int j = threadIdx.x; j < n_chips; j += blockDim.x)
    out.traffic[o * n_chips + j] = traffic_s[j];
  if (threadIdx.x == 0) {
    out.sent[o] = tally[0];
    out.overflow[o] = tally[1];
    out.wrap_expired[o] = tally[2];
  }
  __syncthreads();  // the scratch is cleared again by the next substep
}

__global__ void __launch_bounds__(1024) fused_inject_kernel(
    const int* __restrict__ addr, const int* __restrict__ time,
    const unsigned char* __restrict__ valid, Lut lut, const int* __restrict__ t0,
    int B, int n_chips, int E, int N, int bpc, int C, int full_mode,
    int time_window, InjectOut out) {
  extern __shared__ unsigned long long smem[];
  const int chip = blockIdx.x;
  const int k = blockIdx.y;
  const size_t row = (static_cast<size_t>(k) * n_chips + chip) * E;
  inject_substep(RowEvents{addr + row, time + row, valid + row}, E, lut, chip, k,
                 B, n_chips, N, bpc, C, full_mode, time_window,
                 wrap_add(t0[chip], k), out, smem);
}

__global__ void __launch_bounds__(1024) fused_lif_inject_kernel(
    const float* __restrict__ v_in, const int* __restrict__ refrac_in,
    const float* __restrict__ currents, const float* __restrict__ tau_m,
    const float* __restrict__ v_th, const float* __restrict__ v_reset,
    const float* __restrict__ v_rest, const int* __restrict__ refrac_period,
    Lut lut, const int* __restrict__ t0, int B, int n_chips, int N, int bpc,
    int C, int full_mode, int time_window, int event_capacity,
    long long inject_smem, float* __restrict__ v_out,
    int* __restrict__ refrac_out, float* __restrict__ spikes,
    float* __restrict__ voltage, InjectOut out) {
  extern __shared__ unsigned long long smem[];
  // After the inject scratch: the scan's per-warp counts and running
  // total, then the fired flags of the substep.
  int* scan_hist = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + inject_smem);
  int* scan_running = scan_hist + (blockDim.x >> 5);
  unsigned char* fired = reinterpret_cast<unsigned char*>(scan_running + 1);

  const int chip = blockIdx.x;
  const size_t nrow = static_cast<size_t>(chip) * N;
  // Lane i belongs to thread i % blockDim.x in every loop below, so a
  // thread reads back only the membrane it wrote.
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    v_out[nrow + i] = v_in[nrow + i];
    refrac_out[nrow + i] = refrac_in[nrow + i];
  }
  for (int k = 0; k < B; ++k) {
    const int now = wrap_add(t0[chip], k);
    const size_t krow = (static_cast<size_t>(k) * n_chips + chip) * N;
    if (threadIdx.x == 0) scan_running[0] = 0;
    __syncthreads();
    for (int base = 0; base < N; base += blockDim.x) {
      const int i = base + threadIdx.x;
      bool spike = false;
      if (i < N) {
        float v = v_out[nrow + i];
        int r = refrac_out[nrow + i];
        spike = lif_update(v, r, currents[krow + i], tau_m[nrow + i], v_th[nrow + i],
                           v_reset[nrow + i], v_rest[nrow + i], refrac_period[nrow + i]);
        v_out[nrow + i] = v;
        refrac_out[nrow + i] = r;
        spikes[krow + i] = spike ? 1.0f : 0.0f;
        voltage[krow + i] = v;
      }
      const int rank = block_stable_rank(0, spike, 1, scan_hist, scan_running);
      if (i < N) fired[i] = spike && rank < event_capacity;
    }
    __syncthreads();
    inject_substep(SpikeEvents{fired, now}, N, lut, chip, k, B, n_chips, N, bpc, C,
                   full_mode, time_window, now, out, smem);
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
      addr, time, valid, Lut{lut_chip, lut_addr, lut_delay, lut_valid}, t0, B,
      n_chips, E, N, bpc, C, full_mode, time_window,
      InjectOut{slab, counts, sent, overflow, wrap_expired, traffic});
  return static_cast<int>(cudaGetLastError());
}

// v, refrac, the five neuron parameters and the table's four arrays are
// [n_chips, N]; currents [B, n_chips, N]; t0 [n_chips].  Outputs: v and
// refrac [n_chips, N]; spikes and voltage [B, n_chips, N]; the inject
// outputs as fused_inject_launch's.  inject_smem is the inject scratch's
// share of smem_bytes.
extern "C" int fused_lif_inject_launch(
    const float* v, const int* refrac, const float* currents, const float* tau_m,
    const float* v_th, const float* v_reset, const float* v_rest,
    const int* refrac_period, const int* lut_chip, const int* lut_addr,
    const int* lut_delay, const unsigned char* lut_valid, const int* t0, int B,
    int n_chips, int N, int bpc, int C, int full_mode, int time_window,
    int event_capacity, int threads, long long inject_smem, long long smem_bytes,
    float* v_out, int* refrac_out, float* spikes, float* voltage, int* slab,
    int* counts, int* sent, int* overflow, int* wrap_expired, int* traffic,
    void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(fused_lif_inject_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_lif_inject_kernel<<<n_chips, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      v, refrac, currents, tau_m, v_th, v_reset, v_rest, refrac_period,
      Lut{lut_chip, lut_addr, lut_delay, lut_valid}, t0, B, n_chips, N, bpc, C,
      full_mode, time_window, event_capacity, inject_smem, v_out, refrac_out,
      spikes, voltage, InjectOut{slab, counts, sent, overflow, wrap_expired, traffic});
  return static_cast<int>(cudaGetLastError());
}
