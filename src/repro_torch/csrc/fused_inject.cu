// fused_inject and fused_lif_inject: the whole superstep inject phase of
// every chip in one launch, and the same with the LIF update in front.
//
// Replaces the TPU kernels fused_inject_pallas and fused_lif_inject_pallas
// (src/repro/kernels/fused_inject/kernel.py, _events_kernel and
// _lif_kernel -> _inject_substep).  That kernel read the routing table
// with a one-hot MXU product and built the slab with a pick-matrix reduce
// because the TPU lacks a fast VMEM gather and scatter; here the LUT read
// is a direct gather and each word a direct store into the slab.
//
// inject_substep (one CTA, one chip, one substep k, against clock
// t0 + k), per event lane:
//   route (a negative address wraps once, then clamps, as JAX's gather),
//   the reach cull (with a reach row, an offered lane whose in-range
//   destination chip the row marks unreachable is dropped into lost and
//   never admitted, so never also counted wrap_expired), admit
//   B-1-k < deadline - now < 128 (else wrap_expired), bucket id
//   (full mode adds floor(deadline / time_window) mod bpc), stable rank
//   within the bucket (an out-of-range bucket is ranked against the
//   clipped one and counts towards none), overflow past C, word
//   (addr & 0x3FFF) << 8 | deadline & 0xFF, scatter to slab[bucket, k,
//   rank] (a negative bucket wraps once, past NB drops; when two words
//   land on one cell the later lane wins, as the reference's XLA scatter
//   does), counts, traffic and the scalar stats.
//
// Both kernels run one CTA per (row, substep).  The rows are the source
// chips the caller holds (n_rows: every chip on one device, a rank's own
// block in the shard forms); n_chips counts the destinations (the
// buckets, the traffic width, the reach row's length).
//
// fused_inject: the CTA's events are one row of the block.
//
// The reach table (bool [n_rows, n_chips], each source row's
// deliverable destinations) is optional: a null pointer means every chip
// reaches every chip, and then no lane reads anything more.  With one,
// each CTA copies its chip's row into shared memory once, ahead of the
// lanes' routing: fused_inject after its lanes' loads (a row of one
// tile) with one barrier of its own, fused_lif_inject ahead of the LIF
// steps, covered by the compaction's barrier.
//
// fused_lif_inject: CTA (chip, k) runs repro::lif_update for substeps
// 0..k from the block's initial state (the recurrence is per neuron, so
// recomputing it gives the bits that carrying it would; its current rows
// are loaded together, one decay per neuron), writes substep k's spikes
// and membrane (and the final state when k = B-1), compacts the spikes in
// lane order with the FPGA interface's cut rank < event_capacity, and
// runs inject_substep on the events addr = lane, time = now_k.
//
// Bound: bytes, but a CTA is a chain of latencies: the work per lane is a
// few dozen operations.  The design shortens that chain.
// * Every global load is issued before the first barrier: the event
//   lanes, then the table's four arrays at the clamped address with no
//   load conditional on its valid flag (two rounds); for fused_lif_inject
//   the neuron's state, parameters and current rows (one round, all
//   ahead of decay's division), then the table entry at the lane itself,
//   whose latency the compaction's barrier hides.
// * Each warp counts its lanes into its own column of the histograms
//   (buckets by __match_any_sync, destination chips by shared atomics,
//   sent, expired and lost by warp sums), cleared by the warp itself, so no
//   barrier precedes the counts.  Then two barriers per tile: after the
//   counts (a block vote rides on it, below), and after one thread per
//   bucket has scanned its column of counts over the warps, written the
//   bucket's count and turned the counts into each warp's first rank.
//   The same pass sums traffic and the stats.
// * Members of a bucket take distinct ranks, so in-range lanes own
//   distinct cells: each kept word is stored straight into the slab and
//   the cells past min(count, C) get the sentinel with 16-byte stores.
//   Only a lane whose negative bucket id wraps into range can land on a
//   cell that another lane holds.  When the vote finds such a lane, or
//   when a row has more lanes than the CTA threads (several tiles), the
//   cells are resolved in shared memory: each lane posts its index to its
//   cell with atomicMax, and after a third barrier the lane that won
//   stores its word; cells nobody won get the sentinel.
// * Overflow is known per lane only after the ranks, so warps add it to
//   the output with one atomic each (zeroed before the second barrier)
//   instead of waiting on a last barrier.
// * CTAs of at most 512 threads and 40 registers a thread
//   (__launch_bounds__(512, 3)), so three fit on an SM and the 368 CTAs
//   of the feedforward cell run in one wave on 132 SMs (fused_lif_inject
//   spills a few bytes there, and still runs faster than at two CTAs an
//   SM; PERF.md section 6).
#include <stdint.h>

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
  int* lost;
  int* traffic;
};

// One event lane before routing: whether it carries an event, its time,
// its table index and the table's entry there.
struct Lane {
  bool valid;
  int time;
  int index;
  int chip;
  int addr;
  int delay;
  bool entry_valid;
};

__device__ __forceinline__ void load_entry(const Lut& lut, size_t i, Lane& l) {
  l.chip = __ldg(lut.chip + i);
  l.addr = __ldg(lut.addr + i);
  l.delay = __ldg(lut.delay + i);
  l.entry_valid = __ldg(lut.valid + i) != 0;
}

// Event lane e of a compacted event row: event() loads the event, entry()
// the table entry at its address (a negative one wraps once, then
// clamps; an invalid lane reads entry 0).
struct RowEvents {
  const int* addr;
  const int* time;
  const unsigned char* valid;
  int E;
  Lut lut;
  size_t lut_row;
  int N;
  __device__ __forceinline__ void event(int e, Lane& l) const {
    int a = 0;
    l.valid = false;
    l.time = 0;
    if (e < E) {
      l.valid = __ldg(valid + e) != 0;
      a = __ldg(addr + e);
      l.time = __ldg(time + e);
    }
    a = l.valid ? a : 0;
    if (a < 0) a += N;
    l.index = clamp_int(a, 0, N - 1);
  }
  __device__ __forceinline__ void entry(Lane& l) const { load_entry(lut, lut_row + l.index, l); }
};

// Event lane e of a dense spike row in shared memory: neuron e fired and
// made the cut.
struct SpikeEvents {
  const unsigned char* fired;
  int E;
  int now;
  Lut lut;
  size_t lut_row;
  __device__ __forceinline__ void event(int e, Lane& l) const {
    l.valid = e < E && fired[e] != 0;
    l.time = now;
    l.index = e < E ? e : 0;
  }
  __device__ __forceinline__ void entry(Lane& l) const { load_entry(lut, lut_row + l.index, l); }
};

// The calling thread's own lane, loaded already (a single tile).
struct HeldLane {
  Lane lane;
  __device__ __forceinline__ void event(int, Lane& l) const { l = lane; }
  __device__ __forceinline__ void entry(Lane&) const {}
};

// A lane after routing, the reach cull and admission.
struct Routed {
  bool sent;     // offered: a valid event with a valid table entry
  bool lost;     // offered, to an in-range chip the reach row cannot reach
  bool expired;  // offered, reachable, outside the admission window
  bool v;        // admitted
  int dest_chip;
  int bid;
  int word;
};

// `reach` is the CTA's reach row in shared memory, or null (no cull).
__device__ __forceinline__ Routed route(const Lane& l, int now, int defer, int bpc,
                                        int full_mode, int window,
                                        const unsigned char* reach, int n_chips) {
  Routed r;
  const bool ok = l.valid && l.entry_valid;
  r.dest_chip = ok ? l.chip : 0;
  const int dest_addr = ok ? l.addr : -1;
  const int deadline = wrap_add(l.time, l.delay);
  const int diff = wrap_sub(deadline, now);
  const bool in_window = diff > defer && diff < kHalfWindow;
  bool reachable = true;
  if (reach != nullptr && r.dest_chip >= 0 && r.dest_chip < n_chips)
    reachable = reach[r.dest_chip] != 0;
  r.sent = ok;
  r.lost = ok && !reachable;
  r.expired = ok && reachable && !in_window;
  r.v = ok && reachable && in_window;
  r.bid = wrap_mul(r.dest_chip, bpc);
  if (full_mode) r.bid = wrap_add(r.bid, floor_mod(floor_div(deadline, window), bpc));
  r.word = ((dest_addr & kAddrMask) << kAddrShift) | (deadline & kTimeMask);
  return r;
}

// Ints of the inject scratch (the wrappers' launch plans count the same):
//   owner    nb * C    the lane that holds each cell, -1 empty (staged)
//   hist     warps * nb       each warp's bucket counts, then first ranks
//   tcol     warps * n_chips  each warp's admitted events by destination
//   tally    warps * 3        each warp's sent, wrap_expired and lost
//   running  nb        each bucket's members so far
// and, with a reach table, the chip's reach row as n_chips bytes after
// the kernel's other scratch.
__device__ __forceinline__ int inject_scratch_ints(int nb, int C, int n_chips,
                                                   int n_warps) {
  return nb * C + n_warps * (nb + n_chips + 3) + nb;
}

// Copies row `chip` of the reach table into `row` (shared memory).
__device__ __forceinline__ void load_reach_row(const unsigned char* reach, int chip,
                                               int n_chips, unsigned char* row) {
  const unsigned char* src = reach + static_cast<size_t>(chip) * n_chips;
  for (int i = threadIdx.x; i < n_chips; i += blockDim.x) row[i] = __ldg(src + i);
}

__device__ __forceinline__ void clear_cells(int* owner, int n) {
  int4* o4 = reinterpret_cast<int4*>(owner);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) o4[i] = make_int4(-1, -1, -1, -1);
  for (int i = (n & ~3) + threadIdx.x; i < n; i += blockDim.x) owner[i] = -1;
}

// One substep of the inject chain for one chip, every thread of the CTA
// taking part; `smem` holds the scratch above (16-byte aligned), `reach`
// the chip's reach row in shared memory (visible to every thread) or
// null.
template <class Events>
__device__ __forceinline__ void inject_substep(const Events& events, int E, int chip,
                                               int k, int B, int n_rows, int n_chips,
                                               int bpc,
                                               int C, int full_mode, int time_window,
                                               int now, const unsigned char* reach,
                                               const InjectOut& out, int* smem) {
  const int nb = n_chips * bpc;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int* owner = smem;
  int* hist = owner + nb * C;
  int* tcol = hist + n_warps * nb;
  int* tally = tcol + n_warps * n_chips;
  int* running = tally + 3 * n_warps;

  const int defer = B - 1 - k;
  const int window = time_window > 1 ? time_window : 1;
  const size_t o = static_cast<size_t>(k) * n_rows + chip;
  // Bucket b's row of this substep starts at slab + row0 + b * row_stride.
  const size_t row_stride = static_cast<size_t>(B) * C;
  const size_t row0 = (static_cast<size_t>(chip) * nb * B + k) * C;
  const int tile = blockDim.x;

  bool staged = E > tile;
  if (staged) clear_cells(owner, nb * C);
  for (int i = lane; i < n_chips; i += 32) tcol[warp * n_chips + i] = 0;
  int sent = 0, expired = 0, lost = 0;  // this warp's, over the tiles so far

  // At least one pass, so an empty row still writes its outputs.
  int base = 0;
  do {
    const int e = base + threadIdx.x;
    const bool more = base + tile < E;
    Lane lane_in;
    events.event(e, lane_in);
    events.entry(lane_in);
    const Routed r = route(lane_in, now, defer, bpc, full_mode, window, reach, n_chips);
    const bool member = r.v && r.bid >= 0 && r.bid < nb;
    const int key = clamp_int(r.bid, 0, nb - 1);
    for (int i = lane; i < nb; i += 32) hist[warp * nb + i] = 0;
    __syncwarp();
    const unsigned same = __match_any_sync(0xffffffffu, key);
    const unsigned members = __ballot_sync(0xffffffffu, member);
    const int in_warp = __popc(same & members & ((1u << lane) - 1u));
    if (lane == __ffs(same) - 1) hist[warp * nb + key] = __popc(same & members);
    const int dest = r.v && r.dest_chip >= 0 && r.dest_chip < n_chips ? r.dest_chip : -1;
    if (dest >= 0) atomicAdd(tcol + warp * n_chips + dest, 1);
    sent += __reduce_add_sync(0xffffffffu, r.sent ? 1 : 0);
    expired += __reduce_add_sync(0xffffffffu, r.expired ? 1 : 0);
    lost += __reduce_add_sync(0xffffffffu, r.lost ? 1 : 0);
    if (!more && lane == 0) {
      tally[3 * warp] = sent;
      tally[3 * warp + 1] = expired;
      tally[3 * warp + 2] = lost;
    }
    // A kept lane whose negative bucket wraps into range may land on a
    // cell that another lane holds.
    const bool wraps = r.v && r.bid < 0 && r.bid >= -nb;
    if (__syncthreads_or(wraps) && !staged) {
      staged = true;
      clear_cells(owner, nb * C);  // ordered before the atomics below
    }

    // One thread per bucket, destination chip and the stats.
    for (int j = threadIdx.x; j < nb + n_chips + 1; j += tile) {
      if (j < nb) {
        int acc = base == 0 ? 0 : running[j];
        for (int w = 0; w < n_warps; ++w) {
          const int c = hist[w * nb + j];
          hist[w * nb + j] = acc;
          acc += c;
        }
        running[j] = acc;
        if (!more) out.counts[o * nb + j] = acc;
      } else if (j < nb + n_chips) {
        if (!more) {
          int s = 0;
          for (int w = 0; w < n_warps; ++w) s += tcol[w * n_chips + j - nb];
          out.traffic[o * n_chips + j - nb] = s;
        }
      } else {
        if (base == 0) out.overflow[o] = 0;  // the warps add to it below
        if (!more) {
          int s = 0, x = 0, l = 0;
          for (int w = 0; w < n_warps; ++w) {
            s += tally[3 * w];
            x += tally[3 * w + 1];
            l += tally[3 * w + 2];
          }
          out.sent[o] = s;
          out.wrap_expired[o] = x;
          out.lost[o] = l;
        }
      }
    }
    __syncthreads();

    const int slot = hist[warp * nb + key] + in_warp;
    const bool keep = r.v && slot < C;
    const int ovf = __reduce_add_sync(0xffffffffu, r.v && slot >= C ? 1 : 0);
    if (lane == 0 && ovf != 0) atomicAdd(out.overflow + o, ovf);
    if (!staged) {
      if (keep && member) out.slab[row0 + r.bid * row_stride + slot] = r.word;
    } else {
      const int b = r.bid < 0 ? r.bid + nb : r.bid;
      const bool lands = keep && b >= 0 && b < nb;
      if (lands) atomicMax(owner + b * C + slot, e);
      __syncthreads();
      if (lands && owner[b * C + slot] == e) out.slab[row0 + b * row_stride + slot] = r.word;
    }
    base += tile;
  } while (base < E);

  if (staged) {
    for (int i = threadIdx.x; i < nb * C; i += tile) {
      const int b = i / C;
      if (owner[i] < 0) out.slab[row0 + b * row_stride + (i - b * C)] = kSentinel;
    }
  } else if ((C & 3) == 0 && (reinterpret_cast<uintptr_t>(out.slab) & 15) == 0) {
    // Bucket b's members hold its cells [0, min(count, C)).
    const int q = C >> 2;
    for (int i = threadIdx.x; i < nb * q; i += tile) {
      const int b = i / q;
      const int s = (i - b * q) << 2;
      const int filled = min(running[b], C);
      int* row = out.slab + row0 + b * row_stride;
      if (s >= filled) {
        *reinterpret_cast<int4*>(row + s) = make_int4(-1, -1, -1, -1);
      } else {
        for (int t = filled; t < s + 4; ++t) row[t] = kSentinel;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nb * C; i += tile) {
      const int b = i / C;
      const int s = i - b * C;
      if (s >= min(running[b], C)) out.slab[row0 + b * row_stride + s] = kSentinel;
    }
  }
}

__global__ void __launch_bounds__(512, 3) fused_inject_kernel(
    const int* __restrict__ addr, const int* __restrict__ time,
    const unsigned char* __restrict__ valid, Lut lut, const int* __restrict__ t0,
    const unsigned char* __restrict__ reach, int B, int n_rows, int n_chips, int E,
    int N, int bpc, int C, int full_mode, int time_window, InjectOut out) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int chip = blockIdx.x;
  const int k = blockIdx.y;
  const int now = wrap_add(__ldg(t0 + chip), k);
  const size_t row = (static_cast<size_t>(k) * n_rows + chip) * E;
  const RowEvents events{addr + row, time + row, valid + row, E,
                         lut, static_cast<size_t>(chip) * N, N};
  if (reach == nullptr) {
    inject_substep(events, E, chip, k, B, n_rows, n_chips, bpc, C, full_mode,
                   time_window, now, nullptr, out, smem);
    return;
  }
  unsigned char* reach_row = reinterpret_cast<unsigned char*>(
      smem + inject_scratch_ints(n_chips * bpc, C, n_chips, blockDim.x >> 5));
  if (E <= static_cast<int>(blockDim.x)) {
    // One tile: the lane and its table entry are loaded ahead of the
    // row, their latency under its barrier.
    Lane held;
    events.event(threadIdx.x, held);
    events.entry(held);
    load_reach_row(reach, chip, n_chips, reach_row);
    __syncthreads();
    inject_substep(HeldLane{held}, E, chip, k, B, n_rows, n_chips, bpc, C, full_mode,
                   time_window, now, reach_row, out, smem);
    return;
  }
  load_reach_row(reach, chip, n_chips, reach_row);
  __syncthreads();
  inject_substep(events, E, chip, k, B, n_rows, n_chips, bpc, C, full_mode,
                 time_window, now, reach_row, out, smem);
}

struct Neurons {
  const float* v;
  const int* refrac;
  const float* currents;  // [B, n_rows, N]
  const float* tau_m;
  const float* v_th;
  const float* v_reset;
  const float* v_rest;
  const int* refrac_period;
};

struct NeuronsOut {
  float* v;
  int* refrac;
  float* spikes;   // [B, n_rows, N]
  float* voltage;  // [B, n_rows, N]
};

// Substeps 0..k of neuron i (offset `at` = chip * N + i) from the block's
// initial state; writes substep k's spike and membrane, and the state
// after the block when k = B-1.  Returns substep k's spike.
__device__ __forceinline__ bool lif_substeps(const Neurons& in, const NeuronsOut& out,
                                             size_t at, int k, int B, size_t row) {
  // Every load is issued before decay's division, whose slow path is a
  // call that the compiler does not move loads across.
  float v = __ldg(in.v + at);
  int refrac = __ldg(in.refrac + at);
  const float tau = __ldg(in.tau_m + at);
  const float v_th = __ldg(in.v_th + at);
  const float v_reset = __ldg(in.v_reset + at);
  const float v_rest = __ldg(in.v_rest + at);
  const int period = __ldg(in.refrac_period + at);
  float c[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) c[u] = u <= k ? __ldg(in.currents + u * row + at) : 0.0f;
  const float decay = expf(__fdiv_rn(-1.0f, tau));
  bool spike = false;
  for (int j0 = 0; j0 <= k; j0 += 8) {
    if (j0 > 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        c[u] = j0 + u <= k ? __ldg(in.currents + (j0 + u) * row + at) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u <= k)
        spike = lif_update_decay(v, refrac, c[u], decay, v_th, v_reset, v_rest, period);
  }
  out.spikes[k * row + at] = spike ? 1.0f : 0.0f;
  out.voltage[k * row + at] = v;
  if (k == B - 1) {
    out.v[at] = v;
    out.refrac[at] = refrac;
  }
  return spike;
}

// This thread's rank among the spikes of one tile in lane order, plus
// `before`, which then gains the tile's spikes.  `count` is shared, one
// int per warp (tiles alternate between two such arrays, so one barrier
// a tile suffices).
__device__ __forceinline__ int spike_rank(bool spike, int* count, int& before) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned fired = __ballot_sync(0xffffffffu, spike);
  if (lane == 0) count[warp] = __popc(fired);
  __syncthreads();
  int rank = before + __popc(fired & ((1u << lane) - 1u));
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int c = count[w];
    rank += w < warp ? c : 0;
    total += c;
  }
  before += total;
  return rank;
}

__global__ void __launch_bounds__(512, 3) fused_lif_inject_kernel(
    Neurons in, Lut lut, const int* __restrict__ t0,
    const unsigned char* __restrict__ reach, int B, int n_rows, int n_chips, int N,
    int bpc, int C, int full_mode, int time_window, int event_capacity,
    NeuronsOut nout, InjectOut out) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int n_warps = blockDim.x >> 5;
  // After the inject scratch: the spike counts per warp of two tiles,
  // then the fired flags (rows of several tiles), then the reach row.
  int* counts = smem + inject_scratch_ints(n_chips * bpc, C, n_chips, n_warps);
  unsigned char* fired = reinterpret_cast<unsigned char*>(counts + 2 * n_warps);
  unsigned char* reach_row = nullptr;

  const int chip = blockIdx.x;
  const int k = blockIdx.y;
  const int now = wrap_add(__ldg(t0 + chip), k);
  if (reach != nullptr) {
    // Visible after the compaction's first barrier.
    reach_row = fired + N;
    load_reach_row(reach, chip, n_chips, reach_row);
  }
  const size_t nrow = static_cast<size_t>(chip) * N;
  const size_t row = static_cast<size_t>(n_rows) * N;
  int before = 0;
  if (N <= static_cast<int>(blockDim.x)) {
    // One tile: the neuron and its table entry stay in registers (the
    // entry loaded after the LIF steps, its latency under the barrier).
    const int i = threadIdx.x;
    const bool spike = i < N && lif_substeps(in, nout, nrow + i, k, B, row);
    Lane held;
    held.time = now;
    held.index = i < N ? i : 0;
    load_entry(lut, nrow + held.index, held);
    const int rank = spike_rank(spike, counts, before);
    held.valid = spike && rank < event_capacity;
    inject_substep(HeldLane{held}, N, chip, k, B, n_rows, n_chips, bpc, C, full_mode,
                   time_window, now, reach_row, out, smem);
    return;
  }
  for (int base = 0, t = 0; base < N; base += blockDim.x, ++t) {
    const int i = base + threadIdx.x;
    const bool spike = i < N && lif_substeps(in, nout, nrow + i, k, B, row);
    const int rank = spike_rank(spike, counts + (t & 1) * n_warps, before);
    if (i < N) fired[i] = spike && rank < event_capacity;
  }
  __syncthreads();
  inject_substep(SpikeEvents{fired, N, now, lut, nrow}, N, chip, k, B, n_rows, n_chips,
                 bpc, C, full_mode, time_window, now, reach_row, out, smem);
}

}  // namespace

// Events are [B, n_rows, E] (valid as bytes); the table's dest_chip,
// dest_addr, delay and valid (bytes) are each [n_rows, N]; t0 is
// [n_rows]; reach is [n_rows, n_chips] bytes or null.  NB = n_chips *
// bpc.  Outputs: slab [n_rows, NB, B, C]; counts [B, n_rows, NB]; sent,
// overflow, wrap_expired, lost [B, n_rows]; traffic [B, n_rows,
// n_chips].
extern "C" int fused_inject_launch(
    const int* addr, const int* time, const unsigned char* valid,
    const int* lut_chip, const int* lut_addr, const int* lut_delay,
    const unsigned char* lut_valid, const int* t0, const unsigned char* reach,
    int B, int n_rows, int n_chips, int E, int N, int bpc, int C, int full_mode,
    int time_window, int threads, long long smem_bytes, int* slab, int* counts,
    int* sent, int* overflow, int* wrap_expired, int* lost, int* traffic,
    void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(fused_inject_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_rows, B);
  fused_inject_kernel<<<grid, threads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      addr, time, valid, Lut{lut_chip, lut_addr, lut_delay, lut_valid}, t0, reach,
      B, n_rows, n_chips, E, N, bpc, C, full_mode, time_window,
      InjectOut{slab, counts, sent, overflow, wrap_expired, lost, traffic});
  return static_cast<int>(cudaGetLastError());
}

// v, refrac, the five neuron parameters and the table's four arrays are
// [n_rows, N]; currents [B, n_rows, N]; t0 [n_rows]; reach as
// fused_inject_launch's.  Outputs: v and refrac [n_rows, N]; spikes and
// voltage [B, n_rows, N]; the inject outputs as fused_inject_launch's.
extern "C" int fused_lif_inject_launch(
    const float* v, const int* refrac, const float* currents, const float* tau_m,
    const float* v_th, const float* v_reset, const float* v_rest,
    const int* refrac_period, const int* lut_chip, const int* lut_addr,
    const int* lut_delay, const unsigned char* lut_valid, const int* t0,
    const unsigned char* reach, int B, int n_rows, int n_chips, int N, int bpc,
    int C, int full_mode, int time_window, int event_capacity, int threads,
    long long smem_bytes, float* v_out, int* refrac_out, float* spikes,
    float* voltage, int* slab, int* counts, int* sent, int* overflow,
    int* wrap_expired, int* lost, int* traffic, void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(fused_lif_inject_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_rows, B);
  fused_lif_inject_kernel<<<grid, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      Neurons{v, refrac, currents, tau_m, v_th, v_reset, v_rest, refrac_period},
      Lut{lut_chip, lut_addr, lut_delay, lut_valid}, t0, reach, B, n_rows, n_chips, N,
      bpc, C, full_mode, time_window, event_capacity,
      NeuronsOut{v_out, refrac_out, spikes, voltage},
      InjectOut{slab, counts, sent, overflow, wrap_expired, lost, traffic});
  return static_cast<int>(cudaGetLastError());
}
