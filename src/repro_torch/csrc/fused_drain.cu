// fused_drain: the whole superstep drain phase (merge + ring deposit) of
// every chip in one launch.
//
// Replaces the TPU kernel fused_drain_pallas
// (src/repro/kernels/fused_drain/kernel.py, _kernel, _sort_row,
// _deposit).  The TPU kernel sorted each merge cycle with a bitonic
// network padded to a power of two and deposited with an outer-product
// MXU matmul of slot and column one-hots, because it lacks a fast VMEM
// gather and scatter.  Here the merge is stable counting passes over the
// 257 values of word_key (common.cuh) and the deposit an integer
// atomicAdd into a shared-memory copy of the chip's [D, n_inputs] ring,
// which is bitwise safe because integer adds commute.
//
// One CTA per chip, because the ring and the merge queue carry from one
// substep to the next.  Per substep k at now = t0 + k:
//   passthrough  the delivered row as it is;
//   sort         the row sorted stably by word_key, with the lane index
//                as tie-break;
//   rate         the merged row queue + row sorted the same way (queue
//                lanes first on equal keys); emit positions [0, rate),
//                keep [rate, rate + depth) as the queue, and drop the
//                valid words past it: dropped = max(n_valid - rate -
//                depth, 0), the reference's max(n_valid - min(n_valid,
//                rate) - depth, 0).  The reference's padding sentinels
//                are not built: positions past the merged row are
//                kSentinel.
// Each emitted word w >= 0 with ahead = wrap8(w - now) deposits at
// ring[(now + ahead) mod D, clip(addr)] if min_ahead < ahead <= D and is
// counted in dep_expired otherwise.  A gated-off chip (pipeline empty
// carry) emits sentinels, deposits and drops nothing and keeps its queue.
// Every negative word sorts in bin 256 and keeps its value.
//
// A row's keys depend on its substep's clock and not on the queue, so the
// rows are sorted first, all at once: the block is cut into `groups`
// warp groups (one named barrier each), and group g sorts rows g, g +
// groups, ... with one counting_pass each, staged in shared memory with
// cp.async.  Sort mode is then done: each group places its row's words
// and deposits them.  Rate mode keeps, per row, its first rate + depth
// sorted words (the head) and, per bin, how many of its lanes sort at or
// before it (ends).  What stays serial per substep is the queue's merge
// into the row's head, done by comparing with the queue's keys:
//   queue lane i, bin b   goes to (queue lanes of a bin < b, or of bin b
//                         before i) + (row lanes in bins < b),
//   head word s, bin b    goes to s + (queue lanes in bins <= b),
// which is the merged row's stable order; only positions below rate +
// depth are written.  Each of the depth + min(L, rate + depth) items
// reads the depth keys once (broadcast int4 loads): one thread per item
// and 64 compare steps at the path's rate 128 and depth 64.  The queue
// is double-buffered: the new one is placed while the old one is still
// read.
//
// Bound: bytes.  The ring and queue are read and written once per block,
// each delivered word read once and each emitted word written once.  The
// time is instruction issue and barrier latency on one SM per chip (46
// of 132 on the wafer), so the rows are sorted in parallel warp groups
// and the serial chain per substep is two barriers and one placement
// step.
#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
namespace sm = repro::sm90;

enum Mode { kPassthrough = 0, kSort = 1, kRate = 2 };

constexpr int kBins = kTimeMod + 1;
constexpr int kMaxGroups = 8;  // named barriers 1 to 8

// Offsets (ints) of the shared-memory arrays; the wrapper's launch_plan
// (kernels/fused_drain/ops.py) sizes the same layout.  Q is 0 outside rate
// mode; head rows hold the first min(L, rate + Q) sorted words.  The
// queue's keys, the rows and the ring come first, 16-byte aligned (the
// rows and the ring where L is a multiple of 4).
struct Layout {
  long long qkey, stage, ring, tally, ends, head, queue, hist, scratch, total;
};

__host__ __device__ inline Layout layout(int mode, int B, int L, int Q, int D,
                                         int NI, int rate, int groups,
                                         int threads) {
  const bool merging = mode != kPassthrough;
  const bool rate_mode = mode == kRate;
  const long long head = rate_mode ? (L < rate + Q ? L : rate + Q) : 0;
  const long long warps = threads / 32 / groups;
  Layout s;
  long long o = 0;
  s.qkey = o;   // the queue's keys, padded to whole int4s
  o += (Q + 3) / 4 * 4;
  s.stage = o;  // one row per group
  o += merging ? static_cast<long long>(groups) * L : 0;
  s.ring = o;
  o += static_cast<long long>(D) * NI;
  s.tally = o;  // expired and dropped per substep
  o += 2LL * B;
  s.ends = o;   // per row and bin: its lanes in bins <= b
  o += rate_mode ? static_cast<long long>(B) * kBins : 0;
  s.head = o;
  o += static_cast<long long>(B) * head;
  s.queue = o;  // old and new queue
  o += 2LL * Q;
  s.hist = o;   // one histogram per group
  o += merging ? groups * kBins * (warps + 1) : 0;
  s.scratch = o;
  o += merging ? 32LL * groups : 0;
  s.total = o;
  return s;
}

// Starts copying n ints from global src to shared dst (cp.async), thread
// `rank` of `size`: 16 bytes a copy where both are 16-byte aligned and n
// is a multiple of 4, else 4.
__device__ __forceinline__ void fetch(int* dst, const int* src, int n,
                                      int rank, int size) {
  const auto addr = reinterpret_cast<uintptr_t>(dst) |
                    reinterpret_cast<uintptr_t>(src);
  if ((addr & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * rank; i < n; i += 4 * size)
      sm::cp_async<16>(dst + i, src + i, 16);
  } else {
    for (int i = rank; i < n; i += size) sm::cp_async<4>(dst + i, src + i, 4);
  }
}

// Deposits word w emitted at clock now into the shared ring; returns 1 if
// it is valid and outside the window (min_ahead, D], else 0.
__device__ __forceinline__ int deposit(int* ring, int w, int now,
                                       int min_ahead, int D, int NI) {
  if (w < 0) return 0;
  const int d8 = ((w & kTimeMask) - (now & kTimeMask)) & kTimeMask;
  const int ahead = d8 >= kHalfWindow ? d8 - kTimeMod : d8;
  if (ahead <= min_ahead || ahead > D) return 1;
  const int slot = floor_mod(wrap_add(now, ahead), D);
  const int col = clamp_int(w >> kAddrShift, 0, NI - 1);
  atomicAdd(&ring[slot * NI + col], 1);
  return 0;
}

__global__ void __launch_bounds__(1024) fused_drain_kernel(
    const int* __restrict__ delivered, const int* __restrict__ queue_in,
    const int* __restrict__ ring_in, const int* __restrict__ t0,
    const unsigned char* __restrict__ gate, int n_chips, int B, int L, int Q,
    int D, int NI, int mode, int rate, int extra_ahead, int groups,
    int* __restrict__ ring_out, int* __restrict__ words_out,
    int* __restrict__ queue_out, int* __restrict__ dep_expired,
    int* __restrict__ dropped) {
  extern __shared__ int smem[];
  const Layout lay = layout(mode, B, L, Q, D, NI, rate, groups, blockDim.x);
  int* ring = smem + lay.ring;
  int* expired_k = smem + lay.tally;
  int* dropped_k = expired_k + B;
  int* qcur = smem + lay.queue;
  int* qnext = qcur + Q;

  const int chip = blockIdx.x;
  const int t = t0[chip];
  const bool on = gate == nullptr || gate[chip] != 0;
  const bool merging = mode != kPassthrough;
  const int R = mode == kRate ? rate : L;
  const int keep = rate + Q;                 // rate mode
  const int head_n = L < keep ? L : keep;    // rate mode
  const int* chip_rows = delivered + static_cast<size_t>(chip) * B * L;
  auto out_row = [&](int k) {
    return words_out + (static_cast<size_t>(k) * n_chips + chip) * R;
  };

  // Group g of `groups` sorts rows g, g + groups, ... in phase 1.
  const int gsize = blockDim.x / groups;
  const int g = threadIdx.x / gsize;
  const WarpGroup grp{static_cast<int>(threadIdx.x) - g * gsize, gsize, 1 + g};
  int* stage = smem + lay.stage + static_cast<size_t>(g) * L;
  int* hist =
      smem + lay.hist + static_cast<size_t>(g) * kBins * (gsize / 32 + 1);
  int* scratch = smem + lay.scratch + 32 * g;

  fetch(ring, ring_in + static_cast<size_t>(chip) * D * NI, D * NI,
        threadIdx.x, blockDim.x);
  fetch(qcur, queue_in + static_cast<size_t>(chip) * Q, Q, threadIdx.x,
        blockDim.x);
  if (merging && on) fetch(stage, chip_rows + static_cast<size_t>(g) * L, L,
                           grp.rank, gsize);
  sm::cp_async_commit();
  for (int i = threadIdx.x; i < 2 * B; i += blockDim.x) expired_k[i] = 0;
  sm::cp_async_wait_all();
  __syncthreads();

  if (!on) {
    for (int i = threadIdx.x; i < B * R; i += blockDim.x)
      out_row(i / R)[i % R] = kSentinel;
  } else if (!merging) {
    for (int k = 0; k < B; ++k) {
      const int now = wrap_add(t, k);
      const int min_ahead = extra_ahead + B - 1 - k;
      const int* row = chip_rows + static_cast<size_t>(k) * L;
      int* out = out_row(k);
      int expired = 0;
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        const int w = row[i];
        out[i] = w;
        expired += deposit(ring, w, now, min_ahead, D, NI);
      }
      warp_tally(expired, &expired_k[k]);
    }
  } else {
    // Phase 1: sort every row.  Sort mode places and deposits; rate mode
    // keeps the head and the bin ends.
    int* ends = smem + lay.ends;
    int* head = smem + lay.head;
    for (int k = g; k < B; k += groups) {
      if (k != g) {
        fetch(stage, chip_rows + static_cast<size_t>(k) * L, L, grp.rank,
              gsize);
        sm::cp_async_commit();
        sm::cp_async_wait_all();
        grp.sync();
      }
      const int now = wrap_add(t, k);
      const int min_ahead = extra_ahead + B - 1 - k;
      int* out = out_row(k);
      int* row_head = head + static_cast<size_t>(k) * head_n;
      int expired = 0;
      counting_pass(
          grp, L, kBins, hist, scratch,
          [&](int i) { return word_key(stage[i], now); },
          [&](int i, int pos) {
            const int w = stage[i];
            if (mode == kSort) {
              out[pos] = w;
              expired += deposit(ring, w, now, min_ahead, D, NI);
            } else if (pos < head_n) {
              row_head[pos] = w;
            }
          },
          mode == kRate ? ends + static_cast<size_t>(k) * kBins : nullptr);
      warp_tally(expired, &expired_k[k]);
      grp.sync();  // the group's stage and histogram serve its next row
    }
    __syncthreads();

    // Phase 2 (rate): merge the queue into each row's head, in order.
    int* qkey = smem + lay.qkey;
    for (int k = 0; mode == kRate && k < B; ++k) {
      const int now = wrap_add(t, k);
      const int min_ahead = extra_ahead + B - 1 - k;
      const int* row_ends = ends + static_cast<size_t>(k) * kBins;
      const int* row_head = head + static_cast<size_t>(k) * head_n;
      int* out = out_row(k);
      int expired = 0, valid = 0;
      for (int i = threadIdx.x; i < (Q + 3) / 4 * 4; i += blockDim.x) {
        qkey[i] = i < Q ? word_key(qcur[i], now) : INT_MAX;  // padding
        valid += i < Q && qcur[i] >= 0;
      }
      warp_tally(valid, &dropped_k[k]);  // the queue's valid words, for now
      __syncthreads();
      // Item i < Q is queue lane i; item Q + s is head word s.  Queue lanes
      // ahead of it: those of a smaller key, and of an equal key at a
      // lower lane (queue lanes) or at any lane (head words).
      for (int item = threadIdx.x; item < Q + head_n; item += blockDim.x) {
        const bool queued = item < Q;
        const int w = queued ? qcur[item] : row_head[item - Q];
        const int b = word_key(w, now);
        const int lim = queued ? item : Q;
        int before = 0;
#pragma unroll 4
        for (int j = 0; j < Q; j += 4) {
          const int4 v = *reinterpret_cast<const int4*>(qkey + j);
          before += (v.x < b + (j < lim)) + (v.y < b + (j + 1 < lim)) +
                    (v.z < b + (j + 2 < lim)) + (v.w < b + (j + 3 < lim));
        }
        const int pos = queued ? before + (b == 0 ? 0 : row_ends[b - 1])
                               : item - Q + before;
        if (pos >= keep) continue;
        if (pos < rate) {
          out[pos] = w;
          expired += deposit(ring, w, now, min_ahead, D, NI);
        } else {
          qnext[pos - rate] = w;
        }
      }
      // Positions past the merged row (fewer lanes than rate) hold the
      // reference's padding sentinels.
      for (int pos = Q + L + threadIdx.x; pos < keep; pos += blockDim.x) {
        if (pos < rate) {
          out[pos] = kSentinel;
        } else {
          qnext[pos - rate] = kSentinel;
        }
      }
      warp_tally(expired, &expired_k[k]);
      if (threadIdx.x == 0) {
        const int n_valid = row_ends[kTimeMod - 1] + dropped_k[k];
        dropped_k[k] = n_valid > keep ? n_valid - keep : 0;
      }
      __syncthreads();
      int* q = qcur;
      qcur = qnext;
      qnext = q;
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < B; k += blockDim.x) {
    const size_t s = static_cast<size_t>(k) * n_chips + chip;
    dep_expired[s] = expired_k[k];
    dropped[s] = dropped_k[k];
  }
  int* ring_dst = ring_out + static_cast<size_t>(chip) * D * NI;
  for (int i = threadIdx.x; i < D * NI; i += blockDim.x) ring_dst[i] = ring[i];
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    queue_out[static_cast<size_t>(chip) * Q + i] = qcur[i];
}

}  // namespace

// delivered [n_chips, B, L]; queue [n_chips, Q] (rate mode, else null and
// Q = 0); ring [n_chips, D, NI]; t0 [n_chips]; gate [n_chips] bytes or
// null.  Outputs: ring [n_chips, D, NI]; words [B, n_chips, R] (R = rate
// in rate mode, else L); queue [n_chips, Q]; dep_expired and dropped
// [B, n_chips].  threads, groups (of threads / groups each, a multiple of
// 32; 1 in passthrough) and smem_bytes as the wrapper's launch_plan gives
// them; a smaller plan is refused.
extern "C" int fused_drain_launch(
    const int* delivered, const int* queue_in, const int* ring_in,
    const int* t0, const unsigned char* gate, int n_chips, int B, int L,
    int Q, int D, int NI, int mode, int rate, int extra_ahead, int threads,
    int groups, long long smem_bytes, int* ring_out, int* words_out,
    int* queue_out, int* dep_expired, int* dropped, void* stream) {
  if (threads < 32 || threads > 1024 || groups < 1 || groups > kMaxGroups ||
      groups > (B > 0 ? B : 1) || threads % (32 * groups) != 0 ||
      smem_bytes <
          4 * layout(mode, B, L, Q, D, NI, rate, groups, threads).total)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(fused_drain_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_drain_kernel<<<n_chips, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      delivered, queue_in, ring_in, t0, gate, n_chips, B, L, Q, D, NI, mode,
      rate, extra_ahead, groups, ring_out, words_out, queue_out, dep_expired,
      dropped);
  return static_cast<int>(cudaGetLastError());
}
