// bucket_pack: stable FIFO packing of events into bucket rows, the wire
// word built in registers, for every (substep, chip) row of a block in
// one launch.
//
// Replaces the TPU kernel bucket_pack_pallas
// (src/repro/kernels/bucket_pack/kernel.py:84, _kernel).  That kernel ran
// one grid program per bucket row and re-read the whole event stream for
// each bucket, building the row with a slot-selection reduce because the
// TPU has no fast VMEM scatter.  Here one CTA per stream row reads its
// lanes once: block_stable_rank gives every member its rank in its bucket
// in lane order, and the word is scattered into a shared-memory copy of
// the row's [NB, C] cells, written out once.
//
// Bound: bytes.  13 B read per lane (bucket id, addr and deadline int32,
// valid one byte), NB * C * 4 + NB * 4 + 4 B written per row; a few
// integer operations per lane.  At the wafer's flush (46 rows of 2048
// lanes) that is 1.5 MB, 0.45 us at 3.35 TB/s, so the kernel is in fact
// bound by its chain of barriers and latencies.  What the design does
// about that: the word (encode_word: ((addr & 0x3FFF) << 8) | (deadline &
// 0xFF), -1 where the lane is not valid) is built in registers from the
// event's lanes, so no elementwise pass writes the words first and a
// wrapper call is one launch; and each thread loads its lane of the next
// tile before the current tile is ranked.  (A cluster of CTAs per row,
// sharing its per-bucket totals through distributed shared memory, ran no
// faster on an H100 at the wafer's shape; PERF.md section 6.)
//
// Semantics of the TPU kernel: lane e belongs to bucket b iff it is
// valid and bucket_id[e] == b (0 <= b < NB); cell [b, c] holds the c-th
// member of b in lane order, or -1; counts[b] is the member count and the
// row's overflow is sum_b max(counts[b] - C, 0).
#include "common.cuh"

namespace {

using namespace repro;

__global__ void __launch_bounds__(1024) bucket_pack_kernel(
    const int* __restrict__ bucket_id, const int* __restrict__ addr,
    const int* __restrict__ deadline, const unsigned char* __restrict__ valid,
    int n_inner, int L, int nb, int C, int* __restrict__ out,
    long long s_outer, long long s_inner, long long s_bucket,
    int* __restrict__ counts, int* __restrict__ overflow) {
  extern __shared__ int smem_i[];
  const int n_warps = blockDim.x >> 5;
  int* cells = smem_i;                 // nb * C
  int* hist = cells + nb * C;          // nb * n_warps
  int* running = hist + nb * n_warps;  // nb

  const int r = blockIdx.x;
  for (int i = threadIdx.x; i < nb * C; i += blockDim.x) cells[i] = kSentinel;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) running[i] = 0;

  // Each thread loads its lane of the next tile before the current tile
  // is ranked, so those loads are in flight during the rank's barriers.
  const size_t off = static_cast<size_t>(r) * L;
  int e = threadIdx.x;
  int bid = 0, a = 0, d = 0;
  bool ok = false;
  if (e < L) {
    bid = bucket_id[off + e];
    a = addr[off + e];
    d = deadline[off + e];
    ok = valid[off + e] != 0;
  }
  for (int base = 0; base < L; base += blockDim.x) {
    const bool member = ok && bid >= 0 && bid < nb;
    const int key = member ? bid : 0;
    const int word = ((a & kAddrMask) << kAddrShift) | (d & kTimeMask);
    e += blockDim.x;
    ok = false;
    if (e < L) {
      bid = bucket_id[off + e];
      a = addr[off + e];
      d = deadline[off + e];
      ok = valid[off + e] != 0;
    }
    const int slot = block_stable_rank(key, member, nb, hist, running);
    if (member && slot < C) cells[key * C + slot] = word;
  }
  __syncthreads();

  const int o = r / n_inner;
  const int i = r - o * n_inner;
  int* dst = out + o * s_outer + i * s_inner;
  for (int j = threadIdx.x; j < nb * C; j += blockDim.x) {
    const int b = j / C;
    dst[b * s_bucket + (j - b * C)] = cells[j];
  }
  if (threadIdx.x < 32) {
    int over = 0;
    for (int b = threadIdx.x; b < nb; b += 32) {
      const int c = running[b];
      counts[static_cast<size_t>(r) * nb + b] = c;
      over += c > C ? c - C : 0;
    }
    over = __reduce_add_sync(0xffffffffu, over);
    if (threadIdx.x == 0) overflow[r] = over;
  }
}

}  // namespace

// Rows r = o * n_inner + i of the lanes [n_outer * n_inner, L] (valid as
// bytes, 0 or 1); row r's cell [b, c] goes to out[o * s_outer + i *
// s_inner + b * s_bucket + c].  counts [rows, NB], overflow [rows].  One
// CTA of `threads` threads per row; smem_bytes = 4 * nb * (C + threads /
// 32 + 1).
extern "C" int bucket_pack_launch(
    const int* bucket_id, const int* addr, const int* deadline,
    const unsigned char* valid, int n_outer, int n_inner, int L, int nb,
    int C, int threads, long long smem_bytes, int* out, long long s_outer,
    long long s_inner, long long s_bucket, int* counts, int* overflow,
    void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (smem_bytes < 4LL * nb * (C + threads / 32 + 1))
    return cudaErrorInvalidValue;
  if (n_outer * n_inner == 0) return 0;
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(bucket_pack_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_pack_kernel<<<n_outer * n_inner, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      bucket_id, addr, deadline, valid, n_inner, L, nb, C, out, s_outer,
      s_inner, s_bucket, counts, overflow);
  return static_cast<int>(cudaGetLastError());
}
