// bucket_pack: stable FIFO packing of wire words into bucket rows, for
// every (substep, chip) row of a block in one launch.
//
// Replaces the TPU kernel bucket_pack_pallas
// (src/repro/kernels/bucket_pack/kernel.py, _kernel).  That kernel ran
// one grid program per bucket row and re-read the whole event stream for
// each bucket, building the row with a slot-selection reduce because the
// TPU has no fast VMEM scatter.  Here one CTA per stream row reads its
// lanes once: block_stable_rank gives every word its rank in its bucket
// in lane order, and the word is scattered into a shared-memory copy of
// the row's [NB, C] cells, written out once.
//
// Semantics of the TPU kernel: lane e belongs to bucket b iff
// bucket_id[e] == b (0 <= b < NB) and word[e] >= 0; cell [b, c] holds the
// c-th member of b, or -1; counts[b] is the member count and the row's
// overflow is sum_b max(counts[b] - C, 0).
//
// Bound: bytes.  8 B read per lane, NB * C * 4 + NB * 4 + 4 B written
// per row.
#include "common.cuh"

namespace {

using namespace repro;

__global__ void __launch_bounds__(1024) bucket_pack_kernel(
    const int* __restrict__ bucket_id, const int* __restrict__ words,
    int n_inner, int L, int nb, int C, int* __restrict__ out,
    long long s_outer, long long s_inner, long long s_bucket,
    int* __restrict__ counts, int* __restrict__ overflow) {
  extern __shared__ int smem_i[];
  const int n_warps = blockDim.x >> 5;
  int* cells = smem_i;               // nb * C
  int* hist = cells + nb * C;        // n_warps * nb
  int* running = hist + n_warps * nb;  // nb
  int* total = running + nb;         // 1

  const int r = blockIdx.x;
  for (int i = threadIdx.x; i < nb * C; i += blockDim.x) cells[i] = kSentinel;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) running[i] = 0;
  if (threadIdx.x == 0) *total = 0;
  __syncthreads();

  const int* bid_row = bucket_id + static_cast<size_t>(r) * L;
  const int* word_row = words + static_cast<size_t>(r) * L;
  for (int base = 0; base < L; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const int bid = e < L ? bid_row[e] : -1;
    const int word = e < L ? word_row[e] : kSentinel;
    const bool member = word >= 0 && bid >= 0 && bid < nb;
    const int key = member ? bid : 0;
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
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    counts[static_cast<size_t>(r) * nb + b] = running[b];
    const int over = running[b] - C;
    if (over > 0) atomicAdd(total, over);
  }
  __syncthreads();
  if (threadIdx.x == 0) overflow[r] = *total;
}

}  // namespace

// Rows r = o * n_inner + i of bucket_id / words [n_outer * n_inner, L];
// row r's cell [b, c] goes to out[o * s_outer + i * s_inner + b * s_bucket
// + c].  counts [rows, NB], overflow [rows].
extern "C" int bucket_pack_launch(
    const int* bucket_id, const int* words, int n_outer, int n_inner, int L,
    int nb, int C, int threads, long long smem_bytes, int* out,
    long long s_outer, long long s_inner, long long s_bucket, int* counts,
    int* overflow, void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(bucket_pack_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  bucket_pack_kernel<<<n_outer * n_inner, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      bucket_id, words, n_inner, L, nb, C, out, s_outer, s_inner, s_bucket,
      counts, overflow);
  return static_cast<int>(cudaGetLastError());
}
