// merge_sort: stable bitonic sorts of the merge stage, one CTA per row.
//
// Replaces the TPU kernels merge_sort_words_pallas and merge_sort_pallas
// (src/repro/kernels/merge_sort/kernel.py, _kernel_words and _kernel).
// The TPU kernels carried (key, lane, payload) tuples through every
// compare-exchange stage as reshapes and selects, because the TPU has no
// fast VMEM gather; here the network sorts one unique composite key per
// lane in shared memory (sort key in the high bits, lane index in the
// low bits, so ascending order is the stable order) and the payloads are
// gathered by lane once at the end.
//
//   words  key (w - now + 128) & 255 for a valid word (w >= 0), 256 for a
//          sentinel; composite key * n + lane in 32 bits.
//   SoA    key valid ? deadline : 2^30, any int32 (negative deadlines and
//          deadlines >= 2^30 included); composite
//          (u32(key ^ 0x80000000) << 32) | lane in 64 bits.
// Rows are padded to n, the next power of two >= 128.  Padding lanes
// sort after every real lane (a sentinel key with a lane >= L; all-ones
// high bits in the SoA sort), so the first L lanes of the sorted row are
// exactly the sorted real lanes.
//
// Bound: operations and latency.  Each lane is read and written once,
// but log2(n) (log2(n) + 1) / 2 barrier-separated stages of n / 2
// compare-exchanges run in one CTA per row.
#include "common.cuh"

namespace {

using namespace repro;

__global__ void __launch_bounds__(1024) merge_sort_words_kernel(
    const int* __restrict__ words, const int* __restrict__ now, int L, int n,
    int* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem);
  const size_t row = blockIdx.x;
  const int* w = words + row * L;
  const int t = now[row];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int wi = i < L ? w[i] : kSentinel;
    const int key = wi >= 0 ? wrap_add(wrap_sub(wi, t), kHalfWindow) & kTimeMask
                            : kTimeMod;
    keys[i] = static_cast<unsigned>(key) * static_cast<unsigned>(n) +
              static_cast<unsigned>(i);
  }
  __syncthreads();
  bitonic_sort(keys, n);
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    out[row * L + i] = w[keys[i] & static_cast<unsigned>(n - 1)];
}

__global__ void __launch_bounds__(1024) merge_sort_kernel(
    const int* __restrict__ addr, const int* __restrict__ deadline,
    const unsigned char* __restrict__ valid, int L, int n,
    int* __restrict__ addr_out, int* __restrict__ deadline_out,
    unsigned char* __restrict__ valid_out) {
  extern __shared__ unsigned long long keys[];
  const size_t base = static_cast<size_t>(blockIdx.x) * L;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned hi = 0xffffffffu;
    if (i < L) {
      const int key = valid[base + i] ? deadline[base + i] : (1 << 30);
      hi = static_cast<unsigned>(key) ^ 0x80000000u;
    }
    keys[i] = (static_cast<unsigned long long>(hi) << 32) | static_cast<unsigned>(i);
  }
  __syncthreads();
  bitonic_sort(keys, n);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const size_t lane = base + static_cast<unsigned>(keys[i] & 0xffffffffull);
    addr_out[base + i] = addr[lane];
    deadline_out[base + i] = deadline[lane];
    valid_out[base + i] = valid[lane];
  }
}

}  // namespace

// words and out [rows, L]; now [rows]; n the padded power of two.
extern "C" int merge_sort_words_launch(const int* words, const int* now,
                                       int rows, int L, int n, int threads,
                                       long long smem_bytes, int* out,
                                       void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(merge_sort_words_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sort_words_kernel<<<rows, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(words, now, L, n,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

// addr, deadline, valid (bytes) and the outputs [rows, L].
extern "C" int merge_sort_launch(const int* addr, const int* deadline,
                                 const unsigned char* valid, int rows, int L,
                                 int n, int threads, long long smem_bytes,
                                 int* addr_out, int* deadline_out,
                                 unsigned char* valid_out, void* stream) {
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(merge_sort_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sort_kernel<<<rows, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      addr, deadline, valid, L, n, addr_out, deadline_out, valid_out);
  return static_cast<int>(cudaGetLastError());
}
