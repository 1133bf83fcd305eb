// merge_sort: stable counting and radix sorts of the merge stage, one CTA
// per row.
//
// Replaces the TPU kernels merge_sort_words_pallas and merge_sort_pallas
// (src/repro/kernels/merge_sort/kernel.py, _kernel_words and _kernel).
// The TPU kernels ran a bitonic network on (key, lane, payload) tuples,
// padded to a power of two, because the TPU has no fast VMEM gather or
// scatter.  Here the keys take few values or have few varying bits, so a
// row is sorted by stable counting passes (counting_pass in common.cuh):
// each pass counts and then ranks every lane once, in shared memory,
// and rows are not padded.
//
//   words  key (w - now + 128) & 255 for a valid word (w >= 0), 256 for a
//          sentinel or any other negative word: one counting pass over
//          257 bins; each word goes to its rank in a shared copy of the
//          row, which is then stored coalesced.
//   SoA    key valid ? deadline : 2^30, any int32 (negative deadlines and
//          deadlines >= 2^30 included), flipped to unsigned order.  An AND
//          and an OR over the row find the bits that vary; they are
//          packed into a dense key (bit_extract), and ceil(bits / 8)
//          least-significant-digit passes of 8 bits sort (dense key, lane)
//          pairs, alternating between two buffers (0 passes if every key
//          is equal).  Two keys first differ at a varying bit, so the
//          order is exact for any input.  addr, deadline and valid are
//          then staged coalesced in shared memory over the spent buffers
//          and gathered once in the sorted order.
//
// Bound: bytes (each lane read once and written once), far below what one
// CTA per row reaches: 46 rows fill 46 of 132 SMs, and a pass is a chain
// of barriers (count, scan, rank) over a few 32-lane steps per warp, so
// the time is latency and instruction issue on those SMs.  Shared memory
// per row: the block histogram (bins x (warps + 1) ints) plus 4 B (words)
// or 12 B (SoA: two dense keys and two u16 lane orders) per lane; the
// wrapper's launch_plan sizes it and caps the rows at 32,768 and 16,384
// lanes.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kWordBins = kTimeMod + 1;
constexpr int kDigitBins = 256;
constexpr int kScratch = 34;  // exclusive_scan's 32 ints, AND, OR

// Dynamic shared memory of each kernel; kept in step with the wrapper's
// launch_plan (kernels/merge_sort/ops.py).
long long words_smem(int L, int threads) {
  return 4LL * (kWordBins * (threads / 32 + 1) + kScratch + L);
}

long long soa_smem(int L, int threads) {
  return 4LL * (kDigitBins * (threads / 32 + 1) + kScratch) + 12LL * L;
}

__global__ void __launch_bounds__(1024) merge_sort_words_kernel(
    const int* __restrict__ words, const int* __restrict__ now, int L,
    int* __restrict__ out) {
  extern __shared__ int smem[];
  int* hist = smem;
  int* scratch = hist + kWordBins * ((blockDim.x >> 5) + 1);
  int* row = scratch + kScratch;
  const size_t base = static_cast<size_t>(blockIdx.x) * L;
  const int* w = words + base;
  const int t = now[blockIdx.x];
  counting_pass(
      whole_block(), L, kWordBins, hist, scratch,
      [&](int i) { return word_key(w[i], t); },
      [&](int i, int pos) { row[pos] = w[i]; });
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) out[base + i] = row[i];
}

__global__ void __launch_bounds__(1024) merge_sort_kernel(
    const int* __restrict__ addr, const int* __restrict__ deadline,
    const unsigned char* __restrict__ valid, int L,
    int* __restrict__ addr_out, int* __restrict__ deadline_out,
    unsigned char* __restrict__ valid_out) {
  extern __shared__ int smem[];
  int* hist = smem;
  int* scratch = hist + kDigitBins * ((blockDim.x >> 5) + 1);
  unsigned* bits = reinterpret_cast<unsigned*>(scratch + 32);  // AND, OR
  // Dense keys and lane orders, each in two buffers that the passes
  // alternate between.
  unsigned* key_in = reinterpret_cast<unsigned*>(scratch + kScratch);
  unsigned* key_out = key_in + L;
  unsigned short* in = reinterpret_cast<unsigned short*>(key_out + L);
  unsigned short* out = in + L;
  const size_t base = static_cast<size_t>(blockIdx.x) * L;
  if (threadIdx.x == 0) {
    bits[0] = 0xffffffffu;
    bits[1] = 0u;
  }
  __syncthreads();
  unsigned all = 0xffffffffu, any = 0u;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int key = valid[base + i] ? deadline[base + i] : (1 << 30);
    const unsigned u = static_cast<unsigned>(key) ^ 0x80000000u;
    key_in[i] = u;
    all &= u;
    any |= u;
  }
  all = __reduce_and_sync(0xffffffffu, all);
  any = __reduce_or_sync(0xffffffffu, any);
  if ((threadIdx.x & 31) == 0) {
    atomicAnd(&bits[0], all);
    atomicOr(&bits[1], any);
  }
  __syncthreads();
  const unsigned varying = bits[0] ^ bits[1];
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    key_in[i] = bit_extract(key_in[i], varying);
    in[i] = static_cast<unsigned short>(i);
  }
  __syncthreads();
  const int passes = (__popc(varying) + 7) >> 3;
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    const bool last = p + 1 == passes;
    counting_pass(
        whole_block(), L, kDigitBins, hist, scratch,
        [&](int i) { return static_cast<int>((key_in[i] >> shift) & 255u); },
        [&](int i, int pos) {
          if (!last) key_out[pos] = key_in[i];
          out[pos] = in[i];
        });
    __syncthreads();
    unsigned* k = key_out;
    key_out = key_in;
    key_in = k;
    unsigned short* o = out;
    out = in;
    in = o;
  }
  // The keys are spent: stage the payloads over them and over the spare
  // lane order, then gather them in the sorted order.
  int* a_stage = reinterpret_cast<int*>(key_in);
  int* d_stage = reinterpret_cast<int*>(key_out);
  unsigned char* v_stage = reinterpret_cast<unsigned char*>(out);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    a_stage[i] = addr[base + i];
    d_stage[i] = deadline[base + i];
    v_stage[i] = valid[base + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int lane = in[i];
    addr_out[base + i] = a_stage[lane];
    deadline_out[base + i] = d_stage[lane];
    valid_out[base + i] = v_stage[lane];
  }
}

bool bad_plan(int threads, long long smem_bytes, long long needed) {
  return threads < 32 || threads > 1024 || threads % 32 != 0 ||
         smem_bytes < needed;
}

}  // namespace

// words and out [rows, L]; now [rows]; threads a multiple of 32 and
// smem_bytes as the wrapper's launch_plan gives them.
extern "C" int merge_sort_words_launch(const int* words, const int* now,
                                       int rows, int L, int threads,
                                       long long smem_bytes, int* out,
                                       void* stream) {
  if (bad_plan(threads, smem_bytes, words_smem(L, threads)))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(merge_sort_words_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sort_words_kernel<<<rows, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(words, now, L,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

// addr, deadline, valid (bytes) and the outputs [rows, L]; L <= 65536
// (lane orders are u16).
extern "C" int merge_sort_launch(const int* addr, const int* deadline,
                                 const unsigned char* valid, int rows, int L,
                                 int threads, long long smem_bytes,
                                 int* addr_out, int* deadline_out,
                                 unsigned char* valid_out, void* stream) {
  if (L > 65536 || bad_plan(threads, smem_bytes, soa_smem(L, threads)))
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(merge_sort_kernel, smem_bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_sort_kernel<<<rows, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      addr, deadline, valid, L, addr_out, deadline_out, valid_out);
  return static_cast<int>(cudaGetLastError());
}
