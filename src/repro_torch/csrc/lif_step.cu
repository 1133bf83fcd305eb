// lif_step: one Euler step of leaky integrate-and-fire neurons,
// elementwise.
//
// Replaces the TPU kernel lif_step_pallas
// (src/repro/kernels/lif_step/kernel.py:45, _kernel).  The TPU kernel ran
// over 1024-lane blocks and needed the wrapper to pad the neuron axis;
// here one thread owns one neuron and the grid is bounds-checked.  The
// update itself is repro::lif_update (common.cuh), which fused_inject.cu's
// fused_lif_inject shares, with the reference's rounding (no FMA
// contraction, expf), so it equals the plain version bitwise.
//
// Bound: bytes.  Eight 4-byte streams in, three out, a few operations per
// neuron: 44 B a neuron, about 1 MB at the network's [46, 512].  The
// inputs are read through the read-only data cache (__ldg).  Blocks of 256
// threads put the network's [46, 512] on 92 SMs; at that size one neuron
// per thread ran faster on an H100 than four neurons per thread on 16-byte
// loads and stores (PERF.md section 6).
#include "common.cuh"

namespace {

__global__ void lif_step_kernel(
    const float* __restrict__ v, const int* __restrict__ refrac,
    const float* __restrict__ current, const float* __restrict__ tau_m,
    const float* __restrict__ v_th, const float* __restrict__ v_reset,
    const float* __restrict__ v_rest, const int* __restrict__ refrac_period,
    long long n, float* __restrict__ v_out, int* __restrict__ refrac_out,
    float* __restrict__ spikes) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float vi = __ldg(v + i);
  int r = __ldg(refrac + i);
  const bool spike = repro::lif_update(
      vi, r, __ldg(current + i), __ldg(tau_m + i), __ldg(v_th + i),
      __ldg(v_reset + i), __ldg(v_rest + i), __ldg(refrac_period + i));
  v_out[i] = vi;
  refrac_out[i] = r;
  spikes[i] = spike ? 1.0f : 0.0f;
}

}  // namespace

// Every array holds n elements; refrac and refrac_period are int32.
extern "C" int lif_step_launch(
    const float* v, const int* refrac, const float* current,
    const float* tau_m, const float* v_th, const float* v_reset,
    const float* v_rest, const int* refrac_period, long long n,
    float* v_out, int* refrac_out, float* spikes, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  lif_step_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      v, refrac, current, tau_m, v_th, v_reset, v_rest, refrac_period, n,
      v_out, refrac_out, spikes);
  return static_cast<int>(cudaGetLastError());
}
