// ssm_scan: the selective-SSM recurrence of a Mamba block over a whole
// sequence, from h = 0,
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      h [di, N]
//   y_t = h_t . C_t + D * x_t,
// returning y [B, T, di] and the final state h_T [B, di, N], both f32.
//
// Replaces the TPU kernel ssm_scan_pallas
// (src/repro/kernels/ssm_scan/kernel.py, _kernel).  The TPU kernel walked
// a sequential grid axis over 128-step time tiles with h [128 channels,
// N] in VMEM scratch, and its wrapper padded T and di to 128.  Here the
// time loop runs inside the block, h lives in registers for the whole
// sequence, and the ragged edges are masked; the final state, which the
// TPU kernel kept to itself, is written out for the decode cache.
//
// Bound: operations (one exp and three FMAs per state element and step,
// about 2.7e9 state updates at the zamba2 prefill shape, against each
// input element read once).  Design: G lanes of a warp share one channel
// (G the power of two with 16 G >= N), and lane g holds the 16 state
// elements n = 16 g .. 16 g + 15 in registers, with A's row beside them;
// N is padded to 16 G with states whose A, B and C are 0, which stay 0,
// so the step has no bounds test.  A 256-thread block covers 256 / G
// channels of one batch row.  Each tile of 32 steps stages x, dt
// (channels contiguous), B_t and C_t (padded rows) in shared memory with
// coalesced loads; a lane reads its 16 B and 16 C values as four float4
// each (shared-memory loads, not arithmetic, bounded a layout with one
// 4-byte load per state element: 2.6x slower at the zamba2 shape on an
// H100 80GB HBM3 at 700 W); a
// step's y sums the lanes' partial dot products with G-lane shuffles and
// goes to a shared tile that is written back coalesced.  A is taken as a
// general [di, N] array (no per-head constant is assumed); expf is the
// accurate library exp.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;    // time steps staged per tile
constexpr int kStates = 16;  // state elements per lane

__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dv, int T, int di,
    int N, int G, float* __restrict__ y, float* __restrict__ h_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ch = kThreads / G;   // channels of this block
  const int np = kStates * G;    // N padded with zero states
  float* bs = smem;              // [kTile][np]
  float* cs = bs + kTile * np;   // [kTile][np]
  float* xs = cs + kTile * np;   // [kTile][ch]
  float* dts = xs + kTile * ch;  // [kTile][ch]
  float* ys = dts + kTile * ch;  // [kTile][ch]

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * ch;
  const int cl = threadIdx.x / G;  // channel within the block
  const int g = threadIdx.x % G;
  const int d = d0 + cl;
  const bool live = d < di;
  const int n0 = g * kStates;      // this lane's states n0 .. n0 + 15

  float h[kStates], a[kStates];
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    h[s] = 0.0f;
    a[s] = live && n0 + s < N ? A[static_cast<long long>(d) * N + n0 + s] : 0.0f;
  }
  const float dd = live ? Dv[d] : 0.0f;
  const long long row0 = static_cast<long long>(b) * T;

  for (int t0 = 0; t0 < T; t0 += kTile) {
    const int tn = min(kTile, T - t0);
    __syncthreads();  // the previous tile's ys is written back
    for (int i = threadIdx.x; i < kTile * ch; i += kThreads) {
      const int tt = i / ch, c = i % ch;
      const bool ok = tt < tn && d0 + c < di;
      const long long src = (row0 + t0 + tt) * di + d0 + c;
      xs[i] = ok ? x[src] : 0.0f;
      dts[i] = ok ? dt[src] : 0.0f;
    }
    for (int i = threadIdx.x; i < kTile * np; i += kThreads) {
      const int tt = i / np, n = i % np;
      const bool ok = tt < tn && n < N;
      const long long src = (row0 + t0 + tt) * N + n;
      bs[i] = ok ? Bm[src] : 0.0f;
      cs[i] = ok ? Cm[src] : 0.0f;
    }
    __syncthreads();

    for (int tt = 0; tt < tn; ++tt) {
      const float xv = xs[tt * ch + cl];
      const float dtv = dts[tt * ch + cl];
      const float u = dtv * xv;
      const float4* b4 = reinterpret_cast<const float4*>(bs + tt * np + n0);
      const float4* c4 = reinterpret_cast<const float4*>(cs + tt * np + n0);
      float yp = 0.0f;
#pragma unroll
      for (int q = 0; q < kStates / 4; ++q) {
        const float4 bv = b4[q], cv = c4[q];
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = 4 * q + k;
          h[s] = expf(dtv * a[s]) * h[s] + u * bb[k];
          yp += h[s] * cc[k];
        }
      }
      for (int off = G / 2; off > 0; off >>= 1)
        yp += __shfl_xor_sync(0xffffffffu, yp, off);
      if (g == 0) ys[tt * ch + cl] = yp + dd * xv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * ch; i += kThreads) {
      const int tt = i / ch, c = i % ch;
      if (tt < tn && d0 + c < di) y[(row0 + t0 + tt) * di + d0 + c] = ys[i];
    }
  }

  if (live) {
    float* hp = h_out + (static_cast<long long>(b) * di + d) * N;
#pragma unroll
    for (int s = 0; s < kStates; ++s)
      if (n0 + s < N) hp[n0 + s] = h[s];
  }
}

}  // namespace

// x, dt [batch, T, di]; A [di, N]; Bm, Cm [batch, T, N]; Dv [di]; all
// float32 and contiguous.  Outputs y [batch, T, di] and h_out [batch, di,
// N], float32.  N at most 16 * 32.
extern "C" int ssm_scan_launch(const float* x, const float* dt, const float* A,
                               const float* Bm, const float* Cm,
                               const float* Dv, int batch, int T, int di,
                               int N, float* y, float* h_out, void* stream) {
  if (batch == 0 || di == 0 || N == 0) return 0;
  int G = 1;
  while (G * kStates < N) G <<= 1;
  if (G > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int ch = kThreads / G;
  const size_t smem = sizeof(float) * kTile * (3 * ch + 2 * kStates * G);
  static size_t allowed = 48 * 1024;
  cudaError_t err = repro::allow_smem(ssm_scan_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((di + ch - 1) / ch, batch);
  ssm_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, dt, A, Bm, Cm, Dv, T, di, N, G, y, h_out);
  return static_cast<int>(cudaGetLastError());
}
