// The generic-schedule core of kernel 6 (fft_generic.cu): the (n, V) column
// tile of a middle axis. The row kernels that ran it before (kernel 8's rows
// and kernel 15's generic half length) run on the mixed-radix row core
// (fft_radix.cuh: fft_rows_radix.cu, rfft_radix.cu), which does O(n log n)
// work.
//
// Replaces, for the CUDA port, the schedule of the JAX package's Pallas
// kernel _kernel_axis_mid (which _r2c_kernel's generic half FFT and
// _kernel_lane_last at m > 1 share, now ported to fft_radix.cuh):
// ndrustfft_tpu/ops/pallas/fft.py::_axis0_core on the constants of
// _plan_consts. A C2C of length n = m * f, f = _lane_factor(n)
// <= 256, input index t = f t' + j, output index k = q m + p:
//
//   pass 1 (in place):  B[p][j] = tw[p][j] * sum_t' x[f t' + j] Wm[t'][p]
//   pass 2 (to memory): X[q m + p] = sum_j B[p][j] Wf[j][q]
//
// with Wm = DFT-m, Wf = DFT-f times the scale, tw[p][j] = W_n^{j p}, all
// built on the host in float64 and rounded once (ops/hopper/fft.py::
// generic_consts). DFT-m is one dense product, also for the 37 lengths
// >= 11352 whose planner splits m in two (m <= 219 on the gate's range).
//
// What bounds it on this card: the two dense products do (m + f) complex
// MACs, 8 (m + f) FP32 operations, per output against an FFT's 5 log2 n:
// at n = 600 (m = 3, f = 200) 1624 against 46, so every kernel on this core
// is bound by the FP32 cores, not by its bytes (the step's K6 leg at
// (600, 600, 301): 176 GFLOP >= 2.6 ms at 67 TFLOP/s, against 1.73 GB of
// HBM traffic, 0.52 ms). The design keeps each transform in shared memory
// between the passes, so device memory is read once and written once; runs
// every MAC as 4 fmaf in float32 (no TF32); streams the tables through L2
// with __ldg; and blocks the operands in registers: pass 1 gives each lane
// up to 7 outputs p of one line j (one x load feeds them all), pass 2 each
// thread 4 outputs q of one (p, transform) (one B load feeds them all), so
// a MAC costs 4 FMAs and at most 1.25 loads, each load one shared address
// or a contiguous run across the warp. The lever for later work is the
// mixed-radix core's column tile (fft_radix.cuh, kernel 11's
// fft_blue_radix.cu) in K6's layout.
//
// Tile layout (c = transform of the block, V valid transforms): B/x (r, j)
// of transform c at s[(r * f + j) * V + c], the natural (t, c) tile of K6.
#pragma once

#include "bts2_core.cuh"

namespace ndfft {

constexpr int kGenPM = 7;   // outputs p per lane in pass 1 (m <= 7 * 32)
constexpr int kGenQB = 4;   // outputs q per thread in pass 2

struct GenTile {
  int m, f, V;
  __device__ __forceinline__ int pos(int r, int j, int c) const { return (r * f + j) * V + c; }
};

// Pass 1: for each line (j, c), the DFT-m over t' and the twiddle, in place
// (B[p][j] lands where x[f p + j] was). A line is G lanes of one warp (G the
// power of two >= m, at most 32), each lane holding outputs p = sub + i G;
// the warp reads its lines whole before it writes them, so no barrier but
// __syncwarp is needed. Ends with a block barrier.
__device__ inline void gen_pass1(float2* s, const GenTile& g, const float2* __restrict__ wm,
                                 const float2* __restrict__ tw) {
  const int m = g.m, f = g.f;
  int G = 1;
  while (G < m && G < 32) G <<= 1;
  const int pm = (m + G - 1) / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int gpw = 32 / G;                     // lines per warp pass
  const int lines = f * g.V;
  const int step = (int)(blockDim.x >> 5) * gpw;
  for (int base = (int)(threadIdx.x >> 5) * gpw; base < lines; base += step) {
    const int l = base + lane / G;
    const bool active = l < lines;
    // neighbouring lines are neighbouring columns c
    const int j = l / g.V;
    const int c = l % g.V;
    float2 acc[kGenPM];
#pragma unroll
    for (int i = 0; i < kGenPM; ++i) acc[i] = make_float2(0.f, 0.f);
    if (active) {
      for (int t = 0; t < m; ++t) {
        const float2 xv = s[g.pos(t, j, c)];
        const float2* __restrict__ w = wm + t * m + sub;
#pragma unroll
        for (int i = 0; i < kGenPM; ++i)
          if (i < pm && sub + i * G < m) cmac(acc[i], xv, __ldg(w + i * G));
      }
    }
    __syncwarp();
    if (active) {
#pragma unroll
      for (int i = 0; i < kGenPM; ++i) {
        const int p = sub + i * G;
        if (i < pm && p < m) s[g.pos(p, j, c)] = cmul(acc[i], __ldg(tw + p * f + j));
      }
    }
  }
  __syncthreads();
}

// Pass 2: X[q m + p] = sum_j B[p][j] Wf[j][q] for each transform c, written
// straight to device memory at y[k * ystride + c]. A thread owns the kGenQB
// outputs q = qb + i * nqb of one (p, c), neighbouring c on neighbouring
// threads (contiguous columns, one Wf address per warp).
__device__ inline void gen_pass2(const float2* s, const GenTile& g,
                                 const float2* __restrict__ wf, float2* __restrict__ y,
                                 long long ystride) {
  const int m = g.m, f = g.f;
  const int nqb = (f + kGenQB - 1) / kGenQB;
  const int items = m * nqb * g.V;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int c = idx % g.V;
    const int p = (idx / g.V) % m;
    const int qb = idx / (g.V * m);
    float2 acc[kGenQB];
#pragma unroll
    for (int i = 0; i < kGenQB; ++i) acc[i] = make_float2(0.f, 0.f);
    const float2* b = s + g.pos(p, 0, c);
    for (int j = 0; j < f; ++j) {
      const float2 bv = b[j * g.V];
      const float2* __restrict__ w = wf + j * f + qb;
#pragma unroll
      for (int i = 0; i < kGenQB; ++i)
        if (qb + i * nqb < f) cmac(acc[i], bv, __ldg(w + i * nqb));
    }
#pragma unroll
    for (int i = 0; i < kGenQB; ++i) {
      const int q = qb + i * nqb;
      if (q < f) y[((long long)q * m + p) * ystride + c] = acc[i];
    }
  }
}

// Load the (n, V) column tile of a row-major (n, L) slab, n = m f.
__device__ inline void gen_load(float2* s, const GenTile& g, const float2* __restrict__ x,
                                long long L) {
  const int n = g.m * g.f;
  for (int idx = threadIdx.x; idx < n * g.V; idx += blockDim.x) {
    const int c = idx % g.V, t = idx / g.V;
    s[t * g.V + c] = x[(long long)t * L + c];
  }
  __syncthreads();
}

// Dynamic shared memory of a tile of V transforms.
inline long long gen_smem_bytes(int m, int f, int V) {
  return (long long)V * m * f * (long long)sizeof(float2);
}

}  // namespace ndfft
