// Kernel 15 at a half length h > 256 without a {128, 256} split: the packed
// R2C of contiguous (T, n) float32 rows, n = 2h, h = m * f, to (T, h + 1)
// complex64 (h = 265 at n = 530 and h = 300 at n = 600; odd h included).
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_kernel where
// _half_fft_consts falls back to the generic lane-last schedule. The TPU
// kernel ran the rows [z; conj z] of the even/odd streams through its
// length-h FFT and unpacked Z and C = conj Z[(h - k) mod h]. Here a
// contiguous float32 row of length 2h is read as the complex row
// z[t] = x[2t] + i x[2t + 1], the generic core (fft_generic.cuh) takes it in
// its row layout, and the unpack is the epilogue:
//
//   X[k] = (Z[k] + C[k]) / 2 - i W_n^k (Z[k] - C[k]) / 2,  k < h,
//   X[h] = Re Z[0] - Im Z[0],
//
// in one pass: pass 2 writes Z into the output row's first h slots, and
// after a block barrier each thread takes one mirror pair {k, (h - k) mod h}
// (bts2_core.cuh::r2c_unpack_rows, shared with kernel 2's wide form). The
// bound is the core's (fft_generic.cuh): at (360000, 600) 131 GFLOP of
// dense products against 1.73 GB of HBM traffic; the epilogue adds the row's
// round trip through L2.
#include "fft_generic.cuh"

namespace ndfft {

__global__ void __launch_bounds__(kThreads)
r2c_generic_kernel(const float2* __restrict__ x, float2* y,
                   const float2* __restrict__ wm, const float2* __restrict__ wf,
                   const float2* __restrict__ tw, const float2* __restrict__ u, int m,
                   int f, long long T, int V) {
  extern __shared__ float2 s[];
  const int h = m * f;
  const long long row0 = (long long)blockIdx.x * V;
  GenTile g{m, f, (int)min((long long)V, T - row0), f | 1};
  float2* yb = y + row0 * (h + 1);
  gen_load<true>(s, g, x + row0 * h, 0);
  gen_pass1<true>(s, g, wm, tw);
  gen_pass2<true>(s, g, wf, yb, h + 1);
  __syncthreads();   // Z of every row of the block is in device memory
  r2c_unpack_rows(yb, h, g.V, u);
}

}  // namespace ndfft

// x: (T, 2h) float32, contiguous, 8-byte aligned (read as (T, h) complex64);
// y: (T, h + 1) complex64; h = m * f; wm, wf, tw: the forward generic_consts
// of h (scale 1); u: (h,) W_n^k. V: rows per block. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int ndfft_r2c_generic(const void* x, void* y, const void* wm, const void* wf,
                                 const void* tw, const void* u, long long T, int m, int f,
                                 int V, void* stream) {
  using namespace ndfft;
  if (m < 2 || m > kGenPM * 32 || f < 2 || f > 256 || V < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = gen_smem_bytes(m, f, V, true);
  const long long blocks = (T + V - 1) / V;
  if (smem > kMaxSmemBytes || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      r2c_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  r2c_generic_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y),
      static_cast<const float2*>(wm), static_cast<const float2*>(wf),
      static_cast<const float2*>(tw), static_cast<const float2*>(u), m, f, T, V);
  return (int)cudaGetLastError();
}
