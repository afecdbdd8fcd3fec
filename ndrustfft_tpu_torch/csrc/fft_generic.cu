// Kernel 6: C2C along the middle axis of (B, n, L) on the generic schedule of
// fft_generic.cuh, n = m * f, V columns of one b per block. (Kernel 8's rows
// at such n and kernel 15's generic half length run on the mixed-radix row
// core, fft_rows_radix.cu and rfft_radix.cu.)
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid (the generic
// body of _build_call_axis_mid: n > 512 without a split), the schedule on a
// (1, m, f, TL) block: here the (n, V) column tile of one b, as K1 and K4
// take theirs.
//
// The bound and the design are in fft_generic.cuh. The tile holds V
// transforms, as many as 96 KB hold (two blocks per SM) and at least one
// (up to 227 KB at n = 20480), spread evenly so that the ragged last tile of
// a middle axis (L = 301 on the 600^3 step) is as full as the others; every
// pass loops over the valid transforms only, so a short tile costs its
// share, not a full tile (ops/hopper/fft.py::generic_block). The pass-2
// outputs go straight to device memory, so the tile is read and written in
// place once.
#include "fft_generic.cuh"

namespace ndfft {

__global__ void __launch_bounds__(kThreads)
c2c_generic_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   const float2* __restrict__ wm, const float2* __restrict__ wf,
                   const float2* __restrict__ tw, int m, int f, long long L, int V,
                   long long tiles) {
  extern __shared__ float2 s[];
  const long long n = (long long)m * f;
  GenTile g{m, f, 0};
  const long long b = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * V;
  g.V = (int)min((long long)V, L - col0);
  const float2* xb = x + b * n * L + col0;
  float2* yb = y + b * n * L + col0;
  gen_load(s, g, xb, L);
  gen_pass1(s, g, wm, tw);
  gen_pass2(s, g, wf, yb, L);
}

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; n = m * f with 2 <= m <= 224 and
// f <= 256. wm: (m, m) DFT-m; wf: (f, f) DFT-f times the scale; tw: (m, f)
// twiddle (ops/hopper/fft.py::generic_consts). V: columns per block.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_generic(const void* x, void* y, const void* wm, const void* wf,
                                 const void* tw, long long B, int m, int f, long long L,
                                 int V, void* stream) {
  using namespace ndfft;
  if (m < 2 || m > kGenPM * 32 || f < 2 || f > 256 || V < 1 || B < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const long long smem = gen_smem_bytes(m, f, V);
  const long long tiles = (L + V - 1) / V;
  const long long blocks = B * tiles;
  if (smem > kMaxSmemBytes || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      c2c_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  c2c_generic_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, st>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), static_cast<const float2*>(wm),
      static_cast<const float2*>(wf), static_cast<const float2*>(tw), m, f, L, V, tiles);
  return (int)cudaGetLastError();
}
