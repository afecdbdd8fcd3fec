// Kernels 8 (n > 256 without a split) and 6: C2C on the generic schedule of
// fft_generic.cuh, n = m * f.
//
//   kernel 8 (rows):     (T, n) contiguous rows, V rows per block
//   kernel 6 (columns):  along the middle axis of (B, n, L), V columns of one
//                        b per block
//
// Kernel 8 replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_lane_last with
// m > 1 (built by _build_call, math _lane_last_math): the lane-last C2C at
// 256 < n <= 20480 without a {128, 256} split (the reference's 264; 300,
// 600, 1000 ...). The TPU kernel transposed each (T, n) tile in VMEM to
// (m, f, T) to run the schedule on sublanes; here a block copies its V rows
// into shared memory as (m, f) matrices and runs the passes on them, no
// transpose. Kernel 6 replaces fft.py::_kernel_axis_mid (the generic body of
// _build_call_axis_mid: n > 512 without a split), the same schedule on a
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

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
c2c_generic_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   const float2* __restrict__ wm, const float2* __restrict__ wf,
                   const float2* __restrict__ tw, int m, int f, long long L, int V,
                   long long tiles) {
  extern __shared__ float2 s[];
  const long long n = (long long)m * f;
  GenTile g{m, f, 0, f | 1};
  const float2* xb;
  float2* yb;
  if (kRows) {
    const long long row0 = (long long)blockIdx.x * V;
    g.V = (int)min((long long)V, L - row0);
    xb = x + row0 * n;
    yb = y + row0 * n;
  } else {
    const long long b = blockIdx.x / tiles;
    const long long col0 = (blockIdx.x % tiles) * V;
    g.V = (int)min((long long)V, L - col0);
    xb = x + b * n * L + col0;
    yb = y + b * n * L + col0;
  }
  gen_load<kRows>(s, g, xb, L);
  gen_pass1<kRows>(s, g, wm, tw);
  gen_pass2<kRows>(s, g, wf, yb, kRows ? n : L);
}

template <bool kRows>
static cudaError_t launch_generic(const float2* x, float2* y, const float2* wm,
                                  const float2* wf, const float2* tw, long long B,
                                  int m, int f, long long L, int V, cudaStream_t stream) {
  const long long smem = gen_smem_bytes(m, f, V, kRows);
  const long long tiles = (L + V - 1) / V;
  const long long blocks = B * tiles;
  if (smem > kMaxSmemBytes || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      c2c_generic_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  c2c_generic_kernel<kRows><<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      x, y, wm, wf, tw, m, f, L, V, tiles);
  return cudaGetLastError();
}

}  // namespace ndfft

// x, y: contiguous complex64, (L, n) rows with B = 1 when rows == 1 (kernel
// 8), (B, n, L) when rows == 0 (kernel 6); n = m * f with 2 <= m <= 224 and
// f <= 256. wm: (m, m) DFT-m; wf: (f, f) DFT-f times the scale; tw: (m, f)
// twiddle (ops/hopper/fft.py::generic_consts). V: rows or columns per block.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_generic(const void* x, void* y, const void* wm, const void* wf,
                                 const void* tw, long long B, int m, int f, long long L,
                                 int V, int rows, void* stream) {
  using namespace ndfft;
  if (m < 2 || m > kGenPM * 32 || f < 2 || f > 256 || V < 1 || B < 1 || L < 1 ||
      (rows && B != 1))
    return (int)cudaErrorInvalidValue;
  const float2* xp = static_cast<const float2*>(x);
  float2* yp = static_cast<float2*>(y);
  const float2* wmp = static_cast<const float2*>(wm);
  const float2* wfp = static_cast<const float2*>(wf);
  const float2* twp = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(rows ? launch_generic<true>(xp, yp, wmp, wfp, twp, B, m, f, L, V, st)
                    : launch_generic<false>(xp, yp, wmp, wfp, twp, B, m, f, L, V, st));
}
