// Kernel 1: C2C along the middle axis of a (B, n, L) complex64 tensor.
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_bts2 (built by
// _build_call_axis_mid, core _bts2_core) for n = 128 * F: F in {4, 8, 16} on
// the fixed core below, every other F <= 160 on the wide core
// (bts2_wide.cuh, c2c_axis_mid_wide_kernel at the end of this file).
//
// One block per (b, tile of C columns). The block reads its n x C tile of
// torch's interleaved complex64 straight into shared memory (float2 loads;
// the TPU kernel's separate re/im planes and the real/imag/complex boundary
// passes do not exist here), runs the shared bts2 core (bts2_core.cuh) on it,
// and writes the tile back, so device memory is read once and written once.
// The last column tile may be ragged (L = 257, 513 on the slice): loads past
// L read zeros and stores past L are masked. The normalization scale is
// folded into the Wq constants on the host. The bound and the levers are in
// bts2_core.cuh and bts2_wide.cuh.
#include "bts2_wide.cuh"

namespace ndfft {

template <int F, int C>
__global__ void __launch_bounds__(kThreads)
c2c_axis_mid_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    const float2* __restrict__ wq, float sign, long long L,
                    long long tiles) {
  constexpr int N = F * kM;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  const float2* xb = x + bb * N * L + col0;
  fixed_fill<C>(s, N, valid, [&](int t, int c) { return xb[t * L + c]; });
  __syncthreads();
  Bts2<F, C, false>::run(s, wq, sign);
  float2* yb = y + bb * N * L + col0;
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int t = idx / C;
    const int c = idx % C;
    if (c < valid) yb[t * L + c] = s[idx];
  }
}

// Kernel 1 at every other butterfly factor, on the wide core
// (bts2_wide.cuh): one block per (b, tile of at most C columns), the L
// columns spread evenly over the tiles (L = 385 on axis 1 of the 768^3
// step: 49 tiles of 7 or 8 columns, no one-column tail tile). The block
// reads its (n, V) column tile once; the core writes the outputs to y.
template <int C>
__global__ void __launch_bounds__(kThreads)
c2c_axis_mid_wide_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                         const float2* __restrict__ wq, const float2* __restrict__ wf,
                         int F, long long L, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, n, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float2* xb = x + bb * n * L + col0;
  for (int idx = threadIdx.x; idx < n * C; idx += kThreads) {
    const int t = idx / C;
    const int c = idx % C;
    if (c < valid) sm.s[idx] = xb[t * L + c];
  }
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  Bts2Wide<C, false>{n, F}.run(sm.s, sm.ys, sm.wt, wq, valid, y + bb * n * L + col0, 1, L);
}

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; wq: (F, 128, 128) complex64.
// C: columns per block, a power of two with n * C <= 8192.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_axis_mid(const void* x, void* y, const void* wq,
                                  long long B, int n, long long L, int C,
                                  int sign, void* stream) {
  using namespace ndfft;
  return (int)fixed_dispatch<4>(n, C, [&](auto f, auto c) {
    constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
    return fixed_launch<kF, kC>(c2c_axis_mid_kernel<kF, kC>, B, L,
                                static_cast<cudaStream_t>(stream), static_cast<const float2*>(x),
                                static_cast<float2*>(y), static_cast<const float2*>(wq),
                                sign < 0 ? -1.f : 1.f, L);
  });
}

// Kernel 1 on the wide core, n = 128 * F with 1 <= F <= 160. x, y: (B, n, L)
// complex64, contiguous; wq: (F, 128, 128) complex64 (as above); wf: (F, F)
// complex64 DFT-F of the transform's sign (ops/hopper/fft.py::wide_consts).
// C: columns per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes). Returns the cudaError_t of the launch.
extern "C" int ndfft_c2c_axis_mid_wide(const void* x, void* y, const void* wq,
                                       const void* wf, long long B, int n, long long L,
                                       int C, void* stream) {
  using namespace ndfft;
  const float2* xp = static_cast<const float2*>(x);
  float2* yp = static_cast<float2*>(y);
  const float2* wqp = static_cast<const float2*>(wq);
  const float2* wfp = static_cast<const float2*>(wf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(c2c_axis_mid_wide_kernel<kC>, n, B, L, st, xp, yp, wqp, wfp,
                           n / kM, L);
  });
}
