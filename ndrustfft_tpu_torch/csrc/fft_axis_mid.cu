// Kernel 1: C2C along the middle axis of a (B, n, L) complex64 tensor.
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_bts2 (built by
// _build_call_axis_mid, core _bts2_core) for n = 128 * F: F in {4, 8, 16} on
// the fixed core, every other F <= 160 on the wide core
// (bts2_wide.cuh, c2c_tile.cuh::c2c_axis_mid_wide_kernel).
//
// One block per (b, tile of C columns). The block reads its n x C tile of
// torch's interleaved complex64 straight into shared memory (float2 loads;
// the TPU kernel's separate re/im planes and the real/imag/complex boundary
// passes do not exist here), runs the shared bts2 core (bts2_core.cuh) on it,
// and writes the tile back, so device memory is read once and written once
// (the kernels, shared with kernel 7, are in c2c_tile.cuh). The last column
// tile may be ragged (L = 257, 513 on the slice): loads past L read zeros
// and stores past L are masked. The normalization scale is folded into the
// Wq constants on the host. The bound and the levers are in
// bts2_core.cuh and bts2_wide.cuh.
#include "c2c_tile.cuh"

// x, y: (B, n, L) complex64, contiguous; wq: (F, 128, 128) complex64.
// C: columns per block, a power of two with n * C <= 8192.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_axis_mid(const void* x, void* y, const void* wq,
                                  long long B, int n, long long L, int C,
                                  int sign, void* stream) {
  using namespace ndfft;
  return (int)axis_mid_launch(static_cast<const float2*>(x), MidStore{static_cast<float2*>(y), n, L},
                              static_cast<const float2*>(wq), B, n, L, C, sign,
                              static_cast<cudaStream_t>(stream));
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
  return (int)axis_mid_wide_launch(static_cast<const float2*>(x),
                                   MidStore{static_cast<float2*>(y), n, L},
                                   static_cast<const float2*>(wq), static_cast<const float2*>(wf),
                                   B, n, L, C, static_cast<cudaStream_t>(stream));
}
