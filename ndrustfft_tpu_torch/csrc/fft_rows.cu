// Kernel 10: C2C of contiguous rows of a (T, n) complex64 tensor, n = 128 * F
// with F in {4, 8, 16}, on the fixed core. Every other F runs on the
// mixed-radix row core (fft_rows_radix.cu, fft_radix.cuh).
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_twostep (built by
// _build_call_twostep, math _twostep_math) for the port's split m = 128.
//
// The TPU kernel transposed each (T, n) tile to (n, T) in VMEM so that its
// dense stage ran as a 2-D MXU product with the transform index on sublanes,
// then merged and transposed back. On Hopper no transpose is needed: R
// consecutive rows are one contiguous float2 copy into shared memory, the
// shared bts2 core (bts2_core.cuh) runs in its row layout (Bts2<F, R, true>,
// the layout of kernels 2 and 3, without their R2C unpack or C2R pre-pass),
// and the block stores the R rows back as one contiguous copy. Device memory
// is read once and written once (the kernels, shared with kernel 13, are in
// c2c_tile.cuh). The normalization scale rides the Wq constants, which
// kernels 1 and 10 share per (n, sign, scale).
//
// What bounds it on this card: the core's stage 2, a dense DFT-128 with
// 4 * 128 real FMAs per complex output on the FP32 CUDA cores: 137 GFLOP at
// (262144, 512), >= 2.05 ms at the 67 TFLOP/s FP32 peak, against 2.15 GB of
// HBM traffic (0.64 ms at 3.35 TB/s), so the kernel is compute-bound like
// kernel 1 (the levers are in bts2_core.cuh). The design keeps
// every row in shared memory between the two stages and fills the card by
// halving R (rows per block) while the grid would leave SMs idle
// (ops/hopper/fft.py::block_rows). The last block's rows are ragged when
// T % R != 0: loads past T read zeros and stores past T are masked.
#include "c2c_tile.cuh"

// x, y: (T, n) complex64, contiguous; wq: (F, 128, 128) complex64 (kernel 1's
// constants for n, sign and the scale). R: rows per block, a power of two
// with n * R <= 8192. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_rows(const void* x, void* y, const void* wq,
                              long long T, int n, int R, int sign,
                              void* stream) {
  using namespace ndfft;
  return (int)rows_launch(static_cast<const float2*>(x), RowStore{static_cast<float2*>(y), n},
                          static_cast<const float2*>(wq), T, n, R, sign,
                          static_cast<cudaStream_t>(stream));
}
