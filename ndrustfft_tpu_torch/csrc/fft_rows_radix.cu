// Kernels 10 (n = 128 * F at every F <= 160) and 8 (n <= 256, the JAX
// package's dense lane DFT, and 256 < n <= 20480, its generic schedule):
// C2C of contiguous rows of a (T, n) complex64 tensor on the mixed-radix
// Stockham row core (fft_radix.cuh, where the TPU kernels it replaces, its
// bound and its design are set out), with a row store.
//
// Kernel 10 at F in {4, 8, 16} (n = 512, 1024, 2048: plans (16, 16, 2),
// (16, 16, 4), (16, 16, 8)) ran on the bts2 core until this file took it:
// a dense DFT-128 per output, 4 * 128 FMAs per complex output, 137 GFLOP
// at (262144, 512), >= 2.05 ms at the FP32 peak against 0.64 ms of HBM
// traffic. Here the same rows take about 5 log2 n FP32 operations per
// element and are bound by device memory, as at every other F.
#include "fft_radix.cuh"

namespace ndfft {

// The row store: y (T, n) like x.
struct RowStore {
  float2* __restrict__ y;
  int n;
  __device__ void store(long long r, long long k, float2 v) const { y[r * n + k] = v; }
};

}  // namespace ndfft

// x, y: (T, n) complex64, contiguous; table: complex64, the plan's stage
// twiddles and prime coefficient rows for n and the sign
// (ops/hopper/fft.py::radix_consts); radices: the plan's `stages` radices
// (ops/hopper/fft.py::radix_plan); rows: rows per block; scale: multiplies
// every output. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_rows_radix(const void* x, void* y, const void* table,
                                    const int* radices, int stages, long long T, int n,
                                    int rows, int sign, float scale, void* stream) {
  using namespace ndfft;
  return (int)radix_rows_launch(RowLoad{static_cast<const float2*>(x)},
                                RowStore{static_cast<float2*>(y), n},
                                static_cast<const float2*>(table), radices, stages, T, n, rows,
                                sign, scale, static_cast<cudaStream_t>(stream));
}
