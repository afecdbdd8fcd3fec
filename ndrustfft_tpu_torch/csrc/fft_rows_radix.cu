// Kernels 10 (n = 128 * F, F outside {4, 8, 16}) and 8 (n <= 256, the JAX
// package's dense lane DFT, and 256 < n <= 20480, its generic schedule):
// C2C of contiguous rows of a (T, n) complex64 tensor on the mixed-radix
// Stockham row core (fft_radix.cuh, where the TPU kernels it replaces, its
// bound and its design are set out), with kernel 10's row store.
#include "c2c_tile.cuh"
#include "fft_radix.cuh"

// x, y: (T, n) complex64, contiguous; table: complex64, the plan's stage
// twiddles and prime coefficient rows for n and the sign
// (ops/hopper/fft.py::radix_consts); radices: the plan's `stages` radices
// (ops/hopper/fft.py::radix_plan); rows: rows per block; scale: multiplies
// every output. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_rows_radix(const void* x, void* y, const void* table,
                                    const int* radices, int stages, long long T, int n,
                                    int rows, int sign, float scale, void* stream) {
  using namespace ndfft;
  return (int)radix_rows_launch(static_cast<const float2*>(x),
                                RowStore{static_cast<float2*>(y), n},
                                static_cast<const float2*>(table), radices, stages, T, n, rows,
                                sign, scale, static_cast<cudaStream_t>(stream));
}
