// Kernel 27: dense DCT of any type along the middle axis of a (B, n, L)
// float32 tensor, 2 <= n <= 1100:  y[b, k, c] = sum_t W[t, k] x[b, t, c],
// W = (s M)^T with M the rustdct DCT-type matrix and s the handler's scale,
// built on the host in float64 and rounded once (ops/hopper/dct.py).
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_dct_dense_kernel (built by
// _build_dct_dense_mid), which runs the same product as one MXU dot per
// (1, n, TL) block at the "highest" (float32) tier.
//
// What bounds it on this card: the product's 2 n^2 FLOPs per column on the
// FP32 CUDA cores. At (1, 512, 262144) that is 137 GFLOP, >= 2.05 ms at the
// 67 TFLOP/s FP32 peak (data sheet, 700 W), against 1.07 GB of HBM traffic
// (0.32 ms at 3.35 TB/s). The loop is the shared register-tiled product of
// dense_real.cuh, on the square (n, n) table with x and y in the plain
// (B, n, L) layout. Every n of the reference grid (129, 265, 513, 1025) is
// odd, so every edge is masked there.
#include "dense_real.cuh"

namespace ndfft {

// x and y both (B, n, L) float32
struct MidOperand {
  static constexpr bool kRows = false;
  const float* x;
  float* y;
  int n;
  long long L;
  __device__ float load(long long b, int t, long long c) const {
    return __ldg(x + (b * n + t) * L + c);
  }
  __device__ void store(long long b, int k, long long c, float v) const {
    y[(b * n + k) * L + c] = v;
  }
};

}  // namespace ndfft

// w: (n, n) float32, w[t * n + k] = s M[k, t]; x, y: (B, n, L) float32,
// contiguous. TM: the micro-tile, 8 (128 x 128 block tile) or 4 (64 x 64).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct_dense_mid(const void* w, const void* x, void* y,
                                   long long B, int n, long long L, int TM,
                                   void* stream) {
  using namespace ndfft;
  const MidOperand op{static_cast<const float*>(x), static_cast<float*>(y), n, L};
  return (int)dense_real(TM, static_cast<const float*>(w), op, n, n, L, B,
                         static_cast<cudaStream_t>(stream));
}
