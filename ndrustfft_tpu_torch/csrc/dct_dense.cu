// Kernel 27's dense product: a DCT along the middle axis of a (B, n, L)
// float32 tensor, 2 <= n <= 1100, at DCT-IV, at odd n for DCT-II/III, at
// the lengths without a radix plan (DCT-I at n - 1, DCT-II/III at n/2) and
// at the DCT-I lengths where ops/hopper/fft.py::dense_beats_radix holds
// (the other types and lengths run on the radix column tile,
// dct_mid_radix.cu):  y[b, k, c] = sum_t W[t, k] x[b, t, c],
// W = (s M)^T with M the rustdct DCT-type matrix and s the handler's scale,
// built on the host in float64 and rounded once (ops/hopper/dct.py).
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_dct_dense_kernel (built by
// _build_dct_dense_mid), which runs the same product as one MXU dot per
// (1, n, TL) block at the "highest" (float32) tier.
//
// What bounds it on this card: the function needs only its HBM traffic
// (8 n bytes a column: 0.0025 ms at the DCT-IV of (1, 1024, 1024) over
// 3.35 TB/s); this design does the product's 2 n^2 FLOPs per column on the
// FP32 CUDA cores (4.3 GFLOP there, >= 0.064 ms at the 67 TFLOP/s FP32
// peak, data sheet, 700 W), because the JAX package's gate sends these sizes
// to the dense product. The loop is the shared register-tiled product of
// dense_real.cuh, on the square (n, n) table with x and y in the plain
// (B, n, L) layout. The odd n (129 ... 1025) mask every edge.
#include "dense_real.cuh"

namespace ndfft {

// x and y both (B, n, L) float32
struct MidOperand {
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
