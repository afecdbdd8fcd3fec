// Kernels 20 and 21: R2C and C2R along the middle axis of (B, n, L) as one
// real product each, m = n/2 + 1, at the odd lengths where their routes
// (ops/hopper/rfft.py::r2c_dense_form, c2r_dense_form) name it: odd n
// without a radix plan below rfft.py::CHIRP_MIN_ODD (131, 137 ...), and
// odd n with a plan where a large prime stage makes the product faster
// (kernel 20: a prime n or 3 p; kernel 21: ops/hopper/fft.py::
// dense_beats_radix, 129 = 3 * 43 ...). At the other lengths both run on
// the radix column tile (rfft_mid_radix.cu) or as a real-input chirp-z,
// kernel 21's backwards (fft_blue_radix.cu). (Kernel 15's rows at h = 1,
// 31 and the primes 131 ... 251 ran this product with kernel 20's table in
// the row layout until the rows' chirp-z beat it 1.1-3.2x on an H100.)
//
// Kernel 20 replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_dense_kernel
// (built by _build_r2c_dense_mid, table _r2c_dense_w); kernel 21 replaces
// rfft.py::_c2r_dense_kernel (built by _build_c2r_dense_mid, table
// _c2r_dense_w). Both TPU kernels run one MXU dot per (1, n, TL) block at
// the "highest" (float32) tier on split re/im planes.
//
//   kernel 20:  Y (2m x L) = W^T X,   W (n, 2m) = [cos | -sin](2 pi t k / n);
//               row k < m of Y is Re X[k], row m + k is Im X[k]
//   kernel 21:  x (n x L) = W2^T Z,   W2 (2m, n) = [A^T; B^T], Z's rows
//               j < m are Re S[j] and j >= m are Im S[j - m]
//
// W2 carries the Hermitian fold (the x2 weights), the DC and (even n)
// Nyquist masking (zero B columns) and the scale, so kernel 21 is the whole
// of the reference's ifft_r2c semantics as one product. The tables are built
// on the host in float64 and rounded once (ops/hopper/rfft.py). Here the
// split planes do not exist: the operand functors read and write torch's
// interleaved complex64 directly (float index 2 * ((b m + k) L + c), + 1 for
// the imaginary part).
//
// What bounds it on this card: the function needs only its HBM traffic (a
// real FFT's 2.5 n log2 n FLOPs per column are far below it); this design
// does the product's 2 n (2m) FLOPs per column on
// the FP32 CUDA cores, because the JAX package's gate sends these sizes to
// the dense product. The loop is the shared register-tiled product of
// dense_real.cuh (kernel 27's), with every edge masked.
#include "dense_real.cuh"

namespace ndfft {

// x: (B, n, L) float32; out: (B, m, L) complex64 as 2 * B * m * L floats
struct R2cDenseOperand {
  const float* x;
  float* out;
  int n;
  int m;
  long long L;
  __device__ float load(long long b, int t, long long c) const {
    return __ldg(x + (b * n + t) * L + c);
  }
  __device__ void store(long long b, int k, long long c, float v) const {
    const int re = k < m;
    out[2 * ((b * m + (re ? k : k - m)) * L + c) + (1 - re)] = v;
  }
};

// spec: (B, m, L) complex64 as floats; y: (B, n, L) float32
struct C2rDenseOperand {
  const float* spec;
  float* y;
  int n;
  int m;
  long long L;
  __device__ float load(long long b, int j, long long c) const {
    const int re = j < m;
    return __ldg(spec + 2 * ((b * m + (re ? j : j - m)) * L + c) + (1 - re));
  }
  __device__ void store(long long b, int k, long long c, float v) const {
    y[(b * n + k) * L + c] = v;
  }
};

}  // namespace ndfft

// w: (n, 2m) float32 in C order; x: (B, n, L) float32; out: (B, m, L)
// complex64; all contiguous. TM: the micro-tile, 8 or 4.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_dense_mid(const void* w, const void* x, void* out,
                                   long long B, int n, long long L, int TM,
                                   void* stream) {
  using namespace ndfft;
  const int m = n / 2 + 1;
  const R2cDenseOperand op{static_cast<const float*>(x), static_cast<float*>(out),
                           n, m, L};
  return (int)dense_real(TM, static_cast<const float*>(w), op, 2 * m, n, L, B,
                         static_cast<cudaStream_t>(stream));
}

// w: (2m, n) float32 in C order, the scale folded in; spec: (B, m, L)
// complex64; out: (B, n, L) float32; all contiguous. TM: 8 or 4.
extern "C" int ndfft_c2r_dense_mid(const void* w, const void* spec, void* out,
                                   long long B, int n, long long L, int TM,
                                   void* stream) {
  using namespace ndfft;
  const int m = n / 2 + 1;
  const C2rDenseOperand op{static_cast<const float*>(spec), static_cast<float*>(out),
                           n, m, L};
  return (int)dense_real(TM, static_cast<const float*>(w), op, n, 2 * m, L, B,
                         static_cast<cudaStream_t>(stream));
}
