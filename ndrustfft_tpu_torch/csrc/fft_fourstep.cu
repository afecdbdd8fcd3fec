// Kernels 7 and 13: the two passes of the four-step long C2C
// (ops/engine.py::_fourstep), n = n1 * n2 with t = t1 n2 + t2 and
// k = k1 + n1 k2:
//
//   step 1+2 (kernel 7):   Z[b, k1, t2] = W_n^{k1 t2} sum_t1 W_n1^{t1 k1} x[b, t1, t2]
//   step 3+4 (kernel 13):  X[b, k2, k1] = s sum_t2 W_n2^{t2 k2} Z[b, k1, t2]
//
// Kernel 7 replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_exit_mul (the
// exit multiply that _add_exit_tw, fft.py:1635, wraps around the middle-axis
// body, pallas_call at :1754) on the bts2 core: kernel 1's code on the
// (B, n1, n2) view, n1 = 128 * F, with the twiddle W_n^{k1 t2} applied to
// each output in the store. The fixed core (F in {4, 8, 16}) runs in place
// on the shared tile, so its store loop multiplies s[k1][c] by tw[k1][col]
// before it writes; the wide core (every other F <= 32) takes the twiddle in
// its store callback, as kernel 24's interleave does. Kernel 7's dense body
// (n1 <= 256) is kernel 4 with a twiddle in its epilogue (fft_dense.cu).
// The table tw (n1, n2) is built on the host per (n, sign), each part
// rounded once to float32 as _add_exit_tw builds it
// (ops/hopper/fft.py::fourstep_tw); a block reads the columns of its tile.
//
// Kernel 13 replaces fft.py::_kernel_lane_store_t (pallas_call at :1895): a
// row FFT of length n2 = 128 * F on the bts2 row tile, the user scale folded
// into Wq, its output stored transposed, so that the four-step's
// (k1, k2) -> (k2, k1) transpose costs no pass of its own. Row r = b n1 + k1
// of the (B n1, n2) rows and bin k2 go to y[(b n2 + k2) n1 + k1]; b and k1
// are computed for each row (a block's rows may cross a batch boundary).
//
// Both are the bts2 column and row tiles of c2c_tile.cuh (kernel 1's, and
// the row tile that kernel 10 ran before it moved onto the radix core) with
// the stores below.
//
// What bounds them on this card: each is its core's stage 2, the dense
// DFT-128 (4 * 128 real FMAs per complex output) on the FP32 CUDA cores, as
// for kernel 1: at n = 2^20 over 256 rows, 275 GFLOP per pass,
// >= 4.1 ms at 67 TFLOP/s, against 4.3 GB of HBM traffic (1.28 ms at
// 3.35 TB/s). Kernel 7 adds one 8-byte table read per output, which stays
// in the 50 MB L2 (8 MB at 2^20); kernel 13's store is scattered. The
// design reads and writes device memory once per pass: the fixed kernel 13
// orders its store loop so that neighbouring threads take neighbouring rows
// of one bin k2 (R contiguous values per output row); the wide core stores
// each output where its callback puts it (C contiguous values per thread).
// The fixed loop's shared-memory reads s[i * n2 + k2] then fall in one bank
// for all R rows (an R-way conflict). Staging the transposed tile with a
// padded row stride for whole-row stores, and 3xTF32 wgmma, are later work.
#include "c2c_tile.cuh"

namespace ndfft {

// Kernel 7's store: kernel 1's times the exit twiddle tw (n1, n2), read at
// the output's own (k1, t2).
struct TwStore {
  float2* __restrict__ y;
  const float2* __restrict__ tw;
  int n;
  long long L;
  __device__ void store(long long b, long long k, long long col, float2 v) const {
    y[(b * n + k) * L + col] = cmul(v, __ldg(tw + k * L + col));
  }
};

// Kernel 13's store: row r = b n1 + k1, bin k2 to y[(b n2 + k2) n1 + k1].
struct TransposedStore {
  float2* __restrict__ y;
  int n, n1;
  __device__ void store(long long r, long long k, float2 v) const {
    const long long b = r / n1;
    y[(b * n + k) * n1 + (r - b * n1)] = v;
  }
};

}  // namespace ndfft

// Kernel 7 on the fixed core, n1 = 128 * F with F in {4, 8, 16}. x, y:
// (B, n1, n2) complex64, contiguous; wq: (F, 128, 128) complex64 (kernel 1's
// constants, unscaled); tw: (n1, n2) complex64 W_{n1 n2}^{k1 t2}. C: columns
// per block, a power of two with n1 * C <= 8192. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ndfft_fourstep_mid(const void* x, void* y, const void* wq, const void* tw,
                                  long long B, int n1, long long n2, int C, int sign,
                                  void* stream) {
  using namespace ndfft;
  const TwStore io{static_cast<float2*>(y), static_cast<const float2*>(tw), n1, n2};
  return (int)axis_mid_launch(static_cast<const float2*>(x), io, static_cast<const float2*>(wq),
                              B, n1, n2, C, sign, static_cast<cudaStream_t>(stream));
}

// Kernel 7 on the wide core, n1 = 128 * F with 1 <= F <= 160. As above, with
// wf: (F, F) complex64 DFT-F of the transform's sign
// (ops/hopper/fft.py::wide_consts). C: columns per tile, a power of two
// <= 16 whose tile fits (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_fourstep_mid_wide(const void* x, void* y, const void* wq, const void* wf,
                                       const void* tw, long long B, int n1, long long n2,
                                       int C, void* stream) {
  using namespace ndfft;
  const TwStore io{static_cast<float2*>(y), static_cast<const float2*>(tw), n1, n2};
  return (int)axis_mid_wide_launch(static_cast<const float2*>(x), io,
                                   static_cast<const float2*>(wq), static_cast<const float2*>(wf),
                                   B, n1, n2, C, static_cast<cudaStream_t>(stream));
}

// Kernel 13 on the fixed core, n2 = 128 * F with F in {4, 8, 16}. x: (T, n2)
// complex64 rows, T = B * n1, contiguous; y: (B, n2, n1) complex64; wq:
// (F, 128, 128) complex64 (kernel 1's constants for n2, sign and the
// scale). R: rows per block, a power of two with n2 * R <= 8192. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_rows_store_t(const void* x, void* y, const void* wq, long long T, int n1,
                                  int n2, int R, int sign, void* stream) {
  using namespace ndfft;
  if (n1 < 1 || T % n1) return (int)cudaErrorInvalidValue;
  return (int)rows_launch(static_cast<const float2*>(x),
                          TransposedStore{static_cast<float2*>(y), n2, n1},
                          static_cast<const float2*>(wq), T, n2, R, sign,
                          static_cast<cudaStream_t>(stream));
}

// Kernel 13 on the wide core, n2 = 128 * F with 1 <= F <= 160. As above,
// with wf: (F, F) complex64 DFT-F of the transform's sign. C: rows per tile,
// a power of two <= 16 whose tile fits (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_rows_store_t_wide(const void* x, void* y, const void* wq, const void* wf,
                                       long long T, int n1, int n2, int C, void* stream) {
  using namespace ndfft;
  if (n1 < 1 || T % n1) return (int)cudaErrorInvalidValue;
  return (int)rows_wide_launch(static_cast<const float2*>(x),
                               TransposedStore{static_cast<float2*>(y), n2, n1},
                               static_cast<const float2*>(wq), static_cast<const float2*>(wf), T,
                               n2, C, static_cast<cudaStream_t>(stream));
}
