// Kernel 12: the real-to-real chirp-z of the Makhoul DCT-II/III along the
// middle axis of a (B, n, L) float32 tensor at a Bluestein length n (a
// prime factor above 128; the routes send n = 1101 ... 6782), on kernel
// 11's chirp-z column kernel (blue_radix.cuh::blue_radix_kernel). For each
// column:
//
//   u = x a, zero-padded to M;  Z = IFFT_M(FFT_M(u) H);  y[k] = Re(Z[k] b[k]),
//
// k < n, with the entry and exit tables a, b of ops/hopper/dct.py::
// _blue_rr_chirps (the chirp exp(-i pi t^2 / n), the Makhoul twiddle
// s e^{-i pi t / 2n} folded into b for DCT-II and into a for DCT-III, whose
// a[0] is halved), H = FFT_M of the wrapped inverse chirp at
// M = ops/hopper/fft.py::chirp_m(n), the 7-smooth length of least
// modelled time (4608 = 16 * 16 * 2 * 9 at n = 2049; 15 lengths from 2304
// to 14336 over the routed n). The caller owns the Makhoul permutations
// (ops/dct.py::dct23_blue_mid): x is v for DCT-II, and DCT-III's y is u,
// still to be un-permuted.
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_blue_rr
// (:1473, built by _build_call_axis_mid_blue_rr :1504, called at :1518; its
// tables _blue_rr_consts_cached :1429). Its first Hopper form ran kernel
// 11's first one (fft_blue_mid.cu) at M = 128 ceil((2n - 1) / 128): the
// bts2 core at F in {4, 8, 16} and the wide core elsewhere, a dense DFT-F
// and DFT-128 per transform with F * 128 KB of folded twiddles streamed
// from L2 a direction and a second M x C tile, one column a tile at F = 33
// (583.5 ms at (2049, 2049, 256) on an H100, 227x its byte bound).
//
// What bounds it on this card: device memory. A column is read once and
// written once, 8 n bytes (2.569 ms at (2049, 2049, 256) over 3.35 TB/s);
// the two length-M FFTs, 10 M log2 M FP32 operations a column (4.4 ms of
// the 67 TFLOP/s peak there at M = 4608), and their passes through shared
// memory come next.
//
// The design: kernel 20's odd real-input chirp-z with kernel 12's tables.
// The load is kernel 20's (x, 0) (fft_radix.cuh::RealCol<false>) times the
// kernel's entry table, here a, zeros to M; both length-M transforms run
// the sign -1 radix table of M in place (the inverse as
// conj(FFT_M(conj V)), one table for both transforms and both DCT types);
// the store (BlueReBins) writes Re(conj(.) s b[k]) = s (z.x b.x + z.y b.y)
// for the rows k < n, with s = 1 / M, a tile row at a time, masked at the
// ragged column edge: one real a column and row, where kernel 11 stores a
// complex one. Columns a tile: ops/hopper/fft.py::radix_mid_cols at M (the
// 16, 32 and 40-element forms by M C, as kernel 11). This source holds
// kernel 12 alone, so that kernels 11's and 20's instantiations cannot move.
#include "blue_radix.cuh"

namespace ndfft {

// Kernel 12's store: rows k < rows of each column, Re(conj(z) b[k]) times
// the scale, to y[(b rows + k) L + col]; the kernel's exit chirp (its
// entry table a) is not used.
struct BlueReBins {
  float* __restrict__ y;
  const float2* __restrict__ b;
  long long L;
  int rows;
  __device__ __forceinline__ long long handle(long long bb, long long col) const {
    return bb * rows * L + col;
  }
  template <class Cx>
  __device__ __forceinline__ void epilogue(float2* s, const Cx& cx, long long yb, int valid,
                                           int cshift, const float2* __restrict__, float scale)
      const {
    const int C = cx.lay.C;
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
      const int r = e >> cshift, cc = e & (C - 1);
      if (cc < valid) {
        const float2 z = s[cx_slot(e)];
        const float2 w = __ldg(b + r);
        y[yb + r * L + cc] = scale * (z.x * w.x + z.y * w.y);
      }
    }
  }
};

}  // namespace ndfft

// x, y: (B, n, L) float32, contiguous; a, b: (n,) complex64 entry and exit
// tables (ops/hopper/dct.py::_blue_rr_chirps); hh: (M,) complex64 H of the
// sign -1 chirp of n at M; table: the sign -1 radix table of M
// (ops/hopper/fft.py::radix_consts); radices: radix_plan(M), `stages` of
// them; 2n - 1 <= M; C: columns per tile, a power of two up to
// kRadixMaxCols with M C <= 20480 (16, 32 or 40 elements a thread by M C)
// and at most 256 threads (512 above M C = 4096). The scale 1 / M is the
// inverse's. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct23_blue_radix(const void* x, void* y, const void* a, const void* b,
                                      const void* hh, const void* table, const int* radices,
                                      int stages, long long B, int n, int M, long long L, int C,
                                      void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (!blue_radix_args(radices, stages, B, n, M, L, C, plan) || b == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)blue_radix_dispatch(
      RealCol<false>{static_cast<const float*>(x), L, n},
      BlueReBins{static_cast<float*>(y), static_cast<const float2*>(b), L, n},
      static_cast<const float2*>(a), static_cast<const float2*>(hh),
      static_cast<const float2*>(table), plan, B, n, M, L, C, 1.f / (float)M,
      static_cast<cudaStream_t>(stream));
}
