// Kernel 11 (and kernel 20's real-input chirp-z, below): Bluestein's chirp-z
// C2C along the middle axis of a (B, n, L)
// complex64 tensor, for a length n with a prime factor above 128, at every
// convolution length M = 128 * F, in one pass on an (M, C) column tile of
// the mixed-radix core (fft_radix.cuh). For each column:
//
//   u = x a, zero-padded to M;  Z = IFFT_M(FFT_M(u) H) (1/M and the user
//   scale in the inverse's last stage);  y[k] = Z[k] a[k],  k < n,
//
// with the chirp a and H = FFT_M of the wrapped inverse chirp built on the
// host (ops/hopper/fft.py::blue_consts; the JAX package's tables bit for
// bit) and M = blue_kernel_M(n).
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_blue (built by
// _build_call_axis_mid_blue, called by c2c_pallas_axis_mid_blue). The TPU
// kernel's length-M transforms are dense stages, cheap on a 128 x 128 MXU;
// their first Hopper forms (the bts2 core at F in {4, 8, 16}, the wide core
// at every other F) ran a dense DFT-F and a dense DFT-128 twice per column,
// 8 (128 + F) FP32 operations per element and transform, streamed
// F * 128 KB of folded twiddles per direction from L2, and the wide core
// kept a second M x C tile because it cannot work in place.
//
// What bounds it on this card: device memory. Each element is read once and
// written once (16 bytes), 0.0064 ms at (1, 1031, 1024) over 3.35 TB/s;
// the two length-M FFTs per column, about 10 M log2 M FP32 operations, come
// to 0.0037 ms of the 67 TFLOP/s peak at that shape.
//
// The design. A block holds C adjacent columns of one b as an (M, C) tile
// in shared memory, in the core's column layout (C columns of a butterfly
// on consecutive threads; a tile row of C >= 4 columns is a 32-byte
// sector; M = 512, 1024, 2048 take C = 4, 2, 2: ops/hopper/fft.py::
// blue_radix_cols). The load multiplies row
// t < n by a[t] and writes zeros from row n to M (a tile never exists in
// device memory padded), four loads in flight a thread. Both transforms run the forward radix_plan(M) in place
// with one table and one set of prime rows, a thread's butterflies held in
// registers across each stage's barrier: the inverse is
// IFFT_M(V) = conj(FFT_M(conj V)), exact in float32 (the sign +1 table and
// codelets are the sign -1 ones conjugated), so a pass over the tile after
// the first transform replaces FFT_M(u)[k] by conj(FFT_M(u)[k] H[k]), the
// second transform takes that, and the epilogue stores rows k < n as
// conj(.) times the scale and a[k], masked at the ragged column edge, a
// tile row at a time.
// One instantiation of the stages serves both transforms (on an H100 two
// inlined calls ran no slower than a loop of two). Shared memory: the
// tile, 8 M C (17 / 16) bytes, and the prime coefficient rows.
// Left for later: the zero pad's free first stage (rows t >= n are zero)
// and the inverse's trim (rows k >= n are not needed), which only save work.
//
// Kernel 20's real-input chirp-z: the same kernel, its load and store as
// template policies (as radix_cols_kernel's), for the R2C along the
// middle axis of (B, n, L) float32 where ops/hopper/rfft.py::r2c_dense_form
// names it: the even n and the odd n >= 449 among the 326 lengths 4 <= n
// <= 1100 whose transform length has a prime factor above 127 (262 ...
// 1099), and the 9 with a plan whose one prime stage p >= 97 is slower
// (n = 2p, 5 * 127, 7 * 127). It replaces
// ndrustfft_tpu/ops/pallas/rfft.py::_r2c_dense_kernel (:882, called at
// :932) there, whose first Hopper form was one real product
// (rfft_dense.cu): 2 n (n / 2 + 1) multiply-adds a column where the
// function needs about 2.5 n log2 n (0.80 ms at (1, 1094, 7668), 40x its
// byte bound and 4.2x torch.fft.rfft on an H100). Even n = 2h: the chirp
// length is h; the load is the column's pairs z[t] = x[2t] + i x[2t + 1]
// (fft_radix.cuh::RealCol<true>, kernel 16's) times a[t], zeros to M; both
// transforms and the product with H as above; then a pass over rows k < h
// makes Z[k] = conj(s) a[k] / M in place and, after its barrier, kernel
// 16's unpack (r2c_unpack_tile) writes the h + 1 bins from the tile. Odd n:
// the chirp length is n, the load (x, 0) times a (RealCol<false>), and the
// store kernel 11's, bins k <= (n - 1) / 2 only. The convolution length M
// (ops/hopper/fft.py::chirp_m) is the integer in [2 len - 1, 2 (2 len - 1)]
// whose prime factors are 2, 3, 5 and 7, so that every stage is a register
// codelet and no prime stage runs, of least modelled time M * sum of a
// fitted cost a point of each stage's radix (a radix-16 stage costs half
// of any other): 131 -> 288 = 16 * 2 * 9, 1097 -> 2304 = 16 * 16 * 9. The
// least such M (270 = 2 * 9 * 3 * 5, 2205) ran 1.6x slower summed over the
// lengths, and kernel 11's 128 * F was the TPU's lane width. What bounds
// it: device memory, 4 n bytes in and 8 (n / 2 + 1) out a column (0.0412 ms
// at (1, 262, 65536) over 3.35 TB/s); the two length-M FFTs, 10 M log2 M
// operations a column (0.023 ms of the FP32 peak there), come next, four
// to five times the function's own, and each stage's pass through shared
// memory (about 6 ps a point for a radix-16 stage, 8-12 for the others,
// over all SMs). So the chirp-z beats the dense product by 2-3x at the
// long lengths (0.28 against 0.80 ms at (1, 1094, 7668)) and ties it at
// n = 262 (0.49-0.59 against 0.52-0.58 at (1, 262, 65536)); odd n below
// 449, whose chirp length is n, keep the product. The tables (chirp, H)
// are built on the host in float64 and rounded once (plan.py::chirp,
// blue_h). Shared memory: 8 M C (17 / 16) bytes, 20 KB at M = 2304 and
// C = 1 (ops/hopper/fft.py::radix_mid_cols's count there).
//
// The kernel itself (blue_radix_kernel) is in blue_radix.cuh; kernel 21's
// chirp-z C2R and kernel 15's rows run it from rfft_blue_radix.cu.
#include "blue_radix.cuh"

namespace ndfft {

// Kernel 11's columns: element r of column col of b of the (B, n, L)
// complex64 x.
struct CplxBlueCol {
  const float2* __restrict__ x;
  long long L;
  int n;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float2 at(long long p, int r) const { return __ldcs(x + p + r * L); }
};

// The store of rows k < rows of each column, conj(s) times the scale and
// the exit chirp a[k], to y[(b rows + k) L + col], a tile row at a time:
// kernel 11's (rows = n) and the odd R2C's bins (rows = (n + 1) / 2).
struct BlueBins {
  float2* __restrict__ y;
  long long L;
  int rows;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * rows * L + col;
  }
  template <class Cx>
  __device__ __forceinline__ void epilogue(float2* s, const Cx& cx, long long yb, int valid,
                                           int cshift, const float2* __restrict__ a,
                                           float scale) const {
    const int C = cx.lay.C;
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
      const int r = e >> cshift, cc = e & (C - 1);
      if (cc < valid) {
        const float2 z = s[cx_slot(e)];
        y[yb + r * L + cc] = cmul(make_float2(scale * z.x, -(scale * z.y)), __ldg(a + r));
      }
    }
  }
};

// The even R2C's epilogue at chirp length h = n / 2: rows k < h of the tile
// become Z[k] = conj(s) times the scale and a[k] in place, and after the
// barrier each column's threads unpack its h + 1 bins from the tile
// (fft_radix.cuh::r2c_unpack_tile, kernel 16's) to y[(b (h + 1) + k) L +
// col]; u[k] = W_n^k.
struct BlueR2cUnpack {
  float2* __restrict__ y;
  const float2* __restrict__ u;
  long long L;
  int h;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * (h + 1) * L + col;
  }
  template <class Cx>
  __device__ __forceinline__ void epilogue(float2* s, const Cx& cx, long long, int, int cshift,
                                           const float2* __restrict__ a, float scale) const {
    const int C = cx.lay.C;
    for (int e = threadIdx.x; e < h * C; e += blockDim.x) {
      const float2 z = s[cx_slot(e)];
      s[cx_slot(e)] = cmul(make_float2(scale * z.x, -(scale * z.y)), __ldg(a + (e >> cshift)));
    }
    __syncthreads();
    Cx ch = cx;
    ch.n = h;
    float2* yc = y + cx.row;
    const long long ls = L;
    r2c_unpack_tile(s, ch, u, [=](int k, float2 v) { yc[k * ls] = v; });
  }
};

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; a: (n,) complex64 chirp
// exp(sign i pi t^2 / n) (entry and exit); h: (M,) complex64 H; table: the
// sign -1 radix table of M (ops/hopper/fft.py::radix_consts), which serves
// both transforms; radices: radix_plan(M), `stages` of them;
// 2n - 1 <= M <= 20480; C: columns per tile, a power of two up to
// kRadixMaxCols with M C <= 20480 (16, 32 or 40 elements a thread by M C:
// fft_radix.cuh::radix_per_thread) and at most 256 threads (512 above
// M C = 4096); scale: the user scale over M. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_blue_radix(const void* x, void* y, const void* a, const void* h,
                                    const void* table, const int* radices, int stages,
                                    long long B, int n, int M, long long L, int C, float scale,
                                    void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (!blue_radix_args(radices, stages, B, n, M, L, C, plan)) return (int)cudaErrorInvalidValue;
  return (int)blue_radix_dispatch(
      CplxBlueCol{static_cast<const float2*>(x), L, n}, BlueBins{static_cast<float2*>(y), L, n},
      static_cast<const float2*>(a), static_cast<const float2*>(h),
      static_cast<const float2*>(table), plan, B, n, M, L, C, scale,
      static_cast<cudaStream_t>(stream));
}

// Kernel 20's chirp-z. x: (B, n, L) float32; y: (B, n / 2 + 1, L)
// complex64; both contiguous. The chirp length is h = n / 2 at even n (the
// column read as its pairs x[2t] + i x[2t + 1]; u: (h,) complex64 W_n^k for
// the unpack) and n at odd n ((x, 0); u unused); a: the chirp length's
// (len,) complex64 chirp exp(-i pi t^2 / len); hh: (M,) complex64 H of the
// chirp length at M; table: the sign -1 radix table of M; radices:
// radix_plan(M), `stages` of them; 2 len - 1 <= M; C as for
// ndfft_c2c_blue_radix. The scale 1 / M is the inverse's. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_blue_radix(const void* x, void* y, const void* a, const void* hh,
                                    const void* u, const void* table, const int* radices,
                                    int stages, long long B, int n, int M, long long L, int C,
                                    void* stream) {
  using namespace ndfft;
  const bool even = n % 2 == 0;
  const int len = even ? n / 2 : n;
  RadixPlan plan{};
  if (n < 2 || !blue_radix_args(radices, stages, B, len, M, L, C, plan) || (even && u == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float2*>(y);
  const auto ap = static_cast<const float2*>(a);
  const auto hp = static_cast<const float2*>(hh);
  const auto tp = static_cast<const float2*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  const float scale = 1.f / (float)M;
  if (even)
    return (int)blue_radix_dispatch(RealCol<true>{xp, L, n},
                                    BlueR2cUnpack{yp, static_cast<const float2*>(u), L, len}, ap,
                                    hp, tp, plan, B, len, M, L, C, scale, st);
  return (int)blue_radix_dispatch(RealCol<false>{xp, L, n}, BlueBins{yp, L, n / 2 + 1}, ap, hp,
                                  tp, plan, B, len, M, L, C, scale, st);
}
