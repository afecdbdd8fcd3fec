// Kernel 21's chirp-z C2R and kernel 15's rows on the chirp-z: the
// real-input forms of kernel 11's Bluestein kernel (blue_radix.cuh's
// blue_radix_kernel on the mixed-radix core's column tile, the convolution
// length M = ops/hopper/fft.py::chirp_m(len), 7-smooth, every stage a
// register codelet), beside kernel 20's R2C in fft_blue_radix.cu.
//
// Kernel 21: the C2R along the middle axis of a (B, n / 2 + 1, L)
// complex64 half spectrum to (B, n, L) float32, times a scale, where
// ops/hopper/rfft.py::c2r_dense_form names it (the even n and the odd
// n >= 449 without a plan, 262 ... 1100, and the 9 lengths with a plan
// where rfft.py::chirp_beats_radix holds: 194 = 2 * 97 ..., 5 * 127,
// 7 * 127). It replaces ndrustfft_tpu/ops/pallas/rfft.py::
// _c2r_dense_kernel (:898, called at :967) there, whose first Hopper form
// was one real product of 4 n (n / 2 + 1) FP32 operations a column
// (rfft_dense.cu: 0.559 ms at (1, 132, 65536), n = 262, 1.9x
// torch.fft.irfft; 0.80 at (1, 548, 7668), n = 1094). The C2R is the
// forward chirp-z backwards, IFFT_len(V) = conj(FFT_len(conj V)) exact in
// float32, so it runs kernel 20's tables (the chirp a, H, the sign -1
// radix table of M): a load policy with a prologue loads the column as it
// is and, behind the load's barrier, writes conj(V[k]) a[k] into the tile;
// the two transforms and the product with H are kernel 11's; the store
// takes z[l] = conj(a[l]) W[l] / M from the tile. Even n = 2h (chirp
// length h): V is kernel 17's inverse unpack (rfft_mid_radix.cu's C2rCol
// load, bin h in a side slot; fft_radix.cuh::c2r_prologue_tile, one thread
// a mirror pair, the user scale in its ab rows), and z[l] gives real rows
// 2l and 2l + 1. Odd n (chirp length n): V is the Hermitian extension
// (kernel 21's HermCol load; the prologue writes rows k and n - k from row
// k), and the store keeps scale Re z[l]. The DC and Nyquist imaginary
// parts are ignored.
//
// Kernel 15's rows at h = 1, 31 and the primes 131 ... 251 (no plan but at
// 31, where the radix row core lost): the R2C of (T, 2h) float32 rows to
// (T, h + 1) complex64 as kernel 20's even form on a tile whose C columns
// are C consecutive rows. It replaces rfft.py::_r2c_kernel (:163, called at
// :211) there, whose Hopper form was the same real product in the row
// layout (0.218 ms at (16384, 262), 3.4x torch.fft.rfft). The skeleton adds
// the tile's column index to the first column's handle, so the row
// policies take the row index as the handle and scale it themselves (a
// row's pairs at x + row h, its bins at y + row (h + 1)): kernel 11's and
// kernel 20's policies, and their code, stay as they were. Rows a tile:
// rfft.py::packed_blue_rows, the fewest whose threads fill whole warps (one
// row is one contiguous run, so fewer rows read fewer sectors a warp).
//
// What bounds both on this card: device memory, 8 (n / 2 + 1) bytes in and
// 4 n out a column (0.0412 ms at (1, 132, 65536)), 4 n + 8 (h + 1) a row
// (0.0104 ms at (16384, 262)); then the two length-M FFTs (10 M log2 M
// operations a transform) and each stage's pass through shared memory, as
// for kernel 20. Only the 16-element form (M C <= 4096) is built: in the
// scan on an H100 no larger tile ran fastest at any length the routes send
// (time_kernels.py --route-dense).
#include "blue_radix.cuh"

namespace ndfft {

// Kernel 15's rows at a prime half length h: the tile's columns are
// consecutive rows of the (T, 2h) float32 input (B = 1), a column's handle
// its row index (the skeleton adds the tile's column index to the first
// row's); element t of row `row` is its pair x[2t] + i x[2t + 1], the
// float2 at row h + t (a warp's load at C = 8 reads 4 consecutive pairs of
// 8 rows), and its h + 1 bins go to y[row (h + 1) + k] through kernel 20's
// even unpack (BlueR2cUnpack's, here a row apart).
struct RealRows {
  const float2* __restrict__ x;
  int h;
  __device__ __forceinline__ long long base(long long, long long row) const { return row; }
  __device__ __forceinline__ float2 at(long long row, int t) const {
    return __ldcs(x + row * h + t);
  }
};
struct BlueR2cUnpackRows {
  float2* __restrict__ y;
  const float2* __restrict__ u;
  int h;
  __device__ __forceinline__ long long handle(long long, long long row) const { return row; }
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
    float2* yr = y + cx.row * (h + 1);
    r2c_unpack_tile(s, ch, u, [=](int k, float2 v) { yr[k] = v; });
  }
};

// Kernel 21's chirp-z, the C2R by IFFT_len(V) = conj(FFT_len(conj V)) on
// the forward chirp-z's tables. Even n = 2h (chirp length h): kernel 17's
// load (rows k < h of the (B, h + 1, L) spectrum into the tile, row h into
// the column's side slot), and a prologue that keeps conj(G[k]) a[k] at row
// k, G kernel 17's inverse unpack (fft_radix.cuh::c2r_prologue_tile, the
// user scale in its ab rows).
struct BlueC2rCol {
  static constexpr int kSide = 1;
  const float2* __restrict__ x;
  const float4* __restrict__ ab;
  long long L;
  int h;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * (h + 1) * L + col;
  }
  __device__ __forceinline__ float2 at(long long p, int r) const { return __ldcs(x + p + r * L); }
  template <class Cx>
  __device__ __forceinline__ void prologue(float2* s, const float2* side, const Cx& cx,
                                           const float2* __restrict__ a) const {
    c2r_prologue_tile(
        s, side, cx, ab,
        [=](int k, float2 g) { return cmul(make_float2(g.x, -g.y), __ldg(a + k)); }, h);
  }
};

// Odd n (chirp length n): kernel 21's odd load (rows r < m = (n + 1) / 2 of
// the (B, m, L) half spectrum, the DC's imaginary part set to 0, zeros
// above), and a prologue that writes the conjugated Hermitian extension
// times the entry chirp: conj(S[k]) a[k] at row k, S[k] a[n - k] at n - k.
struct BlueHermCol {
  static constexpr bool kPrologue = true;
  const float2* __restrict__ x;
  long long L;
  int n, m;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * m * L + col;
  }
  __device__ __forceinline__ float2 at(long long p, int r) const {
    if (r >= m) return make_float2(0.f, 0.f);
    float2 v = __ldcs(x + p + r * L);
    if (r == 0) v.y = 0.f;
    return v;
  }
  template <class Cx>
  __device__ __forceinline__ void prologue(float2* s, const float2*, const Cx& cx,
                                           const float2* __restrict__ a) const {
    if (!cx.active) return;
    for (int k = cx.t; k < m; k += cx.tr) {
      const float2 v = s[cx.slot(k)];
      s[cx.slot(k)] = cmul(make_float2(v.x, -v.y), __ldg(a + k));
      if (k) s[cx.slot(n - k)] = cmul(v, __ldg(a + n - k));
    }
  }
};

// Their stores: the tile holds W = FFT_M(conj(FFT_M(u) H)), and the
// column's inverse is z[l] = conj(a[l]) W[l] times the scale; a tile row at
// a time, masked at the ragged column edge. Even n: Re z[l] and Im z[l] to
// real rows 2l and 2l + 1 of y[b] (B, 2h, L), l < h (scale 1 / M).
struct BlueC2rPairs {
  float* __restrict__ y;
  long long L;
  int h;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * 2 * h * L + col;
  }
  template <class Cx>
  __device__ __forceinline__ void epilogue(float2* s, const Cx& cx, long long yb, int valid,
                                           int cshift, const float2* __restrict__ a,
                                           float scale) const {
    const int C = cx.lay.C;
    for (int e = threadIdx.x; e < h * C; e += blockDim.x) {
      const int r = e >> cshift, cc = e & (C - 1);
      if (cc < valid) {
        const float2 w = __ldg(a + r);
        const float2 z = cmul(s[cx_slot(e)], make_float2(scale * w.x, -(scale * w.y)));
        y[yb + 2 * r * L + cc] = z.x;
        y[yb + (2 * r + 1) * L + cc] = z.y;
      }
    }
  }
};

// Odd n: Re z[l] to real row l of y[b] (B, n, L) (scale: the user's over M).
struct BlueC2rOddRows {
  float* __restrict__ y;
  long long L;
  int n;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * n * L + col;
  }
  template <class Cx>
  __device__ __forceinline__ void epilogue(float2* s, const Cx& cx, long long yb, int valid,
                                           int cshift, const float2* __restrict__ a,
                                           float scale) const {
    const int C = cx.lay.C;
    for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
      const int r = e >> cshift, cc = e & (C - 1);
      if (cc < valid) {
        const float2 z = s[cx_slot(e)], w = __ldg(a + r);
        y[yb + r * L + cc] = scale * (z.x * w.x + z.y * w.y);
      }
    }
  }
};

}  // namespace ndfft

// Kernel 21's chirp-z. spec: (B, n / 2 + 1, L) complex64; out: (B, n, L)
// float32; both contiguous. The chirp length is h = n / 2 at even n (ab:
// kernel 17's (h, 4) float32 rows with the user scale folded in,
// ops/hopper/rfft.py::c2r_unpack_consts) and n at odd n (ab unused; the
// user scale multiplies every output); a, hh, table, radices, M and C as
// for ndfft_r2c_blue_radix (the forward chirp-z's tables at that chirp
// length). The DC and (even n) Nyquist imaginary parts are ignored.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2r_blue_radix(const void* spec, void* out, const void* a, const void* hh,
                                    const void* ab, const void* table, const int* radices,
                                    int stages, float scale, long long B, int n, int M,
                                    long long L, int C, void* stream) {
  using namespace ndfft;
  const bool even = n % 2 == 0;
  const int len = even ? n / 2 : n;
  RadixPlan plan{};
  if (n < 2 || !blue_radix_args(radices, stages, B, len, M, L, C, plan) || (even && ab == nullptr) ||
      radix_per_thread(M * C) != 16)
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float2*>(spec);
  const auto yp = static_cast<float*>(out);
  const auto ap = static_cast<const float2*>(a);
  const auto hp = static_cast<const float2*>(hh);
  const auto tp = static_cast<const float2*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  if (even)
    return (int)blue_radix_launch<16>(BlueC2rCol{xp, static_cast<const float4*>(ab), L, len},
                                      BlueC2rPairs{yp, L, len}, ap, hp, tp, plan, B, len, M, L,
                                      C, 1.f / (float)M, st);
  return (int)blue_radix_launch<16>(BlueHermCol{xp, L, n, (n + 1) / 2},
                                    BlueC2rOddRows{yp, L, n}, ap, hp, tp, plan, B, len, M, L, C,
                                    scale / (float)M, st);
}

// Kernel 15's rows at a half length h without a plan. x: (T, 2h) float32;
// y: (T, h + 1) complex64; both contiguous, x 8-byte aligned. The chirp
// length is h: a, hh, u (W_2h^k), table, radices and M as for
// ndfft_r2c_blue_radix at even n = 2h; C: rows a tile, as its columns.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_blue_rows(const void* x, void* y, const void* a, const void* hh,
                                   const void* u, const void* table, const int* radices,
                                   int stages, long long T, int h, int M, int C, void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (!blue_radix_args(radices, stages, 1, h, M, T, C, plan) || u == nullptr ||
      radix_per_thread(M * C) != 16)
    return (int)cudaErrorInvalidValue;
  return (int)blue_radix_launch<16>(
      RealRows{static_cast<const float2*>(x), h},
      BlueR2cUnpackRows{static_cast<float2*>(y), static_cast<const float2*>(u), h},
      static_cast<const float2*>(a), static_cast<const float2*>(hh),
      static_cast<const float2*>(table), plan, 1, h, M, T, C, 1.f / (float)M,
      static_cast<cudaStream_t>(stream));
}
