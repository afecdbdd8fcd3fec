// Kernels 16, 18 and 20: the R2C along the middle axis, and kernel 17, the
// C2R, on the mixed-radix core's column tile (fft_radix.cuh::
// radix_cols_kernel, kernels 1, 6 and 4's skeleton). Kernels 16 and 20 take a (B, n, L) float32 tensor to
// (B, n / 2 + 1, L) complex64: kernel 16 n = 2h, h = 128 * F (F = 2 ...
// 160); kernel 20 every 4 <= n <= 1100 whose transform length (h for even
// n, n for odd n) has a plan (ops/hopper/fft.py::radix_plan; its 326 other
// lengths keep the dense product of rfft_dense.cu). Kernel 18 takes two
// (B, h, L) float32 streams xe, xo, h = 128 * F (F = 2 ... 160 with a plan),
// to scale * the R2C of length 2h of the column whose even samples are xe
// and whose odd samples are xo, (B, h + 1, L) complex64: DST-I along a
// middle axis is its caller, the streams the even and odd samples of the
// odd extension [0, x, 0, -flip(x)] (ops/dst.py::dst1_streams).
//
// Kernel 17 takes a (B, h + 1, L) complex64 half spectrum to (B, 2h, L)
// float32, times a scale, h = 128 * F (F = 2 ... 160 with a plan), with the
// DC and Nyquist imaginary parts ignored; kernel 21 the same at every
// 4 <= n <= 1100 whose transform length has a plan (768 lengths), but for
// the 61 odd n where ops/hopper/fft.py::dense_beats_radix holds (with its
// 326 lengths without a plan, they keep the dense product of
// rfft_dense.cu): kernel 17's kernel at even n = 2h, and at odd n the
// (B, (n + 1) / 2, L) half spectrum to (B, n, L), the DC's imaginary part
// ignored.
//
// Kernel 16 replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_kernel_mid
// (:443, built by _build_r2c_mid and called at :532); kernel 18 replaces
// ::_r2c_kernel_packed_mid (:627, called at :682 by r2c_pallas_packed_mid);
// kernel 20 replaces ::_r2c_dense_kernel (:882, called at :932); kernel 17
// replaces ::_c2r_kernel_mid (:470, called at :587); kernel 21 replaces
// ::_c2r_dense_kernel (:898, called at :967). The TPU
// kernels ran the half-length FFT as the bts2 core's dense DFT-128 stage
// (kernels 16, 17 and 18) and the whole R2C as one real product (kernel 20),
// cheap on a 128 x 128 MXU. Their first Hopper forms ran the same on the
// FP32 cores: kernels 16 and 18 on the bts2 column R2C, bound by its
// stage-2 DFT-128 (kernel 16 at 7.6x its byte bound at (1, 512, 262144),
// kernel 18 at 10.3x at (1023, 1024, 1023) and 33x on the wide core at
// (1, 1536, 1535)), kernel 20 as one real SGEMM of 2 n (n + 2) operations
// per column where an FFT needs 2.5 n log2 n (132 k against 5.1 k at
// n = 256), with two output rows always zero.
//
// What bounds it on this card: device memory. A column is read once (4 n
// bytes) and its n / 2 + 1 bins written once (8 (n / 2 + 1) bytes): 0.321 ms
// at (1, 512, 262144), 0.0403 ms at (1, 256, 65536), and for kernel 18's two
// streams 5.121 ms at (1023, 1024, 1023) and 0.0113 ms at (1, 1536, 1535)
// over 3.35 TB/s, against 2.5 n log2 n FP32 operations per column (0.045,
// 0.0050, 0.88 and 0.0020 ms of the 67 TFLOP/s peak).
//
// The design. Even n: the column read as its complex pairs
// z[t] = x[2t] + i x[2t + 1] (two real row loads per element, consecutive
// threads on consecutive columns; kernel 18: xe[t] + i xo[t], one row load
// from each stream), one radix_run of radix_plan(h) in place
// whose last stage writes Z back into the tile in natural order (kTileOut),
// and after its barrier the unpack as the epilogue, each bin's mirror
// Z[(h - k) mod h] of the same column a shared-memory read
// (fft_radix.cuh::r2c_unpack_tile, kernels 2 and 15's on rows):
//
//   X[k] = (Z[k] + C[k]) / 2 - i W_n^k (Z[k] - C[k]) / 2,  k < h,
//   X[h] = Re Z[0] - Im Z[0],  C[k] = conj Z[(h - k) mod h],
//
// each X[k] (kernel 18: scale * X[k]) stored once to out[b, k, col0 + c],
// consecutive threads on consecutive columns; W_n^k comes from the host
// (ops/hopper/rfft.py::_device_tw), so the device runs no sincosf. Kernel
// 18's scale multiplies in that store, not in the load or the table: the
// table is kernel 16's, pinned bit for bit to the JAX package's, the store
// touches h + 1 values a column where the load touches 2h, and the product
// is then the plain version's spec * scale, rounded once. Odd n: the
// length-n C2C of (x, 0) on the same tile, left there in natural order, and
// an epilogue that stores the bins k <= n / 2, a tile row at a time.
// (Storing them from the last stage with a bin bound, as kernels 6 and 4
// store all n, made ptxas spill 1300 bytes a thread at 16 elements against
// 52 through the tile; the bound alone took kernels 6 and 4 from 396 to
// 1300.) Columns a tile: ops/hopper/rfft.py::r2c_mid_cols (kernel 4's rule
// at the transform length, up to 32 columns and a tile row of at least one
// 128-byte line where the columns allow); kernel 18's tile row is a C
// 4-byte run of each stream, and from h = 1024 on it takes up to 16 columns
// (a 64-byte run) in the 32- or 40-element form (rfft.py::packed_mid_cols:
// at the Dirichlet solve's (1, 1024, 1046529) 4 columns, the 16-element
// rule's, took 31% longer on an H100). Shared memory: the tile, 8 h C
// (17 / 16) bytes (8 n C at odd n), and the prime rows.
//
// Kernel 17 is kernel 16 backwards, its first Hopper form the bts2 column
// tile (2.191 ms at (1, 257, 262144), 6.8x its byte bound, and 3.1x
// torch.fft.irfft on the wide core at (1, 641, 1280)), whose pre-pass read
// rows k and h - k of the spectrum from device memory for each element.
// Here the load (C2rCol) reads rows k < h of the column into the tile and
// row h into the column's side slot, each row once, consecutive threads on
// consecutive columns; after the barrier the prologue
// (fft_radix.cuh::c2r_prologue_tile, kernel 3's) replaces the bins in place
// with G[k] = A[k] S[k] + B[k] conj S[h - k] (the DC and Nyquist imaginary
// parts ignored; the scale rides A and B), one thread a mirror pair; behind
// a second barrier radix_run runs radix_plan(h) with the sign +1 table and
// leaves z in the tile, and an epilogue writes Re z[l] to real row 2l and
// Im z[l] to row 2l + 1 of out[b, :, col0 + c], a tile row at a time
// (C2rColBins). (Storing from the last stage made ptxas spill 4512, 9140
// and 13444 bytes a thread at 16, 32 and 40 elements against 40, 56 and
// 1640 through the tile, and ran 1.09-2.18x slower at every shape and C
// scanned on an H100: time_kernels.py --scan-c2r.) Columns a tile:
// ops/hopper/rfft.py::c2r_mid_cols (kernel 18's rule, the fastest count at
// each of nine shapes scanned).
//
// Kernel 21 is kernel 20 backwards. Its first Hopper form was one real
// product of 4 n (n / 2 + 1) FP32 operations per column (dense_real.cuh;
// 0.411 ms at (1, 129, 65536), n = 256, 10x its byte bound of 0.0403 ms and
// 1.7x torch.fft.irfft). At even n it is kernel 17's kernel at h = n / 2,
// any h with a plan (the prologue's mirror pairs {k, h - k} cover odd h).
// At odd n the load (HermCol) places bins 0 ... (n - 1) / 2 of the column
// with the DC's imaginary part zeroed and, behind the load's barrier, a
// prologue copies each tile row k to row n - k conjugated, so the spectrum
// is read once. (A second read of each mirrored row in the load instead
// gave the same registers and spills and ran as fast at n = 129 and 2.5%
// slower at n = 255 on an H100, (1, 65, 65536) and (1, 128, 32768).) The
// length-n radix_run with the sign +1 table leaves z in the tile, and an
// epilogue writes scale * Re z[l] to real row l (C2rOddRows), a tile row at
// a time. Columns a tile: rfft.py::c2r_dense_cols (kernel 17's count at
// even n, r2c_mid_cols at odd n). The odd form does the whole length-n
// C2C, about p operations an element on a prime stage p, where the dense
// product does about n: at n = 3 p or n < 128 with p >= 11 the product is
// faster (129 = 3 * 43: 0.233 against 0.207 ms; 387 = 9 * 43: 0.54x of
// it; time_kernels.py --route-dense on an H100), and the wrapper keeps it
// there.
// Left for later: cp.async or TMA loads, the odd length's Hermitian half of
// the work (half the C2C's outputs are dropped), and for kernel 18 reading
// x itself in the load instead of the two streams its caller builds (two
// more passes over the field).
#include "fft_radix.cuh"

namespace ndfft {

// Kernel 18's columns: element t of column col of b as (xe[t], xo[t]) from
// the two (B, h, L) streams.
struct PackedCol {
  const float* __restrict__ xe;
  const float* __restrict__ xo;
  long long L;
  int h;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * h * L + col;
  }
  __device__ __forceinline__ float2 at(long long p, int t) const {
    const long long i = p + t * L;
    return make_float2(__ldcs(xe + i), __ldcs(xo + i));
  }
};

// Even n's epilogue: the tile holds Z (the last stage's outputs kept as
// they are), and each column's threads write its h + 1 bins times scale
// (1 for kernels 16 and 20) to y[(b (h + 1) + k) L + col]; u[k] = W_n^k.
struct R2cColUnpack {
  static constexpr bool kTileOut = true;
  float2* __restrict__ y;
  const float2* __restrict__ u;
  long long L;
  int h;
  float scale;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * (h + 1) * L + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    float2* yc = y + cx.row;
    const long long ls = L;
    const float sc = scale;
    r2c_unpack_tile(s, cx, u,
                    [=](int k, float2 v) { yc[k * ls] = make_float2(sc * v.x, sc * v.y); });
  }
};

// Odd n's epilogue: the tile holds the C2C of (x, 0), and each column's
// threads store its bins k < rows = n / 2 + 1 to y[(b rows + k) L + col].
struct R2cOddBins {
  static constexpr bool kTileOut = true;
  float2* __restrict__ y;
  long long L;
  int rows;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * rows * L + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    for (int k = cx.t; k < rows; k += cx.tr) y[cx.row + k * L] = s[cx.slot(k)];
  }
};

// Kernel 17's columns: element k of column col of b at spec[(b (h + 1) + k)
// L + col], rows k < h into the tile, row h into the side slot (at(p, h));
// the prologue is the inverse unpack with the ab rows.
struct C2rCol {
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
  __device__ __forceinline__ void prologue(float2* s, const float2* side, const Cx& cx) const {
    c2r_prologue_tile(s, side, cx, ab);
  }
};

// Kernel 17's store: the tile holds z (the last stage's outputs kept as
// they are), and each column's threads write its real rows 2l and 2l + 1
// of y[b] (B, 2h, L), l < h.
struct C2rColBins {
  static constexpr bool kTileOut = true;
  float* __restrict__ y;
  long long L;
  int h;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * 2 * h * L + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    for (int l = cx.t; l < h; l += cx.tr) {
      const float2 v = s[cx.slot(l)];
      y[cx.row + 2 * l * L] = v.x;
      y[cx.row + (2 * l + 1) * L] = v.y;
    }
  }
};

// Kernel 21's odd columns: the Hermitian extension of the (B, m, L)
// complex64 half spectrum of an odd n = 2m - 1, element r of column col of
// b being S[r] for r < m (the DC's imaginary part set to 0) and
// conj S[n - r] above: the load reads rows r < m once, and the prologue
// fills rows m ... n - 1 from the tile.
struct HermCol {
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
  __device__ __forceinline__ void prologue(float2* s, const float2*, const Cx& cx) const {
    if (!cx.active) return;
    for (int k = cx.t + 1; k < m; k += cx.tr) {
      const float2 v = s[cx.slot(k)];
      s[cx.slot(n - k)] = make_float2(v.x, -v.y);
    }
  }
};

// Kernel 21's odd store: the tile holds z, the length-n inverse of the
// extension, and each column's threads write scale * Re z[l] to real row l
// of y[b] (B, n, L).
struct C2rOddRows {
  static constexpr bool kTileOut = true;
  float* __restrict__ y;
  long long L;
  int n;
  float scale;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    for (int l = cx.t; l < n; l += cx.tr) y[cx.row + l * L] = scale * s[cx.slot(l)].x;
  }
};

}  // namespace ndfft

// x: (B, n, L) float32; y: (B, n / 2 + 1, L) complex64; both contiguous.
// table: the forward (sign -1) radix table of the transform length, h = n / 2
// for even n and n for odd n (ops/hopper/fft.py::radix_consts); radices:
// its plan, `stages` of them; u: (h,) complex64 W_n^k for even n, unused for
// odd n; C: columns per tile, a power of two up to kRadixMaxCols whose tile
// (transform length times C) holds at most 20480 elements in at most 256
// threads (512 above 4096 elements) (ops/hopper/rfft.py::r2c_mid_cols).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_mid_radix(const void* x, void* y, const void* table, const int* radices,
                                   int stages, const void* u, long long B, int n, long long L,
                                   int C, void* stream) {
  using namespace ndfft;
  const bool even = n % 2 == 0;
  const int len = even ? n / 2 : n;
  RadixPlan plan{};
  if (!radix_plan_of(radices, stages, len, plan) || (even && u == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float2*>(y);
  const auto tp = static_cast<const float2*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  if (even)
    return (int)radix_cols_launch<-1>(
        RealCol<true>{xp, L, n}, R2cColUnpack{yp, static_cast<const float2*>(u), L, len, 1.f},
        tp, plan, B, len, L, C, 1.f, st);
  return (int)radix_cols_launch<-1>(RealCol<false>{xp, L, n}, R2cOddBins{yp, L, n / 2 + 1},
                                    tp, plan, B, len, L, C, 1.f, st);
}

// Kernel 18. xe, xo: (B, h, L) float32; y: (B, h + 1, L) complex64; all
// contiguous. table: the forward (sign -1) radix table of h
// (ops/hopper/fft.py::radix_consts); radices: radix_plan(h), `stages` of
// them; u: (h,) complex64 W_2h^k; scale: multiplies every bin; C: columns
// per tile as for ndfft_r2c_mid_radix at h (ops/hopper/rfft.py::
// r2c_mid_cols). Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_packed_mid_radix(const void* xe, const void* xo, void* y,
                                          const void* table, const int* radices, int stages,
                                          const void* u, float scale, long long B, int h,
                                          long long L, int C, void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (!radix_plan_of(radices, stages, h, plan) || u == nullptr) return (int)cudaErrorInvalidValue;
  return (int)radix_cols_launch<-1>(
      PackedCol{static_cast<const float*>(xe), static_cast<const float*>(xo), L, h},
      R2cColUnpack{static_cast<float2*>(y), static_cast<const float2*>(u), L, h, scale},
      static_cast<const float2*>(table), plan, B, h, L, C, 1.f, static_cast<cudaStream_t>(stream));
}

// Kernel 17. spec: (B, h + 1, L) complex64; out: (B, 2h, L) float32; both
// contiguous. table: the inverse (sign +1) radix table of h
// (ops/hopper/fft.py::radix_consts); radices: radix_plan(h), `stages` of
// them; ab: (h, 4) float32 rows (A.re, A.im, B.re, B.im) with the scale
// folded in (ops/hopper/rfft.py::c2r_unpack_consts); C: columns per tile
// as for ndfft_r2c_mid_radix at h (ops/hopper/rfft.py::c2r_mid_cols).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2r_mid_radix(const void* spec, void* out, const void* table,
                                   const int* radices, int stages, const void* ab, long long B,
                                   int h, long long L, int C, void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (!radix_plan_of(radices, stages, h, plan) || ab == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)radix_cols_launch<1>(
      C2rCol{static_cast<const float2*>(spec), static_cast<const float4*>(ab), L, h},
      C2rColBins{static_cast<float*>(out), L, h}, static_cast<const float2*>(table), plan, B, h,
      L, C, 1.f, static_cast<cudaStream_t>(stream));
}

// Kernel 21 at odd n. spec: (B, (n + 1) / 2, L) complex64; out: (B, n, L)
// float32; both contiguous. table: the inverse (sign +1) radix table of n
// (ops/hopper/fft.py::radix_consts); radices: radix_plan(n), `stages` of
// them; scale: multiplies every output; C: columns per tile as for
// ndfft_r2c_mid_radix at n (ops/hopper/rfft.py::r2c_mid_cols). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2r_odd_mid_radix(const void* spec, void* out, const void* table,
                                       const int* radices, int stages, float scale, long long B,
                                       int n, long long L, int C, void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (n % 2 == 0 || !radix_plan_of(radices, stages, n, plan)) return (int)cudaErrorInvalidValue;
  return (int)radix_cols_launch<1>(
      HermCol{static_cast<const float2*>(spec), L, n, (n + 1) / 2},
      C2rOddRows{static_cast<float*>(out), L, n, scale}, static_cast<const float2*>(table), plan,
      B, n, L, C, 1.f, static_cast<cudaStream_t>(stream));
}
