// Kernel 27 on the mixed-radix core's column tile (fft_radix.cuh::
// radix_cols_kernel, the skeleton of kernels 16, 17, 18 and 20): DCT-I,
// DCT-II and DCT-III along the middle axis of a (B, n, L) float32 tensor,
// in the rustdct convention times a scale s, at every 2 <= n <= 1100 whose
// real FFT has a plan (ops/hopper/fft.py::radix_plan): DCT-II and DCT-III
// at even n = 2h with a plan of h, DCT-I at n with a plan of n - 1. DST-II
// and DST-III reach them through their flip/sign conjugation. DCT-IV, odd
// n for DCT-II/III, the lengths without a plan and the 101 DCT-I lengths
// where a large prime stage of n - 1 makes the product faster
// (ops/hopper/fft.py::dense_beats_radix: 128 = 127 + 1, 130 = 3 * 43 + 1
// ...) keep the dense product of dct_dense.cu.
//
// Replaces, at those types and lengths, ndrustfft_tpu/ops/pallas/dct.py::
// _dct_dense_kernel (:545, called at :579 by dct_dense_pallas_mid), which
// runs the scaled DCT matrix as one MXU dot per (1, n, TL) block at the
// "highest" tier. Its first Hopper form (dct_dense.cu on dense_real.cuh's
// register-tiled SGEMM) did the product's 2 n^2 FP32 operations per column
// (4.263 ms at (1, 512, 262144) on an H100, 13x the byte bound, and 64.7 ms
// at (1024, 1024, 1024), 25x).
//
// Kernel 25, the DCT-II along a middle axis past n = 1100, runs the same
// DCT-II form at n = 128 k wherever h = 64 k has a plan (259 of the 288
// lengths of ops/hopper/dct.py::dct_form, the odd k included), columns a
// tile by dct.py::dct2_mid_cols (up to 16 in the 32/40-element form from
// h = 768 on; one column above h = 10240, loaded through the read-only
// path). It replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel_mid
// (:333, called at :406) there; its first Hopper forms (dct_mid.cu,
// dct_wide.cuh) ran the bts2 fixed core (0.1665 ms at (1, 2048, 2048)),
// the wide core (128.6 ms at (1, 1536, 2359296), 15x its byte bound) and
// the n-point FFT on the wide core's real tile at odd k, whose every
// column streamed the F * 128 KB Wq table from L2 (1397.5 ms at
// (1, 31104, 31104), 600x).
//
// Kernel 26, the DCT-III along a middle axis past n = 1100, runs the
// DCT-III form at the same 259 lengths, columns a tile by kernel 25's
// dct.py::dct2_mid_cols, loaded through the read-only path at one or two
// columns a tile. It replaces ndrustfft_tpu/ops/pallas/dct.py::
// _dct3_kernel_mid (:351, called at :456) there; its first Hopper forms
// ran the bts2 fixed core (0.128 ms at (1, 2048, 2048)), the wide core
// (145.8 ms at (1, 1536, 2359296)) and the n-point form (763.3 ms at
// (1, 31104, 31104), 330x its byte bound). The 29 lengths without a plan
// keep the wide core's and the n-point forms (dct_mid.cu).
//
// Kernel 19, the DCT-I along a middle axis past n = 1100 (odd n = h + 1,
// h = 128 F, every F <= 160 of its routes has a plan), runs the same DCT-I
// form with `half` = its own scale (2 s times the rustdct DCT-I), columns
// a tile by ops/hopper/rfft.py::dct1_mid_cols (kernel 18's rule, up to 16
// in the 32/40-element form; one column above h = 10240, loaded through
// the read-only path). It replaces ndrustfft_tpu/ops/pallas/rfft.py::
// _dct1_kernel_mid (:724, called at :785); its first Hopper form ran the
// bts2 column R2C (the fixed core's dense DFT-128 on the FP32 cores, 68.49
// ms at (2049, 2049, 257), 26.6x its byte bound; the wide core through a
// (B, h, L) complex64 workspace).
//
// What bounds it on this card: device memory. A column is read once and
// written once, 8 n bytes: 0.321 ms at (1, 512, 262144) and 2.56 ms at
// (1024, 1024, 1024) over 3.35 TB/s, against a real FFT's 2.5 n log2 n
// FP32 operations per column (0.045 and 0.40 ms of the 67 TFLOP/s peak).
//
// The design: the Makhoul passes of kernels 25 and 26's first forms
// (dct_mid.cu, dct_nat.cu, whose header has the algebra; the index maps makhoul_src and interleave_dst of
// dct_wide.cuh) as a load policy and an epilogue around radix_run, each
// column once through the tile, every constant from the host
// (ops/hopper/dct.py), no sincosf on the device.
//
// * DCT-II, n = 2h: the load reads the Makhoul pairs
//   z[t] = (x[makhoul_src(2t)], x[makhoul_src(2t + 1)]), two row loads an
//   element, consecutive threads on consecutive columns (MakhoulCol); the
//   forward radix_run of h leaves Z in the tile (kTileOut), and the
//   epilogue is kernel 16's unpack (r2c_unpack_tile, u = W_n^k) whose
//   store multiplies X[k] by P[k] = s e^{-i pi k / 2n} (dct.py::dct2_post)
//   and writes y[k] = Re, and for 0 < k < h also y[n - k] = -Im (P[n - k]
//   = -i conj P[k]); y[h] comes from the unpack's X[h] alone, once.
// * DCT-III, n = 2h: the load forms S[k] = Q[k] (x[k] - i x[n - k]),
//   Q[k] = (s / 2) e^{+i pi k / 2n} (dct.py::dct3_pre, the scale folded
//   there once), x[n] = 0, from two row loads, rows k < h into the tile and
//   k = h into the column's side slot (Dct3Col, kernel 17's C2rCol with
//   the pre twiddle); the prologue is kernel 17's inverse unpack
//   (c2r_prologue_tile) with the ab rows at scale 1; the inverse radix_run
//   of h leaves z in the tile, and the epilogue writes the Makhoul
//   interleave y[interleave_dst(2l)] = Re z[l], y[interleave_dst(2l + 1)] =
//   Im z[l], a tile row at a time (Dct3Rows).
// * DCT-I, n = h + 1: the R2C of the even extension e of length 2h
//   (e[j] = x[j] for j < n, x[2h - j] above), its pairs (e[2t], e[2t + 1])
//   read straight from x (EvenExtCol); the forward radix_run of h and the
//   unpack (u = W_2h^k), whose store writes y[k] = (s / 2) Re X[k] for the
//   n bins k <= h (Dct1Rows).
//
// As in kernels 16 and 17, the stores come from an epilogue over the tile,
// not from the last stage (a bin bound or a store there spilled 0.5-13 KB
// a thread on an H100). Columns a tile: ops/hopper/rfft.py::r2c_mid_cols
// (DCT-II, DCT-I) and c2r_mid_cols (DCT-III) at the transform length
// (kernel 27), dct.py::dct2_mid_cols (kernels 25, 26).
// The DCT-II and DCT-III structs are makhoul_cols.cuh's, shared with
// kernel 29 (spectral_dct_radix.cu).
#include "makhoul_cols.cuh"

namespace ndfft {

// DCT-I's columns: element t < h of column col of b as the pair
// (e[2t], e[2t + 1]) of the even extension of x (B, h + 1, L), loaded
// evict-first or (kLdg) through the read-only path, as MakhoulCol (kernel
// 19 at C <= 2).
template <bool kLdg = false>
struct EvenExtCol {
  const float* __restrict__ x;
  long long L;
  int n;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ int src(int j) const { return j < n ? j : 2 * (n - 1) - j; }
  __device__ __forceinline__ float ld(const float* q) const {
    return kLdg ? __ldg(q) : __ldcs(q);
  }
  __device__ __forceinline__ float2 at(long long p, int t) const {
    return make_float2(ld(x + p + src(2 * t) * L), ld(x + p + src(2 * t + 1) * L));
  }
};

// DCT-I's epilogue: the tile holds Z; y[k] = half Re X[k] for the h + 1
// bins, half = s / 2, into y (B, h + 1, L).
struct Dct1Rows {
  static constexpr bool kTileOut = true;
  float* __restrict__ y;
  const float2* __restrict__ u;      // W_2h^k, k < h
  long long L;
  int n;
  float half;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    float* yc = y + cx.row;
    const long long ls = L;
    const float sc = half;
    r2c_unpack_tile(s, cx, u, [=](int k, float2 v) { yc[k * ls] = sc * v.x; });
  }
};

}  // namespace ndfft

// x, y: (B, n, L) float32, contiguous. type 1, 2 or 3; table: the radix
// table of the transform length h (n - 1 for type 1, n / 2 for types 2
// and 3; sign -1, or +1 for type 3) (ops/hopper/fft.py::radix_consts);
// radices: radix_plan(h), `stages` of them; c1: (h,) complex64 W_2h^k
// (types 1 and 2) or the (h, 4) float32 ab rows at scale 1 (type 3,
// ops/hopper/rfft.py::c2r_unpack_consts); c2: (n,) complex64 P[k]
// (type 2, ops/hopper/dct.py::dct2_post) or (h + 1,) Q[k] (type 3,
// dct.py::dct3_pre), the scale s folded in; unused for type 1, whose
// `half` is s / 2. C: columns per tile (ops/hopper/dct.py::dct_radix_cols,
// dct2_mid_cols, ops/hopper/rfft.py::dct1_mid_cols); ldg: 1 loads x
// through the read-only path, 0 evict-first. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ndfft_dct_mid_radix(int type, const void* x, void* y, const void* table,
                                   const int* radices, int stages, const void* c1,
                                   const void* c2, float half, long long B, int n, long long L,
                                   int C, int ldg, void* stream) {
  using namespace ndfft;
  const int h = type == 1 ? n - 1 : n / 2;
  RadixPlan plan{};
  if (type < 1 || type > 3 || (type != 1 && n % 2) || !radix_plan_of(radices, stages, h, plan) ||
      c1 == nullptr || (type != 1 && c2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float*>(y);
  const auto tp = static_cast<const float2*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  if (type == 1) {
    const Dct1Rows io{yp, static_cast<const float2*>(c1), L, n, half};
    return ldg ? (int)radix_cols_launch<-1>(EvenExtCol<true>{xp, L, n}, io, tp, plan, B, h, L, C,
                                            1.f, st)
               : (int)radix_cols_launch<-1>(EvenExtCol<>{xp, L, n}, io, tp, plan, B, h, L, C,
                                            1.f, st);
  }
  if (type == 2) {
    const Dct2Rows io{yp, static_cast<const float2*>(c1), static_cast<const float2*>(c2), L, n};
    return ldg ? (int)radix_cols_launch<-1>(MakhoulCol<true>{xp, L, n}, io, tp, plan, B, h, L, C,
                                            1.f, st)
               : (int)radix_cols_launch<-1>(MakhoulCol<>{xp, L, n}, io, tp, plan, B, h, L, C,
                                            1.f, st);
  }
  const auto q = static_cast<const float2*>(c2);
  const auto ab = static_cast<const float4*>(c1);
  const Dct3Rows<> io{yp, L, n};
  return ldg ? (int)radix_cols_launch<1>(Dct3Col<true>{xp, q, ab, L, n}, io, tp, plan, B, h, L,
                                         C, 1.f, st)
             : (int)radix_cols_launch<1>(Dct3Col<>{xp, q, ab, L, n}, io, tp, plan, B, h, L, C,
                                         1.f, st);
}
