// Kernels 2 and 15: the R2C of contiguous (T, n) float32 rows, n = 2h, to
// (T, h + 1) complex64, on the mixed-radix row core (fft_radix.cuh) with
// the unpack as its epilogue: kernel 2 at every h = 128 * F (F <= 160, with
// prime factors <= 127), kernel 15 at those h, at a half length h > 256
// without a {128, 256} split (h = 265 at n = 530 and h = 300 at n = 600;
// odd h included) and at its dense rows, every h <= 256 with a plan but 31
// (229 half lengths, h = 2 ... 250; h = 1, 31 and the primes 131 ... 251
// keep the dense product of rfft_dense.cu, faster at h = 31 on an H100). Kernel 3: their inverse, the C2R of (T, h + 1)
// complex64 rows to (T, n) float32 at every h = 128 * F, on the same core
// with the inverse unpack as its prologue.
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_kernel_nat (kernel 2),
// ::_r2c_kernel (kernel 15, the even/odd streams of the lane lowerings,
// which are the natural row read as complex pairs) and ::_c2r_kernel_nat
// (kernel 3, :323, called at :404). Kernels 2, 3 and 15 at h = 128 * F ran
// on the bts2 core until this file took them: a dense DFT-128 per output,
// compute-bound (4 * 128 FMAs per complex output), and on the wide core at
// F outside {1, 2, 4, 8, 16} each tile read the F * 128 * 128 * 8-byte Wq
// table from L2 (16.8 MB per row at h = 16384, each value feeding one
// row); here the table holds h entries (131 KB at h = 16384, one row of
// 512 threads of 32 elements a block). Kernel 3's bts2 form also read
// S[k] and S[h - k] from device memory for each element, half of them in
// reverse.
//
// Kernel 15's dense rows (h <= 256 not 128 * F): the TPU kernel ran the
// half-length FFT as its dense lane DFT, one h x h product on the MXU;
// their first Hopper form was one real product of the whole row, 2 n (n /
// 2 + 1) multiply-adds where the function needs 2.5 n log2 n (0.0845 ms at
// (16384, 128), 17x its byte bound and 2.9x torch.fft.rfft on an H100).
// Here a small h takes many rows a block (ops/hopper/fft.py::radix_block's
// small-tile rule, kernel 8's at n <= 256: 512 complex elements a block,
// 256 rows of h = 2 with one thread a row, whose thread then unpacks all
// h + 1 bins of its row).
//
// Kernel 15's generic half lengths: _half_fft_consts falls back to the
// generic lane-last schedule there. The TPU
// kernel ran the rows [z; conj z] of the even/odd streams through its
// length-h FFT (two dense products) and unpacked Z and C = conj Z[(h - k)
// mod h]. Its first Hopper form ran the same two dense products,
// 8 (m + f) FP32 operations per output (1216 at h = 300 against an FFT's
// 5 log2 h = 41), and read Z back through L2 for the unpack.
//
// What bounds it on this card: device memory. A row is read once (8 h
// bytes) and its h + 1 bins written once (8 (h + 1) bytes): 0.517 ms at
// (360000, 600) and 0.321 ms at (262144, 512) over 3.35 TB/s, against about
// 2.5 n log2 n FP32 operations per row (0.06 ms of the 67 TFLOP/s peak at
// (360000, 600)); kernel 3 moves the same bytes the other way.
//
// The design: a contiguous float32 row of length 2h is the complex row
// z[t] = x[2t] + i x[2t + 1], so the row core's 16-byte load reads it as
// it is. The core runs radix_plan(h) in place; its last stage writes the
// spectrum Z back into the tile in natural order (R2cUnpack::kTileOut), and
// after the barrier the epilogue reads Z[k] and Z[(h - k) mod h] from shared
// memory and writes each bin of the output row once, consecutive threads on
// consecutive bins:
//
//   X[k] = (Z[k] + C[k]) / 2 - i W_n^k (Z[k] - C[k]) / 2,  k < h,
//   X[h] = Re Z[0] - Im Z[0],  C[k] = conj Z[(h - k) mod h].
//
// Kernel 3 runs it backwards. The load (fft_radix.cuh::C2rRowLoad) reads
// the tile's rows of h + 1 bins as one contiguous run with 16-byte loads,
// bins k < h into the tile and bin h into a side slot of the row; after the
// barrier the prologue (c2r_prologue_tile) replaces the bins in place, each
// thread one mirror pair {k, h - k}, with
//
//   G[k] = A[k] S[k] + B[k] conj S[h - k],  A = s (1 + i u),
//   B = s (1 - i u),  u = W_n^{-k},
//
// the DC and Nyquist imaginary parts ignored (the reference's order: scale,
// then DC/Nyquist imag = 0, then invert; the scale s is real and rides A
// and B, ops/hopper/rfft.py::c2r_unpack_consts, and the usual 1/2 of the
// unpack and the 2 of the half-length inverse cancel). Behind a second
// barrier the core runs radix_plan(h) with the sign +1 table and leaves
// z = IFFT_h(G), unnormalized, in the tile, and an epilogue stores it as the
// float2 pairs of the real output row (C2rRowBins): x[2t] = Re z[t],
// x[2t + 1] = Im z[t]. Device memory is read once, coalesced, and never in
// reverse. (K10's row store from the last stage made ptxas spill 540, 1264
// and 2620 bytes a thread at 16, 32 and 40 elements against 84, 0 and 180
// through the tile; on an H100 the epilogue ran 7% faster at
// (32768, 16385), 2% faster at (131072, 1025) and within 2% at (262144,
// 257) and (589824, 385): time_kernels.py --scan-c2r.)
#include "fft_radix.cuh"

namespace ndfft {

// The unpack epilogue: the row core leaves Z in the tile, and each row's
// threads write its h + 1 bins; u[k] = W_n^k.
struct R2cUnpack {
  static constexpr bool kTileOut = true;
  float2* __restrict__ y;
  const float2* __restrict__ u;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    float2* yr = y + cx.row * (cx.n + 1);
    r2c_unpack_tile(s, cx, u, [=](int k, float2 v) { yr[k] = v; });
  }
};

// Kernel 3's store: the tile holds z (the last stage's outputs kept as
// they are), and each row's threads write it as the float2 pairs of the
// real row, consecutive threads on consecutive pairs.
struct C2rRowBins {
  static constexpr bool kTileOut = true;
  float2* __restrict__ y;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    float2* yr = y + cx.row * cx.n;
    for (int l = cx.t; l < cx.n; l += cx.tr) yr[l] = s[cx.slot(l)];
  }
};

}  // namespace ndfft

// x: (T, 2h) float32, contiguous, 8-byte aligned (read as (T, h) complex64);
// y: (T, h + 1) complex64; table: the forward radix table of h
// (ops/hopper/fft.py::radix_consts); radices: the plan's `stages` radices
// (ops/hopper/fft.py::radix_plan); u: (h,) W_n^k; rows: rows per block
// (ops/hopper/fft.py::radix_block). Returns the cudaError_t of the launch
// (0 on success).
extern "C" int ndfft_r2c_radix(const void* x, void* y, const void* table, const int* radices,
                               int stages, const void* u, long long T, int h, int rows,
                               void* stream) {
  using namespace ndfft;
  return (int)radix_rows_launch(RowLoad{static_cast<const float2*>(x)},
                                R2cUnpack{static_cast<float2*>(y), static_cast<const float2*>(u)},
                                static_cast<const float2*>(table), radices, stages, T, h, rows,
                                -1, 1.f, static_cast<cudaStream_t>(stream));
}

// Kernel 3. spec: (T, h + 1) complex64, contiguous; out: (T, 2h) float32,
// contiguous, 8-byte aligned (written as (T, h) complex64); table: the
// inverse (sign +1) radix table of h (ops/hopper/fft.py::radix_consts);
// radices: radix_plan(h), `stages` of them; ab: (h, 4) float32 rows (A.re,
// A.im, B.re, B.im) with the scale folded in (ops/hopper/rfft.py::
// c2r_unpack_consts); rows: rows per block (ops/hopper/fft.py::
// radix_block). Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2r_radix(const void* spec, void* out, const void* table,
                               const int* radices, int stages, const void* ab, long long T,
                               int h, int rows, void* stream) {
  using namespace ndfft;
  if (ab == nullptr) return (int)cudaErrorInvalidValue;
  return (int)radix_rows_launch(
      C2rRowLoad{static_cast<const float2*>(spec), static_cast<const float4*>(ab)},
      C2rRowBins{static_cast<float2*>(out)}, static_cast<const float2*>(table), radices, stages,
      T, h, rows, 1, 1.f, static_cast<cudaStream_t>(stream));
}
