// Kernel 28's remnant: DCT-IV along the middle axis of a (B, n, L) float32
// tensor, even n = 2 hl, hl = 128 * F, at the 23 prime F whose hl has no
// radix plan: 131, 137, 139, 149, 151 and 157 on the wide core
// (dct4_mid_wide_kernel), 163 ... 251 in the long form on the wide core's
// real tile (dct4_mid_long_kernel, at the end of this file). Every other F
// runs on the radix column tile (dct4_mid_radix.cu).
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_dct4_kernel_mid (built by
// _build_dct4_mid, called by dct4_pallas_mid) at those lengths. It computes
// scale * DCT-IV in the rustdct convention by the half-length complex
// factorization
//   c_s = w_s (x[2s] + i x[n-1-2s]),  w_s = e^{-i pi (4s+1) / (4n)},
//   D = FFT_hl(c),
//   y[2k] = scale * Re(D_k e^{-i pi k / n}),
//   y[n-1-2k] = -scale * Im(D_k e^{-i pi k / n}),
// the algebra of the port's composite ops/dct.py::dct4_half_mid, fused into
// one kernel: the load reads rows 2s and n - 1 - 2s and applies the entry
// chirp (a host table), the core is kernel 1's first C2C in the column
// layout (bts2_wide.cuh), and the store applies the exit chirp
// (scale * (cos, sin)(pi k / n), a host table, the scale folded in as the
// JAX kernel folds it) and writes both outputs of each k as two row stores.
// Each output is written once; there is no mirror and no workspace.
//
// The TPU kernel runs four real twostep pipelines (dct.py:610-640): the
// separable chirps folded into its stage constants and a sign-+1 copy of
// the transform, only to avoid flips and strided slices under Mosaic. Here
// the reversed row n - 1 - 2s is one more coalesced row load and the
// interleaved outputs are plain row stores, so one complex FFT per column
// does.
//
// What bounds it: the core's stage 2, a dense DFT-128 on the FP32 CUDA cores
// (bts2_core.cuh, bts2_wide.cuh); device memory is read once and written
// once, the loads and stores are whole rows of the tile's columns, and every
// constant comes from the host (ops/hopper/dct.py).
#include "bts2_wide.cuh"

namespace ndfft {

// c_s = w_s (x[2s] + i x[n-1-2s]) from the column at xc (element t at
// xc[t * L]).
__device__ __forceinline__ float2 dct4_entry(const float* xc, long long L, int n, int s,
                                             const float2* __restrict__ chirp) {
  const float a = xc[(long long)(2 * s) * L];
  const float b = xc[(long long)(n - 1 - 2 * s) * L];
  const float2 w = __ldg(chirp + s);
  return make_float2(a * w.x - b * w.y, a * w.y + b * w.x);
}

// y[2k] and y[n-1-2k] of the column at yc from D_k and p = the exit chirp
// scale * (cos, sin)(pi k / n).
__device__ __forceinline__ void dct4_exit(float* yc, long long L, int n, long long k, float2 d,
                                          float2 p) {
  yc[2 * k * L] = d.x * p.x + d.y * p.y;
  yc[(n - 1 - 2 * k) * L] = d.x * p.y - d.y * p.x;
}

// Kernel 28 on the wide core: the chirped column tile, the core, and the
// exit chirp and interleave in the core's store callback.
template <int C>
__global__ void __launch_bounds__(kThreads)
dct4_mid_wide_kernel(const float* __restrict__ x, float* __restrict__ y,
                     const float2* __restrict__ wq, const float2* __restrict__ wf,
                     const float2* __restrict__ chirp, const float2* __restrict__ post, int F,
                     long long L, long long tiles) {
  const int HL = F * kM, NN = 2 * HL;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, HL, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float* xb = x + bb * NN * L + col0;
  wide_fill<C, false>(sm.s, HL, valid,
                      [&](int t, int c) { return dct4_entry(xb + c, L, NN, t, chirp); });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float* yb = y + bb * NN * L + col0;
  Bts2Wide<C, false>{HL, F}.run(sm.s, sm.ys, sm.wt, wq, valid, [=](int c, long long k, float2 d) {
    dct4_exit(yb + c, L, NN, k, d, __ldg(post + k));
  });
}

// Kernel 28's long form, at the prime 160 < F <= 256 (n = 41728 ...
// 64256): the complex tile of one column (8 hl bytes, 262 KB at
// hl = 32768) does not fit a block. The FFT is linear, so
// D = FFT_hl(w a) + i FFT_hl(w b) with the two real streams a_s = x[2s]
// and b_s = x[n-1-2s]: two passes of the core per column on one real tile
// of hl floats (131 KB), each with the entry chirp
// w_s = e^{-i pi (4s+1)/(4n)}, separable over s = a * 128 + b as
// e^{-i pi a / 2F} * e^{-i pi (4b+1)/(4n)} (ChirpIn). Pass 1 parks
// A_k = FFT(w a)_k in y's own column: Re A_k at row 2k, Im A_k at row
// n-1-2k, the two rows that outputs y[2k] and y[n-1-2k] take. Pass 2's store
// reads A_k back from those rows (written by this block before the core's
// closing barrier), forms D_k = A_k + i B_k and writes y[2k] and y[n-1-2k]
// over them: the "same positions" of dct_wide.cuh's dct2_unpack. No
// workspace; x is read twice. Pass 2 reads x after pass 1 wrote y, so x must
// not alias y (the wrapper always allocates y). Chosen over a 2-CTA cluster
// that splits the complex tile over b (stage 2's sum over b through
// distributed shared memory) because it reuses the wide core unchanged: one
// more pass of stage 1 and stage 2, against a second core variant.
// chirp: (F + 128,) e^{-i pi a / 2F} (a < F), then e^{-i pi (4b+1)/(4n)}
// (b < 128).
template <int C>
__global__ void __launch_bounds__(kThreads)
dct4_mid_long_kernel(const float* __restrict__ x, float* y,
                     const float2* __restrict__ wq, const float2* __restrict__ wf,
                     const float2* __restrict__ chirp, const float2* __restrict__ post, int F,
                     long long L, long long tiles) {
  const int HL = F * kM, NN = 2 * HL;
  extern __shared__ float2 smem[];
  const WideRealSmem sm(smem, HL, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float* xb = x + bb * NN * L + col0;
  float* yb = y + bb * NN * L + col0;
  const Bts2Wide<C, false, ChirpIn> core{HL, F, ChirpIn{sm.wa, chirp + F}};
  wide_fill<C, false>(sm.s, HL, valid, [&](int t, int c) { return xb[2LL * t * L + c]; });
  wide_load_row(sm.wt, wf, F);
  wide_load_chirp(sm.wa, chirp, F);
  __syncthreads();
  // pass 1, ends with a barrier: A_k of every column is in y
  core.run(sm.s, sm.ys, sm.wt, wq, valid, [=](int c, long long k, float2 a) {
    yb[2 * k * L + c] = a.x;
    yb[(NN - 1 - 2 * k) * L + c] = a.y;
  });
  wide_fill<C, false>(sm.s, HL, valid,
                      [&](int t, int c) { return xb[(long long)(NN - 1 - 2 * t) * L + c]; });
  __syncthreads();
  core.run(sm.s, sm.ys, sm.wt, wq, valid, [=](int c, long long k, float2 b) {
    const float2 a = make_float2(yb[2 * k * L + c], yb[(NN - 1 - 2 * k) * L + c]);
    dct4_exit(yb + c, L, NN, k, make_float2(a.x - b.y, a.y + b.x), __ldg(post + k));
  });
}

}  // namespace ndfft

// Kernel 28 on the wide core, hl = n / 2 = 128 * F with 1 <= F <= 160 (the
// prime F > 127 on the routes): x, y: (B, n, L) float32, contiguous; wq:
// (F, 128, 128) complex64 for hl, sign -1, unscaled; chirp: (hl,) complex64
// e^{-i pi (4s+1)/(4n)}; post: (hl,) complex64 scale * (cos, sin)(pi k / n);
// wf: (F, F) complex64 DFT-F, sign -1. C:
// columns per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_dct4_mid_wide(const void* x, void* y, const void* wq, const void* wf,
                                   const void* chirp, const void* post, long long B, int n,
                                   long long L, int C, void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  const int hl = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(dct4_mid_wide_kernel<kC>, hl, B, L, static_cast<cudaStream_t>(stream),
                           static_cast<const float*>(x), static_cast<float*>(y),
                           static_cast<const float2*>(wq), static_cast<const float2*>(wf),
                           static_cast<const float2*>(chirp), static_cast<const float2*>(post),
                           hl / kM, L);
  });
}

// Kernel 28's long form on the real tile, hl = n / 2 = 128 * F with
// 1 <= F <= 256 (the prime F > 160 on the routes): x, y (distinct), wq, wf
// and post as above; chirp: (F + 128,) complex64 e^{-i pi a / 2F}, then
// e^{-i pi (4b+1)/(4n)} (ops/hopper/dct.py::dct4_chirp_long). C: columns per
// tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_real_smem_bytes).
extern "C" int ndfft_dct4_mid_long(const void* x, void* y, const void* wq, const void* wf,
                                   const void* chirp, const void* post, long long B, int n,
                                   long long L, int C, void* stream) {
  using namespace ndfft;
  if (n % 2 || x == y) return (int)cudaErrorInvalidValue;
  const int hl = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch_real<kC>(dct4_mid_long_kernel<kC>, hl, B, L,
                                static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                                static_cast<float*>(y), static_cast<const float2*>(wq),
                                static_cast<const float2*>(wf), static_cast<const float2*>(chirp),
                                static_cast<const float2*>(post), hl / kM, L);
  });
}
