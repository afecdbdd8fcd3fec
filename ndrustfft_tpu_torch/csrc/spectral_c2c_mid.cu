// Kernel 14: the fused complex spectral pipeline IFFT(H * FFT(x)) along the
// middle axis of a (B, n, L) complex64 tensor, n = 128 * F: F in {4, 8, 16}
// on the fixed core, every other F <= 160 on the wide core (the routes send
// 256 < n <= 20480, where the C2C along a middle axis is kernel 1).
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_spectral_c2c_kernel_mid (built
// by _build_spectral_c2c_mid, called by spectral_c2c_pallas_mid). The
// forward FFT is unnormalized; the inverse's scale (1/n, a scalar policy's
// value, or 1) rides the inverse core's Wq, as the TPU kernel folds it into
// its inverse constants. H is (n, 1) or (n, L), real or complex
// (spectral.cuh::SpecMult), the same block for every batch index.
//
// The fixed form is the bts2 column tile (kernel 1's first form) with two cores:
// the tile is loaded once, Bts2::run(s, wq_fwd, -1) works in place, each row
// k of the tile is multiplied by H[k] (or H[k][col]) in place, the inverse
// core runs on the same tile with its scaled Wq, and the tile is stored
// once: the spectrum never reaches device memory, so the pass reads x and H
// and writes y, against the composition's two reads and two writes of the
// field and its extra read and write of the product.
//
// The wide form (F outside {4, 8, 16}). A column of 20480 complex values is
// 160 KB, and the wide core reads its whole tile while it stores, so neither
// an in-place pass nor a second tile fits in a block's 227 KB. The forward
// core's store writes H X into the block's own columns of y; after its
// closing barrier the block reads them back into the tile (rows the block
// wrote a moment before, which L2 serves) and the inverse core stores into
// y. That is one extra write and read of the field against the fixed form
// (not in the kernel's bound, which counts what the function must move),
// and still one launch.
//
// What bounds it: two cores' stage 2, each a dense DFT-128 on the FP32 CUDA
// cores (bts2_core.cuh, bts2_wide.cuh), so twice kernel 1's arithmetic on
// the same bytes; the multiply is 6 FLOPs per element. Every offset is a
// long long: path S1's spectrum holds 5.4e8 complex values.
#include "spectral.cuh"

namespace ndfft {

template <int F, int C>
__global__ void __launch_bounds__(kThreads)
spectral_c2c_mid_kernel(const float2* __restrict__ x, float2* __restrict__ y, SpecMult hm,
                        const float2* __restrict__ wq_fwd, const float2* __restrict__ wq_inv,
                        long long L, long long tiles) {
  constexpr int N = F * kM;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  const float2* xb = x + bb * N * L + col0;
  fixed_fill<C>(s, N, valid, [&](int t, int c) { return xb[t * L + c]; });
  __syncthreads();
  Bts2<F, C, false>::run(s, wq_fwd, -1.f);
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c < valid) s[idx] = cmul(s[idx], hm.at(k, col0 + c));
  }
  __syncthreads();
  Bts2<F, C, false>::run(s, wq_inv, 1.f);
  float2* yb = y + bb * N * L + col0;
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c < valid) yb[k * L + c] = s[idx];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
spectral_c2c_mid_wide_kernel(const float2* __restrict__ x, float2* y, SpecMult hm,
                             const float2* __restrict__ wq_fwd, const float2* __restrict__ wf_fwd,
                             const float2* __restrict__ wq_inv, const float2* __restrict__ wf_inv,
                             int F, long long L, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, n, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float2* xb = x + bb * n * L + col0;
  float2* yb = y + bb * n * L + col0;
  wide_fill<C, false>(sm.s, n, valid, [&](int t, int c) { return xb[t * L + c]; });
  wide_load_row(sm.wt, wf_fwd, F);
  __syncthreads();
  // ends with a barrier: H X of every column of the tile is in y
  Bts2Wide<C, false>{n, F}.run(sm.s, sm.ys, sm.wt, wq_fwd, valid,
                               [=](int c, long long k, float2 z) {
                                 yb[k * L + c] = cmul(z, hm.at((int)k, col0 + c));
                               });
  wide_fill<C, false>(sm.s, n, valid, [&](int t, int c) { return yb[t * L + c]; });
  wide_load_row(sm.wt, wf_inv, F);
  __syncthreads();
  Bts2Wide<C, false>{n, F}.run(sm.s, sm.ys, sm.wt, wq_inv, valid, yb, 1, L);
}

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; hr, hi: H's float32 planes, (n, hc)
// with hc = 1 or L (hi nullptr for a real H); wq_fwd, wq_inv: (F, 128, 128)
// complex64, sign -1 unscaled and sign +1 with the scale folded in. C:
// columns per block, a power of two with n * C <= 8192. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_spectral_c2c_mid(const void* x, void* y, const void* hr, const void* hi,
                                      long long hc, const void* wq_fwd, const void* wq_inv,
                                      long long B, int n, long long L, int C, void* stream) {
  using namespace ndfft;
  const SpecMult hm = spec_mult(hr, hi, hc, L);
  if (hm.hr == nullptr) return (int)cudaErrorInvalidValue;
  return (int)fixed_dispatch<4>(n, C, [&](auto f, auto c) {
    constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
    return fixed_launch<kF, kC>(spectral_c2c_mid_kernel<kF, kC>, B, L,
                                static_cast<cudaStream_t>(stream), static_cast<const float2*>(x),
                                static_cast<float2*>(y), hm, static_cast<const float2*>(wq_fwd),
                                static_cast<const float2*>(wq_inv), L);
  });
}

// Kernel 14 on the wide core, n = 128 * F with 1 <= F <= 160: x, y, hr, hi,
// hc, wq_fwd and wq_inv as above; wf_fwd, wf_inv: (F, F) complex64 DFT-F of
// sign -1 and +1. C: columns per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_spectral_c2c_mid_wide(const void* x, void* y, const void* hr, const void* hi,
                                           long long hc, const void* wq_fwd, const void* wf_fwd,
                                           const void* wq_inv, const void* wf_inv, long long B,
                                           int n, long long L, int C, void* stream) {
  using namespace ndfft;
  const SpecMult hm = spec_mult(hr, hi, hc, L);
  if (hm.hr == nullptr) return (int)cudaErrorInvalidValue;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(spectral_c2c_mid_wide_kernel<kC>, n, B, L,
                           static_cast<cudaStream_t>(stream), static_cast<const float2*>(x),
                           static_cast<float2*>(y), hm, static_cast<const float2*>(wq_fwd),
                           static_cast<const float2*>(wf_fwd), static_cast<const float2*>(wq_inv),
                           static_cast<const float2*>(wf_inv), n / kM, L);
  });
}
