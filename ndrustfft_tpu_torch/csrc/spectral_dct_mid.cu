// Kernel 29: the fused cosine-basis pipeline DCT-III(H * DCT-II(x)) along the
// middle axis of a (B, n, L) float32 tensor, n = 128 * k, at the 29 lengths
// of ops/hopper/dct.py::dct_form whose half length 64 k has no radix plan
// (k = 131 ... 251 prime, and 2 k for k = 131, 137, 139, 149, 151, 157), in
// the forms of kernels 25/26 there (dct_mid.cu): the half length
// h = n/2 = 128 * F on the wide core for even k, the n-point form on the
// wide core's real tile for odd k <= 255 (n <= 32640). At the 259 other
// lengths kernel 29 runs on the radix column tile (spectral_dct_radix.cu),
// and its fixed-core form here is gone.
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_spectral_dct_kernel_mid (built
// by _build_spectral_dct_mid, called by spectral_dct_pallas_mid). It is the
// rustdct DCT-II times s2, the multiply by the real H (n, 1) or (n, L), and
// the rustdct DCT-III times s3 (each handler's scalar applies before its
// transform: 2 for Default, the value of a scalar policy, 1 for NONE):
//
//   half form:  z[t] = v[2t] + i v[2t+1] (kernel 25's Makhoul load),
//     Z = FFT_h(z), V[k] = the R2C unpack of Z[k], Z[h - k],
//     y[k] = Re(P[k] V[k]), y[n-k] = Re(P[n-k] conj V[k]) (P: s2 e^{-i pi k/2n}),
//     w[k] = H[k] y[k],
//     S[k] = Q[k] (w[k] - i w[n-k]) (Q: (s3/2) e^{i pi k/2n}, w[n] = 0),
//     G[k] = A[k] S[k] + B[k] conj S[h-k], u = IFFT_h(G) as a real row,
//     out[2t] = u[t], out[2t+1] = u[n-1-t]  (kernel 26's store).
//   The pair {k, h - k} of Z closes over y[k], y[n-k], y[h-k] and y[h+k]
//   times H, which are exactly the four values that kernel 26's S[k] and
//   S[h-k] need: one thread takes a pair of one column from Z to G without
//   leaving registers, so the DCT-II coefficients are never written anywhere
//   and the pass works in place in the tile (k = 0 gives G[0] from y[0] and
//   y[h], with S[0] and S[h] real; k = h/2 is its own mirror).
//   n-point form (odd k, h = 64 k is no multiple of 128):
//     Z = FFT_n(v) of the real Makhoul row, w[k] = H[k] Re(P[k] Z[k]),
//     Z' = FFT_n(w c), c[t] = s3 e^{-i pi t/2n} with c[0] halved,
//     out[2t] = Re Z'[t], out[2t+1] = Re Z'[n-1-t].
//   Both FFT inputs are real (v, and w before its chirp), so the n-point
//   form runs on the wide core's real tile (kernels 25/26's n-point forms,
//   dct_wide.cuh): 4 n bytes per column, which one block holds up to
//   n = 32640 (k = 255), with the chirp c separable over t = a * 128 + b.
//
// The wide forms cannot work in place (the wide core reads its whole tile
// while it stores) and a second tile does not fit; the intermediate goes
// into the block's own columns of y, which hold it exactly: the half form's
// Z (Re Z[k] at row k, Im Z[k] at row k + h, as kernel 25's wide form
// stores it), the n-point form's n real values w[k]. After the forward
// core's closing barrier the block reads it back (the half form through the
// pair pass, spectral.cuh::spectral_dct_pair, into the tile, the n-point
// form times c into the tile) and the inverse core stores into y. So no
// workspace is needed in any form.
//
// What bounds it: two cores' stage 2 on the FP32 CUDA cores (bts2_core.cuh,
// bts2_wide.cuh): kernel 25's and kernel 26's arithmetic on half of their
// bytes. Every constant comes from the host (ops/hopper/dct.py).
#include "dct_wide.cuh"
#include "spectral.cuh"

namespace ndfft {

// The half form on the wide core, h = 128 * F.
template <int C>
__global__ void __launch_bounds__(kThreads)
spectral_dct_mid_wide_kernel(const float* __restrict__ x, float* y, SpecMult hm,
                             const float2* __restrict__ wq_fwd, const float2* __restrict__ wf_fwd,
                             const float2* __restrict__ tw, const float2* __restrict__ post,
                             const float2* __restrict__ wq_inv, const float2* __restrict__ wf_inv,
                             const float4* __restrict__ ab, const float2* __restrict__ pre, int F,
                             long long L, long long tiles) {
  const int h = F * kM, n = 2 * h;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, h, C);
  const DctTile<false> tl(n, L, tiles);
  const float* xb = x + tl.off;
  float* yb = y + tl.off;
  wide_fill<C, false>(sm.s, h, tl.V, [&](int t, int c) {
    return make_float2(xb[makhoul_src(2 * t, n) * L + c], xb[makhoul_src(2 * t + 1, n) * L + c]);
  });
  wide_load_row(sm.wt, wf_fwd, F);
  __syncthreads();
  // ends with a barrier: Z of every column of the tile is in y
  Bts2Wide<C, false>{h, F}.run(sm.s, sm.ys, sm.wt, wq_fwd, tl.V,
                               [=](int c, long long k, float2 z) {
                                 yb[k * L + c] = z.x;
                                 yb[(k + h) * L + c] = z.y;
                               });
  const long long col0 = tl.off % L;
  const auto zat = [&](int k, int c) { return make_float2(yb[k * L + c], yb[(k + h) * L + c]); };
  for (int idx = threadIdx.x; idx < (h / 2 + 1) * tl.V; idx += kThreads) {
    const int k = idx / tl.V;
    const int c = idx % tl.V;
    const int k2 = (h - k) % h;
    float2 gk, gm;
    spectral_dct_pair(k, h, zat(k, c), zat(k2, c), tw, post, pre, ab, hm, col0 + c, gk, gm);
    sm.s[k * C + c] = gk;
    if (k2 != k) sm.s[k2 * C + c] = gm;
  }
  wide_load_row(sm.wt, wf_inv, F);
  __syncthreads();
  Bts2Wide<C, false>{h, F}.run(sm.s, sm.ys, sm.wt, wq_inv, tl.V,
                               [=](int c, long long l, float2 z) {
                                 yb[interleave_dst(2 * l, n) * L + c] = z.x;       // u[2l]
                                 yb[interleave_dst(2 * l + 1, n) * L + c] = z.y;   // u[2l + 1]
                               });
}

// The n-point form, n = 128 * F with odd F, on the real tile: both
// transforms are FFT_n of sign -1 (wq, wf); post: (n,) P; chirp: (F + 128,)
// the n-point DCT-III's chirp with s3 (dct_wide.cuh::dct3_npoint_kernel).
template <int C>
__global__ void __launch_bounds__(kThreads)
spectral_dct_mid_npoint_kernel(const float* __restrict__ x, float* y, SpecMult hm,
                               const float2* __restrict__ wq, const float2* __restrict__ wf,
                               const float2* __restrict__ post, const float2* __restrict__ chirp,
                               int F, long long L, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideRealSmem sm(smem, n, C);
  const DctTile<false> tl(n, L, tiles);
  const float* xb = x + tl.off;
  float* yb = y + tl.off;
  const long long col0 = tl.off % L;
  wide_fill<C, false>(sm.s, n, tl.V, [&](int t, int c) { return xb[makhoul_src(t, n) * L + c]; });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  // ends with a barrier: w = H times the DCT-II of every column is in y
  Bts2Wide<C, false, RealIn>{n, F}.run(sm.s, sm.ys, sm.wt, wq, tl.V,
                                       [=](int c, long long k, float2 z) {
    const float2 p = __ldg(post + k);
    yb[k * L + c] = hm.re((int)k, col0 + c) * (p.x * z.x - p.y * z.y);
  });
  dct3_npoint_core<C, false>(sm, yb, tl, F, wq, chirp, [=](int c, long long k, float2 z) {
    yb[interleave_dst(k, n) * L + c] = z.x;
  });
}

}  // namespace ndfft

// The half form on the wide core, h = 128 * F with 1 <= F <= 160: x, y:
// (B, n, L) float32, contiguous; hr: H's float32 plane, (n, hc) with hc = 1
// or L; wq_fwd, wq_inv: (F, 128, 128) complex64 for h, sign -1 and +1,
// unscaled; wf_fwd, wf_inv: (F, F) complex64 DFT-F of sign -1 and +1; tw:
// (h,) W_n^k; post: (n,) s2 e^{-i pi k/2n}; ab: (h, 4) kernel 3's rows at
// scale 1; pre: (h + 1,) (s3/2) e^{i pi k/2n} (ops/hopper/dct.py). C: columns
// per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_spectral_dct_mid_wide(const void* x, void* y, const void* hr, long long hc,
                                           const void* wq_fwd, const void* wf_fwd,
                                           const void* tw, const void* post, const void* wq_inv,
                                           const void* wf_inv, const void* ab, const void* pre,
                                           long long B, int n, long long L, int C,
                                           void* stream) {
  using namespace ndfft;
  const SpecMult hm = spec_mult(hr, nullptr, hc, L);
  if (hm.hr == nullptr || n % (2 * kM)) return (int)cudaErrorInvalidValue;
  const int h = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(
        spectral_dct_mid_wide_kernel<kC>, h, B, L, static_cast<cudaStream_t>(stream),
        static_cast<const float*>(x), static_cast<float*>(y), hm,
        static_cast<const float2*>(wq_fwd), static_cast<const float2*>(wf_fwd),
        static_cast<const float2*>(tw), static_cast<const float2*>(post),
        static_cast<const float2*>(wq_inv), static_cast<const float2*>(wf_inv),
        static_cast<const float4*>(ab), static_cast<const float2*>(pre), h / kM, L);
  });
}

// The n-point form on the real tile, n = 128 * F with 1 <= F <= 256: wq:
// (F, 128, 128) complex64 for n, sign -1, unscaled; wf: its (F, F) DFT-F;
// post: (n,) s2 e^{-i pi k/2n}; chirp: (F + 128,) e^{-i pi a/2F}, then
// s3 e^{-i pi b/2n} (ops/hopper/dct.py::npoint_chirp). C: columns per tile,
// a power of two <= 16 whose tile fits (bts2_wide.cuh::wide_real_smem_bytes).
extern "C" int ndfft_spectral_dct_mid_npoint(const void* x, void* y, const void* hr, long long hc,
                                             const void* wq, const void* wf, const void* post,
                                             const void* chirp, long long B, int n, long long L,
                                             int C, void* stream) {
  using namespace ndfft;
  const SpecMult hm = spec_mult(hr, nullptr, hc, L);
  if (hm.hr == nullptr || n % kM) return (int)cudaErrorInvalidValue;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch_real<kC>(spectral_dct_mid_npoint_kernel<kC>, n, B, L,
                                static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                                static_cast<float*>(y), hm, static_cast<const float2*>(wq),
                                static_cast<const float2*>(wf), static_cast<const float2*>(post),
                                static_cast<const float2*>(chirp), n / kM, L);
  });
}
