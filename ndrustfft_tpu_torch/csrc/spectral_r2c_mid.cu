// Kernel 22: the fused real spectral pipeline C2R(H * R2C(x)) along the
// middle axis of a (B, n, L) float32 tensor, even n = 2h, h = 128 * F: F in
// {2, 4, 8, 16} on the fixed core, every other F <= 160 on the wide core
// (the routes send the natural-layout lengths of kernels 16/17, h >= 256).
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_spectral_kernel_mid (built by
// _build_spectral_mid, called by spectral_pallas_mid). It is kernel 16's
// load and half-length FFT (its bts2 form), a pair pass, and kernel 17's
// half-length inverse and store (its bts2 form, retired from
// rfft_mid.cu), on one column tile:
//
//   z[t] = x[2t] + i x[2t+1],  Z = FFT_h(z),
//   X[k] = the R2C unpack of Z[k] and Z[h - k] (bts2_core.cuh::r2c_unpack_one),
//   S[k] = H[k] X[k],  Im S[0] := 0,  S[h] = Re H[h] * X[h] (X[h] real),
//   G[k] = A[k] S[k] + B[k] conj S[h - k]  (kernel 17's pre-pass, the scale in A, B),
//   u = IFFT_h(G),  y[2l] = Re u[l],  y[2l+1] = Im u[l].
//
// The DC and Nyquist rules are the TPU kernel's mask mk and its Nyquist row
// (rfft.py:1060-1063, the reference's C2R contract). The pair pass: one
// thread takes the mirror pair {k, h - k} of one column and goes from Z[k],
// Z[h - k] through X, S to G[k], G[h - k] without leaving registers; every
// pair closes on itself, so the unpack, the multiply and the pre-pass share
// the tile with no read/write hazard. k = 0 carries X[0] and the Nyquist
// X[h], both from Z[0], and gives G[0] alone; k = h/2 is its own mirror.
//
// The fixed form keeps the spectrum in shared memory throughout: the pass
// reads x (and H) and writes y once each, where the composition writes and
// reads the (h + 1)-bin spectrum, and its product, in between. The wide form
// (F outside {2, 4, 8, 16}, up to h = 20480): the forward core stores Z into
// the block's own columns of y, which hold exactly h complex values (bin k at
// rows 2k, 2k + 1); after its closing barrier the pair pass reads Z from y and
// writes G into the tile, and the inverse core stores into y.
//
// What bounds it: two half-length cores' stage 2 on the FP32 CUDA cores
// (bts2_core.cuh, bts2_wide.cuh), kernel 16's and kernel 17's arithmetic on
// half of their bytes. Every constant comes from the host (ops/hopper/rfft.py).
#include "spectral.cuh"

namespace ndfft {

// G[k] (gk) and G[h - k] (gm, for 0 < k < h/2) from za = Z[k] and
// zm = Z[(h - k) mod h] of column col, k <= h/2; tw: (h,) W_n^k; ab: (h, 4)
// (A.re, A.im, B.re, B.im) with the scale.
__device__ __forceinline__ void spectral_r2c_pair(int k, int h, float2 za, float2 zm,
                                                  const float2* __restrict__ tw,
                                                  const float4* __restrict__ ab,
                                                  const SpecMult& hm, long long col, float2& gk,
                                                  float2& gm) {
  if (k == 0) {   // X[0] = Re Z0 + Im Z0 and X[h] = Re Z0 - Im Z0 are real
    const float2 s0 = make_float2(hm.re(0, col) * (za.x + za.y), 0.f);
    const float2 sh = make_float2(hm.re(h, col) * (za.x - za.y), 0.f);
    gk = c2r_combine(__ldg(ab), s0, sh);
    return;
  }
  const int k2 = h - k;
  const float2 sk = cmul(hm.at(k, col), r2c_unpack_one(za, zm, __ldg(tw + k)));
  if (k2 == k) {
    gk = c2r_combine(__ldg(ab + k), sk, sk);
    return;
  }
  const float2 sm = cmul(hm.at(k2, col), r2c_unpack_one(zm, za, __ldg(tw + k2)));
  gk = c2r_combine(__ldg(ab + k), sk, sm);
  gm = c2r_combine(__ldg(ab + k2), sm, sk);
}

// Two blocks per SM (two 64 KB tiles), as kernels 16 and 17.
template <int F, int C>
__global__ void __launch_bounds__(kThreads, 2)
spectral_r2c_mid_kernel(const float* __restrict__ x, float* __restrict__ y, SpecMult hm,
                        const float2* __restrict__ wq_fwd, const float2* __restrict__ tw,
                        const float2* __restrict__ wq_inv, const float4* __restrict__ ab,
                        long long L, long long tiles) {
  constexpr int H = F * kM;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  const float* xb = x + bb * 2 * H * L + col0;
  fixed_fill<C>(s, H, valid, [&](int t, int c) {
    return make_float2(xb[2 * t * L + c], xb[(2 * t + 1) * L + c]);
  });
  __syncthreads();
  Bts2<F, C, false>::run(s, wq_fwd, -1.f);
  for (int idx = threadIdx.x; idx < (H / 2 + 1) * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c >= valid) continue;
    const int k2 = (H - k) % H;
    float2 gk, gm;
    spectral_r2c_pair(k, H, s[k * C + c], s[k2 * C + c], tw, ab, hm, col0 + c, gk, gm);
    s[k * C + c] = gk;
    if (k2 != k) s[k2 * C + c] = gm;
  }
  __syncthreads();
  Bts2<F, C, false>::run(s, wq_inv, 1.f);
  float* yb = y + bb * 2 * H * L + col0;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int l = idx / C;
    const int c = idx % C;
    if (c < valid) {
      const float2 z = s[idx];
      yb[(2 * l) * L + c] = z.x;
      yb[(2 * l + 1) * L + c] = z.y;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
spectral_r2c_mid_wide_kernel(const float* __restrict__ x, float* y, SpecMult hm,
                             const float2* __restrict__ wq_fwd, const float2* __restrict__ wf_fwd,
                             const float2* __restrict__ tw, const float2* __restrict__ wq_inv,
                             const float2* __restrict__ wf_inv, const float4* __restrict__ ab,
                             int F, long long L, long long tiles) {
  const int H = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, H, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float* xb = x + bb * 2 * H * L + col0;
  float* yb = y + bb * 2 * H * L + col0;
  wide_fill<C, false>(sm.s, H, valid, [&](int t, int c) {
    return make_float2(xb[2 * t * L + c], xb[(2 * t + 1) * L + c]);
  });
  wide_load_row(sm.wt, wf_fwd, F);
  __syncthreads();
  // ends with a barrier: Z of every column of the tile is in y
  Bts2Wide<C, false>{H, F}.run(sm.s, sm.ys, sm.wt, wq_fwd, valid,
                               [=](int c, long long k, float2 z) {
                                 yb[2 * k * L + c] = z.x;
                                 yb[(2 * k + 1) * L + c] = z.y;
                               });
  const auto zat = [&](int k, int c) {
    return make_float2(yb[2LL * k * L + c], yb[(2LL * k + 1) * L + c]);
  };
  for (int idx = threadIdx.x; idx < (H / 2 + 1) * valid; idx += kThreads) {
    const int k = idx / valid;
    const int c = idx % valid;
    const int k2 = (H - k) % H;
    float2 gk, gm;
    spectral_r2c_pair(k, H, zat(k, c), zat(k2, c), tw, ab, hm, col0 + c, gk, gm);
    sm.s[k * C + c] = gk;
    if (k2 != k) sm.s[k2 * C + c] = gm;
  }
  wide_load_row(sm.wt, wf_inv, F);
  __syncthreads();
  Bts2Wide<C, false>{H, F}.run(sm.s, sm.ys, sm.wt, wq_inv, valid,
                               [=](int c, long long l, float2 z) {
                                 yb[2 * l * L + c] = z.x;
                                 yb[(2 * l + 1) * L + c] = z.y;
                               });
}

}  // namespace ndfft

// x, y: (B, n, L) float32, contiguous, n = 2h; hr, hi: H's float32 planes,
// (h + 1, hc) with hc = 1 or L (hi nullptr for a real H); wq_fwd, wq_inv:
// (F, 128, 128) complex64 for h, sign -1 and +1, unscaled; tw: (h,)
// complex64 W_n^k; ab: (h, 4) float32 rows (A.re, A.im, B.re, B.im) with the
// scale folded in (ops/hopper/rfft.py::c2r_unpack_consts). C: columns per
// block, a power of two with h * C <= 8192. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ndfft_spectral_r2c_mid(const void* x, void* y, const void* hr, const void* hi,
                                      long long hc, const void* wq_fwd, const void* tw,
                                      const void* wq_inv, const void* ab, long long B, int n,
                                      long long L, int C, void* stream) {
  using namespace ndfft;
  const SpecMult hm = spec_mult(hr, hi, hc, L);
  if (hm.hr == nullptr || n % 2) return (int)cudaErrorInvalidValue;
  return (int)fixed_dispatch<2>(n / 2, C, [&](auto f, auto c) {
    constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
    return fixed_launch<kF, kC>(spectral_r2c_mid_kernel<kF, kC>, B, L,
                                static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                                static_cast<float*>(y), hm, static_cast<const float2*>(wq_fwd),
                                static_cast<const float2*>(tw), static_cast<const float2*>(wq_inv),
                                static_cast<const float4*>(ab), L);
  });
}

// Kernel 22 on the wide core, h = n/2 = 128 * F with 1 <= F <= 160: as above,
// with wf_fwd, wf_inv: (F, F) complex64 DFT-F of sign -1 and +1. C: columns
// per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_spectral_r2c_mid_wide(const void* x, void* y, const void* hr, const void* hi,
                                           long long hc, const void* wq_fwd, const void* wf_fwd,
                                           const void* tw, const void* wq_inv,
                                           const void* wf_inv, const void* ab, long long B,
                                           int n, long long L, int C, void* stream) {
  using namespace ndfft;
  const SpecMult hm = spec_mult(hr, hi, hc, L);
  if (hm.hr == nullptr || n % 2) return (int)cudaErrorInvalidValue;
  const int h = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(spectral_r2c_mid_wide_kernel<kC>, h, B, L,
                           static_cast<cudaStream_t>(stream), static_cast<const float*>(x),
                           static_cast<float*>(y), hm, static_cast<const float2*>(wq_fwd),
                           static_cast<const float2*>(wf_fwd), static_cast<const float2*>(tw),
                           static_cast<const float2*>(wq_inv), static_cast<const float2*>(wf_inv),
                           static_cast<const float4*>(ab), h / kM, L);
  });
}
