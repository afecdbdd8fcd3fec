// What the fused spectral pipelines share (kernels 14, 22 and 29:
// spectral_c2c_mid.cu, spectral_r2c_mid.cu, spectral_dct_radix.cu and
// spectral_dct_mid.cu): the diagonal multiplier H between the forward and
// the inverse transform, and kernel 29's pair pass.
//
// Each of those kernels runs a forward transform, the multiply and the
// inverse transform on one column tile without writing the spectrum to
// device memory on the fixed core and on the radix column tile (the tile
// stays in shared memory). The
// wide core writes every output straight to device memory and reads its
// whole tile while it does, so it cannot work in place and a second tile
// does not fit beside a 160 KB one: there the forward core writes the
// intermediate into the block's own columns of the output, which hold it
// exactly (n complex values for kernel 14, the half-length spectrum's h
// complex values in 2h floats for kernels 22 and 29, the n real DCT-II
// values times H for kernel 29's n-point form), and after the core's closing
// block barrier the block reads it back into the tile for the inverse core.
#pragma once

#include "bts2_wide.cuh"

namespace ndfft {

// The multiplier H as float32 planes: H[k] of column col at hr[k * hc + col]
// (and hi) for a lane-varying (rows, L) multiplier, hc = L; at hr[k] for a
// broadcast (rows, 1) one, hc = 1; hi = nullptr for a real H. H depends on
// (k, col) only: every batch index b reads the same block.
struct SpecMult {
  const float* __restrict__ hr;
  const float* __restrict__ hi;
  long long hc;
  __device__ long long pos(int k, long long col) const { return hc == 1 ? k : k * hc + col; }
  __device__ float re(int k, long long col) const { return __ldg(hr + pos(k, col)); }
  __device__ float2 at(int k, long long col) const {
    const long long i = pos(k, col);
    return make_float2(__ldg(hr + i), hi == nullptr ? 0.f : __ldg(hi + i));
  }
};

// The multiplier of the C entry points: hc = 1 or L, else nullptr in hr.
inline SpecMult spec_mult(const void* hr, const void* hi, long long hc, long long L) {
  if (hc != 1 && hc != L) hr = nullptr;
  return SpecMult{static_cast<const float*>(hr), static_cast<const float*>(hi), hc};
}

// Kernel 29's pair pass, from the half-length spectrum Z of the Makhoul
// DCT-II's R2C to the DCT-III's inverse-unpacked G: G[k] (gk) and G[h - k]
// (gm, for 0 < k < h/2) from za = Z[k] and zm = Z[(h - k) mod h] of column
// col, k <= h/2. The pair {k, h - k} of Z closes over the DCT-II values
// y[k], y[n - k], y[h - k] and y[h + k], which times H are exactly the four
// values that the DCT-III's S[k] and S[h - k] need: the coefficients never
// leave registers. tw: (h,) W_n^k; post: (n,) P; pre: (h + 1,) Q; ab: (h, 4)
// kernel 3's rows at scale 1.
__device__ __forceinline__ void spectral_dct_pair(int k, int h, float2 za, float2 zm,
                                                  const float2* __restrict__ tw,
                                                  const float2* __restrict__ post,
                                                  const float2* __restrict__ pre,
                                                  const float4* __restrict__ ab,
                                                  const SpecMult& hm, long long col, float2& gk,
                                                  float2& gm) {
  const int n = 2 * h;
  // S[j] = Q[j] (a - i b) with a = w[j], b = w[n - j]
  const auto spec = [&](int j, float a, float b) {
    const float2 q = __ldg(pre + j);
    return make_float2(a * q.x + b * q.y, a * q.y - b * q.x);
  };
  // S[j] from V[j], j > 0: w[j] = H[j] Re(P[j] V[j]), w[n-j] = H[n-j] Re(P[n-j] conj V[j])
  const auto spec_of = [&](int j, float2 v) {
    const float2 p = __ldg(post + j);
    const float2 pm = __ldg(post + n - j);
    return spec(j, hm.re(j, col) * (p.x * v.x - p.y * v.y),
                hm.re(n - j, col) * (pm.x * v.x + pm.y * v.y));
  };
  if (k == 0) {   // V[0] = Re Z0 + Im Z0 and V[h] = Re Z0 - Im Z0 are real
    const float w0 = hm.re(0, col) * __ldg(post).x * (za.x + za.y);
    const float wh = hm.re(h, col) * __ldg(post + h).x * (za.x - za.y);
    float2 s0 = spec(0, w0, 0.f);
    float2 sh = spec(h, wh, wh);
    s0.y = 0.f;   // S[0] and S[h] are real; drop their rounding residue
    sh.y = 0.f;
    gk = c2r_combine(__ldg(ab), s0, sh);
    return;
  }
  const int k2 = h - k;
  const float2 sk = spec_of(k, r2c_unpack_one(za, zm, __ldg(tw + k)));
  if (k2 == k) {
    gk = c2r_combine(__ldg(ab + k), sk, sk);
    return;
  }
  const float2 sm = spec_of(k2, r2c_unpack_one(zm, za, __ldg(tw + k2)));
  gk = c2r_combine(__ldg(ab + k), sk, sm);
  gm = c2r_combine(__ldg(ab + k2), sm, sk);
}

}  // namespace ndfft
