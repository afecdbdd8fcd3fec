// What the fused spectral pipelines share (kernels 14, 22 and 29:
// spectral_c2c_radix.cu, spectral_r2c_radix.cu, spectral_dct_radix.cu and
// spectral_dct_mid.cu): the diagonal multiplier H between the forward and
// the inverse transform, kernel 22's and kernel 29's pair passes, and the
// radix column tile's transform of kernels 14 and 22.
//
// Each of those kernels runs a forward transform, the multiply and the
// inverse transform on one column tile without writing the spectrum to
// device memory: on the radix column tile (kernels 14 and 22 at every
// length, kernel 29 where its half length has a radix plan) the tile stays
// in shared memory and both transforms run in place, the inverse on the
// sign +1 table (kernels 14 and 22) or as conj(FFT(conj V)) with the
// forward table (kernel 29). Kernel 29's remnant on the wide
// core (spectral_dct_mid.cu) writes every output straight to device memory
// and reads its whole tile while it does, so it cannot work in place: there
// the forward core writes the intermediate into the block's own columns of
// the output (the half-length spectrum's h complex values in 2h floats, or
// the n real DCT-II values times H in the n-point form), and after the
// core's closing block barrier the block reads it back into the tile for
// the inverse core.
#pragma once

#include "bts2_wide.cuh"
#include "fft_radix.cuh"

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

// Kernel 22's pair pass: G[k] (gk) and G[h - k] (gm, for 0 < k < h/2) from
// za = Z[k] and zm = Z[(h - k) mod h] of column col, k <= h/2, Z the
// half-length spectrum of z[t] = x[2t] + i x[2t + 1]:
//   X[k] = the R2C unpack of Z[k] and Z[h - k] (r2c_unpack_one),
//   S[k] = H[k] X[k],  Im S[0] := 0,  S[h] = Re H[h] X[h] (X[h] real),
//   G[k] = A[k] S[k] + B[k] conj S[h - k]  (kernel 17's inverse unpack),
// the DC and Nyquist rules of the TPU kernel's mask and Nyquist row
// (ndrustfft_tpu/ops/pallas/rfft.py:1060-1063). k = 0 carries X[0] and the
// Nyquist X[h], both from Z[0], and gives G[0] alone; k = h/2 is its own
// mirror. tw: (h,) W_n^k; ab: (h, 4) (A.re, A.im, B.re, B.im) with the scale.
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

// Kernels 14 and 22 on the radix column tile: both transforms leave their
// outputs in the tile as they are.
struct SpecTile {
  static constexpr bool kTileOut = true;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
};

// One transform of sign kS (the radix table tab of that sign, its prime
// stages' coefficient rows cs) of every valid column of the tile, left in
// the tile behind its barrier. Out of line, so that the second transform's
// registers do not stack on the first's (kernel 29's spectral_dct_fft):
// kernels 14 and 22 call the sign -1 copy for the forward transform and
// the sign +1 copy for the inverse, each once; a copy called twice (a
// conjugate inverse on the forward table) spilled about ten times as much
// (spectral_c2c_radix.cu).
template <int kE, int kS, class Cx>
__device__ __noinline__ void spectral_fft(float2* s, const float2* __restrict__ tab,
                                          const float2* cs, const int (&count)[8],
                                          const RadixPlan& plan, Cx cx) {
  radix_run<kE, kS>(s, tab, cs, count, plan, cx, SpecTile{}, 1.f);
}

// Shared memory of a kernel 14 or 22 tile of `elems` elements: the tile and
// the forward and inverse tables' coefficient rows.
inline long long spectral_smem_bytes(int elems, const RadixPlan& plan) {
  return (long long)(cx_tile_slots(elems) + 2 * rx_coef_count(plan)) * sizeof(float2);
}

// A pass over the tile's elements e = r C + cc (row r, column cc < valid;
// C = 2^cshift) in the column skeletons' load order: consecutive threads on
// consecutive columns of a row, four elements a thread in flight. get(r, cc,
// slot) for the four, then put(r, cc, slot, value) for each, so that the
// four reads (of device memory, or of the tile) are all issued before the
// first value is used.
template <class Get, class Put>
__device__ __forceinline__ void tile_pass(int elems, int cshift, int valid, Get&& get,
                                          Put&& put) {
  constexpr int kInFlight = 4;
  const int cmask = (1 << cshift) - 1;
  for (int e0 = threadIdx.x; e0 < elems; e0 += kInFlight * blockDim.x) {
    decltype(get(0, 0, 0)) v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < elems && (e & cmask) < valid) v[u] = get(e >> cshift, e & cmask, cx_slot(e));
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < elems && (e & cmask) < valid) put(e >> cshift, e & cmask, cx_slot(e), v[u]);
    }
  }
}

}  // namespace ndfft
