// The Makhoul passes of the DCT-II and DCT-III along a middle axis as load
// policies and epilogues of the mixed-radix core's column tile
// (fft_radix.cuh::radix_cols_kernel): kernel 27 and kernels 25 and 26 run
// them around one half-length transform (dct_mid_radix.cu, whose header has
// the design), kernel 29 runs the DCT-II's load and the DCT-III's epilogue
// around its forward transform, its pair pass and its inverse
// (spectral_dct_radix.cu). The index maps makhoul_src and interleave_dst
// are dct_wide.cuh's.
#pragma once

#include "dct_wide.cuh"
#include "fft_radix.cuh"

namespace ndfft {

// DCT-II's columns: element t < h of column col of b as the Makhoul pair
// (x[src(2t)], x[src(2t + 1)]) of x (B, n, L), loaded evict-first or (kLdg)
// through the read-only path, which keeps each 32-byte sector in L2 for
// the neighbouring tiles where a tile row is one or two floats (kernel 25
// at C <= 2, as kernel 1).
template <bool kLdg = false>
struct MakhoulCol {
  const float* __restrict__ x;
  long long L;
  int n;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float ld(const float* q) const {
    return kLdg ? __ldg(q) : __ldcs(q);
  }
  __device__ __forceinline__ float2 at(long long p, int t) const {
    return make_float2(ld(x + p + makhoul_src(2 * t, n) * L),
                       ld(x + p + makhoul_src(2 * t + 1, n) * L));
  }
};

// DCT-II's epilogue: the tile holds Z; y[k] = Re(P[k] X[k]) and, for
// 0 < k < h, y[n - k] = -Im(P[k] X[k]), into y (B, n, L).
struct Dct2Rows {
  static constexpr bool kTileOut = true;
  float* __restrict__ y;
  const float2* __restrict__ u;      // W_n^k, k < h
  const float2* __restrict__ post;   // P[k], k <= h
  long long L;
  int n;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    float* yc = y + cx.row;
    const long long ls = L;
    const int nn = n, h = n / 2;
    const float2* __restrict__ pp = post;
    r2c_unpack_tile(s, cx, u, [=](int k, float2 v) {
      const float2 p = __ldg(pp + k);
      yc[k * ls] = v.x * p.x - v.y * p.y;
      if (k > 0 && k < h) yc[(nn - k) * ls] = -(v.x * p.y + v.y * p.x);
    });
  }
};

// DCT-III's columns: S[k] = Q[k] (x[k] - i x[n - k]) of x (B, n, L) with
// x[n] = 0, rows k < h into the tile and k = h into the side slot, loaded
// evict-first or (kLdg) through the read-only path, as MakhoulCol; the
// prologue is the inverse unpack with the ab rows.
template <bool kLdg = false>
struct Dct3Col {
  static constexpr int kSide = 1;
  const float* __restrict__ x;
  const float2* __restrict__ q;      // Q[k], k <= h
  const float4* __restrict__ ab;
  long long L;
  int n;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float ld(const float* p) const {
    return kLdg ? __ldg(p) : __ldcs(p);
  }
  __device__ __forceinline__ float2 at(long long p, int k) const {
    const float a = ld(x + p + k * L);
    const float b = k ? ld(x + p + (n - k) * L) : 0.f;
    const float2 w = __ldg(q + k);
    return make_float2(w.x * a + w.y * b, w.y * a - w.x * b);
  }
  template <class Cx>
  __device__ __forceinline__ void prologue(float2* s, const float2* side, const Cx& cx) const {
    c2r_prologue_tile(s, side, cx, ab);
  }
};

// DCT-III's epilogue: the tile holds z (kConj: conj z, kernel 29's inverse
// as the conjugate of the forward transform); u[2l] = Re z[l] and
// u[2l + 1] = Im z[l] go to y[interleave_dst(j)] of y (B, n, L).
template <bool kConj = false>
struct Dct3Rows {
  static constexpr bool kTileOut = true;
  float* __restrict__ y;
  long long L;
  int n;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    for (int l = cx.t; l < cx.n; l += cx.tr) {
      const float2 v = s[cx.slot(l)];
      y[cx.row + interleave_dst(2 * l, n) * L] = v.x;
      y[cx.row + interleave_dst(2 * l + 1, n) * L] = kConj ? -v.y : v.y;
    }
  }
};

}  // namespace ndfft
