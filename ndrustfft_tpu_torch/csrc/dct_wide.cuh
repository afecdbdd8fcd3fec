// DCT-II and DCT-III on the wide core (bts2_wide.cuh), in both of its tile
// layouts: contiguous (T, n) rows (kernels 23 and 24, csrc/dct_nat.cu) and
// the middle axis of (B, n, L) (kernels 25 and 26, csrc/dct_mid.cu). Each
// computes the rustdct convention times a scale s, in one of two forms:
//
// * The half-length form, even n = 2h with h = 128 * F (the Makhoul passes
//   of dct_nat.cu around the half-length real FFT of kernels 2/3 and 16/17):
//     DCT-II:  z[t] = v[2t] + i v[2t+1] with the Makhoul order
//              v = [x0, x2, .., x_{n-2}, x_{n-1}, .., x3, x1], read straight
//              from device memory (rows 4t, 4t + 2 for t < h/2, rows
//              2n - 1 - 4t, 2n - 3 - 4t above); Z = FFT_h(z);
//              V[k] = (Z[k] + conj Z[-k]) / 2 - i W_n^k (Z[k] - conj Z[-k]) / 2;
//              y[k] = Re(P[k] V[k]), y[n-k] = Re(P[n-k] conj V[k]),
//              P[k] = s e^{-i pi k / 2n}.
//     DCT-III: S[k] = Q[k] (x[k] - i x[n-k]), Q[k] = (s/2) e^{+i pi k / 2n},
//              x[n] := 0, for k = 0 .. h; G[k] = A[k] S[k] + B[k] conj S[h-k]
//              (kernel 3's pre-pass, DC and Nyquist imaginary parts 0);
//              u = IFFT_h(G) read as a real row (u[2l] = Re z[l],
//              u[2l+1] = Im z[l]); y[2t] = u[t], y[2t+1] = u[n-1-t].
// * The n-point form, n = 128 * F with odd F <= 255 (h = n/2 is not
//   128 * F), which is what the TPU kernels compute at every n
//   (dct.py::_real_ts_core_x2):
//     DCT-II:  Z = FFT_n(v) of the real Makhoul row v; y[k] = Re(P[k] Z[k]).
//     DCT-III: Z = FFT_n(w), w[t] = s c[t] e^{-i pi t / 2n}, c = x with x0
//              halved; u = Re Z; y[2t] = u[t], y[2t+1] = u[n-1-t]
//              (u[t] = sum_j c[j] cos(pi j (4t + 1) / 2n)).
//   Both inputs are real, so the tile holds floats (bts2_wide.cuh's real
//   tile: 4 n bytes, 131 KB at n = 32640, where a complex tile of 261 KB
//   would not fit a block): the DCT-II's v (RealIn), the DCT-III's c, whose
//   twiddle is separable over t = a * 128 + b, e^{-i pi t / 2n} =
//   e^{-i pi a / 2F} e^{-i pi b / 2n}: the a factor multiplies each element
//   in stage 1 from a row in shared memory, the b factor (with s) multiplies
//   Y[q][b] (ChirpIn), as the TPU kernel folds its pre_a and pre_b
//   (dct.py::_build_dct3). Not taken: Z[n - k] = conj Z[k] for the real
//   input would let stage 2 compute k <= n/2 only and halve its MACs and Wq
//   reads; each output k here is one (q, p') item of the core, and the
//   halving needs a store that writes k and n - k from one item.
//
// The wide core writes every output straight to device memory, so no
// transform holds its whole spectrum in shared memory afterwards. Three of
// the four epilogues need none: each n-point output and each DCT-III u[j]
// goes to one known position (the core's store callback does the post
// twiddle or the interleave y[2t] = u[t], y[2t+1] = u[n-1-t] on the fly). The
// half-length DCT-II needs Z[k] and Z[h-k] together; the core stores Re Z[k]
// at position k and Im Z[k] at k + h of the transform's own output, and
// after its closing block barrier each thread takes one mirror pair
// {k, h - k}: it reads positions {k, k + h, h - k, 2h - k} and writes
// y[k], y[n-k], y[h-k], y[h+k], the same four positions, so the pass runs in
// place (dct2_unpack below); the reread was written by this block a moment
// before and L2 serves it.
//
// What bounds them: the wide core's stage 2 on the FP32 CUDA cores
// (bts2_wide.cuh); the n-point form runs a core twice as long as the
// half-length one (2 F instead of F planes of the same 128-point product).
// The Makhoul read of the half-length DCT-II takes two 4-byte loads per
// element at a 16-byte stride in the row layout (L1 merges them), and the
// column layout's loads and stores are whole rows. Every constant comes from
// the host (ops/hopper/dct.py).
#pragma once

#include "bts2_wide.cuh"

namespace ndfft {

// The transforms of one tile of a wide block: transform c of the tile
// starts at off + c * cs and its element t lies ks further on per step.
// kRows: (T, n) rows, the T = L transforms spread over the tiles; else the
// middle axis of (B, n, L), blockIdx.x = b * tiles + tile.
template <bool kRows>
struct DctTile {
  long long off, cs, ks;
  int V;
  __device__ DctTile(int n, long long L, long long tiles) {
    long long first;
    if (kRows) {
      wide_tile(L, tiles, blockIdx.x, first, V);
      off = first * n;
      cs = n;
      ks = 1;
    } else {
      wide_tile(L, tiles, blockIdx.x % tiles, first, V);
      off = (long long)(blockIdx.x / tiles) * n * L + first;
      cs = 1;
      ks = L;
    }
  }
};

// Position of the Makhoul input v[p] in x: 2p for p < n/2, 2n - 1 - 2p above.
__device__ __forceinline__ int makhoul_src(int p, int n) {
  return 2 * p < n ? 2 * p : 2 * n - 1 - 2 * p;
}

// Position of the DCT-III output fed by u[j]: y[2j] for j < n/2 (even
// outputs), y[2n - 1 - 2j] above (odd outputs, reversed).
__device__ __forceinline__ long long interleave_dst(long long j, int n) {
  return 2 * j < n ? 2 * j : 2LL * n - 1 - 2 * j;
}

// The half-length DCT-II's unpack and post twiddle in place over the V
// transforms of a tile, behind a barrier that follows the core's stores
// (Re Z[k] at position k, Im Z[k] at k + h of each transform).
template <bool kRows>
__device__ __forceinline__ void dct2_unpack(float* y, int h, const DctTile<kRows>& tl,
                                            const float2* __restrict__ tw,
                                            const float2* __restrict__ post) {
  const int n = 2 * h, pairs = h / 2 + 1;
  const long long ks = tl.ks;
  for (int idx = threadIdx.x; idx < pairs * tl.V; idx += blockDim.x) {
    float* yc = y + (kRows ? idx / pairs : idx % tl.V) * tl.cs;
    const int k = kRows ? idx % pairs : idx / tl.V;
    const int k2 = (h - k) % h;
    const float2 za = make_float2(yc[k * ks], yc[(k + h) * ks]);
    const float2 zb = make_float2(yc[k2 * ks], yc[(k2 + h) * ks]);
    if (k == 0) {   // V[0] = Re Z0 + Im Z0 and V[h] = Re Z0 - Im Z0 are real
      yc[0] = __ldg(post).x * (za.x + za.y);
      yc[h * ks] = __ldg(post + h).x * (za.x - za.y);
      continue;
    }
    // y[j] = Re(P[j] V[j]) and y[n - j] = Re(P[n - j] conj V[j])
    const auto out = [&](int j, float2 v) {
      const float2 p = __ldg(post + j);
      const float2 pm = __ldg(post + n - j);
      yc[j * ks] = p.x * v.x - p.y * v.y;
      yc[(n - j) * ks] = pm.x * v.x + pm.y * v.y;
    };
    out(k, r2c_unpack_one(za, zb, __ldg(tw + k)));
    if (k2 != k) out(k2, r2c_unpack_one(zb, za, __ldg(tw + k2)));
  }
}

// Half-length DCT-II, h = 128 * F. tw: (h,) W_n^k; post: (n,) P[k].
template <int C, bool kRows>
__global__ void __launch_bounds__(kThreads)
dct2_wide_kernel(const float* __restrict__ x, float* y, const float2* __restrict__ wq,
                 const float2* __restrict__ wf, const float2* __restrict__ tw,
                 const float2* __restrict__ post, int F, long long L, long long tiles) {
  const int h = F * kM, n = 2 * h;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, h, C);
  const DctTile<kRows> tl(n, L, tiles);
  const float* xb = x + tl.off;
  wide_fill<C, kRows>(sm.s, h, tl.V, [&](int t, int c) {
    const float* xc = xb + c * tl.cs;
    return make_float2(xc[makhoul_src(2 * t, n) * tl.ks], xc[makhoul_src(2 * t + 1, n) * tl.ks]);
  });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float* yb = y + tl.off;
  const long long cs = tl.cs, ks = tl.ks;
  // ends with a barrier: Z of every transform of the tile is in device memory
  Bts2Wide<C, kRows>{h, F}.run(sm.s, sm.ys, sm.wt, wq, tl.V, [=](int c, long long k, float2 z) {
    yb[c * cs + k * ks] = z.x;
    yb[c * cs + (k + h) * ks] = z.y;
  });
  dct2_unpack<kRows>(yb, h, tl, tw, post);
}

// Half-length DCT-III, h = 128 * F. ab: (h, 4) kernel-3 rows, scale 1;
// pre: (h + 1,) Q[k].
template <int C, bool kRows>
__global__ void __launch_bounds__(kThreads)
dct3_wide_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const float2* __restrict__ wq, const float2* __restrict__ wf,
                 const float4* __restrict__ ab, const float2* __restrict__ pre, int F, long long L,
                 long long tiles) {
  const int h = F * kM, n = 2 * h;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, h, C);
  const DctTile<kRows> tl(n, L, tiles);
  const float* xb = x + tl.off;
  wide_fill<C, kRows>(sm.s, h, tl.V, [&](int k, int c) {
    const float* xc = xb + c * tl.cs;
    const auto spec = [&](int j) {   // S[j] = Q[j] (x[j] - i x[n - j]), x[n] = 0
      const float a = xc[j * tl.ks];
      const float b = j == 0 ? 0.f : xc[(n - j) * tl.ks];
      const float2 q = __ldg(pre + j);
      return make_float2(a * q.x + b * q.y, a * q.y - b * q.x);
    };
    float2 sk = spec(k);
    float2 sm_ = spec(h - k);
    if (k == 0) {   // S[0] and S[h] are real; drop their rounding residue
      sk.y = 0.f;
      sm_.y = 0.f;
    }
    const float4 cf = __ldg(ab + k);   // (A.re, A.im, B.re, B.im)
    return make_float2(cf.x * sk.x - cf.y * sk.y + cf.z * sm_.x + cf.w * sm_.y,
                       cf.x * sk.y + cf.y * sk.x + cf.w * sm_.x - cf.z * sm_.y);
  });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float* yb = y + tl.off;
  const long long cs = tl.cs, ks = tl.ks;
  Bts2Wide<C, kRows>{h, F}.run(sm.s, sm.ys, sm.wt, wq, tl.V, [=](int c, long long l, float2 z) {
    yb[c * cs + interleave_dst(2 * l, n) * ks] = z.x;       // u[2l]
    yb[c * cs + interleave_dst(2 * l + 1, n) * ks] = z.y;   // u[2l + 1]
  });
}

// n-point DCT-II, n = 128 * F, on the real tile. post: (n,) P[k].
template <int C, bool kRows>
__global__ void __launch_bounds__(kThreads)
dct2_npoint_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const float2* __restrict__ wq, const float2* __restrict__ wf,
                   const float2* __restrict__ post, int F, long long L, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideRealSmem sm(smem, n, C);
  const DctTile<kRows> tl(n, L, tiles);
  const float* xb = x + tl.off;
  wide_fill<C, kRows>(sm.s, n, tl.V,
                      [&](int t, int c) { return xb[c * tl.cs + makhoul_src(t, n) * tl.ks]; });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float* yb = y + tl.off;
  const long long cs = tl.cs, ks = tl.ks;
  Bts2Wide<C, kRows, RealIn>{n, F}.run(sm.s, sm.ys, sm.wt, wq, tl.V,
                                       [=](int c, long long k, float2 z) {
    const float2 p = __ldg(post + k);
    yb[c * cs + k * ks] = p.x * z.x - p.y * z.y;
  });
}

// The n-point DCT-III's tile: c = x with x0 halved, then the core on it
// times the chirp (npoint_chirp: wa, then wb with the scale). The caller
// has loaded the row W_F^k; the fill ends with a barrier.
template <int C, bool kRows, class Store>
__device__ __forceinline__ void dct3_npoint_core(const WideRealSmem& sm, const float* xb,
                                                 const DctTile<kRows>& tl, int F,
                                                 const float2* __restrict__ wq,
                                                 const float2* __restrict__ chirp,
                                                 Store&& store) {
  const int n = F * kM;
  wide_fill<C, kRows>(sm.s, n, tl.V, [&](int t, int c) {
    const float v = xb[c * tl.cs + t * tl.ks];
    return t == 0 ? 0.5f * v : v;
  });
  wide_load_chirp(sm.wa, chirp, F);
  __syncthreads();
  Bts2Wide<C, kRows, ChirpIn>{n, F, ChirpIn{sm.wa, chirp + F}}.run(sm.s, sm.ys, sm.wt, wq, tl.V,
                                                                   store);
}

// n-point DCT-III, n = 128 * F, on the real tile. chirp: (F + 128,)
// e^{-i pi a / 2F} (a < F), then s e^{-i pi b / 2n} (b < 128).
template <int C, bool kRows>
__global__ void __launch_bounds__(kThreads)
dct3_npoint_kernel(const float* __restrict__ x, float* __restrict__ y,
                   const float2* __restrict__ wq, const float2* __restrict__ wf,
                   const float2* __restrict__ chirp, int F, long long L, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideRealSmem sm(smem, n, C);
  const DctTile<kRows> tl(n, L, tiles);
  wide_load_row(sm.wt, wf, F);
  float* yb = y + tl.off;
  const long long cs = tl.cs, ks = tl.ks;
  dct3_npoint_core<C, kRows>(sm, x + tl.off, tl, F, wq, chirp, [=](int c, long long k, float2 z) {
    yb[c * cs + interleave_dst(k, n) * ks] = z.x;
  });
}

// Launch one of the four kernels above on `groups` x `total` transforms of
// length n (rows: groups = 1, total = T; middle axis: groups = B, total = L)
// with C transforms per tile. type3 picks DCT-III; npoint the n-point form
// (c1 unused; c2 = post or the n-point chirp), else the half-length form
// (c1 = tw or ab, c2 = post or pre). Returns the cudaError_t of the launch.
template <bool kRows>
static int dct_wide_launch(bool type3, bool npoint, const void* x, void* y, const void* wq,
                           const void* wf, const void* c1, const void* c2, long long groups,
                           int n, long long total, int C, void* stream) {
  const int core = npoint ? n : n / 2;   // the length of the wide core's transform
  if (n % (npoint ? kM : 2 * kM)) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const float2* wqp = static_cast<const float2*>(wq);
  const float2* wfp = static_cast<const float2*>(wf);
  const float2* c2p = static_cast<const float2*>(c2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int F = core / kM;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    if (npoint)
      return type3 ? wide_launch_real<kC>(dct3_npoint_kernel<kC, kRows>, core, groups, total, st,
                                          xp, yp, wqp, wfp, c2p, F, total)
                   : wide_launch_real<kC>(dct2_npoint_kernel<kC, kRows>, core, groups, total, st,
                                          xp, yp, wqp, wfp, c2p, F, total);
    return type3 ? wide_launch<kC>(dct3_wide_kernel<kC, kRows>, core, groups, total, st, xp, yp,
                                   wqp, wfp, static_cast<const float4*>(c1), c2p, F, total)
                 : wide_launch<kC>(dct2_wide_kernel<kC, kRows>, core, groups, total, st, xp, yp,
                                   wqp, wfp, static_cast<const float2*>(c1), c2p, F, total);
  });
}

}  // namespace ndfft
