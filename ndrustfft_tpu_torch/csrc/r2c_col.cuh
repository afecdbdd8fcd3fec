// The R2C of each column of a column tile on the bts2 cores, kernel 19's
// (dct1_mid.cu) alone since kernels 16 and 18 moved onto the radix column
// tile (rfft_mid_radix.cu); the kernel loads the half-length column z and
// stores the spectrum X through its Io:
//
//   z[t] = io.load(b, t, col),  t < h = 128 * F,
//   Z = FFT_h(z) on the fixed core (bts2_core.cuh) or the wide one
//       (bts2_wide.cuh),
//   X[k] = scale * ((Z[k] + C[k]) / 2 - i W_2h^k (Z[k] - C[k]) / 2),  k < h,
//   X[h] = scale * (Re Z[0] - Im Z[0]),  C[k] = conj Z[(h - k) mod h],
//   io.store(b, k, col, X[k]),  k <= h,
//
// the scale folded into the unpack's 1/2 (bts2_core.cuh::r2c_unpack_one).
// On the fixed core the mirror Z[(h - k) mod h] is a shared-memory read. The
// wide core writes each output straight to device memory, so no column holds
// its whole Z in shared memory: it writes Z to io.z(b) (bin k of column col
// at io.z(b)[k * L + col]: the output's own rows where they hold 2h floats,
// a workspace where they do not), and after its closing block barrier each
// thread reads one mirror pair {k, h - k} of one column and stores both X
// (bts2_core.cuh::r2c_unpack; consecutive threads on consecutive columns, so
// the rows stay coalesced, and L2 serves the reread of rows this block wrote
// a moment before). Every constant comes from the host (ops/hopper/rfft.py).
#pragma once

#include "bts2_wide.cuh"

namespace ndfft {

// Two blocks per SM (two 64 KB tiles): at F = 2, C = 32 ptxas otherwise gave
// kernel 16 (when it ran here) 132 registers, which leaves one block per SM.
template <int F, int C, class Io>
__global__ void __launch_bounds__(kThreads, 2)
r2c_col_kernel(Io io, const float2* __restrict__ wq, const float2* __restrict__ tw, float scale,
               long long L, long long tiles) {
  constexpr int H = F * kM;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  fixed_fill<C>(s, H, valid, [&](int t, int c) { return io.load(bb, t, col0 + c); });
  __syncthreads();
  Bts2<F, C, false>::run(s, wq, -1.f);
  const float half = 0.5f * scale;
  for (int idx = threadIdx.x; idx < (H + 1) * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c >= valid) continue;
    float2 X;
    if (k == H) {
      const float2 z0 = s[c];
      X = make_float2(scale * (z0.x - z0.y), 0.f);
    } else {
      X = r2c_unpack_one(s[k * C + c], s[((H - k) % H) * C + c], __ldg(tw + k), half);
    }
    io.store(bb, k, col0 + c, X);
  }
}

template <int C, class Io>
__global__ void __launch_bounds__(kThreads)
r2c_col_wide_kernel(Io io, const float2* __restrict__ wq, const float2* __restrict__ wf,
                    const float2* __restrict__ tw, float scale, int F, long long L,
                    long long tiles) {
  const int H = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, H, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  wide_fill<C, false>(sm.s, H, valid, [&](int t, int c) { return io.load(bb, t, col0 + c); });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float2* zb = io.z(bb) + col0;
  // ends with a barrier: Z of every column of the tile is in device memory
  Bts2Wide<C, false>{H, F}.run(sm.s, sm.ys, sm.wt, wq, valid, zb, 1, L);
  r2c_unpack<true>(zb, H, valid, 1, L, tw, scale,
                   [&](int c, int k, float2 x) { io.store(bb, k, col0 + c, x); });
}

// The column R2C of B x L columns of half length h: on the fixed core for
// h = 128 * {2, 4, 8, 16} (wq: (F, 128, 128) complex64 for h, sign -1,
// unscaled; C: columns per block, a power of two with h * C <= 8192), else
// on the wide core (wf: the (F, F) DFT-F, sign -1; C a power of two <= 16
// whose tile fits, bts2_wide.cuh::wide_smem_bytes). tw: (h,) complex64
// W_2h^k. Returns the cudaError_t of the launch.
template <class Io>
cudaError_t r2c_col_launch(bool wide, Io io, int h, const void* wq, const void* wf,
                           const void* tw, float scale, long long B, long long L, int C,
                           void* stream) {
  const float2* wqp = static_cast<const float2*>(wq);
  const float2* twp = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!wide) {
    return fixed_dispatch<2>(h, C, [&](auto f, auto c) {
      constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
      return fixed_launch<kF, kC>(r2c_col_kernel<kF, kC, Io>, B, L, st, io, wqp, twp, scale, L);
    });
  }
  return wide_dispatch(C, [&](auto c) {
    constexpr int kC = decltype(c)::value;
    return wide_launch<kC>(r2c_col_wide_kernel<kC, Io>, h, B, L, st, io, wqp,
                           static_cast<const float2*>(wf), twp, scale, h / kM, L);
  });
}

}  // namespace ndfft
