// The bts2 C2C of a column tile (kernel 7's; kernel 1's until it moved onto
// the radix column tile, fft_mid_radix.cu) and of a row tile (kernel 13's
// rows), each on the fixed core (F in {4, 8, 16}, bts2_core.cuh) and the
// wide core (every other F <= 160, bts2_wide.cuh). Kernels 7 and 13
// (fft_fourstep.cu) take the column and the row tile with a store of their
// own, so the kernels take the store as a struct Io:
//
//   column tile, x: (B, n, L):  io.store(b, k, col, v)  output k of column col
//   row tile,    x: (T, n):     io.store(r, k, v)       output k of row r
//
// The fixed row kernel's store loop walks the tile bin by bin (consecutive
// threads on consecutive rows of one bin), the order of kernel 13's
// transposed store.
#pragma once

#include "bts2_wide.cuh"

namespace ndfft {

// One block per (b, tile of C columns). The block reads its n x C tile of
// torch's interleaved complex64 straight into shared memory, runs the bts2
// core on it and stores it, so device memory is read once and written once.
// The last column tile may be ragged: loads past L read zeros and stores
// past L are masked.
template <int F, int C, class Io>
__global__ void __launch_bounds__(kThreads)
c2c_axis_mid_kernel(const float2* __restrict__ x, Io io, const float2* __restrict__ wq,
                    float sign, long long L, long long tiles) {
  constexpr int N = F * kM;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  const float2* xb = x + bb * N * L + col0;
  fixed_fill<C>(s, N, valid, [&](int t, int c) { return xb[t * L + c]; });
  __syncthreads();
  Bts2<F, C, false>::run(s, wq, sign);
  for (int idx = threadIdx.x; idx < N * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c < valid) io.store(bb, k, col0 + c, s[idx]);
  }
}

// The same on the wide core: one block per (b, tile of at most C columns),
// the L columns spread evenly over the tiles (L = 385 on axis 1 of the 768^3
// step: 49 tiles of 7 or 8 columns, no one-column tail tile). The core hands
// each output to the store.
template <int C, class Io>
__global__ void __launch_bounds__(kThreads)
c2c_axis_mid_wide_kernel(const float2* __restrict__ x, Io io, const float2* __restrict__ wq,
                         const float2* __restrict__ wf, int F, long long L, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, n, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float2* xb = x + bb * n * L + col0;
  for (int idx = threadIdx.x; idx < n * C; idx += kThreads) {
    const int t = idx / C;
    const int c = idx % C;
    if (c < valid) sm.s[idx] = xb[t * L + c];
  }
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  Bts2Wide<C, false>{n, F}.run(sm.s, sm.ys, sm.wt, wq, valid,
                               [=](int c, long long k, float2 z) { io.store(bb, k, col0 + c, z); });
}

// R consecutive rows of (T, n) are one contiguous float2 copy into shared
// memory; the fixed core runs in its row layout. The last block's rows are
// ragged when T % R != 0: loads past T read zeros and stores past T are
// masked.
template <int F, int R, class Io>
__global__ void __launch_bounds__(kThreads)
c2c_rows_kernel(const float2* __restrict__ x, Io io, const float2* __restrict__ wq, long long T,
                float sign) {
  constexpr int N = F * kM;
  extern __shared__ float2 s[];
  const long long row0 = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, T - row0);
  const float2* xb = x + row0 * N;
  for (int idx = threadIdx.x; idx < R * N; idx += kThreads)
    s[idx] = idx < valid * N ? xb[idx] : make_float2(0.f, 0.f);
  __syncthreads();
  Bts2<F, R, true>::run(s, wq, sign);
  for (int idx = threadIdx.x; idx < valid * N; idx += kThreads) {
    const int i = idx % valid;
    const int k = idx / valid;
    io.store(row0 + i, k, s[i * N + k]);
  }
}

// The same on the wide core in its row layout: the T rows spread evenly over
// the tiles of at most C rows, each tile one contiguous copy into shared
// memory; the core hands each output to the store.
template <int C, class Io>
__global__ void __launch_bounds__(kThreads)
c2c_rows_wide_kernel(const float2* __restrict__ x, Io io, const float2* __restrict__ wq,
                     const float2* __restrict__ wf, int F, long long T, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, n, C);
  long long row0;
  int valid;
  wide_tile(T, tiles, blockIdx.x, row0, valid);
  const float2* xb = x + row0 * n;
  for (int idx = threadIdx.x; idx < valid * n; idx += kThreads) sm.s[idx] = xb[idx];
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  Bts2Wide<C, true>{n, F}.run(sm.s, sm.ys, sm.wt, wq, valid,
                              [=](int c, long long k, float2 z) { io.store(row0 + c, k, z); });
}

// The launchers. x: (B, n, L) or (T, n) complex64, contiguous; wq:
// (F, 128, 128) complex64, the scale folded in; wf: (F, F) complex64 DFT-F
// of the transform's sign (ops/hopper/fft.py::wide_consts). C (R): columns
// (rows) per block, a power of two whose tile fits: n * C <= 8192 on the
// fixed core, bts2_wide.cuh::wide_smem_bytes on the wide one. Each returns
// the cudaError_t of the launch.
template <class Io>
cudaError_t axis_mid_launch(const float2* x, Io io, const float2* wq, long long B, int n,
                            long long L, int C, int sign, cudaStream_t stream) {
  return fixed_dispatch<4>(n, C, [&](auto f, auto c) {
    constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
    return fixed_launch<kF, kC>(c2c_axis_mid_kernel<kF, kC, Io>, B, L, stream, x, io, wq,
                                sign < 0 ? -1.f : 1.f, L);
  });
}

template <class Io>
cudaError_t axis_mid_wide_launch(const float2* x, Io io, const float2* wq, const float2* wf,
                                 long long B, int n, long long L, int C, cudaStream_t stream) {
  return wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(c2c_axis_mid_wide_kernel<kC, Io>, n, B, L, stream, x, io, wq, wf,
                           n / kM, L);
  });
}

template <int F, int R, class Io>
cudaError_t rows_launch_fr(const float2* x, Io io, const float2* wq, long long T, float sign,
                           cudaStream_t stream) {
  if constexpr (F * kM * R > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const int smem = F * kM * R * (int)sizeof(float2);
    const long long blocks = (T + R - 1) / R;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(c2c_rows_kernel<F, R, Io>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    c2c_rows_kernel<F, R, Io><<<(unsigned)blocks, kThreads, smem, stream>>>(x, io, wq, T, sign);
    return cudaGetLastError();
  }
}

template <int F, class Io>
cudaError_t rows_launch_f(int R, const float2* x, Io io, const float2* wq, long long T,
                          float sign, cudaStream_t stream) {
  switch (R) {
    case 1: return rows_launch_fr<F, 1>(x, io, wq, T, sign, stream);
    case 2: return rows_launch_fr<F, 2>(x, io, wq, T, sign, stream);
    case 4: return rows_launch_fr<F, 4>(x, io, wq, T, sign, stream);
    case 8: return rows_launch_fr<F, 8>(x, io, wq, T, sign, stream);
    case 16: return rows_launch_fr<F, 16>(x, io, wq, T, sign, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class Io>
cudaError_t rows_launch(const float2* x, Io io, const float2* wq, long long T, int n, int R,
                        int sign, cudaStream_t stream) {
  const float sg = sign < 0 ? -1.f : 1.f;
  if (T < 1) return cudaErrorInvalidValue;
  switch (n) {
    case 4 * kM: return rows_launch_f<4>(R, x, io, wq, T, sg, stream);
    case 8 * kM: return rows_launch_f<8>(R, x, io, wq, T, sg, stream);
    case 16 * kM: return rows_launch_f<16>(R, x, io, wq, T, sg, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class Io>
cudaError_t rows_wide_launch(const float2* x, Io io, const float2* wq, const float2* wf,
                             long long T, int n, int C, cudaStream_t stream) {
  return wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(c2c_rows_wide_kernel<kC, Io>, n, 1, T, stream, x, io, wq, wf, n / kM,
                           T);
  });
}

}  // namespace ndfft
