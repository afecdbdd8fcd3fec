// The chirp-z skeleton on the mixed-radix core's column tile
// (fft_radix.cuh): kernel 11's blue_radix_kernel, templated on a load
// policy and a store, which fft_blue_radix.cu (kernel 11's C2C, kernel 20's
// real-input R2C), rfft_blue_radix.cu (kernel 21's C2R, kernel 15's rows)
// and dct_blue_radix.cu (kernel 12's real-to-real chirp-z, its own exit
// table in its store) instantiate; the design and what bounds it are
// described there.
// For each column of an (M, C) tile in shared memory: the chirp length n's
// input u = x a zero-padded to M, FFT_M(u) times H, the inverse as
// conj(FFT_M(conj V)) with the one sign -1 radix table of M, and the
// store of conj(.) times the scale and the exit chirp a (the Out
// policy's epilogue).
#pragma once

#include "fft_radix.cuh"

namespace ndfft {

// Both transforms leave their spectrum in the tile as it is (the product
// with H is a pass of its own: folded into the last stage's write-back, its
// loads doubled ptxas's spill at 16 elements a thread).
struct BlueTile {
  static constexpr bool kTileOut = true;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
};

// One block per (b, tile of at most C columns), the L columns spread evenly
// over the `tiles` tiles; tr = ceil(M / kE) threads per column, thread
// c + C t taking column c's place t. The load policy gives the chirp
// length n of each column (ld.base(b, col), ld.at(p, r), r < n) and the Out
// its store (out.handle(b, col), out.epilogue); column col0 + c's handle is
// the policy's handle of col0 plus c. A load policy with a
// prologue (fft_radix.cuh::RxPrologue; kernel 21's chirp-z) loads the
// column as it is, its side slot (kSide: element n) after the coefficient
// rows, and behind the load's barrier its prologue(s, side, cx, a) makes
// the tile's rows r < n the chirp-z's input times the entry chirp a;
// without one the load multiplies by a itself.
template <int kE, class Load, class Out>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
blue_radix_kernel(Load ld, Out out, const float2* __restrict__ a, const float2* __restrict__ h,
                  const float2* __restrict__ tab, RadixPlan plan, int n, int M, long long L,
                  long long tiles, int C, float scale) {
  extern __shared__ float2 smem[];
  const long long bb = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long col0 = tile * L / tiles;
  const int valid = (int)((tile + 1) * L / tiles - col0);
  const long long base = ld.base(bb, col0);
  const long long yb = out.handle(bb, col0);
  const int tr = (M + kE - 1) / kE;
  const int cshift = 31 - __clz(C);   // C is a power of two: no division per element
  const int t = (int)threadIdx.x >> cshift, c = (int)threadIdx.x & (C - 1);
  const RadixCtx<ColLayout> cx{M, tr, t, ColLayout{c, C}, c < valid && t < tr, yb + c};
  float2* s = smem;
  float2* cs = smem + cx_tile_slots(M * C);
  int count[8];
  radix_prepare(count, cs, tab, plan, M);
  // the chirped columns and the zero pad, tile element e = (r, cc) at
  // e = r C + cc, four loads in flight a thread
  constexpr int kLoads = 4;
  const int elems = M * C;
  for (int e0 = threadIdx.x; e0 < elems; e0 += kLoads * blockDim.x) {
    float2 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, r = e >> cshift, cc = e & (C - 1);
      v[u] = make_float2(0.f, 0.f);
      if (e < elems && r < n && cc < valid) v[u] = ld.at(base + cc, r);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, r = e >> cshift;
      if constexpr (RxPrologue<Load>::value) {
        if (e < elems) s[cx_slot(e)] = v[u];
      } else {
        if (e < elems) s[cx_slot(e)] = r < n ? cmul(v[u], __ldg(a + r)) : v[u];
      }
    }
  }
  if constexpr (RxPrologue<Load>::value) {
    float2* side = cs + rx_coef_count(plan);
    if constexpr (RxSide<Load>::value > 0) {
      static_assert(RxSide<Load>::value == 1, "one side slot a column");
      for (int cc = threadIdx.x; cc < C; cc += blockDim.x)
        side[cc] = cc < valid ? ld.at(base + cc, n) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    ld.prologue(s, side + c, cx, a);
  }
  __syncthreads();
  radix_run<kE, -1>(s, tab, cs, count, plan, cx, BlueTile{}, 1.f);
  // conj(FFT_M(u)[k] H[k]) in place: the second transform's input
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const float2 w = cmul(s[cx_slot(e)], __ldg(h + (e >> cshift)));
    s[cx_slot(e)] = make_float2(w.x, -w.y);
  }
  __syncthreads();
  radix_run<kE, -1>(s, tab, cs, count, plan, cx, BlueTile{}, 1.f);
  // conj(FFT_M(conj V)) times the scale and the exit chirp, stored
  out.epilogue(s, cx, yb, valid, cshift, a, scale);
}

template <int kE, class Load, class Out>
cudaError_t blue_radix_launch(Load ld, Out out, const float2* a, const float2* h,
                              const float2* tab, const RadixPlan& plan, long long B, int n,
                              int M, long long L, int C, float scale, cudaStream_t stream) {
  const int tr = (M + kE - 1) / kE;
  const int threads = (C * tr + 31) / 32 * 32;
  const long long smem =
      (long long)(cx_tile_slots(M * C) + rx_coef_count(plan) + RxSide<Load>::value * C) *
      sizeof(float2);
  const long long tiles = (L + C - 1) / C;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || B * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(blue_radix_kernel<kE, Load, Out>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  blue_radix_kernel<kE, Load, Out><<<(unsigned)(B * tiles), threads, (size_t)smem, stream>>>(
      ld, out, a, h, tab, plan, n, M, L, tiles, C, scale);
  return cudaGetLastError();
}

// The launcher at chirp length n and convolution length M: 16, 32 or 40
// elements a thread by the tile's M C elements.
template <class Load, class Out>
cudaError_t blue_radix_dispatch(Load ld, Out out, const float2* a, const float2* h,
                                const float2* tab, const RadixPlan& plan, long long B, int n,
                                int M, long long L, int C, float scale, cudaStream_t stream) {
  const int e = radix_per_thread(M * C);
  return e == 40 ? blue_radix_launch<40>(ld, out, a, h, tab, plan, B, n, M, L, C, scale, stream)
       : e == 32 ? blue_radix_launch<32>(ld, out, a, h, tab, plan, B, n, M, L, C, scale, stream)
                 : blue_radix_launch<16>(ld, out, a, h, tab, plan, B, n, M, L, C, scale, stream);
}

// The checks every entry shares: B L columns, C a power of two up to
// kRadixMaxCols with M C <= 20480, 2 n - 1 <= M, and the plan of M.
inline bool blue_radix_args(const int* radices, int stages, long long B, int n, int M,
                            long long L, int C, RadixPlan& plan) {
  return B >= 1 && L >= 1 && n >= 1 && 2 * n - 1 <= M && C >= 1 && C <= kRadixMaxCols &&
         !(C & (C - 1)) && (long long)M * C <= 20480 && radix_plan_of(radices, stages, M, plan);
}

}  // namespace ndfft
