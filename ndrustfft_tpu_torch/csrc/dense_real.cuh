// The register-tiled float32 product of the dense real kernels: kernel 27
// (dct_dense.cu) at DCT-IV, odd-n DCT-II/III, the lengths without a radix
// plan and the DCT-I lengths where ops/hopper/fft.py::dense_beats_radix
// holds, kernels 20 and 21 at the odd lengths where their routes name the
// dense product (rfft_dense.cu); at the other lengths and types kernels 20,
// 21 and 27 run on the radix column tile (rfft_mid_radix.cu,
// dct_mid_radix.cu) or, kernels 20 and 21, as a chirp-z
// (fft_blue_radix.cu). For each batch b,
//
//   Y(b, k, c) = sum_{t < red} W[t, k] * X(b, t, c),    k < rows, c < L,
//
// with W a (red, rows) float32 table in C order (w[t * rows + k]) built on the
// host in float64 and rounded once. X is read and Y written through an
// operand functor Op, so one loop serves kernel 27's square product on
// (B, n, L) float32 and the rectangular R2C/C2R products whose result or
// operand is torch's interleaved complex64. Op provides
//
//   __device__ float load(long long b, int t, long long c) const;   // X(b, t, c)
//   __device__ void store(long long b, int k, long long c, float v) const;
//
// and is called only in range (t < red, k < rows, c < L).
//
// What bounds it on this card: the product's 2 * red * rows FLOPs per column
// on the FP32 CUDA cores (67 TFLOP/s peak, data sheet, 700 W), far above
// its HBM traffic at every n the dense gates take. The product stays in
// float32 (no TF32, no bf16) to match the JAX package's "highest" tier. The
// design is the classic register-tiled SGEMM: a block owns a BM x BN output
// tile (BM = BN = 16 * TM) of one batch b, 256 threads each accumulate a
// TM x TM micro-tile with fmaf, and the reduction over t runs in chunks of 8
// staged in shared memory, double buffered through registers so that the
// next chunk's global loads overlap the current chunk's FMAs. n is odd on
// part of every dense path (the reference's 129 ... 1025 and 201, 265), so
// the reduction edge and both output edges are masked. W (<= 4.9 MB) streams
// through L2; the k-tiles of one column strip are consecutive blocks, so the
// strip of X is read from HBM once and then hit in L2. The 64 x 64 tile
// (TM = 4) serves grids that would leave SMs idle at 128 x 128.
#pragma once

#include <cuda_runtime.h>

namespace ndfft {

constexpr int kDenseThreads = 256;
constexpr int kBK = 8;   // reduction chunk staged in shared memory

template <int TM, class Op>
__global__ void __launch_bounds__(kDenseThreads)
dense_real_kernel(const float* __restrict__ w, Op op, int rows, int red,
                  long long L, long long B, int ktiles) {
  constexpr int BM = 16 * TM;              // output rows (k) and columns (c)
  constexpr int HALF = TM / 2;             // each thread: 2 x 2 groups of HALF
  constexpr int LPT = kBK * BM / kDenseThreads;  // tile loads per thread
  __shared__ __align__(16) float As[2][kBK][BM];
  __shared__ __align__(16) float Bs[2][kBK][BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = (int)(blockIdx.x % ktiles) * BM;
  const long long c0 = (long long)(blockIdx.x / ktiles) * BM;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    float ra[LPT], rb[LPT];
    auto load = [&](int t0) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const int e = i * kDenseThreads + tid;
        const int t = t0 + e / BM;
        const int cc = e % BM;
        ra[i] = (t < red && k0 + cc < rows) ? __ldg(w + (long long)t * rows + k0 + cc) : 0.f;
        const long long cb = c0 + cc;
        rb[i] = (t < red && cb < L) ? op.load(b, t, cb) : 0.f;
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const int e = i * kDenseThreads + tid;
        As[buf][e / BM][e % BM] = ra[i];
        Bs[buf][e / BM][e % BM] = rb[i];
      }
    };
    float acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

    load(0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int t0 = 0; t0 < red; t0 += kBK) {
      const bool more = t0 + kBK < red;
      if (more) load(t0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], v[TM];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* ap = &As[buf][kk][h * (BM / 2) + ty * HALF];
          const float* bp = &Bs[buf][kk][h * (BM / 2) + tx * HALF];
          if constexpr (HALF == 4) {
            const float4 av = *reinterpret_cast<const float4*>(ap);
            const float4 bv = *reinterpret_cast<const float4*>(bp);
            a[h * 4 + 0] = av.x; a[h * 4 + 1] = av.y;
            a[h * 4 + 2] = av.z; a[h * 4 + 3] = av.w;
            v[h * 4 + 0] = bv.x; v[h * 4 + 1] = bv.y;
            v[h * 4 + 2] = bv.z; v[h * 4 + 3] = bv.w;
          } else {
            const float2 av = *reinterpret_cast<const float2*>(ap);
            const float2 bv = *reinterpret_cast<const float2*>(bp);
            a[h * 2 + 0] = av.x; a[h * 2 + 1] = av.y;
            v[h * 2 + 0] = bv.x; v[h * 2 + 1] = bv.y;
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
      if (more) store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int k = k0 + (i / HALF) * (BM / 2) + ty * HALF + i % HALF;
      if (k >= rows) continue;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const long long c = c0 + (j / HALF) * (BM / 2) + tx * HALF + j % HALF;
        if (c < L) op.store(b, k, c, acc[i][j]);
      }
    }
  }
}

template <int TM, class Op>
static cudaError_t launch_dense_real(const float* w, const Op& op, int rows,
                                     int red, long long L, long long B,
                                     cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const int ktiles = (rows + BM - 1) / BM;
  const long long blocks = (long long)ktiles * ((L + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
  dense_real_kernel<TM, Op><<<dim3((unsigned)blocks, gy), kDenseThreads, 0, stream>>>(
      w, op, rows, red, L, B, ktiles);
  return cudaGetLastError();
}

// Y = W^T X through op, on the micro-tile TM: 8 (128 x 128 block tiles) or 4
// (64 x 64). Returns the cudaError_t of the launch.
template <class Op>
static cudaError_t dense_real(int TM, const float* w, const Op& op, int rows,
                              int red, long long L, long long B,
                              cudaStream_t stream) {
  if (rows < 1 || red < 1 || B < 1 || L < 1) return cudaErrorInvalidValue;
  switch (TM) {
    case 8: return launch_dense_real<8>(w, op, rows, red, L, B, stream);
    case 4: return launch_dense_real<4>(w, op, rows, red, L, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ndfft
