// Kernel 27: dense DCT of any type along the middle axis of a (B, n, L)
// float32 tensor, 2 <= n <= 1100:  y[b, k, c] = sum_t W[t, k] x[b, t, c],
// W = (s M)^T with M the rustdct DCT-type matrix and s the handler's scale,
// built on the host in float64 and rounded once (ops/hopper/dct.py).
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_dct_dense_kernel (built by
// _build_dct_dense_mid), which runs the same product as one MXU dot per
// (1, n, TL) block at the "highest" (float32) tier.
//
// What bounds it on this card: the product's 2 n^2 FLOPs per column on the
// FP32 CUDA cores. At (1, 512, 262144) that is 137 GFLOP, >= 2.05 ms at the
// 67 TFLOP/s FP32 peak (data sheet, 700 W), against 1.07 GB of HBM traffic
// (0.32 ms at 3.35 TB/s). The product stays in float32 (no TF32, no bf16) to
// match the JAX package's tier. The design is the classic register-tiled
// SGEMM: a block owns a BM x BN output tile (BM = BN = 16 * TM) of one batch
// b, 256 threads each accumulate a TM x TM micro-tile with fmaf, and the
// reduction over t runs in chunks of 8 staged in shared memory, double
// buffered through registers so that the next chunk's global loads overlap
// the current chunk's FMAs. Every n of the reference grid (129, 265, 513,
// 1025) is odd, so the reduction edge and both output edges are masked. W
// (4.2 MB at n = 1025) streams through L2; the k-tiles of one column strip
// are consecutive blocks, so the strip of x is read from HBM once and then
// hit in L2. The 64 x 64 tile (TM = 4) serves grids that would leave SMs
// idle at 128 x 128 (n = 1025 square: 81 blocks -> 289).
#include <cuda_runtime.h>

namespace ndfft {

constexpr int kDenseThreads = 256;
constexpr int kBK = 8;

template <int TM>
__global__ void __launch_bounds__(kDenseThreads)
dct_dense_kernel(const float* __restrict__ w, const float* __restrict__ x,
                 float* __restrict__ y, int n, long long L, long long B,
                 int ktiles) {
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
    const float* xb = x + b * n * L;
    float ra[LPT], rb[LPT];
    auto load = [&](int t0) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const int e = i * kDenseThreads + tid;
        const int t = t0 + e / BM;
        const int cc = e % BM;
        ra[i] = (t < n && k0 + cc < n) ? __ldg(w + (long long)t * n + k0 + cc) : 0.f;
        rb[i] = (t < n && c0 + cc < L) ? __ldg(xb + (long long)t * L + c0 + cc) : 0.f;
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
    for (int t0 = 0; t0 < n; t0 += kBK) {
      const bool more = t0 + kBK < n;
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

    float* yb = y + b * n * L;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int k = k0 + (i / HALF) * (BM / 2) + ty * HALF + i % HALF;
      if (k >= n) continue;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const long long c = c0 + (j / HALF) * (BM / 2) + tx * HALF + j % HALF;
        if (c < L) yb[(long long)k * L + c] = acc[i][j];
      }
    }
  }
}

template <int TM>
static cudaError_t launch_dense(const float* w, const float* x, float* y, int n,
                                long long L, long long B, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const int ktiles = (n + BM - 1) / BM;
  const long long blocks = (long long)ktiles * ((L + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
  dct_dense_kernel<TM><<<dim3((unsigned)blocks, gy), kDenseThreads, 0, stream>>>(
      w, x, y, n, L, B, ktiles);
  return cudaGetLastError();
}

}  // namespace ndfft

// w: (n, n) float32, w[t * n + k] = s M[k, t]; x, y: (B, n, L) float32,
// contiguous. TM: the micro-tile, 8 (128 x 128 block tile) or 4 (64 x 64).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct_dense_mid(const void* w, const void* x, void* y,
                                   long long B, int n, long long L, int TM,
                                   void* stream) {
  using namespace ndfft;
  const float* wp = static_cast<const float*>(w);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  switch (TM) {
    case 8: return (int)launch_dense<8>(wp, xp, yp, n, L, B, st);
    case 4: return (int)launch_dense<4>(wp, xp, yp, n, L, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
