// Kernel 4: C2C of length n <= 512 along the middle axis of (B, n, L) as
// one dense complex product with the scaled DFT matrix W[t, k] =
// s * exp(sign 2 pi i t k / n), built on the host in float64 and rounded
// once (ops/hopper/fft.py::dense_consts):
//
//   Y[b, k, c] = sum_t W[k, t] X[b, t, c]
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_dense (the
// dense branch of _build_call_axis_mid: n <= 256, or n <= 512 without a
// {128, 256} split, e.g. the reference's 264 grid), which runs one MXU dot
// per block at the "highest" (float32) tier. (Kernel 8's rows at n <= 256,
// the dense lane DFT of fft.py::_kernel_lane_last, run on the mixed-radix
// row core: fft_rows_radix.cu.)
//
// What bounds it on this card: the function needs only its 0.27 GB of HBM
// traffic per 256^3 leg (0.08 ms at 3.35 TB/s; an FFT's 5 n log2 n FLOPs
// are far below that), but this design does the product's 8 n real FLOPs
// per complex output on the FP32 CUDA cores: 34.4 GFLOP per leg, >= 0.51 ms
// at the 67 TFLOP/s FP32 peak (data sheet, 700 W), kept because the JAX
// package's gate sends these sizes to the dense product. The product stays
// in float32 (no TF32, no bf16) to match the JAX package's tier. The
// design is kernel 27's register-tiled SGEMM (dct_dense.cu) on float2
// operands: a block owns a BM x BN complex output tile (BM = BN = 16 * TM)
// of one batch b, 256 threads each accumulate a TM x TM complex micro-tile,
// and the reduction over t runs in chunks of 8 staged in shared memory,
// double buffered through registers. Each complex MAC is 4 real fmaf into
// two accumulators (re, im) per output: the 4M form keeps float32's rounding
// of every product, where the 3M form would save a quarter of the FMAs at
// the cost of cancellation in its sums. The data operand is the (t, c) tile
// with c contiguous. n is any length up to 512 (264, 200, 130 on the
// slice), so the reduction edge and both output edges are masked. The
// 64 x 64 tile (TM = 4) serves grids that would leave SMs idle at 128 x 128
// (the reference's 128 and 264 grids: 1 and 9 blocks -> 4 and 25).
//
// Kernel 7's dense body: kernel 4 with the four-step's exit twiddle. The
// JAX package's _kernel_exit_mul (ndrustfft_tpu/ops/pallas/fft.py:1549,
// added by _add_exit_tw :1635 to the dense body's pallas_call :1724)
// multiplies the (n1, L) output block by W_{n1 L}^{k1 t2} in VMEM; here the
// epilogue multiplies each output Y[b, k, c] by tw[k * L + c] before its one
// store (tw: the (n1, n2) table of ops/hopper/fft.py::fourstep_tw, read
// once per batch b from L2: 8 MB at n = 2^20, 32 MB at 2^22), so the
// twiddle costs no pass of its own. The template flag kTw compiles the
// multiply in, so kernel 4 keeps its epilogue (and registers).
#include "bts2_core.cuh"

namespace ndfft {

constexpr int kDenseBK = 8;   // reduction chunk (t) staged in shared memory

template <int TM, bool kTw>
__global__ void __launch_bounds__(kThreads)
c2c_dense_kernel(const float2* __restrict__ w, const float2* __restrict__ x,
                 float2* __restrict__ y, const float2* __restrict__ tw, int n,
                 long long L, long long B, int ktiles) {
  constexpr int BM = 16 * TM;              // output rows (k) and columns (c)
  constexpr int HALF = TM / 2;             // each thread: 2 x 2 groups of HALF
  constexpr int LPT = kDenseBK * BM / kThreads;  // tile loads per thread
  __shared__ __align__(16) float2 As[2][kDenseBK][BM];
  __shared__ __align__(16) float2 Bs[2][kDenseBK][BM];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = (int)(blockIdx.x % ktiles) * BM;
  const long long c0 = (long long)(blockIdx.x / ktiles) * BM;
  const float2 zero = make_float2(0.f, 0.f);

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const float2* xb = x + b * n * L;
    float2 ra[LPT], rb[LPT];
    auto load = [&](int t0) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const int e = i * kThreads + tid;
        const int ta = t0 + e / BM;
        const int ka = e % BM;
        ra[i] = (ta < n && k0 + ka < n) ? __ldg(w + (long long)ta * n + k0 + ka) : zero;
        const int t = t0 + e / BM;
        const long long c = c0 + e % BM;
        rb[i] = (t < n && c < L) ? __ldg(xb + (long long)t * L + c) : zero;
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) {
        const int e = i * kThreads + tid;
        As[buf][e / BM][e % BM] = ra[i];
        Bs[buf][e / BM][e % BM] = rb[i];
      }
    };
    float2 acc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] = zero;

    load(0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int t0 = 0; t0 < n; t0 += kDenseBK) {
      const bool more = t0 + kDenseBK < n;
      if (more) load(t0 + kDenseBK);
#pragma unroll
      for (int kk = 0; kk < kDenseBK; ++kk) {
        float2 a[TM], v[TM];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2* ap = &As[buf][kk][h * (BM / 2) + ty * HALF];
          const float2* bp = &Bs[buf][kk][h * (BM / 2) + tx * HALF];
#pragma unroll
          for (int j = 0; j < HALF; j += 2) {
            const float4 av = *reinterpret_cast<const float4*>(ap + j);
            const float4 bv = *reinterpret_cast<const float4*>(bp + j);
            a[h * HALF + j] = make_float2(av.x, av.y);
            a[h * HALF + j + 1] = make_float2(av.z, av.w);
            v[h * HALF + j] = make_float2(bv.x, bv.y);
            v[h * HALF + j + 1] = make_float2(bv.z, bv.w);
          }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TM; ++j) cmac(acc[i][j], v[j], a[i]);
      }
      if (more) store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }

    float2* yb = y + b * n * L;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int k = k0 + (i / HALF) * (BM / 2) + ty * HALF + i % HALF;
      if (k >= n) continue;
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const long long c = c0 + (j / HALF) * (BM / 2) + tx * HALF + j % HALF;
        if (c < L) {
          const long long o = (long long)k * L + c;
          yb[o] = kTw ? cmul(acc[i][j], __ldg(tw + o)) : acc[i][j];
        }
      }
    }
  }
}

template <int TM, bool kTw = false>
static cudaError_t launch_c2c_dense(const float2* w, const float2* x, float2* y,
                                    const float2* tw, int n, long long L, long long B,
                                    cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const int ktiles = (n + BM - 1) / BM;
  const long long blocks = (long long)ktiles * ((L + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
  c2c_dense_kernel<TM, kTw><<<dim3((unsigned)blocks, gy), kThreads, 0, stream>>>(
      w, x, y, tw, n, L, B, ktiles);
  return cudaGetLastError();
}

}  // namespace ndfft

// w: (n, n) complex64, w[t * n + k] = s W_n^{sign t k}; x, y: (B, n, L)
// complex64, contiguous. tw: null, or the (n, L) complex64 exit twiddle of
// kernel 7 that multiplies every output. TM: the micro-tile, 8 (128 x 128
// block tile) or 4 (64 x 64). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ndfft_c2c_dense(const void* w, const void* x, void* y, const void* tw,
                               long long B, int n, long long L, int TM, void* stream) {
  using namespace ndfft;
  const float2* wp = static_cast<const float2*>(w);
  const float2* xp = static_cast<const float2*>(x);
  float2* yp = static_cast<float2*>(y);
  const float2* twp = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (TM == 8)
    return (int)(twp ? launch_c2c_dense<8, true>(wp, xp, yp, twp, n, L, B, st)
                     : launch_c2c_dense<8>(wp, xp, yp, nullptr, n, L, B, st));
  if (TM == 4)
    return (int)(twp ? launch_c2c_dense<4, true>(wp, xp, yp, twp, n, L, B, st)
                     : launch_c2c_dense<4>(wp, xp, yp, nullptr, n, L, B, st));
  return (int)cudaErrorInvalidValue;
}
