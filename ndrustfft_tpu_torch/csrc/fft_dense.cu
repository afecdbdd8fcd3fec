// Kernel 7's dense body: C2C of length n1 <= 256 along the middle axis of a
// (B, n1, n2) complex64 tensor as one dense complex product with the DFT
// matrix W[t, k] = exp(sign 2 pi i t k / n1), built on the host in float64
// and rounded once (ops/hopper/fft.py::dense_consts), times the four-step's
// exit twiddle:
//
//   Y[b, k, c] = tw[k, c] sum_t W[k, t] X[b, t, c]
//
// Replaces, for n1 <= 256, ndrustfft_tpu/ops/pallas/fft.py::_kernel_exit_mul
// (:1549, added by _add_exit_tw :1635 to the dense body of
// _build_call_axis_mid, _kernel_axis_mid_dense, whose pallas_call is :1724),
// which runs one MXU dot per block at the "highest" (float32) tier and
// multiplies the (n1, L) output block by W_{n1 L}^{k1 t2} in VMEM. (The
// same dense body along a middle axis without the twiddle, kernel 4, runs on
// the mixed-radix core's column tile: fft_mid_radix.cu.)
//
// What bounds it on this card: the function needs only its HBM traffic
// (the tensor read and written once, the twiddle read once per b), but this
// design does the product's 8 n1 real FLOPs per complex output on the FP32
// CUDA cores, kept because the JAX package's four-step sends these sizes to
// the dense body. The product stays in float32 (no TF32, no bf16) to match
// the JAX package's tier. The design is kernel 27's register-tiled SGEMM
// (dct_dense.cu) on float2 operands: a block owns a BM x BN complex output
// tile (BM = BN = 16 * TM) of one batch b, 256 threads each accumulate a
// TM x TM complex micro-tile, and the reduction over t runs in chunks of 8
// staged in shared memory, double buffered through registers. Each complex
// MAC is 4 real fmaf into two accumulators (re, im) per output: the 4M form
// keeps float32's rounding of every product, where the 3M form would save a
// quarter of the FMAs at the cost of cancellation in its sums. The data
// operand is the (t, c) tile with c contiguous. n1 is any length up to 256,
// so the reduction edge and both output edges are masked. The 64 x 64 tile
// (TM = 4) serves grids that would leave SMs idle at 128 x 128. The epilogue
// multiplies each output Y[b, k, c] by tw[k * L + c] before its one store
// (tw: the (n1, n2) table of ops/hopper/fft.py::fourstep_tw, read once per
// batch b from L2: 8 MB at n = 2^20, 32 MB at 2^22), so the twiddle costs
// no pass of its own.
#include "bts2_core.cuh"

namespace ndfft {

constexpr int kDenseBK = 8;   // reduction chunk (t) staged in shared memory

template <int TM>
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
          yb[o] = cmul(acc[i][j], __ldg(tw + o));
        }
      }
    }
  }
}

template <int TM>
static cudaError_t launch_c2c_dense(const float2* w, const float2* x, float2* y,
                                    const float2* tw, int n, long long L, long long B,
                                    cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const int ktiles = (n + BM - 1) / BM;
  const long long blocks = (long long)ktiles * ((L + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned gy = (unsigned)(B < 65535 ? B : 65535);
  c2c_dense_kernel<TM><<<dim3((unsigned)blocks, gy), kThreads, 0, stream>>>(
      w, x, y, tw, n, L, B, ktiles);
  return cudaGetLastError();
}

}  // namespace ndfft

// w: (n, n) complex64, w[t * n + k] = W_n^{sign t k}; x, y: (B, n, L)
// complex64, contiguous; tw: the (n, L) complex64 exit twiddle that
// multiplies every output. TM: the micro-tile, 8 (128 x 128 block tile) or
// 4 (64 x 64). Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_dense(const void* w, const void* x, void* y, const void* tw,
                               long long B, int n, long long L, int TM, void* stream) {
  using namespace ndfft;
  const float2* wp = static_cast<const float2*>(w);
  const float2* xp = static_cast<const float2*>(x);
  float2* yp = static_cast<float2*>(y);
  const float2* twp = static_cast<const float2*>(tw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || B < 1 || L < 1 || twp == nullptr) return (int)cudaErrorInvalidValue;
  if (TM == 8) return (int)launch_c2c_dense<8>(wp, xp, yp, twp, n, L, B, st);
  if (TM == 4) return (int)launch_c2c_dense<4>(wp, xp, yp, twp, n, L, B, st);
  return (int)cudaErrorInvalidValue;
}
