// Kernel 3: C2R of contiguous rows, even n = 2h, h = 128 * F.
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_c2r_kernel_nat (built by
// _build_c2r_nat). It runs the shared bts2 core (bts2_core.cuh) as the
// half-length inverse FFT, on R rows of the block held in shared memory.
// Its forward twin, kernel 2 (rfft.py::_r2c_kernel_nat), and kernel 15 at
// h = 128 * F run on the mixed-radix row core with the unpack as its
// epilogue (rfft_radix.cu).
//
// A real row of n floats IS the interleaved complex row z[t] = x[2t] +
// i*x[2t+1] of length h, so the block writes the inverse's R rows back as
// one contiguous float2 copy: no interleave pass.
//
//   C2R:  S[0] and S[h] lose their imaginary parts (the reference's order:
//         scale, then DC/Nyquist imag = 0, then invert; the scale is linear
//         and real, so it rides the constants A and B),
//         G[k] = A[k] S[k] + B[k] conj S[h-k],  A = s (1 + i u), B = s (1 - i u),
//         u = W_n^{-k}; z = IFFT_h(G) unnormalized; x[2t] = Re z, x[2t+1] = Im z.
//         (The usual 1/2 of the unpack and the factor 2 of the half-length
//         inverse cancel, so A and B carry neither.)
// The bound is that of the core: stage 2's dense DFT-128 on the FP32 CUDA
// cores (bts2_core.cuh); its move onto the radix core is later work.
//
// At every other F <= 160 (h = 384, 640, 768 ... 20480) it runs on the wide
// core (bts2_wide.cuh): c2r_nat_wide_kernel below, with the same pre-pass,
// A/B constants and DC/Nyquist rule.
#include "bts2_wide.cuh"

namespace ndfft {

template <int F, int R>
__global__ void __launch_bounds__(kThreads)
c2r_nat_kernel(const float2* __restrict__ spec, float2* __restrict__ out,
               const float2* __restrict__ wq, const float4* __restrict__ ab,
               long long T) {
  constexpr int H = F * kM;
  extern __shared__ float2 s[];
  const long long row0 = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, T - row0);
  const float2* sb = spec + row0 * (H + 1);
  for (int idx = threadIdx.x; idx < R * H; idx += kThreads) {
    const int r = idx / H;
    const int k = idx % H;
    s[idx] = r < valid ? c2r_pre(sb + r * (H + 1), ab, H, k) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  Bts2<F, R, true>::run(s, wq, 1.f);
  float2* ob = out + row0 * H;
  for (int idx = threadIdx.x; idx < valid * H; idx += kThreads) ob[idx] = s[idx];
}

// Kernel 3 at every other butterfly factor, on the wide core
// (bts2_wide.cuh) in its row layout, with the pre-pass above: the pre-pass
// fills the tile and the core writes z, the real row as its complex pairs,
// straight to the output.
template <int C>
__global__ void __launch_bounds__(kThreads)
c2r_nat_wide_kernel(const float2* __restrict__ spec, float2* __restrict__ out,
                    const float2* __restrict__ wq, const float2* __restrict__ wf,
                    const float4* __restrict__ ab, int F, long long T, long long tiles) {
  const int H = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, H, C);
  long long row0;
  int valid;
  wide_tile(T, tiles, blockIdx.x, row0, valid);
  const float2* sb = spec + row0 * (H + 1);
  for (int idx = threadIdx.x; idx < valid * H; idx += kThreads)
    sm.s[idx] = c2r_pre(sb + (idx / H) * (H + 1), ab, H, idx % H);
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  Bts2Wide<C, true>{H, F}.run(sm.s, sm.ys, sm.wt, wq, valid, out + row0 * H, H, 1);
}

template <int F, int R>
static cudaError_t launch_c2r(const float2* spec, float2* out, const float2* wq,
                              const float4* ab, long long T, cudaStream_t stream) {
  if constexpr (F * kM * R > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const int smem = F * kM * R * (int)sizeof(float2);
    const unsigned blocks = (unsigned)((T + R - 1) / R);
    cudaError_t e = cudaFuncSetAttribute(c2r_nat_kernel<F, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    c2r_nat_kernel<F, R><<<blocks, kThreads, smem, stream>>>(spec, out, wq, ab, T);
    return cudaGetLastError();
  }
}

template <int F>
static cudaError_t dispatch_r(int R, const float2* spec, float2* out, const float2* wq,
                              const float4* ab, long long T, cudaStream_t stream) {
  switch (R) {
    case 1: return launch_c2r<F, 1>(spec, out, wq, ab, T, stream);
    case 2: return launch_c2r<F, 2>(spec, out, wq, ab, T, stream);
    case 4: return launch_c2r<F, 4>(spec, out, wq, ab, T, stream);
    case 8: return launch_c2r<F, 8>(spec, out, wq, ab, T, stream);
    case 16: return launch_c2r<F, 16>(spec, out, wq, ab, T, stream);
    case 32: return launch_c2r<F, 32>(spec, out, wq, ab, T, stream);
    case 64: return launch_c2r<F, 64>(spec, out, wq, ab, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ndfft

// spec: (T, n/2 + 1) complex64; out: (T, n) float32; wq: (F, 128, 128)
// complex64 for h = n/2, sign +1, unscaled; ab: (h, 4) float32 rows
// (A.re, A.im, B.re, B.im) with the scale folded in. R: rows per block, a
// power of two with (n/2) * R <= 8192. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ndfft_c2r_nat(const void* spec, void* out, const void* wq,
                             const void* ab, long long T, int n, int R,
                             void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  const float2* sp = static_cast<const float2*>(spec);
  float2* op = static_cast<float2*>(out);
  const float2* wp = static_cast<const float2*>(wq);
  const float4* abp = static_cast<const float4*>(ab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n / 2) {
    case kM: return (int)dispatch_r<1>(R, sp, op, wp, abp, T, st);
    case 2 * kM: return (int)dispatch_r<2>(R, sp, op, wp, abp, T, st);
    case 4 * kM: return (int)dispatch_r<4>(R, sp, op, wp, abp, T, st);
    case 8 * kM: return (int)dispatch_r<8>(R, sp, op, wp, abp, T, st);
    case 16 * kM: return (int)dispatch_r<16>(R, sp, op, wp, abp, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 3 on the wide core, h = n/2 = 128 * F with 1 <= F <= 160: spec,
// out, wq and ab as for ndfft_c2r_nat; wf: (F, F) complex64 DFT-F, sign +1.
// C: rows per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_c2r_nat_wide(const void* spec, void* out, const void* wq, const void* wf,
                                  const void* ab, long long T, int n, int C, void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  const int h = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(c2r_nat_wide_kernel<kC>, h, 1, T, static_cast<cudaStream_t>(stream),
                           static_cast<const float2*>(spec), static_cast<float2*>(out),
                           static_cast<const float2*>(wq), static_cast<const float2*>(wf),
                           static_cast<const float4*>(ab), h / kM, T);
  });
}
