// Kernels 2 and 3: R2C and C2R of contiguous rows, even n = 2h, h = 128 * F.
//
// Kernel 2 replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_kernel_nat
// (built by _build_r2c_nat); kernel 3 replaces rfft.py::_c2r_kernel_nat
// (built by _build_c2r_nat). Both run the shared bts2 core (bts2_core.cuh)
// as the half-length FFT, on R rows of the block held in shared memory.
//
// The R2C is also kernel 15 at h = 128 * F (both cores): it
// replaces rfft.py::_r2c_kernel (built by _build_r2c, called by r2c_pallas),
// which takes the even/odd streams of rows that the lane lowerings build
// (the R2C of n = 256, the DCT-I and DST-I extensions). Those streams are
// this kernel's natural row read as complex pairs, so K15 here is the same
// function at one more factor: F = 1 (the 256^3 step's n = 256, DCT-I at
// n = 129), with up to R = 64 rows of 128 in the block's 64 KB.
//
// A real row of n floats IS the interleaved complex row z[t] = x[2t] +
// i*x[2t+1] of length h, so R consecutive rows are one contiguous float2
// copy into shared memory: no de-interleave pass. The TPU kernel ran
// [z | conj z] through one FFT to avoid a gather of the mirror Z[(h-k) % h];
// on Hopper that mirror is a shared-memory read, so each row takes one FFT_h.
//
//   R2C:  Z = FFT_h(z);  Fe = (Z[k] + conj Z[-k]) / 2;  Fo = -i (Z[k] - conj Z[-k]) / 2
//         X[k] = Fe + W_n^k Fo  (k < h),   X[h] = Re Z[0] - Im Z[0]
//   C2R:  S[0] and S[h] lose their imaginary parts (the reference's order:
//         scale, then DC/Nyquist imag = 0, then invert; the scale is linear
//         and real, so it rides the constants A and B),
//         G[k] = A[k] S[k] + B[k] conj S[h-k],  A = s (1 + i u), B = s (1 - i u),
//         u = W_n^{-k}; z = IFFT_h(G) unnormalized; x[2t] = Re z, x[2t+1] = Im z.
//         (The usual 1/2 of the unpack and the factor 2 of the half-length
//         inverse cancel, so A and B carry neither.)
// The bound is that of the core: stage 2's dense DFT-128 on the FP32 CUDA
// cores (bts2_core.cuh).
//
// At every other F <= 160 (h = 384, 640, 768 ... 20480) both run on the wide
// core (bts2_wide.cuh): r2c_nat_wide_kernel and c2r_nat_wide_kernel below,
// with the same pre- and post-passes, A/B constants and DC/Nyquist rule.
#include "bts2_wide.cuh"

namespace ndfft {

template <int F, int R>
__global__ void __launch_bounds__(kThreads)
r2c_nat_kernel(const float2* __restrict__ x, float2* __restrict__ out,
               const float2* __restrict__ wq, const float2* __restrict__ tw,
               long long T) {
  constexpr int H = F * kM;
  extern __shared__ float2 s[];
  const long long row0 = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, T - row0);
  const float2* xb = x + row0 * H;
  for (int idx = threadIdx.x; idx < R * H; idx += kThreads)
    s[idx] = idx < valid * H ? xb[idx] : make_float2(0.f, 0.f);
  __syncthreads();
  Bts2<F, R, true>::run(s, wq, -1.f);
  float2* ob = out + row0 * (H + 1);
  for (int idx = threadIdx.x; idx < valid * (H + 1); idx += kThreads) {
    const int r = idx / (H + 1);
    const int k = idx % (H + 1);
    const float2* z = s + r * H;
    float2 X;
    if (k == H) {
      X = make_float2(z[0].x - z[0].y, 0.f);
    } else {
      const float2 zk = z[k];
      const float2 zm = z[(H - k) % H];
      const float2 fe = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
      const float2 fo = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
      const float2 w = __ldg(tw + k);
      X = make_float2(fe.x + (fo.x * w.x - fo.y * w.y),
                      fe.y + (fo.x * w.y + fo.y * w.x));
    }
    ob[idx] = X;
  }
}

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

// Kernels 2 (and so 15) and 3 at every other butterfly factor, on the wide
// core (bts2_wide.cuh) in its row layout, with the pre- and post-passes
// above. The wide core keeps its tile and writes Z to device memory, so the
// R2C's unpack, which needs Z[k] and Z[(h - k) mod h] (plane (F - q) mod F),
// runs after a block barrier on the output rows in place, one mirror pair
// per thread (bts2_core.cuh::r2c_unpack_rows, as kernel 15's generic form
// does); the C2R's pre-pass fills the tile and the core writes z, the real
// row as its complex pairs, straight to the output.
template <int C>
__global__ void __launch_bounds__(kThreads)
r2c_nat_wide_kernel(const float2* __restrict__ x, float2* out, const float2* __restrict__ wq,
                    const float2* __restrict__ wf, const float2* __restrict__ tw, int F,
                    long long T, long long tiles) {
  const int H = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, H, C);
  long long row0;
  int valid;
  wide_tile(T, tiles, blockIdx.x, row0, valid);
  const float2* xb = x + row0 * H;
  for (int idx = threadIdx.x; idx < valid * H; idx += kThreads) sm.s[idx] = xb[idx];
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float2* ob = out + row0 * (H + 1);
  // ends with a barrier: Z of every row of the tile is in device memory
  Bts2Wide<C, true>{H, F}.run(sm.s, sm.ys, sm.wt, wq, valid, ob, H + 1, 1);
  r2c_unpack_rows(ob, H, valid, tw);
}

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
static cudaError_t launch_rfft(bool inverse, const void* in, void* out,
                               const float2* wq, const void* extra,
                               long long T, cudaStream_t stream) {
  if constexpr (F * kM * R > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const int smem = F * kM * R * (int)sizeof(float2);
    const unsigned blocks = (unsigned)((T + R - 1) / R);
    cudaError_t e;
    if (inverse) {
      e = cudaFuncSetAttribute(c2r_nat_kernel<F, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      c2r_nat_kernel<F, R><<<blocks, kThreads, smem, stream>>>(
          static_cast<const float2*>(in), static_cast<float2*>(out), wq,
          static_cast<const float4*>(extra), T);
    } else {
      e = cudaFuncSetAttribute(r2c_nat_kernel<F, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      r2c_nat_kernel<F, R><<<blocks, kThreads, smem, stream>>>(
          static_cast<const float2*>(in), static_cast<float2*>(out), wq,
          static_cast<const float2*>(extra), T);
    }
    return cudaGetLastError();
  }
}

template <int F>
static cudaError_t dispatch_r(int R, bool inverse, const void* in, void* out,
                              const float2* wq, const void* extra, long long T,
                              cudaStream_t stream) {
  switch (R) {
    case 1: return launch_rfft<F, 1>(inverse, in, out, wq, extra, T, stream);
    case 2: return launch_rfft<F, 2>(inverse, in, out, wq, extra, T, stream);
    case 4: return launch_rfft<F, 4>(inverse, in, out, wq, extra, T, stream);
    case 8: return launch_rfft<F, 8>(inverse, in, out, wq, extra, T, stream);
    case 16: return launch_rfft<F, 16>(inverse, in, out, wq, extra, T, stream);
    case 32: return launch_rfft<F, 32>(inverse, in, out, wq, extra, T, stream);
    case 64: return launch_rfft<F, 64>(inverse, in, out, wq, extra, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

static int rfft_entry(bool inverse, const void* in, void* out, const void* wq,
                      const void* extra, long long T, int n, int R,
                      void* stream) {
  const float2* wp = static_cast<const float2*>(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n / 2) {
    case kM: return dispatch_r<1>(R, inverse, in, out, wp, extra, T, st);
    case 2 * kM: return dispatch_r<2>(R, inverse, in, out, wp, extra, T, st);
    case 4 * kM: return dispatch_r<4>(R, inverse, in, out, wp, extra, T, st);
    case 8 * kM: return dispatch_r<8>(R, inverse, in, out, wp, extra, T, st);
    case 16 * kM: return dispatch_r<16>(R, inverse, in, out, wp, extra, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ndfft

// x: (T, n) float32 rows, 8-byte aligned; out: (T, n/2 + 1) complex64; wq:
// (F, 128, 128) complex64 for h = n/2, sign -1; tw: (h,) complex64, W_n^k.
// R: rows per block, a power of two with (n/2) * R <= 8192. Kernels 2 and 15.
extern "C" int ndfft_r2c_nat(const void* x, void* out, const void* wq,
                             const void* tw, long long T, int n, int R,
                             void* stream) {
  if (n % 2) return (int)cudaErrorInvalidValue;
  return ndfft::rfft_entry(false, x, out, wq, tw, T, n, R, stream);
}

// spec: (T, n/2 + 1) complex64; out: (T, n) float32; wq: (F, 128, 128)
// complex64 for h = n/2, sign +1, unscaled; ab: (h, 4) float32 rows
// (A.re, A.im, B.re, B.im) with the scale folded in.
extern "C" int ndfft_c2r_nat(const void* spec, void* out, const void* wq,
                             const void* ab, long long T, int n, int R,
                             void* stream) {
  if (n % 2) return (int)cudaErrorInvalidValue;
  return ndfft::rfft_entry(true, spec, out, wq, ab, T, n, R, stream);
}

// Kernels 2 and 15 on the wide core, h = n/2 = 128 * F with 1 <= F <= 160:
// x, out, wq and tw as for ndfft_r2c_nat; wf: (F, F) complex64 DFT-F, sign
// -1. C: rows per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_r2c_nat_wide(const void* x, void* out, const void* wq, const void* wf,
                                  const void* tw, long long T, int n, int C, void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  const int h = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(r2c_nat_wide_kernel<kC>, h, 1, T, static_cast<cudaStream_t>(stream),
                           static_cast<const float2*>(x), static_cast<float2*>(out),
                           static_cast<const float2*>(wq), static_cast<const float2*>(wf),
                           static_cast<const float2*>(tw), h / kM, T);
  });
}

// Kernel 3 on the wide core: spec, out, wq and ab as for ndfft_c2r_nat; wf:
// (F, F) complex64 DFT-F, sign +1; C as above.
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
