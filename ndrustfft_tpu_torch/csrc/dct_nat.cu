// Kernel 24: DCT-III of contiguous float32 rows, even n = 128 * k,
// k <= 256 (the JAX gate's split (128, k)): on the fixed core below for
// n = 2h, h = 128 * F, F in {1, 2, 4, 8, 16} (n = 256 ... 4096), on the
// wide core (dct_wide.cuh, entries at the end of this file) at every other
// n: the half-length form for even k (h = 128 * k/2), the n-point form on a
// real tile for odd k (n = 128, 384, 640 ... 32640). Kernel 23 (DCT-II)
// keeps the two wide-core forms at the 29 lengths whose half length has no
// radix plan (odd prime k = 131 ... 251 in the n-point form, k = 262, 274,
// 278, 298, 302, 314 in the half-length form); at every other length it
// runs on the radix row core (dct_rows_radix.cu), and its fixed-core form
// here is gone.
//
// Kernel 23 replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel (built by
// _build_dct2, called by dct2_pallas); kernel 24 replaces dct.py::_dct3_kernel
// (built by _build_dct3) together with dct3_pallas's interleave epilogue
// (dct.py:320-323), which here is the kernel's store. Both compute the
// rustdct convention times a scale s (the handler's policy: Default s = 2).
//
//   DCT-II  (Makhoul): v = [x0, x2, .., x_{n-2}, x_{n-1}, .., x3, x1];
//           V = FFT_n(v), a real input, by the half-length R2C (kernel 2's math):
//           z[t] = v[2t] + i v[2t+1], Z = FFT_h(z),
//           V[k] = (Z[k] + conj Z[-k]) / 2 - i W_n^k (Z[k] - conj Z[-k]) / 2;
//           y[k] = Re(P[k] V[k]) and y[n-k] = Re(P[n-k] conj V[k]), with the
//           post twiddle P[k] = s e^{-i pi k / 2n}.
//   DCT-III (the transpose): y[2t] = u[t], y[2t+1] = u[n-1-t], with
//           u = Re FFT_n(c e^{-i pi t / 2n}), c = x with x0 halved. u is the
//           unnormalized C2R of the Hermitian half spectrum
//           S[k] = Q[k] (x[k] - i x[n-k]),  Q[k] = (s/2) e^{+i pi k / 2n},
//           k = 0..h, x[n] := 0 (so S[0] = s x0 / 2 and S[h] is real), which
//           kernel 3's unpack and half-length inverse turn into u.
//
// One block of the fixed core owns R whole rows in shared memory (R * h
// float2, at most 64 KB): device memory is read once and written once per
// element, the mirror reads x[n-k] are shared-memory reads, and the DCT-III
// output interleave is a permuted store out of shared memory. What bounds
// it on this card is the core's stage 2 (a dense DFT-128 on the FP32 CUDA
// cores, see bts2_core.cuh); the kernel adds an O(n) prologue and epilogue
// per row.
#include "dct_wide.cuh"

namespace ndfft {

// Copy R rows of n = 2H floats (as H float2 each) into shared memory; rows
// past T read zeros.
template <int F, int R>
__device__ __forceinline__ void load_rows(float2* s, const float* __restrict__ x,
                                          long long row0, int valid) {
  constexpr int H = F * kM;
  const float2* xb = reinterpret_cast<const float2*>(x) + row0 * H;
  for (int idx = threadIdx.x; idx < R * H; idx += kThreads)
    s[idx] = idx < valid * H ? xb[idx] : make_float2(0.f, 0.f);
}

template <int F, int R>
__global__ void __launch_bounds__(kThreads)
dct3_nat_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float2* __restrict__ wq, const float4* __restrict__ ab,
                const float2* __restrict__ pre, long long T) {
  constexpr int H = F * kM;
  constexpr int NN = 2 * H;
  constexpr int PER = (R * H + kThreads - 1) / kThreads;  // float2 per thread
  extern __shared__ float2 s[];
  const long long row0 = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, T - row0);
  load_rows<F, R>(s, x, row0, valid);
  __syncthreads();
  // S[k] = Q[k] (x[k] - i x[n-k]), then kernel 3's half-length spectrum
  // G[k] = A[k] S[k] + B[k] conj S[h-k], in place through registers
  const float* sf = reinterpret_cast<const float*>(s);
  float2 g[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    if (idx < R * H) {
      const float* row = sf + (idx / H) * NN;
      const int k = idx % H;
      const float a = row[k];
      const float b = k == 0 ? 0.f : row[NN - k];
      const float2 q = __ldg(pre + k);
      float2 sk = make_float2(a * q.x + b * q.y, a * q.y - b * q.x);
      const int km = H - k;  // 1..h
      const float am = row[km];
      const float bm = row[NN - km];
      const float2 qm = __ldg(pre + km);
      float2 sm = make_float2(am * qm.x + bm * qm.y, am * qm.y - bm * qm.x);
      if (k == 0) {  // S[0] and S[h] are real; drop their rounding residue
        sk.y = 0.f;
        sm.y = 0.f;
      }
      const float4 c = __ldg(ab + k);  // (A.re, A.im, B.re, B.im)
      g[j] = make_float2(c.x * sk.x - c.y * sk.y + c.z * sm.x + c.w * sm.y,
                         c.x * sk.y + c.y * sk.x + c.w * sm.x - c.z * sm.y);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    if (idx < R * H) s[idx] = g[j];
  }
  __syncthreads();
  Bts2<F, R, true>::run(s, wq, 1.f);
  // u = the real row held as s (x[2t] = Re z[t], x[2t+1] = Im z[t]);
  // y[2t] = u[t], y[2t+1] = u[n-1-t]
  float2* yb = reinterpret_cast<float2*>(y) + row0 * H;
  for (int idx = threadIdx.x; idx < valid * H; idx += kThreads) {
    const int r = idx / H;
    const int t = idx % H;
    const float* u = sf + r * NN;
    yb[idx] = make_float2(u[t], u[NN - 1 - t]);
  }
}

template <int F, int R>
static cudaError_t launch_dct3(const float* x, float* y, const float2* wq, const float4* ab,
                               const float2* pre, long long T, cudaStream_t stream) {
  if constexpr (F * kM * R > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const int smem = F * kM * R * (int)sizeof(float2);
    const unsigned blocks = (unsigned)((T + R - 1) / R);
    cudaError_t e = cudaFuncSetAttribute(dct3_nat_kernel<F, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dct3_nat_kernel<F, R><<<blocks, kThreads, smem, stream>>>(x, y, wq, ab, pre, T);
    return cudaGetLastError();
  }
}

template <int F>
static cudaError_t dispatch_dct3(int R, const float* x, float* y, const float2* wq,
                                 const float4* ab, const float2* pre, long long T,
                                 cudaStream_t stream) {
  switch (R) {
    case 1: return launch_dct3<F, 1>(x, y, wq, ab, pre, T, stream);
    case 2: return launch_dct3<F, 2>(x, y, wq, ab, pre, T, stream);
    case 4: return launch_dct3<F, 4>(x, y, wq, ab, pre, T, stream);
    case 8: return launch_dct3<F, 8>(x, y, wq, ab, pre, T, stream);
    case 16: return launch_dct3<F, 16>(x, y, wq, ab, pre, T, stream);
    case 32: return launch_dct3<F, 32>(x, y, wq, ab, pre, T, stream);
    case 64: return launch_dct3<F, 64>(x, y, wq, ab, pre, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ndfft

// x, y: (T, n) float32 rows, 8-byte aligned; wq: (F, 128, 128) complex64 for
// h = n/2, sign +1, unscaled; ab: (h, 4) float32 kernel-3 unpack rows, scale 1;
// pre: (h + 1,) complex64 (s/2) e^{+i pi k / 2n}. R: rows per block, a power
// of two with (n/2) * R <= 8192.
extern "C" int ndfft_dct3_nat(const void* x, void* y, const void* wq,
                              const void* ab, const void* pre, long long T,
                              int n, int R, void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const float2* wp = static_cast<const float2*>(wq);
  const float4* abp = static_cast<const float4*>(ab);
  const float2* prep = static_cast<const float2*>(pre);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n / 2) {
    case kM: return (int)dispatch_dct3<1>(R, xp, yp, wp, abp, prep, T, st);
    case 2 * kM: return (int)dispatch_dct3<2>(R, xp, yp, wp, abp, prep, T, st);
    case 4 * kM: return (int)dispatch_dct3<4>(R, xp, yp, wp, abp, prep, T, st);
    case 8 * kM: return (int)dispatch_dct3<8>(R, xp, yp, wp, abp, prep, T, st);
    case 16 * kM: return (int)dispatch_dct3<16>(R, xp, yp, wp, abp, prep, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernels 23 (type3 = 0) and 24 (type3 = 1) on the wide core in the row
// layout, half-length form: n = 2h, h = 128 * F, 1 <= F <= 160. x, y: (T, n)
// float32; wq: (F, 128, 128) complex64 for h (sign -1 for DCT-II, +1 for
// DCT-III, unscaled); wf: (F, F) DFT-F of the same sign; c1: tw (h,) W_n^k
// (DCT-II) or ab (h, 4) kernel-3 rows at scale 1 (DCT-III); c2: post (n,)
// s e^{-i pi k / 2n} (DCT-II) or pre (h + 1,) (s/2) e^{+i pi k / 2n}
// (DCT-III). C: rows per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes). Returns the cudaError_t of the launch.
extern "C" int ndfft_dct_nat_wide(int type3, const void* x, void* y, const void* wq,
                                  const void* wf, const void* c1, const void* c2, long long T,
                                  int n, int C, void* stream) {
  return ndfft::dct_wide_launch<true>(type3 != 0, false, x, y, wq, wf, c1, c2, 1, n, T, C,
                                      stream);
}

// Kernels 23 and 24 in the n-point form on the real tile: n = 128 * F,
// 1 <= F <= 256 (odd F <= 255 on the routes). wq: (F, 128, 128) complex64
// for n, sign -1, unscaled; wf: (F, F) DFT-F, sign -1; c: post (n,)
// s e^{-i pi k / 2n} (DCT-II) or the n-point chirp (F + 128,)
// e^{-i pi a / 2F}, then s e^{-i pi b / 2n} (DCT-III). C: rows per tile, a
// power of two <= 16 whose tile fits (bts2_wide.cuh::wide_real_smem_bytes).
extern "C" int ndfft_dct_nat_npoint(int type3, const void* x, void* y, const void* wq,
                                    const void* wf, const void* c, long long T, int n, int C,
                                    void* stream) {
  return ndfft::dct_wide_launch<true>(type3 != 0, true, x, y, wq, wf, nullptr, c, 1, n, T, C,
                                      stream);
}
