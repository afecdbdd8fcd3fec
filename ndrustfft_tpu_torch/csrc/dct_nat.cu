// Kernels 23 and 24: DCT-II and DCT-III of contiguous float32 rows, even
// n = 128 * k, k <= 256 (the JAX gate's split (128, k)): on the fixed core
// below for n = 2h, h = 128 * F, F in {1, 2, 4, 8, 16} (n = 256 ... 4096),
// on the wide core (dct_wide.cuh, entries at the end of this file) at every
// other n: the half-length form for even k (h = 128 * k/2), the n-point
// form on a real tile for odd k (n = 128, 384, 640 ... 32640).
//
// Kernel 23 replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel (built by
// _build_dct2, called by dct2_pallas); kernel 24 replaces dct.py::_dct3_kernel
// (built by _build_dct3) together with dct3_pallas's interleave epilogue
// (dct.py:320-323), which here is the kernel's store. Both compute the
// rustdct convention times a scale s (the handler's policy: Default s = 2).
//
//   DCT-II  (Makhoul): v = [x0, x2, .., x_{n-2}, x_{n-1}, .., x3, x1];
//           V = FFT_n(v), a real input, by the half-length R2C (kernel 2's math)
//           on the bts2 core: z[t] = v[2t] + i v[2t+1], Z = FFT_h(z),
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
// One block owns R whole rows in shared memory (R * h float2, at most 64 KB):
// device memory is read once and written once per element, the Makhoul
// permutation and the mirror reads Z[-k], x[n-k] are shared-memory reads, and
// the DCT-III output interleave is a permuted store out of shared memory.
// What bounds them on this card is the core's stage 2 (a dense DFT-128 on the
// FP32 CUDA cores, see bts2_core.cuh); the kernel adds one n-element
// permutation pass in shared memory and an O(n) epilogue per row.
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
dct2_nat_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float2* __restrict__ wq, const float2* __restrict__ tw,
                const float2* __restrict__ post, long long T) {
  constexpr int H = F * kM;
  constexpr int NN = 2 * H;
  constexpr int PER = (R * H + kThreads - 1) / kThreads;  // float2 per thread
  extern __shared__ float2 s[];
  const long long row0 = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, T - row0);
  load_rows<F, R>(s, x, row0, valid);
  __syncthreads();
  // Makhoul permutation in place, through registers: z[t] = (v[2t], v[2t+1]),
  // v[p] = x[2p] for p < h, x[2n - 1 - 2p] for p >= h
  const float* sf = reinterpret_cast<const float*>(s);
  float2 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    if (idx < R * H) {
      const float* row = sf + (idx / H) * NN;
      const int p = 2 * (idx % H);
      const float a = p < H ? row[2 * p] : row[2 * NN - 1 - 2 * p];
      const float b = p + 1 < H ? row[2 * p + 2] : row[2 * NN - 3 - 2 * p];
      v[j] = make_float2(a, b);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int idx = j * kThreads + threadIdx.x;
    if (idx < R * H) s[idx] = v[j];
  }
  __syncthreads();
  Bts2<F, R, true>::run(s, wq, -1.f);
  float* yb = y + row0 * NN;
  for (int idx = threadIdx.x; idx < valid * H; idx += kThreads) {
    const int r = idx / H;
    const int k = idx % H;
    const float2* z = s + r * H;
    const float2 zk = z[k];
    const float2 zm = z[(H - k) % H];
    const float2 fe = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
    const float2 fo = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
    const float2 w = __ldg(tw + k);
    const float vr = fe.x + (fo.x * w.x - fo.y * w.y);
    const float vi = fe.y + (fo.x * w.y + fo.y * w.x);
    float* yr = yb + (long long)r * NN;
    const float2 pk = __ldg(post + k);
    yr[k] = pk.x * vr - pk.y * vi;
    if (k == 0) {
      yr[H] = __ldg(post + H).x * (zk.x - zk.y);  // V[h] = Re Z0 - Im Z0 is real
    } else {
      const float2 pm = __ldg(post + NN - k);   // V[n-k] = conj V[k]
      yr[NN - k] = pm.x * vr + pm.y * vi;
    }
  }
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
static cudaError_t launch_dct(bool type3, const float* x, float* y,
                              const float2* wq, const void* c1, const float2* c2,
                              long long T, cudaStream_t stream) {
  if constexpr (F * kM * R > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const int smem = F * kM * R * (int)sizeof(float2);
    const unsigned blocks = (unsigned)((T + R - 1) / R);
    cudaError_t e;
    if (type3) {
      e = cudaFuncSetAttribute(dct3_nat_kernel<F, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      dct3_nat_kernel<F, R><<<blocks, kThreads, smem, stream>>>(
          x, y, wq, static_cast<const float4*>(c1), c2, T);
    } else {
      e = cudaFuncSetAttribute(dct2_nat_kernel<F, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      dct2_nat_kernel<F, R><<<blocks, kThreads, smem, stream>>>(
          x, y, wq, static_cast<const float2*>(c1), c2, T);
    }
    return cudaGetLastError();
  }
}

template <int F>
static cudaError_t dispatch_dct(int R, bool type3, const float* x, float* y,
                                const float2* wq, const void* c1,
                                const float2* c2, long long T,
                                cudaStream_t stream) {
  switch (R) {
    case 1: return launch_dct<F, 1>(type3, x, y, wq, c1, c2, T, stream);
    case 2: return launch_dct<F, 2>(type3, x, y, wq, c1, c2, T, stream);
    case 4: return launch_dct<F, 4>(type3, x, y, wq, c1, c2, T, stream);
    case 8: return launch_dct<F, 8>(type3, x, y, wq, c1, c2, T, stream);
    case 16: return launch_dct<F, 16>(type3, x, y, wq, c1, c2, T, stream);
    case 32: return launch_dct<F, 32>(type3, x, y, wq, c1, c2, T, stream);
    case 64: return launch_dct<F, 64>(type3, x, y, wq, c1, c2, T, stream);
    default: return cudaErrorInvalidValue;
  }
}

static int dct_entry(bool type3, const void* x, void* y, const void* wq,
                     const void* c1, const void* c2, long long T, int n, int R,
                     void* stream) {
  if (n % 2) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const float2* wp = static_cast<const float2*>(wq);
  const float2* c2p = static_cast<const float2*>(c2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n / 2) {
    case kM: return dispatch_dct<1>(R, type3, xp, yp, wp, c1, c2p, T, st);
    case 2 * kM: return dispatch_dct<2>(R, type3, xp, yp, wp, c1, c2p, T, st);
    case 4 * kM: return dispatch_dct<4>(R, type3, xp, yp, wp, c1, c2p, T, st);
    case 8 * kM: return dispatch_dct<8>(R, type3, xp, yp, wp, c1, c2p, T, st);
    case 16 * kM: return dispatch_dct<16>(R, type3, xp, yp, wp, c1, c2p, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ndfft

// x, y: (T, n) float32 rows, 8-byte aligned; wq: (F, 128, 128) complex64 for
// h = n/2, sign -1; tw: (h,) complex64 W_n^k; post: (n,) complex64
// s e^{-i pi k / 2n}. R: rows per block, a power of two with (n/2) * R <= 8192.
extern "C" int ndfft_dct2_nat(const void* x, void* y, const void* wq,
                              const void* tw, const void* post, long long T,
                              int n, int R, void* stream) {
  return ndfft::dct_entry(false, x, y, wq, tw, post, T, n, R, stream);
}

// x, y: (T, n) float32 rows, 8-byte aligned; wq: (F, 128, 128) complex64 for
// h = n/2, sign +1, unscaled; ab: (h, 4) float32 kernel-3 unpack rows, scale 1;
// pre: (h + 1,) complex64 (s/2) e^{+i pi k / 2n}.
extern "C" int ndfft_dct3_nat(const void* x, void* y, const void* wq,
                              const void* ab, const void* pre, long long T,
                              int n, int R, void* stream) {
  return ndfft::dct_entry(true, x, y, wq, ab, pre, T, n, R, stream);
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
