// Kernels 16 and 17: R2C and C2R along the middle axis of a (B, n, L)
// tensor, even n = 2h, h = 128 * F: F in {2, 4, 8, 16} on the fixed core,
// every other F <= 160 on the wide core (r2c_mid_wide_kernel and
// c2r_mid_wide_kernel at the end of this file).
//
// Kernel 16 replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_kernel_mid
// (built by _build_r2c_mid); kernel 17 replaces rfft.py::_c2r_kernel_mid
// (built by _build_c2r_mid). They are kernels 2 and 3's unpack math
// (rfft_nat.cu) in kernel 1's column-tile layout (fft_axis_mid.cu): one block
// per (b, tile of C columns), the shared core Bts2<F, C, false>
// (bts2_core.cuh) as the half-length FFT of each column, in shared memory.
//
//   R2C:  z[t] = x[2t] + i x[2t+1] (two row loads: the TPU kernel's free
//         middle-dim reshape (n, TL) -> (h, 2, TL)), Z = FFT_h(z),
//         X[k] = Fe + W_n^k Fo (k < h) with Fe, Fo from Z[k] and the mirror
//         Z[(h-k) % h] of the same column, X[h] = Re Z[0] - Im Z[0]; the
//         h + 1 rows go straight to torch's interleaved complex64.
//   C2R:  G[k] = A[k] S[k] + B[k] conj S[h-k] with the DC and Nyquist
//         imaginary parts set to 0 (A, B and the scale as in rfft_nat.cu),
//         z = IFFT_h(G) unnormalized, x[2l] = Re z[l] and x[2l+1] = Im z[l]
//         as two row stores.
// The TPU kernels ran [z | conj z] (and [P | conj Q]) through the core to
// avoid gathering the mirror row; here the mirror is a shared-memory read
// (R2C) or a second coalesced row load that L2 serves (C2R), so each column
// takes one FFT_h. The last column tile may be ragged (L = 130, 200 on the
// tests): loads past L read 0 and stores past L are masked. Every constant
// comes from the host (ops/hopper/rfft.py), so the kernels do no twiddle
// work. The bound is that of the core: stage 2's dense DFT-128 on the FP32
// CUDA cores (bts2_core.cuh); the device memory is read once and written once.
//
// On the wide core (bts2_wide.cuh) the tile stays intact and the core writes
// each output straight to device memory, so no column holds its whole
// spectrum Z in shared memory when the R2C's unpack needs the mirror
// Z[(h - k) mod h]. The wide R2C writes Z into the output's first h rows of
// its own columns, and after the core's closing block barrier each thread
// unpacks one mirror pair {k, h - k} of one column in place
// (bts2_core.cuh::r2c_unpack, consecutive threads on consecutive columns:
// the rows stay coalesced and were written by this block a moment before,
// so L2 serves the reread). The wide C2R needs no mirror after the core: its
// pre-pass reads rows k and h - k from device memory into the tile, and the
// core's store callback writes Re z[l] and Im z[l] to real rows 2l and
// 2l + 1.
#include "bts2_wide.cuh"

namespace ndfft {

// Two blocks per SM (two 64 KB tiles): at F = 2, C = 32 ptxas otherwise gives
// kernel 16 132 registers, which leaves one block per SM.
template <int F, int C>
__global__ void __launch_bounds__(kThreads, 2)
r2c_mid_kernel(const float* __restrict__ x, float2* __restrict__ out,
               const float2* __restrict__ wq, const float2* __restrict__ tw,
               long long L, long long tiles) {
  constexpr int H = F * kM;
  extern __shared__ float2 s[];
  const long long bb = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * C;
  const int valid = (int)min((long long)C, L - col0);
  const float* xb = x + bb * 2 * H * L + col0;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int t = idx / C;
    const int c = idx % C;
    s[idx] = c < valid ? make_float2(xb[(2 * t) * L + c], xb[(2 * t + 1) * L + c])
                       : make_float2(0.f, 0.f);
  }
  __syncthreads();
  Bts2<F, C, false>::run(s, wq, -1.f);
  float2* ob = out + bb * (H + 1) * L + col0;
  for (int idx = threadIdx.x; idx < (H + 1) * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c >= valid) continue;
    float2 X;
    if (k == H) {
      const float2 z0 = s[c];
      X = make_float2(z0.x - z0.y, 0.f);
    } else {
      const float2 zk = s[k * C + c];
      const float2 zm = s[((H - k) % H) * C + c];
      const float2 fe = make_float2(0.5f * (zk.x + zm.x), 0.5f * (zk.y - zm.y));
      const float2 fo = make_float2(0.5f * (zk.y + zm.y), -0.5f * (zk.x - zm.x));
      const float2 w = __ldg(tw + k);
      X = make_float2(fe.x + (fo.x * w.x - fo.y * w.y),
                      fe.y + (fo.x * w.y + fo.y * w.x));
    }
    ob[k * L + c] = X;
  }
}

template <int F, int C>
__global__ void __launch_bounds__(kThreads, 2)
c2r_mid_kernel(const float2* __restrict__ spec, float* __restrict__ out,
               const float2* __restrict__ wq, const float4* __restrict__ ab,
               long long L, long long tiles) {
  constexpr int H = F * kM;
  extern __shared__ float2 s[];
  const long long bb = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * C;
  const int valid = (int)min((long long)C, L - col0);
  const float2* sb = spec + bb * (H + 1) * L + col0;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    float2 g = make_float2(0.f, 0.f);
    if (c < valid) {
      float2 sk = sb[k * L + c];
      float2 sm = sb[(H - k) * L + c];  // k = 0: the Nyquist bin S[h]
      if (k == 0) {  // DC imag forced to 0; the Nyquist imag is ignored
        sk.y = 0.f;
        sm.y = 0.f;
      }
      const float4 cf = __ldg(ab + k);  // (A.re, A.im, B.re, B.im)
      g.x = cf.x * sk.x - cf.y * sk.y + cf.z * sm.x + cf.w * sm.y;
      g.y = cf.x * sk.y + cf.y * sk.x + cf.w * sm.x - cf.z * sm.y;
    }
    s[idx] = g;
  }
  __syncthreads();
  Bts2<F, C, false>::run(s, wq, 1.f);
  float* ob = out + bb * 2 * H * L + col0;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int l = idx / C;
    const int c = idx % C;
    if (c < valid) {
      const float2 z = s[idx];
      ob[(2 * l) * L + c] = z.x;
      ob[(2 * l + 1) * L + c] = z.y;
    }
  }
}

template <int F, int C>
static cudaError_t launch_mid(bool inverse, const void* in, void* out,
                              const float2* wq, const void* extra, long long B,
                              long long L, cudaStream_t stream) {
  if constexpr (F * kM * C > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const long long tiles = (L + C - 1) / C;
    if (B * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(B * tiles);
    const int smem = F * kM * C * (int)sizeof(float2);
    cudaError_t e;
    if (inverse) {
      e = cudaFuncSetAttribute(c2r_mid_kernel<F, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      c2r_mid_kernel<F, C><<<blocks, kThreads, smem, stream>>>(
          static_cast<const float2*>(in), static_cast<float*>(out), wq,
          static_cast<const float4*>(extra), L, tiles);
    } else {
      e = cudaFuncSetAttribute(r2c_mid_kernel<F, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      r2c_mid_kernel<F, C><<<blocks, kThreads, smem, stream>>>(
          static_cast<const float*>(in), static_cast<float2*>(out), wq,
          static_cast<const float2*>(extra), L, tiles);
    }
    return cudaGetLastError();
  }
}

template <int F>
static cudaError_t dispatch_mid(int C, bool inverse, const void* in, void* out,
                                const float2* wq, const void* extra, long long B,
                                long long L, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_mid<F, 1>(inverse, in, out, wq, extra, B, L, stream);
    case 2: return launch_mid<F, 2>(inverse, in, out, wq, extra, B, L, stream);
    case 4: return launch_mid<F, 4>(inverse, in, out, wq, extra, B, L, stream);
    case 8: return launch_mid<F, 8>(inverse, in, out, wq, extra, B, L, stream);
    case 16: return launch_mid<F, 16>(inverse, in, out, wq, extra, B, L, stream);
    case 32: return launch_mid<F, 32>(inverse, in, out, wq, extra, B, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

static int mid_entry(bool inverse, const void* in, void* out, const void* wq,
                     const void* extra, long long B, int n, long long L, int C,
                     void* stream) {
  const float2* wp = static_cast<const float2*>(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 2) return (int)cudaErrorInvalidValue;
  switch (n / 2) {
    case 2 * kM: return dispatch_mid<2>(C, inverse, in, out, wp, extra, B, L, st);
    case 4 * kM: return dispatch_mid<4>(C, inverse, in, out, wp, extra, B, L, st);
    case 8 * kM: return dispatch_mid<8>(C, inverse, in, out, wp, extra, B, L, st);
    case 16 * kM: return dispatch_mid<16>(C, inverse, in, out, wp, extra, B, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 16 on the wide core: the column tile of z, the core with Z written
// into the output rows 0 .. h - 1, then the unpack of each column in place.
template <int C>
__global__ void __launch_bounds__(kThreads)
r2c_mid_wide_kernel(const float* __restrict__ x, float2* out, const float2* __restrict__ wq,
                    const float2* __restrict__ wf, const float2* __restrict__ tw, int F,
                    long long L, long long tiles) {
  const int H = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, H, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float* xb = x + bb * 2 * H * L + col0;
  wide_fill<C, false>(sm.s, H, valid, [&](int t, int c) {
    return make_float2(xb[(2 * t) * L + c], xb[(2 * t + 1) * L + c]);
  });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float2* ob = out + bb * (H + 1) * L + col0;
  // ends with a barrier: Z of every column of the tile is in device memory
  Bts2Wide<C, false>{H, F}.run(sm.s, sm.ys, sm.wt, wq, valid, ob, 1, L);
  r2c_unpack<true>(ob, H, valid, 1, L, tw);
}

// Kernel 17 on the wide core: the pre-pass from rows k and h - k of the
// spectrum, the core, and z stored as the real rows 2l and 2l + 1.
template <int C>
__global__ void __launch_bounds__(kThreads)
c2r_mid_wide_kernel(const float2* __restrict__ spec, float* __restrict__ out,
                    const float2* __restrict__ wq, const float2* __restrict__ wf,
                    const float4* __restrict__ ab, int F, long long L, long long tiles) {
  const int H = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, H, C);
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const float2* sb = spec + bb * (H + 1) * L + col0;
  wide_fill<C, false>(sm.s, H, valid,
                      [&](int k, int c) { return c2r_pre(sb + c, ab, H, k, L); });
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  float* ob = out + bb * 2 * H * L + col0;
  Bts2Wide<C, false>{H, F}.run(sm.s, sm.ys, sm.wt, wq, valid, [=](int c, long long l, float2 z) {
    ob[2 * l * L + c] = z.x;
    ob[(2 * l + 1) * L + c] = z.y;
  });
}

}  // namespace ndfft

// x: (B, n, L) float32; out: (B, n/2 + 1, L) complex64; wq: (F, 128, 128)
// complex64 for h = n/2, sign -1; tw: (h,) complex64, W_n^k; all contiguous.
// C: columns per block, a power of two with (n/2) * C <= 8192.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_mid(const void* x, void* out, const void* wq,
                             const void* tw, long long B, int n, long long L,
                             int C, void* stream) {
  return ndfft::mid_entry(false, x, out, wq, tw, B, n, L, C, stream);
}

// spec: (B, n/2 + 1, L) complex64; out: (B, n, L) float32; wq: (F, 128, 128)
// complex64 for h = n/2, sign +1, unscaled; ab: (h, 4) float32 rows
// (A.re, A.im, B.re, B.im) with the scale folded in.
extern "C" int ndfft_c2r_mid(const void* spec, void* out, const void* wq,
                             const void* ab, long long B, int n, long long L,
                             int C, void* stream) {
  return ndfft::mid_entry(true, spec, out, wq, ab, B, n, L, C, stream);
}

// Kernel 16 on the wide core, h = n/2 = 128 * F with 1 <= F <= 160: x, out,
// wq and tw as for ndfft_r2c_mid; wf: (F, F) complex64 DFT-F, sign -1. C:
// columns per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes). Returns the cudaError_t of the launch.
extern "C" int ndfft_r2c_mid_wide(const void* x, void* out, const void* wq, const void* wf,
                                  const void* tw, long long B, int n, long long L, int C,
                                  void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  const int h = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(r2c_mid_wide_kernel<kC>, h, B, L, static_cast<cudaStream_t>(stream),
                           static_cast<const float*>(x), static_cast<float2*>(out),
                           static_cast<const float2*>(wq), static_cast<const float2*>(wf),
                           static_cast<const float2*>(tw), h / kM, L);
  });
}

// Kernel 17 on the wide core: spec, out, wq and ab as for ndfft_c2r_mid; wf:
// (F, F) complex64 DFT-F, sign +1; C as above.
extern "C" int ndfft_c2r_mid_wide(const void* spec, void* out, const void* wq, const void* wf,
                                  const void* ab, long long B, int n, long long L, int C,
                                  void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  const int h = n / 2;
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(c2r_mid_wide_kernel<kC>, h, B, L, static_cast<cudaStream_t>(stream),
                           static_cast<const float2*>(spec), static_cast<float*>(out),
                           static_cast<const float2*>(wq), static_cast<const float2*>(wf),
                           static_cast<const float4*>(ab), h / kM, L);
  });
}
