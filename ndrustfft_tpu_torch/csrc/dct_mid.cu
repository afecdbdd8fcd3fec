// Kernels 25 and 26: DCT-II and DCT-III along the middle axis of a
// (B, n, L) float32 tensor, even n = 128 * k, k <= 256 (the JAX gate's split
// (128, k); the routes send n > 1100 here, K27's dense product below).
//
// Kernel 25 replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel_mid
// (built by _build_dct2_mid, called by dct2_pallas_mid); kernel 26 replaces
// dct.py::_dct3_kernel_mid (built by _build_dct3_mid). Both compute the
// rustdct convention times a scale s, by the Makhoul passes of kernels 23/24
// (dct_nat.cu, whose header comment has the algebra) in the column-tile
// layout of kernels 16/17 (rfft_mid.cu): one block per (b, tile of C
// columns), three forms by n:
//
// * n = 2h, h = 128 * F, F in {2, 4, 8, 16} (n = 512 ... 4096): the fixed
//   core Bts2<F, C, false> on the whole column tile in shared memory
//   (dct2_mid_kernel, dct3_mid_kernel below).
//     K25: the Makhoul order is two row loads into the tile,
//          z[t] = (x[4t], x[4t+2]) for t < h/2 (the even rows) and
//          (x[2n-1-4t], x[2n-3-4t]) above (the odd rows, descending); then
//          kernel 16's half-length R2C and unpack with the mirror Z[h-k] read
//          from the tile, the post twiddle, and y[k], y[n-k] as real rows.
//     K26: S[k] = Q[k] (x[k] - i x[n-k]) from two row loads (k and n - k,
//          and the mirror h - k and h + k), kernel 17's pre-pass into the
//          tile, its half-length C2R, and the interleave y[2t] = u[t],
//          y[2t+1] = u[n-1-t] as whole-row stores from the tile. The TPU
//          kernel runs a second sign-+1 pipeline to avoid that reversed read
//          (dct.py:351-373); here u is in shared memory, so no second pass.
// * even k with h outside those factors (n = 1280, 1536, 2560 ...): the same
//   passes on the wide core (dct_wide.cuh, column layout).
// * odd k (n = 1152, 1408, 1664 ...; h = 64 k is not 128 * F): the n-point
//   form on the wide core, as the TPU kernel computes at every n
//   (dct_wide.cuh).
//
// What bounds them: the core's stage 2 on the FP32 CUDA cores
// (bts2_core.cuh, bts2_wide.cuh); device memory is read once and written
// once, the column loads and stores are whole rows of the tile's C columns,
// and every constant comes from the host (ops/hopper/dct.py).
#include "dct_wide.cuh"

namespace ndfft {

// Two blocks per SM (two 64 KB tiles), as kernels 16 and 17.
template <int F, int C>
__global__ void __launch_bounds__(kThreads, 2)
dct2_mid_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float2* __restrict__ wq, const float2* __restrict__ tw,
                const float2* __restrict__ post, long long L, long long tiles) {
  constexpr int H = F * kM;
  constexpr int NN = 2 * H;
  extern __shared__ float2 s[];
  const long long bb = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * C;
  const int valid = (int)min((long long)C, L - col0);
  const float* xb = x + bb * NN * L + col0;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int t = idx / C;
    const int c = idx % C;
    s[idx] = c < valid ? make_float2(xb[makhoul_src(2 * t, NN) * L + c],
                                     xb[makhoul_src(2 * t + 1, NN) * L + c])
                       : make_float2(0.f, 0.f);
  }
  __syncthreads();
  Bts2<F, C, false>::run(s, wq, -1.f);
  float* yb = y + bb * NN * L + col0;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c >= valid) continue;
    const float2 zk = s[k * C + c];
    const float2 v = r2c_unpack_one(zk, s[((H - k) % H) * C + c], __ldg(tw + k));
    const float2 pk = __ldg(post + k);
    yb[k * L + c] = pk.x * v.x - pk.y * v.y;
    if (k == 0) {
      yb[H * L + c] = __ldg(post + H).x * (zk.x - zk.y);   // V[h] = Re Z0 - Im Z0
    } else {
      const float2 pm = __ldg(post + NN - k);              // V[n-k] = conj V[k]
      yb[(NN - k) * L + c] = pm.x * v.x + pm.y * v.y;
    }
  }
}

template <int F, int C>
__global__ void __launch_bounds__(kThreads, 2)
dct3_mid_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float2* __restrict__ wq, const float4* __restrict__ ab,
                const float2* __restrict__ pre, long long L, long long tiles) {
  constexpr int H = F * kM;
  constexpr int NN = 2 * H;
  extern __shared__ float2 s[];
  const long long bb = blockIdx.x / tiles;
  const long long col0 = (blockIdx.x % tiles) * C;
  const int valid = (int)min((long long)C, L - col0);
  const float* xb = x + bb * NN * L + col0;
  for (int idx = threadIdx.x; idx < H * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    float2 g = make_float2(0.f, 0.f);
    if (c < valid) {
      const auto spec = [&](int j) {   // S[j] = Q[j] (x[j] - i x[n - j]), x[n] = 0
        const float a = xb[j * L + c];
        const float b = j == 0 ? 0.f : xb[(NN - j) * L + c];
        const float2 q = __ldg(pre + j);
        return make_float2(a * q.x + b * q.y, a * q.y - b * q.x);
      };
      float2 sk = spec(k);
      float2 sm = spec(H - k);
      if (k == 0) {   // S[0] and S[h] are real; drop their rounding residue
        sk.y = 0.f;
        sm.y = 0.f;
      }
      const float4 cf = __ldg(ab + k);   // (A.re, A.im, B.re, B.im)
      g = make_float2(cf.x * sk.x - cf.y * sk.y + cf.z * sm.x + cf.w * sm.y,
                      cf.x * sk.y + cf.y * sk.x + cf.w * sm.x - cf.z * sm.y);
    }
    s[idx] = g;
  }
  __syncthreads();
  Bts2<F, C, false>::run(s, wq, 1.f);
  // u[j] = component j % 2 of z[j / 2]; y[2t] = u[t], y[2t+1] = u[n-1-t]
  const float* u = reinterpret_cast<const float*>(s);
  float* yb = y + bb * NN * L + col0;
  for (int idx = threadIdx.x; idx < NN * C; idx += kThreads) {
    const int r = idx / C;
    const int c = idx % C;
    if (c >= valid) continue;
    const int j = r % 2 ? NN - 1 - r / 2 : r / 2;
    yb[r * L + c] = u[((j >> 1) * C + c) * 2 + (j & 1)];
  }
}

template <int F, int C>
static cudaError_t launch_mid(bool type3, const float* x, float* y, const float2* wq,
                              const void* c1, const float2* c2, long long B, long long L,
                              cudaStream_t stream) {
  if constexpr (F * kM * C > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const long long tiles = (L + C - 1) / C;
    if (B * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(B * tiles);
    const int smem = F * kM * C * (int)sizeof(float2);
    cudaError_t e;
    if (type3) {
      e = cudaFuncSetAttribute(dct3_mid_kernel<F, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      dct3_mid_kernel<F, C><<<blocks, kThreads, smem, stream>>>(
          x, y, wq, static_cast<const float4*>(c1), c2, L, tiles);
    } else {
      e = cudaFuncSetAttribute(dct2_mid_kernel<F, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      dct2_mid_kernel<F, C><<<blocks, kThreads, smem, stream>>>(
          x, y, wq, static_cast<const float2*>(c1), c2, L, tiles);
    }
    return cudaGetLastError();
  }
}

template <int F>
static cudaError_t dispatch_mid(int C, bool type3, const float* x, float* y,
                                const float2* wq, const void* c1, const float2* c2,
                                long long B, long long L, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_mid<F, 1>(type3, x, y, wq, c1, c2, B, L, stream);
    case 2: return launch_mid<F, 2>(type3, x, y, wq, c1, c2, B, L, stream);
    case 4: return launch_mid<F, 4>(type3, x, y, wq, c1, c2, B, L, stream);
    case 8: return launch_mid<F, 8>(type3, x, y, wq, c1, c2, B, L, stream);
    case 16: return launch_mid<F, 16>(type3, x, y, wq, c1, c2, B, L, stream);
    case 32: return launch_mid<F, 32>(type3, x, y, wq, c1, c2, B, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ndfft

// Kernels 25 (type3 = 0) and 26 (type3 = 1) on the fixed core: x, y:
// (B, n, L) float32, contiguous, n = 2h, h = 128 * F, F in {2, 4, 8, 16};
// wq, c1 and c2 as for ndfft_dct2_nat / ndfft_dct3_nat (wq: (F, 128, 128)
// complex64 for h, sign -1 / +1, unscaled; c1: tw (h,) or ab (h, 4) at scale
// 1; c2: post (n,) or pre (h + 1,)). C: columns per block, a power of two with
// h * C <= 8192. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct_mid(int type3, const void* x, void* y, const void* wq,
                             const void* c1, const void* c2, long long B, int n, long long L,
                             int C, void* stream) {
  using namespace ndfft;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const float2* wp = static_cast<const float2*>(wq);
  const float2* c2p = static_cast<const float2*>(c2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool t3 = type3 != 0;
  if (n % 2) return (int)cudaErrorInvalidValue;
  switch (n / 2) {
    case 2 * kM: return dispatch_mid<2>(C, t3, xp, yp, wp, c1, c2p, B, L, st);
    case 4 * kM: return dispatch_mid<4>(C, t3, xp, yp, wp, c1, c2p, B, L, st);
    case 8 * kM: return dispatch_mid<8>(C, t3, xp, yp, wp, c1, c2p, B, L, st);
    case 16 * kM: return dispatch_mid<16>(C, t3, xp, yp, wp, c1, c2p, B, L, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernels 25 and 26 on the wide core, half-length form: n = 2h, h = 128 * F,
// 1 <= F <= 160; x, y: (B, n, L); wq, wf, c1 and c2 as for
// ndfft_dct_nat_wide. C: columns per tile, a power of two <= 16 whose tile
// fits (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_dct_mid_wide(int type3, const void* x, void* y, const void* wq,
                                  const void* wf, const void* c1, const void* c2, long long B,
                                  int n, long long L, int C, void* stream) {
  return ndfft::dct_wide_launch<false>(type3 != 0, false, x, y, wq, wf, c1, c2, B, n, L, C,
                                       stream);
}

// Kernels 25 and 26 in the n-point form: n = 128 * F, 1 <= F <= 160; wq, wf
// and c as for ndfft_dct_nat_npoint. C as above.
extern "C" int ndfft_dct_mid_npoint(int type3, const void* x, void* y, const void* wq,
                                    const void* wf, const void* c, long long B, int n,
                                    long long L, int C, void* stream) {
  return ndfft::dct_wide_launch<false>(type3 != 0, true, x, y, wq, wf, nullptr, c, B, n, L, C,
                                       stream);
}
