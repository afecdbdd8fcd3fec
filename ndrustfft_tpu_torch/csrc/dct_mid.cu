// Kernel 26: DCT-III along the middle axis of a (B, n, L) float32 tensor,
// even n = 128 * k, k <= 256 (the JAX gate's split (128, k); the routes
// send n > 1100 here, kernel 27 below), and kernel 25 (DCT-II) at the 29
// lengths whose half length 64 k has no radix plan. Kernel 25 runs on the
// radix column tile at every other length (dct_mid_radix.cu, MakhoulCol +
// Dct2Rows), and its fixed-core form here is gone.
//
// Kernel 25 replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel_mid
// (built by _build_dct2_mid, called by dct2_pallas_mid); kernel 26 replaces
// dct.py::_dct3_kernel_mid (built by _build_dct3_mid). Both compute the
// rustdct convention times a scale s, by the Makhoul passes of kernels 23/24
// (dct_nat.cu, whose header comment has the algebra) in the column-tile
// layout of kernel 17's bts2 form (its c2c_tile.cuh column tile, since
// replaced by the radix column tile): one block per (b, tile of C
// columns), three forms by n:
//
// * n = 2h, h = 128 * F, F in {2, 4, 8, 16} (n = 512 ... 4096): kernel 26
//   on the fixed core Bts2<F, C, false> on the whole column tile in shared
//   memory (dct3_mid_kernel below): S[k] = Q[k] (x[k] - i x[n-k]) from two
//   row loads (k and n - k, and the mirror h - k and h + k), kernel 17's
//   pre-pass into the tile, its half-length C2R, and the interleave
//   y[2t] = u[t], y[2t+1] = u[n-1-t] as whole-row stores from the tile.
//   The TPU kernel runs a second sign-+1 pipeline to avoid that reversed
//   read (dct.py:351-373); here u is in shared memory, so no second pass.
// * even k with h outside those factors (n = 1280, 1536, 2560 ...): the same
//   passes on the wide core (dct_wide.cuh, column layout).
// * odd k (n = 1152, 1408, 1664 ... 32640; h = 64 k is not 128 * F): the
//   n-point form on the wide core's real tile, as the TPU kernel computes
//   at every n (dct_wide.cuh). At odd k > 160 (n >= 20608) one column fills
//   a block (131 KB at n = 32640) and each column streams the whole Wq
//   table (F * 128 KB) from L2: these long forms are bound by that stream.
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
dct3_mid_kernel(const float* __restrict__ x, float* __restrict__ y,
                const float2* __restrict__ wq, const float4* __restrict__ ab,
                const float2* __restrict__ pre, long long L, long long tiles) {
  constexpr int H = F * kM;
  constexpr int NN = 2 * H;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  const float* xb = x + bb * NN * L + col0;
  fixed_fill<C>(s, H, valid, [&](int k, int c) {
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
    return make_float2(cf.x * sk.x - cf.y * sk.y + cf.z * sm.x + cf.w * sm.y,
                       cf.x * sk.y + cf.y * sk.x + cf.w * sm.x - cf.z * sm.y);
  });
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

}  // namespace ndfft

// Kernel 26 on the fixed core: x, y: (B, n, L) float32, contiguous, n = 2h,
// h = 128 * F, F in {2, 4, 8, 16}; wq: (F, 128, 128) complex64 for h, sign
// +1, unscaled; ab: (h, 4) kernel 3 rows at scale 1; pre: (h + 1,)
// complex64 (s/2) e^{+i pi k / 2n}. C: columns per block, a power of two
// with h * C <= 8192. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct3_mid(const void* x, void* y, const void* wq, const void* ab,
                              const void* pre, long long B, int n, long long L, int C,
                              void* stream) {
  using namespace ndfft;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  const float2* wp = static_cast<const float2*>(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n % 2) return (int)cudaErrorInvalidValue;
  return (int)fixed_dispatch<2>(n / 2, C, [&](auto f, auto c) {
    constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
    return fixed_launch<kF, kC>(dct3_mid_kernel<kF, kC>, B, L, st, xp, yp, wp,
                                static_cast<const float4*>(ab),
                                static_cast<const float2*>(pre), L);
  });
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

// Kernels 25 and 26 in the n-point form on the real tile: n = 128 * F,
// 1 <= F <= 256; wq, wf and c as for ndfft_dct_nat_npoint. C: columns per
// tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_real_smem_bytes).
extern "C" int ndfft_dct_mid_npoint(int type3, const void* x, void* y, const void* wq,
                                    const void* wf, const void* c, long long B, int n,
                                    long long L, int C, void* stream) {
  return ndfft::dct_wide_launch<false>(type3 != 0, true, x, y, wq, wf, nullptr, c, B, n, L, C,
                                       stream);
}
