// Kernel 17: the C2R along the middle axis of a (B, n/2 + 1, L) complex64
// spectrum to (B, n, L) float32, even n = 2h, h = 128 * F: F in
// {2, 4, 8, 16} on the fixed core, every other F <= 160 on the wide core
// (c2r_mid_wide_kernel below). (Kernel 16, the R2C, ran here on the bts2
// cores until it moved onto the radix column tile: rfft_mid_radix.cu.)
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_c2r_kernel_mid (built by
// _build_c2r_mid). It is kernel 3's inverse unpack (rfft_nat.cu) in the
// bts2 column-tile layout (c2c_tile.cuh): one block per (b, tile of C
// columns), the shared core Bts2<F, C, false> (bts2_core.cuh) as the
// half-length inverse FFT of each column, in shared memory.
//
//   G[k] = A[k] S[k] + B[k] conj S[h-k] with the DC and Nyquist imaginary
//   parts set to 0 (A, B and the scale as in rfft_nat.cu), z = IFFT_h(G)
//   unnormalized, x[2l] = Re z[l] and x[2l+1] = Im z[l] as two row stores.
//
// The TPU kernel ran [P | conj Q] through the core to avoid gathering the
// mirror row; here the mirror is a second coalesced row load that L2
// serves, so each column takes one IFFT_h. The last column tile may be
// ragged (L = 130, 200 on the tests): loads past L read 0 and stores past L
// are masked. Every constant comes from the host (ops/hopper/rfft.py), so
// the kernel does no twiddle work. The bound is that of the core: stage 2's
// dense DFT-128 on the FP32 CUDA cores (bts2_core.cuh); the device memory
// is read once and written once. The wide C2R's pre-pass reads rows k and
// h - k from device memory into the tile, and the core's store callback
// writes Re z[l] and Im z[l] to real rows 2l and 2l + 1.
#include "bts2_wide.cuh"

namespace ndfft {

template <int F, int C>
__global__ void __launch_bounds__(kThreads, 2)
c2r_mid_kernel(const float2* __restrict__ spec, float* __restrict__ out,
               const float2* __restrict__ wq, const float4* __restrict__ ab,
               long long L, long long tiles) {
  constexpr int H = F * kM;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  const float2* sb = spec + bb * (H + 1) * L + col0;
  fixed_fill<C>(s, H, valid, [&](int k, int c) { return c2r_pre(sb + c, ab, H, k, L); });
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

// spec: (B, n/2 + 1, L) complex64; out: (B, n, L) float32; wq: (F, 128, 128)
// complex64 for h = n/2, sign +1, unscaled; ab: (h, 4) float32 rows
// (A.re, A.im, B.re, B.im) with the scale folded in.
extern "C" int ndfft_c2r_mid(const void* spec, void* out, const void* wq,
                             const void* ab, long long B, int n, long long L,
                             int C, void* stream) {
  using namespace ndfft;
  if (n % 2) return (int)cudaErrorInvalidValue;
  return (int)fixed_dispatch<2>(n / 2, C, [&](auto f, auto c) {
    constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
    return fixed_launch<kF, kC>(c2r_mid_kernel<kF, kC>, B, L, static_cast<cudaStream_t>(stream),
                                static_cast<const float2*>(spec), static_cast<float*>(out),
                                static_cast<const float2*>(wq), static_cast<const float4*>(ab),
                                L);
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
