// Kernels 16 and 17: R2C and C2R along the middle axis of a (B, n, L)
// tensor, even n = 2h, h = 128 * F: F in {2, 4, 8, 16} on the fixed core,
// every other F <= 160 on the wide core (r2c_col.cuh's wide kernel for the
// R2C, c2r_mid_wide_kernel below for the C2R).
//
// Kernel 16 replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_kernel_mid
// (built by _build_r2c_mid); kernel 17 replaces rfft.py::_c2r_kernel_mid
// (built by _build_c2r_mid). They are kernels 2 and 3's unpack math
// (rfft_radix.cu, rfft_nat.cu) in kernel 1's column-tile layout (fft_axis_mid.cu): one block
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
// The R2C's kernels are r2c_col.cuh's, shared with kernels 18 and 19, with
// the load and store below (MidIo); on the wide core (bts2_wide.cuh) Z goes
// into the output's first h rows of its own columns and is unpacked there in
// place. The wide C2R needs no mirror after the core: its pre-pass reads
// rows k and h - k from device memory into the tile, and the core's store
// callback writes Re z[l] and Im z[l] to real rows 2l and 2l + 1.
#include "r2c_col.cuh"

namespace ndfft {

// Kernel 16's load and store: z[t] = x[2t] + i x[2t+1] from (B, 2h, L), X
// to (B, h + 1, L) complex64, Z in the output's rows 0 .. h - 1 (wide core).
struct MidIo {
  const float* __restrict__ x;
  float2* out;
  int h;
  long long L;
  __device__ float2 load(long long b, int t, long long col) const {
    const float* p = x + (b * 2 * h + 2 * t) * L + col;
    return make_float2(__ldg(p), __ldg(p + L));
  }
  __device__ float2* z(long long b) const { return out + b * (h + 1) * L; }
  __device__ void store(long long b, int k, long long col, float2 v) const {
    out[(b * (h + 1) + k) * L + col] = v;
  }
};

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

static int r2c_mid_entry(bool wide, const void* x, void* out, const void* wq, const void* wf,
                         const void* tw, long long B, int n, long long L, int C, void* stream) {
  if (n % 2) return (int)cudaErrorInvalidValue;
  const MidIo io{static_cast<const float*>(x), static_cast<float2*>(out), n / 2, L};
  return (int)r2c_col_launch(wide, io, n / 2, wq, wf, tw, 1.f, B, L, C, stream);
}

}  // namespace ndfft

// x: (B, n, L) float32; out: (B, n/2 + 1, L) complex64; wq: (F, 128, 128)
// complex64 for h = n/2, sign -1; tw: (h,) complex64, W_n^k; all contiguous.
// C: columns per block, a power of two with (n/2) * C <= 8192.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_mid(const void* x, void* out, const void* wq,
                             const void* tw, long long B, int n, long long L,
                             int C, void* stream) {
  return ndfft::r2c_mid_entry(false, x, out, wq, nullptr, tw, B, n, L, C, stream);
}

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

// Kernel 16 on the wide core, h = n/2 = 128 * F with 1 <= F <= 160: x, out,
// wq and tw as for ndfft_r2c_mid; wf: (F, F) complex64 DFT-F, sign -1. C:
// columns per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes). Returns the cudaError_t of the launch.
extern "C" int ndfft_r2c_mid_wide(const void* x, void* out, const void* wq, const void* wf,
                                  const void* tw, long long B, int n, long long L, int C,
                                  void* stream) {
  return ndfft::r2c_mid_entry(true, x, out, wq, wf, tw, B, n, L, C, stream);
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
