// Kernel 12: Bluestein's chirp-z along the middle axis of a (B, n, L)
// float32 tensor, for a length n with a prime factor above 128, in one pass
// on the bts2 core. (Kernel 11, the complex64 C2C on the same chirp-z, runs
// on the mixed-radix core's column tile at every F: fft_blue_radix.cu.)
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_blue_rr (built
// by _build_call_axis_mid_blue_rr, called by dct23_blue_pallas_mid): the
// chirp-z on a real column with Re(z b) out, which the Makhoul DCT-II/III
// takes at a Bluestein length, its twiddles (and DCT-III's c0/2) folded
// into the chirps on the host. For each column, with M = 128 * F >= 2n - 1:
//
//   u = x a, zero-padded to M;  Z = IFFT_M(FFT_M(u) H) (1/M and the user
//   scale in the inverse core's Wq);  y[k] = Re(Z[k] b[k]),  k < n,
//
// with the chirps a, b and H = FFT_M of the wrapped inverse chirp built on
// the host (ops/hopper/dct.py::blue_rr_consts; the JAX package's tables bit
// for bit). The load/store struct BlueRR serves both bts2 forms:
//
// * the fixed form (F in {4, 8, 16}, bts2_core.cuh; the routes never send
//   it, they send n > 1100, F >= 18): the core leaves its output in natural
//   order in its tile, so the block fills the chirped column and explicit
//   zeros to row M (a tile left from the last column is not zero), runs the
//   forward core, multiplies row k by H[k] in place, runs the inverse core
//   and stores rows k < n;
// * the wide form (every other F <= 111, bts2_wide.cuh): its core reads the
//   whole tile while its store callback writes the outputs, so it cannot
//   work in place. The forward core's store writes d H[k] into a second
//   shared tile, and the inverse core runs on that tile with the exit chirp
//   in its store. At one column and M = 13568 (F = 106, the routes' largest)
//   the block takes 8 (2M + 4 * 128) + 8F = 222,032 bytes of the 232,448 it
//   may have.
//
// What bounds it: the core's stage 2, a dense DFT-128 on the FP32 cores,
// twice per column at length M >= 2n - 1: ~16 (128 + F) M FLOPs per column
// against the 2.5 n log2 n of the function, so the kernel is bound by the
// FP32 cores, not by the 8 bytes per element it reads and writes once. The
// design keeps the whole convolution in shared memory (device memory is
// read once and written once, the padding never exists outside the block),
// and takes every table from the host. The TPU kernel's zero-aware first
// butterfly level and its trimmed inverse Wq (p_trim) only save work and are
// left to later work, as is the wide form's one-column tile at M > 6000;
// the kernel goes onto the radix column tile (fft_blue_radix.cu, as kernel
// 11 did) when its turn comes.
#include "bts2_wide.cuh"

namespace ndfft {

// The load and store: float32 in and out, the real part of z b.
struct BlueRR {
  const float* x;
  float* y;
  const float2* a;
  const float2* b;
  __device__ float2 load(long long off, int t) const {
    const float v = x[off];
    const float2 w = __ldg(a + t);
    return make_float2(v * w.x, v * w.y);
  }
  __device__ void store(long long off, int k, float2 z) const {
    const float2 w = __ldg(b + k);
    y[off] = z.x * w.x - z.y * w.y;
  }
};

// The fixed form: one block per (b, tile of C columns), M = 128 * F.
template <int F, int C, class IO>
__global__ void __launch_bounds__(kThreads)
blue_mid_kernel(IO io, const float2* __restrict__ h, const float2* __restrict__ wq_fwd,
                const float2* __restrict__ wq_inv, int n, long long L, long long tiles) {
  constexpr int MM = F * kM;
  extern __shared__ float2 s[];
  long long col0;
  int valid;
  const long long bb = fixed_tile<C>(L, tiles, col0, valid);
  const long long base = bb * n * L + col0;
  fixed_fill<C>(s, MM, valid, [&](int t, int c) {
    return t < n ? io.load(base + t * L + c, t) : make_float2(0.f, 0.f);
  });
  __syncthreads();
  Bts2<F, C, false>::run(s, wq_fwd, -1.f);
  for (int idx = threadIdx.x; idx < MM * C; idx += kThreads)
    s[idx] = cmul(s[idx], __ldg(h + idx / C));
  __syncthreads();
  Bts2<F, C, false>::run(s, wq_inv, 1.f);
  for (int idx = threadIdx.x; idx < n * C; idx += kThreads) {
    const int k = idx / C;
    const int c = idx % C;
    if (c < valid) io.store(base + k * L + c, k, s[idx]);
  }
}

// Dynamic shared memory of the wide form: the wide core's tile, Y scratch
// and row W_F^k (wide_smem_bytes), and the second tile of M x C.
inline long long blue_wide_smem_bytes(int M, int C) {
  return wide_smem_bytes(M, C) + (long long)sizeof(float2) * M * C;
}

// The wide form: one block per (b, tile of at most C columns), the L
// columns spread evenly over the tiles.
template <int C, class IO>
__global__ void __launch_bounds__(kThreads)
blue_mid_wide_kernel(IO io, const float2* __restrict__ h, const float2* __restrict__ wq_fwd,
                     const float2* __restrict__ wf_fwd, const float2* __restrict__ wq_inv,
                     const float2* __restrict__ wf_inv, int n, int F, long long L,
                     long long tiles) {
  const int MM = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, MM, C);
  float2* s2 = sm.wt + F;   // the second tile, element (k, c) at s2[k * C + c]
  const long long bb = blockIdx.x / tiles;
  long long col0;
  int valid;
  wide_tile(L, tiles, blockIdx.x % tiles, col0, valid);
  const long long base = bb * n * L + col0;
  wide_fill<C, false>(sm.s, MM, valid, [&](int t, int c) {
    return t < n ? io.load(base + t * L + c, t) : make_float2(0.f, 0.f);
  });
  wide_load_row(sm.wt, wf_fwd, F);
  __syncthreads();
  const Bts2Wide<C, false> core{MM, F};
  core.run(sm.s, sm.ys, sm.wt, wq_fwd, valid, [=](int c, long long k, float2 d) {
    s2[k * C + c] = cmul(d, __ldg(h + k));
  });
  // the core ends with a barrier: the row of the inverse may replace it
  wide_load_row(sm.wt, wf_inv, F);
  __syncthreads();
  core.run(s2, sm.ys, sm.wt, wq_inv, valid, [=](int c, long long k, float2 z) {
    if (k < n) io.store(base + k * L + c, (int)k, z);
  });
}

inline bool blue_shape_ok(int n, int M) { return M % kM == 0 && n >= 1 && 2 * n - 1 <= M; }

template <class IO>
cudaError_t blue_fixed(IO io, const void* h, const void* wq_fwd, const void* wq_inv,
                       long long B, int n, int M, long long L, int C, void* stream) {
  if (!blue_shape_ok(n, M)) return cudaErrorInvalidValue;
  return fixed_dispatch<4>(M, C, [&](auto f, auto c) {
    constexpr int kF = decltype(f)::value, kC = decltype(c)::value;
    return fixed_launch<kF, kC>(blue_mid_kernel<kF, kC, IO>, B, L,
                                static_cast<cudaStream_t>(stream), io,
                                static_cast<const float2*>(h), static_cast<const float2*>(wq_fwd),
                                static_cast<const float2*>(wq_inv), n, L);
  });
}

template <class IO>
cudaError_t blue_wide(IO io, const void* h, const void* wq_fwd, const void* wf_fwd,
                      const void* wq_inv, const void* wf_inv, long long B, int n, int M,
                      long long L, int C, void* stream) {
  if (!blue_shape_ok(n, M)) return cudaErrorInvalidValue;
  return wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch_smem<kC>(
        blue_mid_wide_kernel<kC, IO>, M, blue_wide_smem_bytes(M, kC), B, L,
        static_cast<cudaStream_t>(stream), io, static_cast<const float2*>(h),
        static_cast<const float2*>(wq_fwd), static_cast<const float2*>(wf_fwd),
        static_cast<const float2*>(wq_inv), static_cast<const float2*>(wf_inv), n, M / kM, L);
  });
}

}  // namespace ndfft

// Kernel 12 on the fixed core: x, y: (B, n, L) float32, contiguous; a, b:
// (n,) complex64 entry and exit constants (the chirp exp(-i pi t^2 / n) with
// the Makhoul twiddle and scale folded into b for DCT-II, into a for
// DCT-III); h: (M,) complex64 H; wq_fwd, wq_inv: (F, 128, 128) complex64 of
// M = 128 * F, F in {4, 8, 16}, signs -1 and +1, the inverse's with 1 / M;
// 2n - 1 <= M. C: columns per block, a power of two with M * C <= 8192.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct23_blue_mid(const void* x, void* y, const void* a, const void* b,
                                    const void* h, const void* wq_fwd, const void* wq_inv,
                                    long long B, int n, int M, long long L, int C,
                                    void* stream) {
  using namespace ndfft;
  const BlueRR io{static_cast<const float*>(x), static_cast<float*>(y),
                  static_cast<const float2*>(a), static_cast<const float2*>(b)};
  return (int)blue_fixed(io, h, wq_fwd, wq_inv, B, n, M, L, C, stream);
}

// Kernel 12 on the wide core: as above at any F <= 111, with wf_fwd, wf_inv:
// the (F, F) complex64 DFT-F of each sign (ops/hopper/fft.py::wide_consts);
// C: columns per tile (ops/hopper/fft.py::wide_block with blue_bytes).
extern "C" int ndfft_dct23_blue_mid_wide(const void* x, void* y, const void* a, const void* b,
                                         const void* h, const void* wq_fwd,
                                         const void* wf_fwd, const void* wq_inv,
                                         const void* wf_inv, long long B, int n, int M,
                                         long long L, int C, void* stream) {
  using namespace ndfft;
  const BlueRR io{static_cast<const float*>(x), static_cast<float*>(y),
                  static_cast<const float2*>(a), static_cast<const float2*>(b)};
  return (int)blue_wide(io, h, wq_fwd, wf_fwd, wq_inv, wf_inv, B, n, M, L, C, stream);
}
