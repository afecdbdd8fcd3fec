// Kernel 10: C2C of contiguous rows of a (T, n) complex64 tensor, n = 128 * F:
// F in {4, 8, 16} on the fixed core, every other F <= 160 on the wide core
// (bts2_wide.cuh, c2c_rows_wide_kernel below).
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_twostep (built by
// _build_call_twostep, math _twostep_math) for the port's split m = 128.
//
// The TPU kernel transposed each (T, n) tile to (n, T) in VMEM so that its
// dense stage ran as a 2-D MXU product with the transform index on sublanes,
// then merged and transposed back. On Hopper no transpose is needed: R
// consecutive rows are one contiguous float2 copy into shared memory, the
// shared bts2 core (bts2_core.cuh) runs in its row layout (Bts2<F, R, true>,
// the layout of kernels 2 and 3, without their R2C unpack or C2R pre-pass),
// and the block stores the R rows back as one contiguous copy. Device memory
// is read once and written once. The normalization scale rides the Wq
// constants, which kernels 1 and 10 share per (n, sign, scale).
//
// What bounds it on this card: the core's stage 2, a dense DFT-128 with
// 4 * 128 real FMAs per complex output on the FP32 CUDA cores: 137 GFLOP at
// (262144, 512), >= 2.05 ms at the 67 TFLOP/s FP32 peak, against 2.15 GB of
// HBM traffic (0.64 ms at 3.35 TB/s), so the kernel is compute-bound like
// kernel 1 (the levers are in bts2_core.cuh). The design keeps
// every row in shared memory between the two stages and fills the card by
// halving R (rows per block) while the grid would leave SMs idle
// (ops/hopper/fft.py::block_rows). The last block's rows are ragged when
// T % R != 0: loads past T read zeros and stores past T are masked.
#include "bts2_wide.cuh"

namespace ndfft {

template <int F, int R>
__global__ void __launch_bounds__(kThreads)
c2c_rows_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                const float2* __restrict__ wq, long long T, float sign) {
  constexpr int N = F * kM;
  extern __shared__ float2 s[];
  const long long row0 = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, T - row0);
  const float2* xb = x + row0 * N;
  for (int idx = threadIdx.x; idx < R * N; idx += kThreads)
    s[idx] = idx < valid * N ? xb[idx] : make_float2(0.f, 0.f);
  __syncthreads();
  Bts2<F, R, true>::run(s, wq, sign);
  float2* yb = y + row0 * N;
  for (int idx = threadIdx.x; idx < valid * N; idx += kThreads) yb[idx] = s[idx];
}

template <int F, int R>
static cudaError_t launch_rows(const float2* x, float2* y, const float2* wq,
                               long long T, float sign, cudaStream_t stream) {
  if constexpr (F * kM * R > kSmemElems) {
    return cudaErrorInvalidValue;
  } else {
    const int smem = F * kM * R * (int)sizeof(float2);
    const long long blocks = (T + R - 1) / R;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        c2c_rows_kernel<F, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    c2c_rows_kernel<F, R><<<(unsigned)blocks, kThreads, smem, stream>>>(
        x, y, wq, T, sign);
    return cudaGetLastError();
  }
}

// Kernel 10 at every other butterfly factor, on the wide core
// (bts2_wide.cuh) in its row layout: the T rows spread evenly over the
// tiles of at most C rows, each tile one contiguous copy into shared memory;
// the core writes the outputs to y.
template <int C>
__global__ void __launch_bounds__(kThreads)
c2c_rows_wide_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                     const float2* __restrict__ wq, const float2* __restrict__ wf, int F,
                     long long T, long long tiles) {
  const int n = F * kM;
  extern __shared__ float2 smem[];
  const WideSmem sm(smem, n, C);
  long long row0;
  int valid;
  wide_tile(T, tiles, blockIdx.x, row0, valid);
  const float2* xb = x + row0 * n;
  for (int idx = threadIdx.x; idx < valid * n; idx += kThreads) sm.s[idx] = xb[idx];
  wide_load_row(sm.wt, wf, F);
  __syncthreads();
  Bts2Wide<C, true>{n, F}.run(sm.s, sm.ys, sm.wt, wq, valid, y + row0 * n, n, 1);
}

template <int F>
static cudaError_t dispatch_rows(int R, const float2* x, float2* y,
                                 const float2* wq, long long T, float sign,
                                 cudaStream_t stream) {
  switch (R) {
    case 1: return launch_rows<F, 1>(x, y, wq, T, sign, stream);
    case 2: return launch_rows<F, 2>(x, y, wq, T, sign, stream);
    case 4: return launch_rows<F, 4>(x, y, wq, T, sign, stream);
    case 8: return launch_rows<F, 8>(x, y, wq, T, sign, stream);
    case 16: return launch_rows<F, 16>(x, y, wq, T, sign, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ndfft

// x, y: (T, n) complex64, contiguous; wq: (F, 128, 128) complex64 (kernel 1's
// constants for n, sign and the scale). R: rows per block, a power of two
// with n * R <= 8192. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_rows(const void* x, void* y, const void* wq,
                              long long T, int n, int R, int sign,
                              void* stream) {
  using namespace ndfft;
  const float2* xp = static_cast<const float2*>(x);
  float2* yp = static_cast<float2*>(y);
  const float2* wp = static_cast<const float2*>(wq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sg = sign < 0 ? -1.f : 1.f;
  if (T < 1) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 4 * kM: return (int)dispatch_rows<4>(R, xp, yp, wp, T, sg, st);
    case 8 * kM: return (int)dispatch_rows<8>(R, xp, yp, wp, T, sg, st);
    case 16 * kM: return (int)dispatch_rows<16>(R, xp, yp, wp, T, sg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel 10 on the wide core, n = 128 * F with 1 <= F <= 160. x, y: (T, n)
// complex64, contiguous; wq as above; wf: (F, F) complex64 DFT-F of the
// transform's sign (ops/hopper/fft.py::wide_consts). C: rows per tile, a
// power of two <= 16 whose tile fits (bts2_wide.cuh::wide_smem_bytes).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_rows_wide(const void* x, void* y, const void* wq, const void* wf,
                                   long long T, int n, int C, void* stream) {
  using namespace ndfft;
  const float2* xp = static_cast<const float2*>(x);
  float2* yp = static_cast<float2*>(y);
  const float2* wqp = static_cast<const float2*>(wq);
  const float2* wfp = static_cast<const float2*>(wf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)wide_dispatch(C, [&](auto cc) {
    constexpr int kC = decltype(cc)::value;
    return wide_launch<kC>(c2c_rows_wide_kernel<kC>, n, 1, T, st, xp, yp, wqp, wfp, n / kM,
                           T);
  });
}
