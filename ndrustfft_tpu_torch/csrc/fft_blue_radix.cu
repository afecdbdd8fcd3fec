// Kernel 11: Bluestein's chirp-z C2C along the middle axis of a (B, n, L)
// complex64 tensor, for a length n with a prime factor above 128, at every
// convolution length M = 128 * F, in one pass on an (M, C) column tile of
// the mixed-radix core (fft_radix.cuh). For each column:
//
//   u = x a, zero-padded to M;  Z = IFFT_M(FFT_M(u) H) (1/M and the user
//   scale in the inverse's last stage);  y[k] = Z[k] a[k],  k < n,
//
// with the chirp a and H = FFT_M of the wrapped inverse chirp built on the
// host (ops/hopper/fft.py::blue_consts; the JAX package's tables bit for
// bit) and M = blue_kernel_M(n).
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_blue (built by
// _build_call_axis_mid_blue, called by c2c_pallas_axis_mid_blue). The TPU
// kernel's length-M transforms are dense stages, cheap on a 128 x 128 MXU;
// their first Hopper forms (the bts2 core at F in {4, 8, 16}, the wide core
// at every other F) ran a dense DFT-F and a dense DFT-128 twice per column,
// 8 (128 + F) FP32 operations per element and transform, streamed
// F * 128 KB of folded twiddles per direction from L2, and the wide core
// kept a second M x C tile because it cannot work in place.
//
// What bounds it on this card: device memory. Each element is read once and
// written once (16 bytes), 0.0064 ms at (1, 1031, 1024) over 3.35 TB/s;
// the two length-M FFTs per column, about 10 M log2 M FP32 operations, come
// to 0.0037 ms of the 67 TFLOP/s peak at that shape.
//
// The design. A block holds C adjacent columns of one b as an (M, C) tile
// in shared memory, in the core's column layout (C columns of a butterfly
// on consecutive threads; a tile row of C >= 4 columns is a 32-byte
// sector; M = 512, 1024, 2048 take C = 4, 2, 2: ops/hopper/fft.py::
// blue_radix_cols). The load multiplies row
// t < n by a[t] and writes zeros from row n to M (a tile never exists in
// device memory padded), four loads in flight a thread. Both transforms run the forward radix_plan(M) in place
// with one table and one set of prime rows, a thread's butterflies held in
// registers across each stage's barrier: the inverse is
// IFFT_M(V) = conj(FFT_M(conj V)), exact in float32 (the sign +1 table and
// codelets are the sign -1 ones conjugated), so a pass over the tile after
// the first transform replaces FFT_M(u)[k] by conj(FFT_M(u)[k] H[k]), the
// second transform takes that, and the epilogue stores rows k < n as
// conj(.) times the scale and a[k], masked at the ragged column edge, a
// tile row at a time.
// One instantiation of the stages serves both transforms (on an H100 two
// inlined calls ran no slower than a loop of two). Shared memory: the
// tile, 8 M C (17 / 16) bytes, and the prime coefficient rows.
// Left for later: the zero pad's free first stage (rows t >= n are zero)
// and the inverse's trim (rows k >= n are not needed), which only save work.
#include "fft_radix.cuh"

namespace ndfft {

// Both transforms leave their spectrum in the tile as it is (the product
// with H is a pass of its own: folded into the last stage's write-back, its
// loads doubled ptxas's spill at 16 elements a thread).
struct BlueTile {
  static constexpr bool kTileOut = true;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
};

// One block per (b, tile of at most C columns), the L columns spread evenly
// over the `tiles` tiles; tr = ceil(M / kE) threads per column, thread
// c + C t taking column c's place t.
template <int kE>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
blue_radix_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ a, const float2* __restrict__ h,
                  const float2* __restrict__ tab, RadixPlan plan, int n, int M, long long L,
                  long long tiles, int C, float scale) {
  extern __shared__ float2 smem[];
  const long long bb = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long col0 = tile * L / tiles;
  const int valid = (int)((tile + 1) * L / tiles - col0);
  const long long base = bb * n * L + col0;
  const int tr = (M + kE - 1) / kE;
  const int cshift = 31 - __clz(C);   // C is a power of two: no division per element
  const int t = (int)threadIdx.x >> cshift, c = (int)threadIdx.x & (C - 1);
  const RadixCtx<ColLayout> cx{M, tr, t, ColLayout{c, C}, c < valid && t < tr, base + c};
  float2* s = smem;
  float2* cs = smem + cx_tile_slots(M * C);
  int count[8];
  radix_prepare(count, cs, tab, plan, M);
  // the chirped columns and the zero pad, tile element e = (r, cc) at
  // e = r C + cc, four loads in flight a thread
  constexpr int kLoads = 4;
  const int elems = M * C;
  for (int e0 = threadIdx.x; e0 < elems; e0 += kLoads * blockDim.x) {
    float2 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, r = e >> cshift, cc = e & (C - 1);
      v[u] = make_float2(0.f, 0.f);
      if (e < elems && r < n && cc < valid) v[u] = __ldcs(x + base + r * L + cc);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, r = e >> cshift;
      if (e < elems) s[cx_slot(e)] = r < n ? cmul(v[u], __ldg(a + r)) : v[u];
    }
  }
  __syncthreads();
  radix_run<kE, -1>(s, tab, cs, count, plan, cx, BlueTile{}, 1.f);
  // conj(FFT_M(u)[k] H[k]) in place: the second transform's input
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const float2 w = cmul(s[cx_slot(e)], __ldg(h + (e >> cshift)));
    s[cx_slot(e)] = make_float2(w.x, -w.y);
  }
  __syncthreads();
  radix_run<kE, -1>(s, tab, cs, count, plan, cx, BlueTile{}, 1.f);
  // rows k < n: conj(FFT_M(conj V)) times the scale and the exit chirp
  for (int e = threadIdx.x; e < n * C; e += blockDim.x) {
    const int r = e >> cshift, cc = e & (C - 1);
    if (cc < valid) {
      const float2 z = s[cx_slot(e)];
      y[base + r * L + cc] = cmul(make_float2(scale * z.x, -(scale * z.y)), __ldg(a + r));
    }
  }
}

template <int kE>
cudaError_t blue_radix_launch(const float2* x, float2* y, const float2* a, const float2* h,
                              const float2* tab, const RadixPlan& plan, long long B, int n,
                              int M, long long L, int C, float scale, cudaStream_t stream) {
  const int tr = (M + kE - 1) / kE;
  const int threads = (C * tr + 31) / 32 * 32;
  const long long smem = (long long)(cx_tile_slots(M * C) + rx_coef_count(plan)) * sizeof(float2);
  const long long tiles = (L + C - 1) / C;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || B * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(blue_radix_kernel<kE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  blue_radix_kernel<kE><<<(unsigned)(B * tiles), threads, (size_t)smem, stream>>>(
      x, y, a, h, tab, plan, n, M, L, tiles, C, scale);
  return cudaGetLastError();
}

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; a: (n,) complex64 chirp
// exp(sign i pi t^2 / n) (entry and exit); h: (M,) complex64 H; table: the
// sign -1 radix table of M (ops/hopper/fft.py::radix_consts), which serves
// both transforms; radices: radix_plan(M), `stages` of them;
// 2n - 1 <= M <= 20480; C: columns per tile, a power of two up to
// kRadixMaxCols with M C <= 20480 (16, 32 or 40 elements a thread by M C:
// fft_radix.cuh::radix_per_thread) and at most 256 threads (512 above
// M C = 4096); scale: the user scale over M. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_blue_radix(const void* x, void* y, const void* a, const void* h,
                                    const void* table, const int* radices, int stages,
                                    long long B, int n, int M, long long L, int C, float scale,
                                    void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (B < 1 || L < 1 || n < 1 || 2 * n - 1 > M || C < 1 || C > kRadixMaxCols ||
      (C & (C - 1)) || (long long)M * C > 20480 || !radix_plan_of(radices, stages, M, plan))
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float2*>(x);
  const auto yp = static_cast<float2*>(y);
  const auto ap = static_cast<const float2*>(a);
  const auto hp = static_cast<const float2*>(h);
  const auto tp = static_cast<const float2*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  const int e = radix_per_thread(M * C);
  return (int)(e == 40 ? blue_radix_launch<40>(xp, yp, ap, hp, tp, plan, B, n, M, L, C, scale, st)
               : e == 32 ? blue_radix_launch<32>(xp, yp, ap, hp, tp, plan, B, n, M, L, C, scale,
                                                 st)
                         : blue_radix_launch<16>(xp, yp, ap, hp, tp, plan, B, n, M, L, C, scale,
                                                 st));
}
