// Kernels 6 and 4: C2C along the middle axis of a (B, n, L) complex64
// tensor, on an (n, C) column tile of the mixed-radix core (fft_radix.cuh),
// times a scale. Kernel 6 takes 512 < n <= 20480 without a {128, 256} split
// (the lengths of the JAX package's generic two-factor schedule), kernel 4
// n <= 256, or n <= 512 without a split (its dense route).
//
// Kernel 6 replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid (the
// generic body of _build_call_axis_mid: n > 512 without a split, built at
// :1649 and called at :1776); kernel 4 replaces ::_kernel_axis_mid_dense
// (its dense body, :1565, called at :1724). The TPU kernels run dense
// products, cheap on a 128 x 128 MXU: kernel 6 n = m f as a DFT-m and a
// DFT-f with the twiddle between them, kernel 4 one DFT-n. Their first
// Hopper forms ran the same products on the FP32 cores, 8 (m + f) or 8 n
// FP32 operations per output where an FFT needs 5 log2 n (1624 against 46
// at n = 600, 2048 against 40 at n = 256), and were bound by them.
//
// What bounds it on this card: device memory. Each element is read once and
// written once (16 bytes): 0.518 ms at (600, 600, 301) and 0.080 ms at
// (1, 256, 65536) over 3.35 TB/s, against about 5 n log2 n FP32 operations
// per column (0.08 and 0.010 ms of the 67 TFLOP/s peak at those shapes).
//
// The design: kernel 11's column tile (fft_blue_radix.cu) with a single
// transform. A block holds C adjacent columns of one b as an (n, C) tile in
// the core's column layout (element q of column c at q C + c, the C columns
// of a butterfly on consecutive threads), the L columns spread evenly over
// the tiles so that a ragged last tile is as full as the others. The load
// runs four 8-byte loads in flight a thread, a tile row (C columns) at a
// time; one radix_run with the sign's own table and prime rows runs
// radix_plan(n) in place, a thread's butterflies in registers across each
// stage's barrier; the last stage multiplies by the scale and stores each
// output straight to y[b, k, col0 + c] (MidStore), masked at the ragged
// column edge. The tile is read and written once and never goes back
// through shared memory after the last stage. C is a power of two up to
// kRadixMaxCols with n C <= 20480 (16, 32 or 40 elements a thread by n C)
// and at most 256 threads in the 16-element form
// (ops/hopper/fft.py::radix_mid_cols): at kernel 6's n one to eight
// columns; at kernel 4's short columns up to 32, at most 4096 / n, so that
// a tile row is at least one 128-byte line (C >= 16 at n <= 256) and a
// block at small n still has a warp (at n <= 16 one thread a column). At C = 1 a tile
// row is one float2 of a 32-byte sector, whose other three the neighbouring
// tiles (blocks) of the same b read. Shared memory: the tile,
// 8 n C (17 / 16) bytes, and the prime rows.
#include "fft_radix.cuh"

namespace ndfft {

// The last stage's store: a transform's handle is the offset of its
// column's first element, b n L + col0 + c, and output k lies L further on
// per bin.
struct MidStore {
  float2* __restrict__ y;
  long long L;
  __device__ __forceinline__ void store(long long col, long long k, float2 v) const {
    y[col + k * L] = v;
  }
};

// One block per (b, tile of at most C columns), the L columns spread evenly
// over the `tiles` tiles; tr = ceil(n / kE) threads per column, thread
// c + C t taking column c's place t.
template <int kE, int kS>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
mid_radix_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                 const float2* __restrict__ tab, RadixPlan plan, int n, long long L,
                 long long tiles, int C, float scale) {
  extern __shared__ float2 smem[];
  const long long bb = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long col0 = tile * L / tiles;
  const int valid = (int)((tile + 1) * L / tiles - col0);
  const long long base = bb * n * L + col0;
  const int tr = (n + kE - 1) / kE;
  const int cshift = 31 - __clz(C);   // C is a power of two: no division per element
  const int t = (int)threadIdx.x >> cshift, c = (int)threadIdx.x & (C - 1);
  const RadixCtx<ColLayout> cx{n, tr, t, ColLayout{c, C}, c < valid && t < tr, base + c};
  float2* s = smem;
  float2* cs = smem + cx_tile_slots(n * C);
  int count[8];
  radix_prepare(count, cs, tab, plan, n);
  // the tile, element e = (r, cc) at e = r C + cc (columns past the valid
  // ones zero), four loads in flight a thread
  constexpr int kLoads = 4;
  const int elems = n * C;
  for (int e0 = threadIdx.x; e0 < elems; e0 += kLoads * blockDim.x) {
    float2 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, r = e >> cshift, cc = e & (C - 1);
      v[u] = make_float2(0.f, 0.f);
      if (e < elems && cc < valid) v[u] = __ldcs(x + base + r * L + cc);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < elems) s[cx_slot(e)] = v[u];
    }
  }
  __syncthreads();
  radix_run<kE, kS>(s, tab, cs, count, plan, cx, MidStore{y, L}, scale);
}

template <int kE, int kS>
cudaError_t mid_radix_launch(const float2* x, float2* y, const float2* tab,
                             const RadixPlan& plan, long long B, int n, long long L, int C,
                             float scale, cudaStream_t stream) {
  const int tr = (n + kE - 1) / kE;
  const int threads = (C * tr + 31) / 32 * 32;
  const long long smem = (long long)(cx_tile_slots(n * C) + rx_coef_count(plan)) * sizeof(float2);
  const long long tiles = (L + C - 1) / C;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || B * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(mid_radix_kernel<kE, kS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  mid_radix_kernel<kE, kS><<<(unsigned)(B * tiles), threads, (size_t)smem, stream>>>(
      x, y, tab, plan, n, L, tiles, C, scale);
  return cudaGetLastError();
}

template <int kS>
cudaError_t mid_radix_launch_s(const float2* x, float2* y, const float2* tab,
                               const RadixPlan& plan, long long B, int n, long long L, int C,
                               float scale, cudaStream_t stream) {
  const int e = radix_per_thread(n * C);
  return e == 40 ? mid_radix_launch<40, kS>(x, y, tab, plan, B, n, L, C, scale, stream)
       : e == 32 ? mid_radix_launch<32, kS>(x, y, tab, plan, B, n, L, C, scale, stream)
                 : mid_radix_launch<16, kS>(x, y, tab, plan, B, n, L, C, scale, stream);
}

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; table: the radix table of n for
// the sign (ops/hopper/fft.py::radix_consts); radices: radix_plan(n),
// `stages` of them; C: columns per tile, a power of two up to kRadixMaxCols
// with n C <= 20480 and at most 256 threads (512 above n C = 4096)
// (ops/hopper/fft.py::radix_mid_cols); scale: multiplies every output.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_mid_radix(const void* x, void* y, const void* table, const int* radices,
                                   int stages, long long B, int n, long long L, int C, int sign,
                                   float scale, void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if (B < 1 || L < 1 || C < 1 || C > kRadixMaxCols || (C & (C - 1)) ||
      (long long)n * C > 20480 ||
      (sign != 1 && sign != -1) || !radix_plan_of(radices, stages, n, plan))
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float2*>(x);
  const auto yp = static_cast<float2*>(y);
  const auto tp = static_cast<const float2*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  return (int)(sign < 0 ? mid_radix_launch_s<-1>(xp, yp, tp, plan, B, n, L, C, scale, st)
                        : mid_radix_launch_s<1>(xp, yp, tp, plan, B, n, L, C, scale, st));
}
