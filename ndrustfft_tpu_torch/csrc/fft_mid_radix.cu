// Kernels 1, 6 and 4: C2C along the middle axis of a (B, n, L) complex64
// tensor, on an (n, C) column tile of the mixed-radix core (fft_radix.cuh),
// times a scale. Kernel 1 takes n = 128 * F (F = 3 ... 160 with a plan:
// the lengths with the JAX package's twostep split), kernel 6 512 < n <=
// 20480 without a {128, 256} split (the lengths of its generic two-factor
// schedule), kernel 4 n <= 256, or n <= 512 without a split (its dense
// route).
//
// Kernel 1 replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_axis_mid_bts2
// (the bts2 body of _build_call_axis_mid, :1124, called at :1754); kernel 6
// replaces ::_kernel_axis_mid (the generic body: n > 512 without a split,
// built at :1649 and called at :1776); kernel 4 replaces
// ::_kernel_axis_mid_dense (its dense body, :1565, called at :1724). The TPU
// kernels run dense products, cheap on a 128 x 128 MXU: kernel 1 n = 128 F
// as a DFT-F and a twiddled DFT-128, kernel 6 n = m f as a DFT-m and a
// DFT-f with the twiddle between them, kernel 4 one DFT-n. Their first
// Hopper forms ran the same products on the FP32 cores, 8 (128 + F),
// 8 (m + f) or 8 n FP32 operations per output where an FFT needs 5 log2 n
// (1056 against 45 at n = 512, 1624 against 46 at n = 600, 2048 against 40
// at n = 256), and were bound by them (kernel 1 at 7.2x its byte bound at
// (1, 512, 131584), 13.3x on the wide core at (768, 768, 385)).
//
// What bounds it on this card: device memory. Each element is read once and
// written once (16 bytes): 0.322 ms at (1, 512, 131584), 1.085 ms at
// (768, 768, 385), 0.080 ms at (1, 4096, 4096), 0.518 ms at (600, 600, 301)
// and 0.080 ms at (1, 256, 65536) over 3.35 TB/s, against about 5 n log2 n
// FP32 operations per column (0.045, 0.16, 0.015, 0.08 and 0.010 ms of the
// 67 TFLOP/s peak at those shapes).
//
// The design: kernel 11's column tile (fft_blue_radix.cu) with a single
// transform: the core's column skeleton (fft_radix.cuh::radix_cols_kernel,
// shared with kernels 16, 18 and 20) on complex columns. A block holds C
// adjacent columns of one b as an (n, C) tile in the core's column layout
// (element q of column c at q C + c, the C columns of a butterfly on
// consecutive threads), the L columns spread evenly over the tiles so that
// a ragged last tile is as full as the others. The load runs four 8-byte
// loads in flight a thread, a tile row (C columns) at a time, evict-first
// (__ldcs) or, where the host asks (ldg: kernel 1 at one or two columns a
// tile, whose 32-byte sectors the neighbouring tiles share), through the
// read-only path (__ldg); one radix_run with the sign's own table and prime
// rows runs radix_plan(n) in place, a thread's butterflies in registers
// across each stage's barrier; the last stage multiplies by the scale and
// stores each output straight to y[b, k, col0 + c] (ColStore), masked at
// the ragged column edge. The tile is read and written once and never goes
// back through shared memory after the last stage. C is a power of two up
// to kRadixMaxCols with n C <= 20480 (16, 32 or 40 elements a thread by
// n C) and at most 256 threads in the 16-element form
// (ops/hopper/fft.py::radix_mid_cols; for kernel 1 ::axis_mid_tile): at
// kernel 6's n one to eight columns; at kernel 4's short columns up to 32,
// at most 4096 / n, so that a tile row is at least one 128-byte line
// (C >= 16 at n <= 256) and a block at small n still has a warp (at n <= 16
// one thread a column); at kernel 1's 8 to n = 512 and 4 to 5120, in the
// 32- or 40-element form above n = 1024 (2.4x and 3.3x faster than the
// 16-element form's 2 and 1 columns at n = 2048 and 4096 on an H100). At
// C = 1 a tile row is one float2 of a 32-byte sector, whose other three the
// neighbouring tiles (blocks) of the same b read. Shared memory: the tile,
// 8 n C (17 / 16) bytes, and the prime rows.
// Left for later: cp.async or TMA loads of the next tile row.
#include "fft_radix.cuh"

namespace ndfft {

// The last stage's store: output k of column col of b at y[(b n + k) L + col].
struct ColStore {
  float2* __restrict__ y;
  long long L;
  int n;
  __device__ __forceinline__ long long handle(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ void store(long long h, long long k, float2 v) const {
    y[h + k * L] = v;
  }
};

template <bool kLdg>
int mid_radix_entry(const void* x, void* y, const float2* tp, const RadixPlan& plan,
                    long long B, int n, long long L, int C, int sign, float scale,
                    cudaStream_t st) {
  const CplxCol<kLdg> ld{static_cast<const float2*>(x), L, n};
  const ColStore io{static_cast<float2*>(y), L, n};
  return (int)(sign < 0 ? radix_cols_launch<-1>(ld, io, tp, plan, B, n, L, C, scale, st)
                        : radix_cols_launch<1>(ld, io, tp, plan, B, n, L, C, scale, st));
}

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; table: the radix table of n for
// the sign (ops/hopper/fft.py::radix_consts); radices: radix_plan(n),
// `stages` of them; C: columns per tile, a power of two up to kRadixMaxCols
// with n C <= 20480 and at most 256 threads (512 above n C = 4096)
// (ops/hopper/fft.py::radix_mid_cols); scale: multiplies every output;
// ldg: 1 loads x through the read-only path, 0 evict-first. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_c2c_mid_radix(const void* x, void* y, const void* table, const int* radices,
                                   int stages, long long B, int n, long long L, int C, int sign,
                                   float scale, int ldg, void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if ((sign != 1 && sign != -1) || !radix_plan_of(radices, stages, n, plan))
    return (int)cudaErrorInvalidValue;
  const auto tp = static_cast<const float2*>(table);
  const auto st = static_cast<cudaStream_t>(stream);
  return ldg ? mid_radix_entry<true>(x, y, tp, plan, B, n, L, C, sign, scale, st)
             : mid_radix_entry<false>(x, y, tp, plan, B, n, L, C, sign, scale, st);
}
