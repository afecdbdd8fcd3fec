// Kernels 7 and 13: the two passes of the four-step long C2C
// (ops/engine.py::_fourstep), n = n1 * n2 with t = t1 n2 + t2 and
// k = k1 + n1 k2:
//
//   step 1+2 (kernel 7):   Z[b, k1, t2] = W_n^{k1 t2} sum_t1 W_n1^{t1 k1} x[b, t1, t2]
//   step 3+4 (kernel 13):  X[b, k2, k1] = s sum_t2 W_n2^{t2 k2} Z[b, k1, t2]
//
// Kernel 7 replaces ndrustfft_tpu/ops/pallas/fft.py::_kernel_exit_mul (the
// exit multiply that _add_exit_tw, fft.py:1635, wraps around the middle-axis
// body, pallas_call at :1724 for the dense body and :1754 for bts2); kernel
// 13 replaces fft.py::_kernel_lane_store_t (pallas_call at :1895), the row
// FFT of length n2 = 128 * F <= 16384 with the user scale, stored
// transposed so that the four-step's (k1, k2) -> (k2, k1) transpose costs
// no pass of its own. Their first Hopper forms ran the bts2 cores' dense
// DFT-128 (4 * 128 real FMAs per complex output) on the FP32 cores, 10-14x
// their byte bounds (kernel 7 13.40 ms and kernel 13 12.91 ms at
// (256, 1024, 1024) on an H100).
//
// What bounds them on this card: device memory. Each pass reads and writes
// every element once, 16 bytes: 1.28 ms at (256, 1024, 1024) over 3.35
// TB/s, against 5 n log2 n FP32 operations per transform (0.2 ms of the
// 67 TFLOP/s peak); kernel 7 also reads its (n1, n2) twiddle table once
// (8 MB at n = 2^20, which stays in the 50 MB L2).
//
// Kernel 7 is kernel 1's radix column tile (fft_radix.cuh::
// radix_cols_kernel with kernel 1's load CplxCol, read-only at one or two
// columns a tile) on the (B, n1, n2) view, L = n2 columns, at every n1
// with a radix plan: the last stage leaves the spectra in the tile
// (kTileOut) and an epilogue multiplies each by the exit twiddle
// tw[k1 n2 + col] (ops/hopper/fft.py::fourstep_tw, bit-identical to
// _add_exit_tw's) and writes it, the tile's C columns of one k1 on
// consecutive threads. An epilogue rather than the last stage's store:
// kernel 1's store from the last stage spills 836-3776 bytes a thread, and
// kernels 17 and 3 ran up to 2.18x faster with an epilogue, and on an
// H100 this epilogue ran 1.06-1.47x faster than that store with the
// twiddle at every column count (PERF.md, kernel table row 7). The 23
// prime n1 from 131 to 251 have no plan and keep the dense product
// (fft_dense.cu).
//
// Kernel 13 is kernel 10's radix row core (radix_rows_kernel) over the
// T = B n1 rows of n2, with the scale and the transpose in an epilogue:
// for each bin k2 the threads of one warp take the R rows of the tile
// (row r = b n1 + k1, b and k1 computed per row: a block's rows may cross
// a batch boundary) and write them to y[(b n2 + k2) n1 + k1 ...], one
// contiguous run of R values (a 32-byte sector from R = 4 on). Read in that
// order from the core's row layout, the R values of one k2 would fall in
// one bank wherever the row stride is a multiple of 16 slots (n2 = 1024:
// 1056 slots), an R-way conflict; so the tile's rows lie `pitch` elements
// apart, pitch = n2 + 32 g, with g chosen on the host
// (ops/hopper/fft.py::store_t_pitch) so that the R rows of a half-warp's
// reads start in distinct banks. The pitched load (PitchedRowLoad) is
// RowLoad's 16-byte run with each element moved to its row's pitch.
#include "fft_radix.cuh"

namespace ndfft {

// Kernel 7's epilogue: column col of batch bb holds X[k1], k1 < n1, in the
// tile; y[(bb n1 + k1) L + col] = X[k1] tw[k1 L + col]. The handle is
// bb 2^32 + col (L < 2^31).
struct FourstepCols {
  static constexpr bool kTileOut = true;
  float2* __restrict__ y;
  const float2* __restrict__ tw;
  long long L;
  int n;
  __device__ __forceinline__ long long handle(long long bb, long long col) const {
    return (bb << 32) + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    const long long col = cx.row & 0xffffffffLL;
    float2* yc = y + (cx.row >> 32) * n * L + col;
    const float2* tc = tw + col;
    for (int k = cx.t; k < cx.n; k += cx.tr)
      yc[k * L] = cmul(s[cx.slot(k)], __ldg(tc + k * L));
  }
};

// Kernel 13's rows: the tile's valid rows of (T, n) as one 16-byte run
// (RowLoad's), element e = r n + k into tile element r pitch + k; r by a
// multiply-high by floor(2^32 / n) + 1 (exact while e n < 2^32: a tile
// holds at most 20480 elements and n <= 16384).
struct PitchedRowLoad {
  static constexpr bool kPitched = true;
  const float2* __restrict__ x;
  int pitch;
  __device__ __forceinline__ void load(float2* s, float2*, long long row0, int valid,
                                       int n) const {
    const unsigned magic = 0xffffffffu / (unsigned)n + 1u;
    const int gap = pitch - n;
    load_run16(x + row0 * n, valid * n, [=](int e, float2 v) {
      const int r = (int)__umulhi((unsigned)e, magic);
      s[rx_slot(e + r * gap)] = v;
    });
  }
};

// Kernel 13's epilogue: the tile's rows hold their spectra in natural
// order. Thread i takes tile row c = i mod 2^rshift (2^rshift: the block's
// row count rounded up to a power of two, at most 32, so that every thread
// keeps one row) and bins k2 = i >> rshift, stepping by blockDim >>
// rshift; row r = row0 + c = b n1 + k1 goes to y[(b n2 + k2) n1 + k1]
// times the scale. The stages' thread i sits in row i / tr = cx.row - row0,
// and the valid rows are those whose first thread is active (counted at a
// barrier), so no 64-bit division is needed (T < 2^31 rows: 2^31 rows of
// 128 complex64 values would be 2 TB).
struct StoreT {
  static constexpr bool kTileOut = true;
  float2* __restrict__ y;
  int n1, pitch, rshift;
  float scale;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    const int valid = __syncthreads_count(cx.active && cx.t == 0);
    const int row0 = (int)cx.row - (int)threadIdx.x / cx.tr;
    const int c = (int)threadIdx.x & ((1 << rshift) - 1);
    if (c >= valid) return;
    const int r = row0 + c, b = r / n1;
    float2* yr = y + (long long)b * cx.n * n1 + (r - b * n1);
    const int base = c * pitch;
    for (int k = (int)threadIdx.x >> rshift; k < cx.n; k += (int)blockDim.x >> rshift) {
      const float2 v = s[rx_slot(base + k)];
      yr[(long long)k * n1] = make_float2(scale * v.x, scale * v.y);
    }
  }
};

template <int kS, bool kLdg>
cudaError_t fourstep_launch(const float2* x, float2* y, const float2* tp, const float2* tw,
                            const RadixPlan& plan, long long B, int n1, long long n2, int C,
                            cudaStream_t st) {
  return radix_cols_launch<kS>(CplxCol<kLdg>{x, n2, n1}, FourstepCols{y, tw, n2, n1}, tp, plan,
                               B, n1, n2, C, 1.f, st);
}

}  // namespace ndfft

// Kernel 7. x, y: (B, n1, n2) complex64, contiguous, n2 < 2^31; table: the
// radix table of n1 for the sign (ops/hopper/fft.py::radix_consts);
// radices: radix_plan(n1), `stages` of them; tw: (n1, n2) complex64
// W_{n1 n2}^{k1 t2} (fft.py::fourstep_tw); C: columns per tile, a power of
// two up to kRadixMaxCols with n1 C <= 20480 (fft.py::fourstep_cols); ldg:
// 1 loads x through the read-only path, 0 evict-first. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_fourstep_mid(const void* x, void* y, const void* table, const int* radices,
                                  int stages, const void* tw, long long B, int n1, long long n2,
                                  int C, int sign, int ldg, void* stream) {
  using namespace ndfft;
  RadixPlan plan{};
  if ((sign != 1 && sign != -1) || n2 >= (1LL << 31) || tw == nullptr ||
      !radix_plan_of(radices, stages, n1, plan))
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float2*>(x);
  const auto yp = static_cast<float2*>(y);
  const auto tp = static_cast<const float2*>(table);
  const auto wp = static_cast<const float2*>(tw);
  const auto st = static_cast<cudaStream_t>(stream);
  if (sign < 0)
    return (int)(ldg ? fourstep_launch<-1, true>(xp, yp, tp, wp, plan, B, n1, n2, C, st)
                     : fourstep_launch<-1, false>(xp, yp, tp, wp, plan, B, n1, n2, C, st));
  return (int)(ldg ? fourstep_launch<1, true>(xp, yp, tp, wp, plan, B, n1, n2, C, st)
                   : fourstep_launch<1, false>(xp, yp, tp, wp, plan, B, n1, n2, C, st));
}

// Kernel 13. x: (T, n2) complex64 rows, T = B n1 < 2^31, contiguous; y:
// (B, n2, n1) complex64; table, radices, stages: the radix table and plan of n2 for
// the sign; rows: rows per block, 1 ... 32, whose tile fits
// (fft.py::store_t_rows); pitch: the tile's row distance in elements, a
// multiple of 32 no less than n2 (fft.py::store_t_pitch); scale:
// multiplies every output. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ndfft_rows_store_t(const void* x, void* y, const void* table, const int* radices,
                                  int stages, long long T, int n1, int n2, int rows, int pitch,
                                  int sign, float scale, void* stream) {
  using namespace ndfft;
  if (n1 < 1 || T < 1 || T >= (1LL << 31) || T % n1 || rows < 1 || rows > 32 || n2 % 32 ||
      pitch % 32 || pitch < n2)
    return (int)cudaErrorInvalidValue;
  int rshift = 0;
  while ((1 << rshift) < rows) ++rshift;
  const StoreT io{static_cast<float2*>(y), n1, pitch, rshift, scale};
  return (int)radix_rows_launch(PitchedRowLoad{static_cast<const float2*>(x), pitch}, io,
                                static_cast<const float2*>(table), radices, stages, T, n2, rows,
                                sign, 1.f, static_cast<cudaStream_t>(stream));
}
