// Kernel 23: the DCT-II of contiguous (T, n) float32 rows in the rustdct
// convention times a scale s, n = 128 k, on the mixed-radix row core
// (fft_radix.cuh::radix_rows_kernel) as the Makhoul R2C at the half length
// h = n / 2 = 64 k, at every n that ops/hopper/dct.py::dct_form takes and
// whose h has a plan (ops/hopper/fft.py::radix_plan): 259 of its 288
// lengths, the odd k included. The 29 others (k = 131 ... 251 prime, and
// twice 131 ... 157) keep the wide core's forms of dct_nat.cu.
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel (:190, built by
// _build_dct2 :228, called at :247) at those lengths. Its first Hopper forms
// (dct_nat.cu) ran the half-length R2C on the bts2 core (a dense DFT-128 a
// complex output: 2.048 ms at (262144, 512) on an H100, 6.4x the byte
// bound), on the wide core at other even k (126.6 ms at (2359296, 1536),
// 15x) and the n-point FFT on the wide core's real tile at odd k, which
// streams F * 128 KB of its Wq table from L2 for every row (1389.6 ms at
// (31104, 31104), 600x).
//
// What bounds it on this card: device memory. A row is read once and
// written once, 8 n bytes (0.321 ms at (262144, 512) over 3.35 TB/s),
// against a real FFT's 2.5 n log2 n FP32 operations (0.05 ms of the
// 67 TFLOP/s peak there); the passes through shared memory come next, as
// for kernels 2 and 15 on the same core.
//
// The design: kernel 2's skeleton with a load policy and an epilogue of its
// own. The Makhoul order v = [x0, x2, ..., x_{n-2}, x_{n-1}, ..., x3, x1]
// (v[m] = x[2m], v[n - 1 - m] = x[2m + 1]) read as the complex row
// z[t] = v[2t] + i v[2t + 1] is one contiguous read of the row: its 16-byte
// quad q holds x[4q ... 4q + 3], that is z[q] = (x[4q], x[4q + 2]) and
// z[h - 1 - q] = (x[4q + 3], x[4q + 1]) (h is even), so each quad fills two
// whole tile slots, the second row of a warp's stores descending
// (MakhoulRowLoad). The core runs radix_plan(h) in place and leaves Z in
// the tile (kTileOut); the epilogue is kernel 2's unpack
// (r2c_unpack_tile, u = W_n^k) whose store multiplies X[k] by the post
// twiddle P[k] = s e^{-i pi k / 2n} (ops/hopper/dct.py::dct2_post, the
// scale folded in once) and writes y[k] = Re(P[k] X[k]) and, for
// 0 < k < h, y[n - k] = -Im(P[k] X[k]) (P[n - k] = -i conj P[k]), the
// threads of a row on consecutive bins (Dct2RowBins, the row twin of
// dct_mid_radix.cu's Dct2Rows). Rows a block: ops/hopper/fft.py::
// radix_block at h, as kernel 2.
#include "fft_radix.cuh"

namespace ndfft {

// Kernel 23's rows: the tile's `valid` rows of n = 2h floats as one run of
// 16-byte quads (x 16-byte aligned), each quad into the two tile slots of
// its Makhoul pairs. The row of quad q is q / (h / 2), the quotient a
// multiply-high by floor(2^32 / (h / 2)) + 1 (exact while q h / 2 < 2^32:
// a tile holds at most 20480 elements).
struct MakhoulRowLoad {
  const float* __restrict__ x;
  __device__ __forceinline__ void load(float2* s, float2*, long long row0, int valid,
                                       int h) const {
    constexpr int kLoads = 4;
    const int hq = h >> 1;
    const int total = valid * hq;
    const unsigned magic = 0xffffffffu / (unsigned)hq + 1u;
    const float4* src = reinterpret_cast<const float4*>(x + row0 * 2 * h);
    for (int q0 = threadIdx.x; q0 < total; q0 += kLoads * blockDim.x) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * blockDim.x;
        if (q < total) v[u] = __ldcs(src + q);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int q = q0 + u * blockDim.x;
        if (q < total) {
          const int r = (int)__umulhi((unsigned)q, magic), k = q - r * hq;
          s[rx_slot(r * h + k)] = make_float2(v[u].x, v[u].z);
          s[rx_slot(r * h + h - 1 - k)] = make_float2(v[u].w, v[u].y);
        }
      }
    }
  }
};

// Kernel 23's epilogue: the tile holds Z of each row; y[k] = Re(P[k] X[k])
// and, for 0 < k < h, y[n - k] = -Im(P[k] X[k]) into the (T, n) rows.
struct Dct2RowBins {
  static constexpr bool kTileOut = true;
  float* __restrict__ y;
  const float2* __restrict__ u;      // W_n^k, k < h
  const float2* __restrict__ post;   // P[k], k <= h
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    const int h = cx.n, nn = 2 * cx.n;
    float* yr = y + cx.row * nn;
    const float2* __restrict__ pp = post;
    r2c_unpack_tile(s, cx, u, [=](int k, float2 v) {
      const float2 p = __ldg(pp + k);
      yr[k] = v.x * p.x - v.y * p.y;
      if (k > 0 && k < h) yr[nn - k] = -(v.x * p.y + v.y * p.x);
    });
  }
};

}  // namespace ndfft

// x, y: (T, 2h) float32, contiguous, x 16-byte aligned, h even; table: the
// forward radix table of h (ops/hopper/fft.py::radix_consts); radices:
// radix_plan(h), `stages` of them; u: (h,) complex64 W_n^k; post: (n,)
// complex64 s e^{-i pi k / 2n} (ops/hopper/dct.py::dct2_post; entries
// k <= h are read); rows: rows per block (ops/hopper/fft.py::radix_block).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct2_rows_radix(const void* x, void* y, const void* table,
                                     const int* radices, int stages, const void* u,
                                     const void* post, long long T, int h, int rows,
                                     void* stream) {
  using namespace ndfft;
  if (h < 2 || h % 2 || u == nullptr || post == nullptr ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return (int)cudaErrorInvalidValue;
  return (int)radix_rows_launch(
      MakhoulRowLoad{static_cast<const float*>(x)},
      Dct2RowBins{static_cast<float*>(y), static_cast<const float2*>(u),
                  static_cast<const float2*>(post)},
      static_cast<const float2*>(table), radices, stages, T, h, rows, -1, 1.f,
      static_cast<cudaStream_t>(stream));
}
