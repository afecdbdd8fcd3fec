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
// makhoul_cols.cuh's Dct2Rows). Rows a block: ops/hopper/fft.py::
// radix_block at h, as kernel 2.
//
// Kernel 24: the DCT-III of the same rows, the same n, as the Makhoul C2R:
// kernel 3's inverse on the same core with the pre twiddle in its load and
// the interleave in its store.
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_dct3_kernel (:208, built by
// _build_dct3, called at :284) with dct3_pallas's interleave (:320-323) at
// those lengths. Its first Hopper forms (dct_nat.cu) ran kernel 3's bts2
// core (2.612 ms at (262144, 512) on an H100, 8.1x the byte bound), the
// wide core (95.2 ms at (2359296, 1536), 11x) and the n-point FFT on the
// wide core's real tile at odd k (755.0 ms at (31104, 31104), 325x: the
// F * 128 KB Wq stream of every row). The bound is kernel 23's: a row read
// once and written once.
//
// The algebra (dct_nat.cu's header): u = the unnormalized C2R of the
// Hermitian half spectrum S[k] = Q[k] (x[k] - i x[n - k]), k = 0 ... h,
// x[n] = 0, Q[k] = (s / 2) e^{+i pi k / 2n} (ops/hopper/dct.py::dct3_pre),
// and y[2t] = u[t], y[2t + 1] = u[n - 1 - t]. The load reads the row as
// one run of 16-byte quads and puts each float where the prologue wants
// it: x[m] into the real half of tile slot m for m < h, into the row's
// side slot for m = h, and into the imaginary half of slot n - m above
// (Dct3RowLoad), so slot k holds (x[k], x[n - k]) and slot 0's imaginary
// half, x[n], is never read. The prologue takes a mirror pair {k, h - k}
// a thread, forms S of both from its two slots and the pre twiddle, and
// replaces them with kernel 3's G[k] = A[k] S[k] + B[k] conj S[h - k]
// (c2r_combine, the ab rows at scale 1), dropping the rounding residue of
// the real S[0] and S[h] as dct_nat.cu did. The inverse radix_run of h
// leaves z in the tile (kTileOut), and the epilogue writes the interleave
// as 16-byte quads: quad p of the output row is (u[2p], u[n - 1 - 2p],
// u[2p + 1], u[n - 2 - 2p]) = (Re z[p], Im z[h - 1 - p], Im z[p],
// Re z[h - 1 - p]), the inverse of MakhoulRowLoad's map (Dct3RowBins).
// Device memory is read once and written once, both as coalesced 16-byte
// runs, and never in reverse.
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

// Kernel 24's rows: the tile's `valid` rows of n = 2h floats as one run of
// 16-byte quads (x 16-byte aligned), float m of a row into slot m's real
// half (m < h), the side slot (m = h) or slot n - m's imaginary half; the
// prologue forms S and the inverse unpack in place. The row of quad q is
// q / (h / 2), as in MakhoulRowLoad.
struct Dct3RowLoad {
  static constexpr int kSide = 1;
  const float* __restrict__ x;
  const float2* __restrict__ q;      // Q[k], k <= h
  const float4* __restrict__ ab;     // kernel 3's (A, B) rows at scale 1
  __device__ __forceinline__ void load(float2* s, float2* side, long long row0, int valid,
                                       int h) const {
    constexpr int kLoads = 4;
    const int hq = h >> 1, n = 2 * h;
    const int total = valid * hq;
    const unsigned magic = 0xffffffffu / (unsigned)hq + 1u;
    const float4* src = reinterpret_cast<const float4*>(x + row0 * n);
    float* sf = reinterpret_cast<float*>(s);
    for (int q0 = threadIdx.x; q0 < total; q0 += kLoads * blockDim.x) {
      float4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int qq = q0 + u * blockDim.x;
        if (qq < total) v[u] = __ldcs(src + qq);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int qq = q0 + u * blockDim.x;
        if (qq < total) {
          const int r = (int)__umulhi((unsigned)qq, magic), m0 = 4 * (qq - r * hq);
          const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = m0 + j;
            if (m < h) {
              sf[2 * rx_slot(r * h + m)] = e[j];
            } else if (m == h) {
              side[r] = make_float2(e[j], 0.f);
            } else {
              sf[2 * rx_slot(r * h + n - m) + 1] = e[j];
            }
          }
        }
      }
    }
  }
  // S[k] = Q[k] (a - i b) of the pair (a, b) = (x[k], x[n - k])
  __device__ __forceinline__ float2 spec(int k, float2 p) const {
    const float2 w = __ldg(q + k);
    return make_float2(w.x * p.x + w.y * p.y, w.y * p.x - w.x * p.y);
  }
  template <class Cx>
  __device__ __forceinline__ void prologue(float2* s, const float2* side, const Cx& cx) const {
    if (!cx.active) return;
    const int h = cx.n;
    for (int k = cx.t; k <= h / 2; k += cx.tr) {
      const int qa = cx.slot(k);
      if (k == 0) {   // S[0] and S[h] are real: keep their real parts only
        const float x0 = s[qa].x, xh = side->x;
        const float2 a = make_float2(spec(0, make_float2(x0, 0.f)).x, 0.f);
        const float2 b = make_float2(spec(h, make_float2(xh, xh)).x, 0.f);
        s[qa] = c2r_combine(__ldg(ab), a, b);
      } else {
        const int qb = cx.slot(h - k);
        const float2 a = spec(k, s[qa]), b = spec(h - k, s[qb]);
        s[qa] = c2r_combine(__ldg(ab + k), a, b);
        if (2 * k != h) s[qb] = c2r_combine(__ldg(ab + h - k), b, a);
      }
    }
  }
};

// Kernel 24's epilogue: the tile holds z of each row (u[2l] = Re z[l],
// u[2l + 1] = Im z[l]); quad p of the (T, n) output row is
// (Re z[p], Im z[h - 1 - p], Im z[p], Re z[h - 1 - p]), y 16-byte aligned.
struct Dct3RowBins {
  static constexpr bool kTileOut = true;
  float* __restrict__ y;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    const int h = cx.n;
    float4* yr = reinterpret_cast<float4*>(y + cx.row * 2 * h);
    for (int p = cx.t; p < h / 2; p += cx.tr) {
      const float2 a = s[cx.slot(p)], b = s[cx.slot(h - 1 - p)];
      yr[p] = make_float4(a.x, b.y, a.y, b.x);
    }
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

// Kernel 24. x, y: (T, 2h) float32, contiguous, both 16-byte aligned, h
// even; table: the inverse (sign +1) radix table of h (ops/hopper/fft.py::
// radix_consts); radices: radix_plan(h), `stages` of them; ab: (h, 4)
// float32 kernel 3 rows at scale 1 (ops/hopper/rfft.py::
// c2r_unpack_consts); pre: (h + 1,) complex64 (s / 2) e^{+i pi k / 2n}
// (ops/hopper/dct.py::dct3_pre); rows: rows per block (ops/hopper/fft.py::
// radix_block). Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct3_rows_radix(const void* x, void* y, const void* table,
                                     const int* radices, int stages, const void* ab,
                                     const void* pre, long long T, int h, int rows,
                                     void* stream) {
  using namespace ndfft;
  if (h < 2 || h % 2 || ab == nullptr || pre == nullptr ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15))
    return (int)cudaErrorInvalidValue;
  return (int)radix_rows_launch(
      Dct3RowLoad{static_cast<const float*>(x), static_cast<const float2*>(pre),
                  static_cast<const float4*>(ab)},
      Dct3RowBins{static_cast<float*>(y)}, static_cast<const float2*>(table), radices, stages,
      T, h, rows, 1, 1.f, static_cast<cudaStream_t>(stream));
}
