// Kernel 28 on the mixed-radix core's column tile (fft_radix.cuh::
// radix_cols_kernel): DCT-IV along the middle axis of a (B, n, L) float32
// tensor, n = 2 hl, hl = 128 * F, at every F whose hl has a plan
// (ops/hopper/fft.py::radix_plan): one pass at hl <= 10240, the two passes
// of a column four-step above it (ops/hopper/dct.py::dct4_form). The 23
// prime F without a plan keep the wide core and the long form (dct4_mid.cu).
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_dct4_kernel_mid (:670, called
// at :735 by dct4_pallas_mid), which runs four real twostep pipelines with
// the chirps folded into its stage constants. Its first Hopper forms ran the
// bts2 cores' dense DFT-128 on the FP32 cores: 27.02 ms at (2048, 2048,
// 256) on the fixed core, and the long form, two passes of the wide core's
// real tile per column, one column a tile, 466.7 ms at (1, 65536, 8192),
// 361x its byte bound.
//
// The algebra is dct4_mid.cu's: the entry chirp
//   c_s = w_s (x[2s] + i x[n-1-2s]),  w_s = e^{-i pi (4s+1) / (4n)},
// D = FFT_hl(c), and the exit y[2k] = Re(D_k conj p_k),
// y[n-1-2k] = -Im(D_k conj p_k), p_k = scale e^{i pi k / n}, both chirps
// host tables (ops/hopper/dct.py::dct4_chirp, dct4_post).
//
// What bounds it on this card: device memory. A column is read once and
// written once, 8 n bytes (1.29 ms at (1, 65536, 8192) over 3.35 TB/s),
// against 5 hl log2 hl FP32 operations (0.17 ms of the 67 TFLOP/s peak).
//
// The single pass: the load policy reads rows 2s and n - 1 - 2s of the tile's
// columns (consecutive threads on consecutive columns) and applies the entry
// chirp (Dct4Col); the forward radix_run of hl leaves D in the tile
// (kTileOut); the epilogue applies the exit chirp and writes y[2k] and
// y[n-1-2k] a tile row at a time (Dct4Rows). As in kernels 16, 17 and 27 the
// stores come from an epilogue, not the last stage (a store there spilled
// 0.5-13 KB a thread on an H100).
//
// The four-step, hl = h1 h2: above hl = 20480 the core stops (20480
// elements a tile) and the complex tile of one column (8 hl bytes, 256 KB
// at hl = 32768) does not fit a block; above 10240 the single pass holds one
// column a tile, whose rows are 4-byte reads (2.7x slower than the
// four-step at (1, 40960, 8192) on an H100, chip_smoke.py phase 5). With
// s = s1 h2 + s2 and k = k1 + h1 k2,
//   D[k1 + h1 k2] = sum_s2 W_h2^{s2 k2} W_hl^{s2 k1} sum_s1 W_h1^{s1 k1} c[s1 h2 + s2].
// Pass 1 runs the length-h1 transforms over s1, one for each (b, s2) and
// column, with Dct4Col's load at s = s2 + h2 s1; its epilogue multiplies by
// W_hl^{s2 k1} (a host table of hl entries, dct.py::dct4_fourstep_tw) and
// parks the value in y itself, Re at row 2k' and Im at row n - 1 - 2k',
// k' = k1 + h1 s2. Pass 2 runs the length-h2 transforms over s2, one for
// each (b, k1) and column: it loads rows 2k' and n - 1 - 2k' at
// k' = k1 + h1 s2 and writes Dct4Rows's exit at k = k1 + h1 k2, the same
// set of rows. The skeleton loads the whole tile behind a barrier before
// any store and no other tile touches those rows, so pass 2 runs in place
// on y: no workspace, x read once, y written twice and read once (16 n
// bytes a column). Both passes take 8-32 columns a tile, so that every
// tile row is a 32-128-byte run. x must not alias y (pass 1 writes y while
// other tiles read x; the wrapper always allocates y).
//
// Both passes treat (b, s0) as the skeleton's batch bb = b m + s0, m
// sub-transforms of each b: the load handle carries s0 beside the column's
// offset (Dct4Handle), and the epilogue decodes them from its handle
// bb 2^32 + col once a thread, by 32-bit arithmetic (a 64-bit division is
// a call).
#include "fft_radix.cuh"

namespace ndfft {

// A transform's load handle: the offset b n L + col of its column and its
// first index s0.
struct Dct4Handle {
  long long p;
  int s0;
  __device__ __forceinline__ Dct4Handle operator+(int c) const { return {p + c, s0}; }
};

// The DCT-IV's columns: element r of transform bb = b m + s0 of column col
// at s = s0 + m r, from rows 2s and n - 1 - 2s of x (B, n, L): kChirp
// w_s (x[2s] + i x[n-1-2s]) (the single pass, pass 1), else the value that
// pass 1 parked there, x[2s] + i x[n-1-2s] (pass 2, on y in place), loaded
// evict-first or (kLdg) through the read-only path, which keeps each
// 32-byte sector in L2 for the neighbouring tiles where a tile row is one
// or two floats.
template <bool kChirp, bool kLdg = false>
struct Dct4Col {
  const float* x;                  // pass 2: y, which its epilogue writes
  const float2* __restrict__ w;    // w_s, s < hl (kChirp)
  long long L;
  int n, m;
  __device__ __forceinline__ Dct4Handle base(long long bb, long long col) const {
    const int b = (int)bb / m;
    return {(long long)b * n * L + col, (int)bb - b * m};
  }
  __device__ __forceinline__ float ld(const float* q) const {
    return kLdg ? __ldg(q) : __ldcs(q);
  }
  __device__ __forceinline__ float2 at(const Dct4Handle& h, int r) const {
    const int s = h.s0 + m * r;
    const float a = ld(x + h.p + (long long)(2 * s) * L);
    const float b = ld(x + h.p + (long long)(n - 1 - 2 * s) * L);
    if constexpr (kChirp) {
      const float2 c = __ldg(w + s);
      return make_float2(a * c.x - b * c.y, a * c.y + b * c.x);
    } else {
      return make_float2(a, b);
    }
  }
};

// The DCT-IV's epilogue: transform bb = b m + s0 of column col holds X[j],
// j < len, in the tile; output j goes to k = c0 s0 + a j. kPark (pass 1):
// v = X W_hl^{s0 j} (t: W_hl^u, u < hl), Re v to row 2k and Im v to row
// n - 1 - 2k; else (the single pass, pass 2) the exit y[2k] = Re(X conj p_k),
// y[n-1-2k] = -Im(X conj p_k) (t: the exit chirp p_k, k < hl), into y
// (B, n, L).
template <bool kPark>
struct Dct4Rows {
  static constexpr bool kTileOut = true;
  float* y;
  const float2* __restrict__ t;
  long long L;
  int n, m, c0, a;
  __device__ __forceinline__ long long handle(long long bb, long long col) const {
    return (bb << 32) + col;
  }
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
  template <class Cx>
  __device__ __forceinline__ void epilogue(const float2* s, const Cx& cx) const {
    if (!cx.active) return;
    const int bb = (int)(cx.row >> 32), b = bb / m, s0 = bb - b * m;
    float* yc = y + (long long)b * n * L + (cx.row & 0xffffffffLL);
    const long long ls = L;
    for (int j = cx.t; j < cx.n; j += cx.tr) {
      const float2 v = s[cx.slot(j)];
      const int k = c0 * s0 + a * j;
      float re, im;
      if constexpr (kPark) {
        const float2 w = __ldg(t + s0 * j);
        re = v.x * w.x - v.y * w.y;
        im = v.x * w.y + v.y * w.x;
      } else {
        const float2 p = __ldg(t + k);
        re = v.x * p.x + v.y * p.y;
        im = v.x * p.y - v.y * p.x;
      }
      yc[2 * k * ls] = re;
      yc[(n - 1 - 2 * k) * ls] = im;
    }
  }
};

}  // namespace ndfft

// x, y: (B, n, L) float32, contiguous, n = 2 hl, L < 2^31; y distinct from
// x. pass: 0 the single pass (len = hl), 1 and 2 the four-step's passes
// (len = h1 and h2, hl = h1 h2; pass 2 reads and writes y alone). table:
// the radix table of len, sign -1 (ops/hopper/fft.py::radix_consts);
// radices: radix_plan(len), `stages` of them; chirp: (hl,) complex64 entry
// chirp w_s (passes 0 and 1, ops/hopper/dct.py::dct4_chirp); t: (hl,)
// complex64, the exit chirp p_k with the scale folded in (passes 0 and 2,
// dct.py::dct4_post) or W_hl^u (pass 1, dct.py::dct4_fourstep_tw). C:
// columns per tile (dct.py::dct4_mid_cols, dct4_fourstep_cols); ldg: 1
// loads x through the read-only path (pass 0), 0 evict-first. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct4_mid_radix(int pass, const void* x, void* y, const void* table,
                                    const int* radices, int stages, const void* chirp,
                                    const void* t, long long B, int n, long long L, int len,
                                    int C, int ldg, void* stream) {
  using namespace ndfft;
  const int hl = n / 2;
  RadixPlan plan{};
  if (pass < 0 || pass > 2 || n % 2 || len < 2 || hl % len || (pass == 0) != (len == hl) ||
      L >= (1LL << 31) || x == y || !radix_plan_of(radices, stages, len, plan) || t == nullptr ||
      (pass < 2 && chirp == nullptr))
    return (int)cudaErrorInvalidValue;
  const int m = hl / len;
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float*>(y);
  const auto tp = static_cast<const float2*>(table);
  const auto w = static_cast<const float2*>(chirp);
  const auto tt = static_cast<const float2*>(t);
  const auto st = static_cast<cudaStream_t>(stream);
  // output j of transform (b, s0) at k = c0 s0 + a j: k1 + h1 s2 in pass 1
  // (j = k1, s0 = s2), k1 + h1 k2 in pass 2 (s0 = k1, j = k2), k in pass 0
  if (pass == 1)
    return (int)radix_cols_launch<-1>(Dct4Col<true>{xp, w, L, n, m},
                                      Dct4Rows<true>{yp, tt, L, n, m, len, 1}, tp, plan, B * m,
                                      len, L, C, 1.f, st);
  const Dct4Rows<false> exit{yp, tt, L, n, m, 1, m};
  if (pass == 2)
    return (int)radix_cols_launch<-1>(Dct4Col<false>{yp, nullptr, L, n, m}, exit, tp, plan,
                                      B * m, len, L, C, 1.f, st);
  return ldg ? (int)radix_cols_launch<-1>(Dct4Col<true, true>{xp, w, L, n, 1}, exit, tp, plan, B,
                                          len, L, C, 1.f, st)
             : (int)radix_cols_launch<-1>(Dct4Col<true>{xp, w, L, n, 1}, exit, tp, plan, B, len,
                                          L, C, 1.f, st);
}
