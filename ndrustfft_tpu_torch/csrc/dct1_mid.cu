// Kernel 19: DCT-I along the middle axis of a (B, n, L) float32 tensor, odd
// n = h + 1, h = 128 * F: F in {2, 4, 8, 16} on the fixed core, every other
// F <= 160 on the wide core (both in r2c_col.cuh).
// The routes send n > 1100 here (n = 1153 ... 20481); kernel 27 takes the
// shorter lengths.
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_dct1_kernel_mid (built by
// _build_dct1_mid, called by dct1_pallas_mid). It computes scale * Re of the
// R2C of length 2h of the even extension e of each column,
//   e[j] = x[j] for j <= h,  e[2h - j] = x[j] for 0 < j < h,
// which is scale * 2 * the rustdct DCT-I; the API passes 0.5 * the policy's
// scalar, as the JAX package does. The output is the real rows 0 .. h only,
// h + 1 = n floats per column.
//
// It is the bts2 column R2C (r2c_col.cuh; kernel 18's until it moved onto
// the radix column tile, rfft_mid_radix.cu) with the load and store of
// Dct1Io below: the load builds z[t] = e[2t] + i e[2t+1]
// by reading x from both ends of the column (two row loads per element, no
// flipped copy of x: the JAX package materialises flip(x) as a second
// operand because Mosaic needs it, a full extra pass); Z = FFT_h(z) on the
// core; the store keeps the unpack's real part
//   y[k] = scale * Re((Z[k] + C[k]) / 2 - i W_{2h}^k (Z[k] - C[k]) / 2),
//   y[h] = scale * (Re Z[0] - Im Z[0]),  C[k] = conj Z[(h - k) mod h],
// with the scale folded into the unpack's 1/2 (bts2_core.cuh::r2c_unpack_one).
//
// The wide form. The wide core writes each output straight to device
// memory, and the unpack needs Z[k] and its mirror Z[h - k] together; the
// output has only h + 1 floats per column, no room for Z's 2h. The wrapper
// gives the wide form a (B, h, L) complex64 workspace: the core writes Z
// there, and after its closing block barrier each thread takes one mirror
// pair {k, h - k} of one column and writes y[k] and y[h - k] (Dct1Io::z;
// the reread was written by this block a moment before, and L2 serves it).
// The workspace costs 16 h bytes per column of extra traffic (written once,
// read once), counted in the kernel's bound.
//
// What bounds it: the core's stage 2, a dense DFT-128 on the FP32 CUDA cores
// (bts2_core.cuh, bts2_wide.cuh). The column is read once (each element of
// x feeds e at most twice, from one coalesced row load each) and written
// once; every constant comes from the host (ops/hopper/rfft.py).
#include "r2c_col.cuh"

namespace ndfft {

// Kernel 19's load and store: z[t] = e[2t] + i e[2t+1] of the even extension
// of a column of x (B, h + 1, L), e[j] = x[j] for j <= h and x[2h - j]
// above; the real part of X to y (B, h + 1, L); Z in the workspace ws
// (B, h, L) complex64 (wide core).
struct Dct1Io {
  const float* __restrict__ x;
  float* y;
  float2* ws;
  int h;
  long long L;
  __device__ float at(long long b, int j, long long col) const {
    return __ldg(x + (b * (h + 1) + (j <= h ? j : 2 * h - j)) * L + col);
  }
  __device__ float2 load(long long b, int t, long long col) const {
    return make_float2(at(b, 2 * t, col), at(b, 2 * t + 1, col));
  }
  __device__ float2* z(long long b) const { return ws + b * h * L; }
  __device__ void store(long long b, int k, long long col, float2 v) const {
    y[(b * (h + 1) + k) * L + col] = v.x;
  }
};

static int dct1_entry(bool wide, const void* x, void* y, void* ws, const void* wq,
                      const void* wf, const void* tw, float scale, long long B, int n,
                      long long L, int C, void* stream) {
  const Dct1Io io{static_cast<const float*>(x), static_cast<float*>(y),
                  static_cast<float2*>(ws), n - 1, L};
  return (int)r2c_col_launch(wide, io, n - 1, wq, wf, tw, scale, B, L, C, stream);
}

}  // namespace ndfft

// Kernel 19 on the fixed core: x, y: (B, n, L) float32, contiguous, n = h + 1,
// h = 128 * F, F in {2, 4, 8, 16}; wq: (F, 128, 128) complex64 for h, sign -1,
// unscaled; tw: (h,) complex64 W_{2h}^k. C: columns per block, a power of two
// with h * C <= 8192. Returns the cudaError_t of the launch (0 on success).
extern "C" int ndfft_dct1_mid(const void* x, void* y, const void* wq, const void* tw,
                              float scale, long long B, int n, long long L, int C,
                              void* stream) {
  return ndfft::dct1_entry(false, x, y, nullptr, wq, nullptr, tw, scale, B, n, L, C, stream);
}

// Kernel 19 on the wide core, h = n - 1 = 128 * F with 1 <= F <= 160: x, y,
// wq and tw as above; ws: (B, h, L) complex64 workspace; wf: (F, F)
// complex64 DFT-F, sign -1. C: columns per tile, a power of two <= 16 whose
// tile fits (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_dct1_mid_wide(const void* x, void* y, void* ws, const void* wq,
                                   const void* wf, const void* tw, float scale, long long B,
                                   int n, long long L, int C, void* stream) {
  return ndfft::dct1_entry(true, x, y, ws, wq, wf, tw, scale, B, n, L, C, stream);
}
