// Kernel 18: the packed R2C along the middle axis of two (B, h, L) float32
// streams, h = 128 * F: F in {2, 4, 8, 16} on the fixed core, every other
// F <= 160 on the wide core (both in r2c_col.cuh).
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_r2c_kernel_packed_mid (built
// by _build_r2c_packed_mid, called by r2c_pallas_packed_mid). It computes,
// for each column, scale * the R2C of length n = 2h of the real column whose
// even samples are xe and whose odd samples are xo, as (B, h + 1, L)
// complex64. DST-I along a middle axis is its caller: the streams are the
// even and odd samples of the odd extension [0, x, 0, -flip(x)], assembled
// by elementwise torch ops (ops/dst.py::dst1_streams), as the JAX package
// assembles them in XLA.
//
// It is kernel 16's former bts2 form with one change: z[t] = xe[t] + i xo[t]
// is loaded from two tensors, where kernel 16 loads rows 2t and 2t + 1 of one.
// Both run r2c_col.cuh's kernels (Z = FFT_h(z) on the fixed or the wide
// core, then the unpack), with the load and store of PackedIo below:
//   X[k] = scale * ((Z[k] + C[k]) / 2 - i W_n^k (Z[k] - C[k]) / 2),  k < h,
//   X[h] = scale * (Re Z[0] - Im Z[0]),  C[k] = conj Z[(h - k) mod h].
// The scale folds into the unpack's 1/2, as the TPU kernel folds
// 0.5 * scale into its combine; the W_n^k table carries none. The TPU kernel
// ran [z | conj z] through its core to avoid gathering the mirror; here the
// mirror is a shared-memory read (fixed core) or, on the wide core, a reread
// of Z from the output's own rows after the core's closing barrier.
//
// What bounds it: the core's stage 2, a dense DFT-128 on the FP32 CUDA cores
// (bts2_core.cuh); the two streams are read once and the spectrum written
// once, each row load and store coalesced over the tile's C columns, and
// every constant comes from the host (ops/hopper/rfft.py). The streams
// themselves cost the caller two passes over the field; reading x directly
// in the kernel is queued as speed work.
#include "r2c_col.cuh"

namespace ndfft {

// Kernel 18's load and store: z[t] = xe[t] + i xo[t] from two (B, h, L)
// streams, X to (B, h + 1, L) complex64, Z in the output's rows 0 .. h - 1
// (wide core).
struct PackedIo {
  const float* __restrict__ xe;
  const float* __restrict__ xo;
  float2* out;
  int h;
  long long L;
  __device__ float2 load(long long b, int t, long long col) const {
    const long long i = (b * h + t) * L + col;
    return make_float2(__ldg(xe + i), __ldg(xo + i));
  }
  __device__ float2* z(long long b) const { return out + b * (h + 1) * L; }
  __device__ void store(long long b, int k, long long col, float2 v) const {
    out[(b * (h + 1) + k) * L + col] = v;
  }
};

static int packed_entry(bool wide, const void* xe, const void* xo, void* out, const void* wq,
                        const void* wf, const void* tw, float scale, long long B, int h,
                        long long L, int C, void* stream) {
  const PackedIo io{static_cast<const float*>(xe), static_cast<const float*>(xo),
                    static_cast<float2*>(out), h, L};
  return (int)r2c_col_launch(wide, io, h, wq, wf, tw, scale, B, L, C, stream);
}

}  // namespace ndfft

// Kernel 18 on the fixed core: xe, xo: (B, h, L) float32; out: (B, h + 1, L)
// complex64; wq: (F, 128, 128) complex64 for h, sign -1, unscaled; tw: (h,)
// complex64 W_{2h}^k; all contiguous; h = 128 * F, F in {2, 4, 8, 16}. C:
// columns per block, a power of two with h * C <= 8192. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_r2c_packed_mid(const void* xe, const void* xo, void* out, const void* wq,
                                    const void* tw, float scale, long long B, int h,
                                    long long L, int C, void* stream) {
  return ndfft::packed_entry(false, xe, xo, out, wq, nullptr, tw, scale, B, h, L, C, stream);
}

// Kernel 18 on the wide core, h = 128 * F with 1 <= F <= 160: xe, xo, out, wq
// and tw as above; wf: (F, F) complex64 DFT-F, sign -1. C: columns per tile,
// a power of two <= 16 whose tile fits (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_r2c_packed_mid_wide(const void* xe, const void* xo, void* out,
                                         const void* wq, const void* wf, const void* tw,
                                         float scale, long long B, int h, long long L, int C,
                                         void* stream) {
  return ndfft::packed_entry(true, xe, xo, out, wq, wf, tw, scale, B, h, L, C, stream);
}
