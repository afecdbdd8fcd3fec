// What the fused spectral pipelines share (kernels 14, 22 and 29:
// spectral_c2c_mid.cu, spectral_r2c_mid.cu, spectral_dct_mid.cu): the
// diagonal multiplier H between the forward and the inverse transform.
//
// Each of those kernels runs a forward transform, the multiply and the
// inverse transform on one column tile without writing the spectrum to
// device memory on the fixed core (the tile stays in shared memory). The
// wide core writes every output straight to device memory and reads its
// whole tile while it does, so it cannot work in place and a second tile
// does not fit beside a 160 KB one: there the forward core writes the
// intermediate into the block's own columns of the output, which hold it
// exactly (n complex values for kernel 14, the half-length spectrum's h
// complex values in 2h floats for kernels 22 and 29, the n real DCT-II
// values times H for kernel 29's n-point form), and after the core's closing
// block barrier the block reads it back into the tile for the inverse core.
#pragma once

#include "bts2_wide.cuh"

namespace ndfft {

// The multiplier H as float32 planes: H[k] of column col at hr[k * hc + col]
// (and hi) for a lane-varying (rows, L) multiplier, hc = L; at hr[k] for a
// broadcast (rows, 1) one, hc = 1; hi = nullptr for a real H. H depends on
// (k, col) only: every batch index b reads the same block.
struct SpecMult {
  const float* __restrict__ hr;
  const float* __restrict__ hi;
  long long hc;
  __device__ long long pos(int k, long long col) const { return hc == 1 ? k : k * hc + col; }
  __device__ float re(int k, long long col) const { return __ldg(hr + pos(k, col)); }
  __device__ float2 at(int k, long long col) const {
    const long long i = pos(k, col);
    return make_float2(__ldg(hr + i), hi == nullptr ? 0.f : __ldg(hi + i));
  }
};

// The multiplier of the C entry points: hc = 1 or L, else nullptr in hr.
inline SpecMult spec_mult(const void* hr, const void* hi, long long hc, long long L) {
  if (hc != 1 && hc != L) hr = nullptr;
  return SpecMult{static_cast<const float*>(hr), static_cast<const float*>(hi), hc};
}

}  // namespace ndfft
