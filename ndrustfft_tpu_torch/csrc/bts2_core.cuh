// What the Hopper kernels share from the bts2 core, the n-leading DIF
// split n = m * F, m = 128, of the JAX package's Pallas kernels
// (ndrustfft_tpu/ops/pallas/fft.py::_bts2_core): its constants, the complex
// multiply-add, and the R2C/C2R unpack of one bin (used by the radix core,
// fft_radix.cuh, and by the dense kernels).
//
// The core itself, a dense DFT-F then a dense DFT-128 (4 m = 512 real FMAs
// per complex output on the FP32 CUDA cores), runs only on the wide core
// (bts2_wide.cuh: any F <= 256, the remnant forms of kernels 23 to 26, 28
// and 29 at the lengths whose half length has no radix plan). Its fixed
// form (F in {2, 4, 8, 16} at compile time, the tile overwritten in place)
// is gone: every kernel it ran moved to the mixed-radix core.
#pragma once

#include <cuda_runtime.h>

namespace ndfft {

constexpr int kM = 128;        // stage-2 DFT length m
constexpr int kThreads = 256;  // threads per block of every kernel
constexpr long long kMaxSmemBytes = 232448;   // dynamic shared memory of a block

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 w) {
  acc.x = fmaf(a.x, w.x, acc.x);
  acc.x = fmaf(-a.y, w.y, acc.x);
  acc.y = fmaf(a.x, w.y, acc.y);
  acc.y = fmaf(a.y, w.x, acc.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// X[k] of the R2C unpack from a = Z[k], b = Z[(h - k) mod h] and
// w = W_n^k: X[k] = (Z[k] + C[k]) / 2 - i W_n^k (Z[k] - C[k]) / 2 with
// C = conj b.
__device__ __forceinline__ float2 r2c_unpack_one(float2 a, float2 b, float2 w) {
  constexpr float half = 0.5f;
  const float fer = half * (a.x + b.x);
  const float fei = half * (a.y - b.y);
  const float for_ = half * (a.y + b.y);    // Re(-i/2 (Z - C))
  const float foi = -half * (a.x - b.x);    // Im(-i/2 (Z - C))
  return make_float2(fer + for_ * w.x - foi * w.y, fei + for_ * w.y + foi * w.x);
}

// A sk + B conj sm with c = (A.re, A.im, B.re, B.im): one bin of the C2R's
// inverse unpack from S[k] = sk and S[h - k] = sm (kernels 22 and 29's pair
// passes, kernels 3 and 17's prologue, fft_radix.cuh::c2r_prologue_tile).
__device__ __forceinline__ float2 c2r_combine(float4 c, float2 sk, float2 sm) {
  return make_float2(c.x * sk.x - c.y * sk.y + c.z * sm.x + c.w * sm.y,
                     c.x * sk.y + c.y * sk.x + c.w * sm.x - c.z * sm.y);
}

}  // namespace ndfft
