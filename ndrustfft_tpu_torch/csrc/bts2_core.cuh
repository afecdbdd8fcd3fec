// Shared n-leading DIF core of the Hopper FFT and DCT kernels (n = m * F,
// m = 128).
//
// Replaces, for the CUDA port, the core that the JAX package's Pallas kernels
// share: ndrustfft_tpu/ops/pallas/fft.py::_bts2_core with bfly_dft_leading
// and the twiddle-folded constants of _bts2_consts. It computes, for each
// column c of a block held in shared memory,
//
//   Y[q][b]        = sum_a x[a*m + b] W_F^{a q}             (stage 1, F-point
//                                                            radix-2 DIF, registers)
//   Z[q + F*p'][c] = sum_b Y[q][b] * Wq[q][b][p']            (stage 2, F dense
//                                                            m x m complex products)
//
// with Wq[q][b][p'] = W_n^{q b} * W_m^{b p'} * scale built on the host (numpy
// float64, cast to float32; ops/hopper/fft.py::bts2_consts), so the kernel
// does no twiddle work.
//
// What bounds it on the card: stage 2 is a dense DFT-128, 4*m = 512 real FMAs
// per complex output, on the FP32 CUDA cores. At 1024^2 that is ~1.07 GFLOP
// for ~17 MB of HBM traffic, so the kernel is compute-bound (~16 us at the
// 67 TFLOP/s FP32 peak against ~5 us of HBM). The design keeps the block in
// shared memory so that device memory is read and written once, broadcasts
// the Y operand across a warp (all its threads share q), and streams Wq
// (F * 128 KB, at most 2 MB) through L2. Tensor cores (3xTF32 wgmma) and a
// smaller radix are the levers for later work.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace ndfft {

constexpr int kM = 128;        // stage-2 DFT length m
constexpr int kThreads = 256;  // threads per block of every kernel
constexpr int kSmemElems = 8192;  // float2 elements of a block's tile (64 KB)
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

// cos and sin of 2*pi*j/16 for j = 0..7 (folded to constants after unrolling)
__device__ __forceinline__ float cos16(int j) {
  switch (j) {
    case 0: return 1.0f;
    case 1: return 0.92387953251128674f;
    case 2: return 0.70710678118654752f;
    case 3: return 0.38268343236508977f;
    case 4: return 0.0f;
    case 5: return -0.38268343236508977f;
    case 6: return -0.70710678118654752f;
    default: return -0.92387953251128674f;
  }
}

template <int F>
__device__ __forceinline__ int bitrev(int q) {
  int r = 0;
#pragma unroll
  for (int b = 1; b < F; b <<= 1) {
    r = (r << 1) | (q & 1);
    q >>= 1;
  }
  return r;
}

// F-point DFT (F in {2, 4, 8, 16}) of v in place, natural output order:
// radix-2 DIF levels with W_{2s}^k = exp(sign * 2 pi i k / (2s)), then the
// bit-reversal permutation (the natural-order output of bfly_dft_leading).
template <int F>
__device__ __forceinline__ void dft_leading(float2 (&v)[F], float sign) {
#pragma unroll
  for (int s = F / 2; s >= 1; s >>= 1) {
#pragma unroll
    for (int g = 0; g < F; g += 2 * s) {
#pragma unroll
      for (int k = 0; k < s; ++k) {
        const float2 a = v[g + k];
        const float2 b = v[g + k + s];
        v[g + k] = make_float2(a.x + b.x, a.y + b.y);
        const float2 d = make_float2(a.x - b.x, a.y - b.y);
        const int j = k * (16 / (2 * s));
        if (j == 0) {
          v[g + k + s] = d;
        } else if (j == 4) {  // times (0, sign): a re/im swap and a sign
          v[g + k + s] = make_float2(-d.y * sign, d.x * sign);
        } else {
          const float c = cos16(j);
          // sin(2 pi j / 16) = cos(2 pi |4 - j| / 16)
          const float sn = sign * cos16(j > 4 ? j - 4 : 4 - j);
          v[g + k + s] = make_float2(d.x * c - d.y * sn, d.x * sn + d.y * c);
        }
      }
    }
  }
  float2 t[F];
#pragma unroll
  for (int q = 0; q < F; ++q) t[q] = v[bitrev<F>(q)];
#pragma unroll
  for (int q = 0; q < F; ++q) v[q] = t[q];
}

// The length-n transform of C columns held in shared memory.
// kRows == false: element (t, c) at s[t * C + c]   (a column tile, kernel 1)
// kRows == true:  element (t, c) at s[c * n + t]   (C contiguous rows, kernels 13, 23, 24)
// wq: (F, m, m) complex constants in device memory, wq[(q*m + b)*m + p'].
// All kThreads threads of the block must call it; it ends with a barrier.
// For n = 128 (F = 1, the DCT kernels' n = 256 rows) stage 1 is the identity
// and the block's threads split into G = 2 groups, each taking half of the
// columns in stage 2; for n >= 256, G = 1 and every thread takes all C.
template <int F, int C, bool kRows>
struct Bts2 {
  static constexpr int N = F * kM;
  static constexpr int ST = kRows ? 1 : C;  // stride of the transform index
  static constexpr int SC = kRows ? N : 1;  // stride of the column index
  static constexpr int G = N >= kThreads ? 1 : kThreads / N;  // column groups
  static constexpr int P = N * G / kThreads;  // stage-2 (q, p') pairs per thread
  static constexpr int CG = (C + G - 1) / G;  // columns per group
  static_assert((N * G) % kThreads == 0, "n must divide or be a multiple of the block size");
  static_assert(N * C <= kSmemElems, "tile exceeds the shared-memory budget");

  __device__ static void run(float2* s, const float2* __restrict__ wq,
                             float sign) {
    if constexpr (F > 1) {
      // stage 1: F-point DFT over the leading planes a, for each (b, c)
      for (int idx = threadIdx.x; idx < kM * C; idx += kThreads) {
        const int b = kRows ? idx % kM : idx / C;
        const int c = kRows ? idx / kM : idx % C;
        float2 v[F];
#pragma unroll
        for (int a = 0; a < F; ++a) v[a] = s[(a * kM + b) * ST + c * SC];
        dft_leading<F>(v, sign);
#pragma unroll
        for (int q = 0; q < F; ++q) s[(q * kM + b) * ST + c * SC] = v[q];
      }
      __syncthreads();
    }
    // stage 2: per-q dense product b -> p' with the folded constants
    const int lane = G == 1 ? (int)threadIdx.x : (int)threadIdx.x % N;
    const int c0 = G == 1 ? 0 : ((int)threadIdx.x / N) * CG;
    float2 acc[P][CG];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int idx = j * kThreads + lane;
      const int q = idx / kM;
      const int p = idx % kM;
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[j][c] = make_float2(0.f, 0.f);
      const float2* __restrict__ w = wq + (size_t)q * kM * kM + p;
      const float2* y = s + q * kM * ST;
#pragma unroll 4
      for (int b = 0; b < kM; ++b) {
        const float2 wv = __ldg(w + b * kM);
#pragma unroll
        for (int c = 0; c < CG; ++c)
          if (G == 1 || c0 + c < C)
            cmac(acc[j][c], y[b * ST + (c0 + c) * SC], wv);
      }
    }
    __syncthreads();
    // exit: the (p', q) order IS k = q + F*p'
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int idx = j * kThreads + lane;
      const int k = idx / kM + F * (idx % kM);
#pragma unroll
      for (int c = 0; c < CG; ++c)
        if (G == 1 || c0 + c < C) s[k * ST + (c0 + c) * SC] = acc[j][c];
    }
    __syncthreads();
  }
};

// Fill the column tile s of a fixed-core block (element (t, c) at
// s[t * C + c], h rows) with fn(t, c) for the V valid columns and zeros
// past them; consecutive threads take consecutive columns of a row, so that
// the loads from device memory coalesce. No barrier.
template <int C, class Fn>
__device__ __forceinline__ void fixed_fill(float2* s, int h, int V, Fn&& fn) {
  for (int idx = threadIdx.x; idx < h * C; idx += kThreads) {
    const int t = idx / C;
    const int c = idx % C;
    s[idx] = c < V ? fn(t, c) : make_float2(0.f, 0.f);
  }
}

// The first column and the count of valid columns of a fixed-core block
// (one block per (b, tile of C columns), the last tile ragged), and its b.
template <int C>
__device__ __forceinline__ long long fixed_tile(long long L, long long tiles, long long& col0,
                                                int& valid) {
  col0 = (blockIdx.x % tiles) * C;
  valid = (int)min((long long)C, L - col0);
  return blockIdx.x / tiles;
}

// fn(std::integral_constant<int, F>{}, std::integral_constant<int, C>{})
// for a fixed-core column tile: h = 128 * F with F in {2, 4, 8, 16} and
// F >= kMinF, C in {1, 2, ..., 32} with h * C <= kSmemElems. Any other h or C
// returns an error, and only the tiles that fit are instantiated.
template <int kMinF, class Fn>
cudaError_t fixed_dispatch(int h, int C, Fn&& fn) {
  auto with_f = [&](auto f) -> cudaError_t {
    constexpr int F = decltype(f)::value;
    auto go = [&](auto c) -> cudaError_t {
      if constexpr (F < kMinF || F * kM * decltype(c)::value > kSmemElems) {
        return cudaErrorInvalidValue;
      } else {
        return fn(f, c);
      }
    };
    switch (C) {
      case 1: return go(std::integral_constant<int, 1>{});
      case 2: return go(std::integral_constant<int, 2>{});
      case 4: return go(std::integral_constant<int, 4>{});
      case 8: return go(std::integral_constant<int, 8>{});
      case 16: return go(std::integral_constant<int, 16>{});
      case 32: return go(std::integral_constant<int, 32>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (h) {
    case 2 * kM: return with_f(std::integral_constant<int, 2>{});
    case 4 * kM: return with_f(std::integral_constant<int, 4>{});
    case 8 * kM: return with_f(std::integral_constant<int, 8>{});
    case 16 * kM: return with_f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// Launch kernel(args..., tiles) on B times the tiles of L columns, C per
// tile, with the tile (F * 128 * C complex values) as dynamic shared memory.
// A grid the card cannot take returns an error.
template <int F, int C, class... KArgs, class... Args>
cudaError_t fixed_launch(void (*kernel)(KArgs...), long long B, long long L,
                         cudaStream_t stream, Args... args) {
  const long long tiles = (L + C - 1) / C;
  if (B < 1 || L < 1 || B * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = F * kM * C * (int)sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)(B * tiles), kThreads, smem, stream>>>(args..., tiles);
  return cudaGetLastError();
}

}  // namespace ndfft
