// The n-leading DIF core of the Hopper FFT kernels at any butterfly factor:
// n = m * F, m = 128, F a runtime value (1 <= F <= 256, n <= 32768).
//
// Replaces, for the CUDA port, ndrustfft_tpu/ops/pallas/fft.py::_bts2_core
// where its stage 1 is not a radix-2 butterfly (F outside {2, 4, 8, 16}: the
// dense DFT-F dot of _combine_f with the Wf table of _bts2_consts). It
// computes the function of bts2_core.cuh, for each column c of a tile held
// in shared memory,
//
//   Y[q][b]        = sum_a x[a*m + b] W_F^{a q}                  (stage 1)
//   Z[q + F*p'][c] = sum_b Y[q][b] * Wq[q][b][p']                (stage 2)
//
// with the same twiddle-folded Wq (ops/hopper/fft.py::bts2_consts) and
// W_F^k = row 1 of the DFT-F table (ops/hopper/fft.py::wide_consts): the
// table's phase is reduced mod F, so W_F^{a q} is that row at (a q) mod F
// bit for bit, and the block keeps the row (F values) in shared memory.
//
// The form, and why. bts2_core.cuh overwrites its tile in place: stage 1
// holds a column's F inputs in registers and stage 2 holds each thread's F/2
// outputs per column until a barrier. At a runtime F up to 160 neither fits
// in registers, and a second tile does not fit beside a 164 KB one. So the
// tile x stays intact and the planes q go in groups of at most four: stage
// 1 builds Y of the group's planes into a small scratch (4 * 128 * C), then
// stage 2 takes each (q, p') of the group with all C columns in registers
// and writes its outputs straight to device memory (as the generic core's
// pass 2 does). The planes pair as {j, F - j}: W_F^{a (F - j)} is the
// conjugate of W_F^{a j}, so one pass over x gives both planes from four
// real sums, A = sum x.re w.re, B = sum x.im w.im, C = sum x.re w.im,
// D = sum x.im w.re (plane j: A - B + i (C + D); plane F - j: A + B +
// i (D - C)), 2 F FMAs per output. For even F the real-twiddle planes 0 and
// F/2 form one unit; for odd F plane 0 is a unit alone, the last one.
//
// What bounds it on this card: stage 2's dense DFT-128, 512 FP32 FMAs per
// complex output, plus stage 1's 2 F: 8 (128 + F) FLOPs per output against
// the 5 log2 n of an FFT, so every kernel on this core is bound by the FP32
// cores (the 768^3 step's K1 leg at (768, 768, 385): 243 GFLOP, >= 3.6 ms at
// 67 TFLOP/s, against 3.63 GB of HBM traffic, 1.08 ms). The design reads and
// writes device memory once (the outputs go out as scattered 8-byte stores,
// k = q + F p' with p' across the warp; L2 merges them), broadcasts Y across
// the warp in stage 2 (the warp shares q), streams Wq (F * 128 KB, 21 MB at
// F = 160) through L2 with __ldg, and gives each thread C columns so that one
// Wq load feeds C complex MACs. A group whose planes fill fewer than four
// slots leaves threads idle in stage 2: half a plane per transform for odd
// F. A radix split of F, 3xTF32 wgmma and TMA are later work.
//
// The tile of complex inputs holds 8 n bytes per transform, so one
// transform fits a block up to F = 221 (n = 28288); the complex-input
// kernels stop at F = 160 (n = 20480, the JAX package's kernel bound). The
// DCT forms beyond it (n-point DCT-II/III at n = 128 k, odd k <= 255, and
// DCT-IV's half length 128 F, F <= 256) have a real input: the DCT-II's
// Makhoul row, the DCT-III's c (x with x0 halved) times a chirp, DCT-IV's
// two real streams times a chirp. Their tile holds floats (4 n bytes,
// 131 KB at n = 32768), and the stage-1 input policy (below) says how an
// element enters the DFT-F: as it is (CplxIn), as a real value (RealIn:
// a mirror pair is one complex sum and its conjugate, F FMAs per plane
// instead of 2 F), or times a chirp w[a * 128 + b] = wa[a] * wb[b] that
// is separable over the split (ChirpIn: wa, F values, in shared memory
// beside the row W_F^k; wb[b] multiplies Y[q][b] after the sum), the fold
// that the TPU kernels make in their stage constants
// (ndrustfft_tpu/ops/pallas/dct.py::_fft_consts' pre_a and pre_b). At
// F = 256 the Wq table is 32 MB, streamed from L2 once per tile, so a tile
// of one transform reads 1 KB of Wq per output (every long form runs one
// transform per tile): that stream and the column's two stages, not device
// memory, bound them.
//
// Tile layouts (C = transforms of the tile, V <= C valid):
//   kRows:  element (t, c) at s[c * n + t]   (contiguous rows: K23, K24)
//   cols:   element (t, c) at s[t * C + c]   (a column tile: K25, K26, K28, K29)
#pragma once

#include <type_traits>

#include "bts2_core.cuh"

namespace ndfft {

constexpr int kWideSlots = 4;      // planes per group: two units of up to two
constexpr int kWideMaxF = 256;     // n <= 32768

// Dynamic shared memory of a tile of C transforms of length n: the tile,
// the Y scratch and the row W_F^k.
inline long long wide_smem_bytes(int n, int C) {
  return (long long)sizeof(float2) * ((long long)C * (n + kWideSlots * kM) + n / kM);
}

// The same for a real tile (floats) with two rows of F values: W_F^k and
// a chirp row wa (ChirpIn).
inline long long wide_real_smem_bytes(int n, int C) {
  return (long long)sizeof(float) * C * n +
         (long long)sizeof(float2) * ((long long)C * kWideSlots * kM + 2 * (n / kM));
}

// Stage-1 input policies of Bts2Wide (see the header): the tile's element
// type T, the complex value of element a of a column (operator()), and the
// factor of Y[q][b] (post). kReal: the value is real (imaginary part 0).
struct CplxIn {
  using T = float2;
  static constexpr bool kReal = false;
  __device__ float2 operator()(float2 v, int) const { return v; }
  __device__ float2 post(float2 y, int) const { return y; }
};

struct RealIn {
  using T = float;
  static constexpr bool kReal = true;
  __device__ float2 operator()(float v, int) const { return make_float2(v, 0.f); }
  __device__ float2 post(float2 y, int) const { return y; }
};

// w[a * 128 + b] = wa[a] * wb[b]: wa in shared memory, wb in device memory.
struct ChirpIn {
  using T = float;
  static constexpr bool kReal = false;
  const float2* wa;
  const float2* __restrict__ wb;
  __device__ float2 operator()(float v, int a) const {
    const float2 w = wa[a];
    return make_float2(v * w.x, v * w.y);
  }
  __device__ float2 post(float2 y, int b) const { return cmul(y, __ldg(wb + b)); }
};

// The planes of unit u (q2 < 0: a unit of one plane), and whether the unit
// is a mirror pair {j, F - j}.
__device__ __forceinline__ void wide_unit(int F, int u, int& q1, int& q2, bool& mirror) {
  if (F % 2 == 0) {
    q1 = u;
    q2 = u == 0 ? F / 2 : F - u;
    mirror = u != 0;
  } else if (u < (F - 1) / 2) {
    q1 = u + 1;
    q2 = F - u - 1;
    mirror = true;
  } else {
    q1 = 0;
    q2 = -1;
    mirror = false;
  }
}

// Load W_F^k, k < F, into shared memory: row 1 of the (F, F) table wf
// (its only entry (0, 0) for F = 1). All threads; no barrier.
__device__ __forceinline__ void wide_load_row(float2* wt, const float2* __restrict__ wf, int F) {
  for (int k = threadIdx.x; k < F; k += blockDim.x) wt[k] = __ldg(wf + (F > 1 ? F : 0) + k);
}

template <int C, bool kRows, class In = CplxIn>
struct Bts2Wide {
  using T = typename In::T;
  int n, F;
  In in;

  __device__ int tpos(int t, int c) const { return kRows ? c * n + t : t * C + c; }
  __device__ static int ypos(int slot, int b, int c) {
    return kRows ? (slot * C + c) * kM + b : (slot * kM + b) * C + c;
  }

  // The length-n transform of the V valid transforms of tile s: output k of
  // transform c goes to out[c * cs + k * ks]. ys: scratch of kWideSlots *
  // kM * C; wt: W_F^k in shared memory (wide_load_row, behind a barrier).
  // All kThreads threads of the block call it; it ends with a barrier.
  __device__ void run(const T* s, float2* ys, const float2* wt,
                      const float2* __restrict__ wq, int V, float2* out, long long cs,
                      long long ks) const {
    run(s, ys, wt, wq, V, [=](int c, long long k, float2 z) { out[c * cs + k * ks] = z; });
  }

  // The same with the store of output k of transform c left to
  // store(c, k, value): the real transforms' and the DCTs' epilogues, which
  // write real rows or a permuted order.
  template <class Store>
  __device__ void run(const T* s, float2* ys, const float2* wt,
                      const float2* __restrict__ wq, int V, Store&& store) const {
    const int units = (F + 1) / 2;
    const int astep = kRows ? kM : kM * C;   // stride of a in the tile
    for (int u0 = 0; u0 < units; u0 += 2) {
      // stage 1: Y of the group's planes, one (unit, b, c) per item
      for (int idx = threadIdx.x; idx < 2 * kM * C; idx += kThreads) {
        const int uu = idx / (kM * C);
        const int b = kRows ? idx % kM : (idx / C) % kM;
        const int c = kRows ? (idx / kM) % C : idx % C;
        const int u = u0 + uu;
        if (u >= units || c >= V) continue;
        int q1, q2;
        bool mirror;
        wide_unit(F, u, q1, q2, mirror);
        const T* xp = s + tpos(b, c);
        if (mirror) {
          float sa = 0.f, sb = 0.f, sc = 0.f, sd = 0.f;
          int k = 0;
#pragma unroll 4
          for (int a = 0; a < F; ++a) {
            const float2 w = wt[k];
            if constexpr (In::kReal) {   // sb = sd = 0
              const float xr = xp[a * astep];
              sa = fmaf(xr, w.x, sa);
              sc = fmaf(xr, w.y, sc);
            } else {
              const float2 xv = in(xp[a * astep], a);
              sa = fmaf(xv.x, w.x, sa);
              sb = fmaf(xv.y, w.y, sb);
              sc = fmaf(xv.x, w.y, sc);
              sd = fmaf(xv.y, w.x, sd);
            }
            k += q1;
            if (k >= F) k -= F;
          }
          ys[ypos(2 * uu, b, c)] = in.post(make_float2(sa - sb, sc + sd), b);
          ys[ypos(2 * uu + 1, b, c)] = in.post(make_float2(sa + sb, sd - sc), b);
        } else {
          float2 y1 = make_float2(0.f, 0.f), y2 = make_float2(0.f, 0.f);
          int k1 = 0, k2 = 0;
          for (int a = 0; a < F; ++a) {
            const float2 xv = in(xp[a * astep], a);
            cmac(y1, xv, wt[k1]);
            k1 += q1;
            if (k1 >= F) k1 -= F;
            if (q2 >= 0) {
              cmac(y2, xv, wt[k2]);
              k2 += q2;
              if (k2 >= F) k2 -= F;
            }
          }
          ys[ypos(2 * uu, b, c)] = in.post(y1, b);
          if (q2 >= 0) ys[ypos(2 * uu + 1, b, c)] = in.post(y2, b);
        }
      }
      __syncthreads();
      // stage 2: one (slot, p') per item, all C columns in registers
      for (int idx = threadIdx.x; idx < kWideSlots * kM; idx += kThreads) {
        const int slot = idx / kM;
        const int p = idx % kM;
        const int u = u0 + slot / 2;
        if (u >= units) continue;
        int q1, q2;
        bool mirror;
        wide_unit(F, u, q1, q2, mirror);
        const int q = slot & 1 ? q2 : q1;
        if (q < 0) continue;
        float2 acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = make_float2(0.f, 0.f);
        const float2* __restrict__ w = wq + (size_t)q * kM * kM + p;
        const float2* y = ys + ypos(slot, 0, 0);
#pragma unroll 4
        for (int b = 0; b < kM; ++b) {
          const float2 wv = __ldg(w + b * kM);
#pragma unroll
          for (int c = 0; c < C; ++c)
            cmac(acc[c], y[kRows ? c * kM + b : b * C + c], wv);
        }
        const long long k = q + (long long)F * p;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (c < V) store(c, k, acc[c]);
      }
      __syncthreads();
    }
  }
};

// Fill the tile s of a wide block (layout as Bts2Wide's, nt elements per
// transform) with fn(t, c) for the V valid transforms; consecutive threads
// take consecutive elements of a row (kRows) or consecutive transforms of a
// column tile, so that the loads from device memory coalesce. No barrier.
template <int C, bool kRows, class T, class Fn>
__device__ __forceinline__ void wide_fill(T* s, int nt, int V, Fn&& fn) {
  for (int idx = threadIdx.x; idx < nt * V; idx += kThreads) {
    const int t = kRows ? idx % nt : idx / V;
    const int c = kRows ? idx / nt : idx % V;
    s[kRows ? c * nt + t : t * C + c] = fn(t, c);
  }
}

// The transforms [first, first + count) of tile `tile` of `tiles`: the
// `total` transforms spread evenly, so that no tile is a short tail.
__device__ __forceinline__ void wide_tile(long long total, long long tiles, long long tile,
                                          long long& first, int& count) {
  first = tile * total / tiles;
  count = (int)((tile + 1) * total / tiles - first);
}

// fn(std::integral_constant<int, C>{}) for a tile of C in {1, 2, 4, 8, 16}
// transforms.
template <class Fn>
cudaError_t wide_dispatch(int C, Fn&& fn) {
  switch (C) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// Launch kernel(args..., tiles) on `groups` times the tiles of `total`
// transforms of length n, C per tile, with `smem` bytes of dynamic shared
// memory. A grid or a tile the card cannot take returns an error.
template <int C, class... KArgs, class... Args>
cudaError_t wide_launch_smem(void (*kernel)(KArgs...), int n, long long smem, long long groups,
                             long long total, cudaStream_t stream, Args... args) {
  const long long tiles = (total + C - 1) / C;
  const long long blocks = groups * tiles;
  if (n % kM || n / kM < 1 || n / kM > kWideMaxF || groups < 1 || total < 1 ||
      blocks > 0x7fffffffLL || smem > kMaxSmemBytes)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(args..., tiles);
  return cudaGetLastError();
}

// wide_launch_smem with the shared memory of wide_smem_bytes (one tile).
template <int C, class... KArgs, class... Args>
cudaError_t wide_launch(void (*kernel)(KArgs...), int n, long long groups, long long total,
                        cudaStream_t stream, Args... args) {
  return wide_launch_smem<C>(kernel, n, wide_smem_bytes(n, C), groups, total, stream, args...);
}

// wide_launch_smem with the shared memory of wide_real_smem_bytes (one real
// tile, WideRealSmem).
template <int C, class... KArgs, class... Args>
cudaError_t wide_launch_real(void (*kernel)(KArgs...), int n, long long groups, long long total,
                             cudaStream_t stream, Args... args) {
  return wide_launch_smem<C>(kernel, n, wide_real_smem_bytes(n, C), groups, total, stream,
                             args...);
}

// The shared memory of a wide block: the tile (n x C), the Y scratch and the
// row W_F^k, in that order.
struct WideSmem {
  float2 *s, *ys, *wt;
  __device__ WideSmem(float2* base, int n, int C)
      : s(base), ys(base + (size_t)n * C), wt(base + (size_t)C * (n + kWideSlots * kM)) {}
};

// The shared memory of a wide block on a real tile (wide_real_smem_bytes):
// the tile (n x C floats), the Y scratch, the row W_F^k and the chirp row
// wa (F values each).
struct WideRealSmem {
  float* s;
  float2 *ys, *wt, *wa;
  __device__ WideRealSmem(float2* base, int n, int C)
      : s(reinterpret_cast<float*>(base)),
        ys(base + (size_t)n * C / 2),
        wt(ys + (size_t)kWideSlots * kM * C),
        wa(wt + n / kM) {}
};

// Load wa[a] = chirp[a], a < F, into shared memory (the chirp row of
// ChirpIn). All threads; no barrier.
__device__ __forceinline__ void wide_load_chirp(float2* wa, const float2* __restrict__ chirp,
                                                int F) {
  for (int a = threadIdx.x; a < F; a += blockDim.x) wa[a] = __ldg(chirp + a);
}

}  // namespace ndfft
