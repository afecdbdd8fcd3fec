// The mixed-radix core: a Stockham autosort FFT in shared memory, for any
// n <= 20480 whose prime factors are at most 127, on a tile of contiguous
// complex64 rows or of columns. Kernel 10 runs it on rows at every
// n = 128 * F and kernel 8 at every n <= 20480 it takes (fft_rows_radix.cu);
// kernels 2 and 15 at their half length on rows with the R2C's unpack as
// the epilogue, and kernel 3 with the C2R's inverse unpack as the prologue
// (rfft_radix.cu); kernel 23's DCT-II as the Makhoul R2C on rows, its
// permutation in the load and its post twiddle in the unpack's store, and
// kernel 24's DCT-III as the Makhoul C2R on rows, its pre twiddle in a
// prologue and the interleave in its store (dct_rows_radix.cu); kernel 11 at every
// convolution length M = 128 * F on an (M, C) column tile, its forward and
// inverse length-M transforms in place, and the real-input chirp-z of
// kernel 20 (fft_blue_radix.cu), kernel 21 and kernel 15's rows
// (rfft_blue_radix.cu) and kernel 12's real-to-real chirp-z of the Makhoul
// DCT-II/III (dct_blue_radix.cu) on the same kernel (blue_radix.cuh) at a
// 7-smooth M; kernels 1, 6
// and 4 (n = 128 * F; n > 512 without a split; n <= 512) on an (n, C)
// column tile with the store in its last stage (fft_mid_radix.cu); kernels
// 16, 18 and 20 (the R2C along a middle axis, kernel 18 of DST-I's two
// streams) on the same column tile, at the half length with the unpack as
// the epilogue or, at an odd length, with an epilogue that stores half the
// bins, and kernels 17 and 21 (the C2R along a middle axis) at the half
// length with the inverse unpack as the prologue or, kernel 21 at an odd
// length, on the column's Hermitian extension (rfft_mid_radix.cu); kernel
// 27's DCT-I, DCT-II and DCT-III, kernel 19's DCT-I and kernels 25 and 26's
// DCT-II and DCT-III as load policies and epilogues of the Makhoul passes
// around the half-length real FFT (dct_mid_radix.cu); kernel 28's
// DCT-IV as the chirped load and the exit chirp's epilogue around one
// length-hl transform, or the two passes of a column four-step
// (dct4_mid_radix.cu); and the two passes of the four-step long C2C,
// kernel 7's columns with the exit twiddle in an epilogue and kernel 13's
// rows with the scale and the transposed store in an epilogue, on a tile
// whose rows lie a pitch apart (fft_fourstep.cu).
//
// Replaces, for the CUDA port, the JAX package's
// ndrustfft_tpu/ops/pallas/fft.py::_kernel_twostep and
// ::_kernel_axis_mid_bts2 (the twostep split m = 128 on rows and along a
// middle axis), rfft.py::_r2c_kernel_nat, ::_r2c_kernel_mid,
// ::_r2c_kernel_packed_mid and ::_r2c_kernel (the R2C's half-length FFT),
// ::_c2r_kernel_nat and ::_c2r_kernel_mid (the C2R's),
// fft.py::_kernel_lane_last (its dense lane DFT at n <= 256 and its generic
// lane schedule above), ::_kernel_axis_mid (the generic
// schedule along a middle axis), ::_kernel_axis_mid_dense (the dense DFT-n
// along a middle axis at n <= 512) and ::_kernel_axis_mid_blue (the
// chirp-z's length-M transforms). The TPU kernels run dense DFT stages, cheap
// on a 128 x 128 MXU; their first Hopper forms (bts2_core.cuh and
// bts2_wide.cuh: a dense DFT-F then a dense DFT-128; a dense DFT-n product
// at n <= 512; two dense products DFT-m and DFT-f above) did 8 (128 + F),
// 8 n or 8 (m + f) FP32 operations per output, tens of times an FFT's
// 5 log2 n (51x at n = 256, 35x at n = 600), and read their folded twiddles
// or DFT matrices from L2.
//
// What bounds it on this card: device memory. A row is read once and
// written once, 16 n T bytes over 3.35 TB/s (0.080 ms at (4096, 4096)),
// against about 5 n log2 n FP32 operations per row (0.015 ms of the
// 67 TFLOP/s peak at that shape); the passes through shared memory, one
// read and one write per element and stage, come next.
//
// The design. The host factors n (ops/hopper/fft.py::radix_plan) into at
// most 8 stages: 16 while it divides the power of two, one 8, 4 or 2 for the
// rest, a 9 for each pair of 3s, a 3, each 5 and 7, then each prime
// 11 <= p <= 127 as a stage of its own. A block copies R contiguous rows into
// shared memory with 16-byte loads (one float2 of padding after every 32, so
// that the strided writes of the early stages fall in different banks).
// The stage of radix r after stages whose radices multiply to L reads, for
// butterfly i = q L + k of a row, x[i + j n / r] (j < r), multiplies by
// W_{rL}^{j k} from the host's table (__ldg; no sincosf on the device), runs
// the DFT-r in registers and writes y[q r L + m L + k] (Stockham: natural
// order after the last stage, no final transpose). A thread holds all of its
// butterflies (16 elements; 32 above n = 4096, 40 above 16384) in registers across the
// stage's barrier, so the stage runs in place and the tile is 8 n R bytes.
// The last stage multiplies by the scale and hands each output to the store
// at k = i + m n / r: consecutive threads on consecutive bins, coalesced.
// Codelets: 2, 4, 8, 16 by radix-2 splits with the W_16 constants folded at
// compile time; 3, 5, 7, 9 by the conjugate-pair form below with constants;
// a prime p >= 11 by the same form at run time, its coefficient row W_p^u
// (u < p) in shared memory and the stage in two passes: the pairs
// a_j = x_j + x_{p-j} and b_j = x_j - x_{p-j} in place, then each output pair
//   X[m]     = x_0 + sum_j a_j Re W_p^{jm} + i sum_j b_j Im W_p^{jm},
//   X[p - m] = x_0 + sum_j a_j Re W_p^{jm} - i sum_j b_j Im W_p^{jm},
// 2 p FMAs per output where a dense DFT-p costs 4 p; only that stage pays
// O(p). The plan puts the primes last, where the output pass writes device
// memory and holds nothing.
//
// Two layouts share the stages: a row layout (transform c of a tile of rows,
// element q at rx_slot(c n + q), the threads of a row consecutive) and a
// column layout (column c of an (n, C) tile, element q at cx_slot(q C + c),
// the C columns of one butterfly on consecutive threads, so that a warp
// reads and writes runs of consecutive slots; one float2 of padding after
// every 16 elements keeps the first stages' strided writes off one bank).
// Two outputs: the last stage stores to device memory through the Io
// struct's store(), or, for an Io with kTileOut, writes its outputs back
// into the tile in natural order through out(k, v) (kernel 11's product
// with H, kernel 15's plain copy) for an epilogue or a second transform.
// Two skeletons run the stages: radix_rows_kernel on rows, radix_cols_kernel
// on an (n, C) column tile of a (B, rows, L) tensor, each column read
// through a load policy (a complex column, the R2C's real column as
// pairs of rows or with a zero imaginary part, or the C2R's spectrum). A
// load policy with side slots (kSide) also parks each transform's bin h in
// a slot of its own after the coefficient rows and, after the load's
// barrier, runs its prologue on the tile in place (the C2R's inverse
// unpack, c2r_prologue_tile) behind a second barrier.
//
// Left for later: cp.async or TMA prefetch of the next tile, and twiddles
// staged in shared memory.
#pragma once

#include <cstdint>
#include <type_traits>

#include "bts2_core.cuh"

namespace ndfft {

constexpr int kRadixMaxStages = 8;  // stages of a plan
constexpr int kRadixMaxP = 127;     // the largest prime stage
constexpr int kRadixWideN = 4096;   // above it, a thread holds 32 or 40 elements
constexpr int kRadixMaxCols = 256;  // columns of a column tile: one thread each at n <= 16

struct RadixPlan {
  int count;
  int r[kRadixMaxStages];
};

// Elements a thread holds at n, and the block's launch bounds for it: 16
// elements and 256 threads up to n = 4096 (a row of 4096 or a few shorter
// rows a block), three blocks an SM (80 registers a thread); above it one
// row a block, 32 elements to n = 16384 and 40 to 20480, at most 512
// threads (128 registers). A 1024-thread bound left ptxas 32 registers and
// spilled the butterflies; 640 threads left 96 and spilled more than 512.
__host__ __device__ constexpr int radix_per_thread(int n) {
  return n > 16384 ? 40 : n > kRadixWideN ? 32 : 16;
}
template <int kE>
constexpr int kRadixMaxThreads = kE == 16 ? 256 : 512;
template <int kE>
constexpr int kRadixMinBlocks = kE == 16 ? 3 : 1;

// The shared-memory slot of tile element q: one float2 of padding after
// every 32 elements (rows) or every 16 (columns).
__host__ __device__ __forceinline__ int rx_slot(int q) { return q + (q >> 5); }
__host__ __device__ constexpr int rx_tile_slots(int elems) { return elems + (elems >> 5) + 1; }
__host__ __device__ __forceinline__ int cx_slot(int q) { return q + (q >> 4); }
__host__ __device__ constexpr int cx_tile_slots(int elems) { return elems + (elems >> 4) + 1; }

// Whether an Io struct takes the last stage's outputs into the tile
// (static constexpr bool kTileOut = true; out(k, v) gives the value kept at
// natural index k) instead of storing them (store(row, k, v)).
template <class Io, class = void>
struct RxTileOut : std::false_type {};
template <class Io>
struct RxTileOut<Io, std::void_t<decltype(Io::kTileOut)>> : std::bool_constant<Io::kTileOut> {};

// The side slots a load policy parks per transform (static constexpr int
// kSide; 0 where it names none), which also says that it has a prologue
// (prologue(s, side, cx) on the loaded tile, side the transform's slots).
template <class Load, class = void>
struct RxSide : std::integral_constant<int, 0> {};
template <class Load>
struct RxSide<Load, std::void_t<decltype(Load::kSide)>>
    : std::integral_constant<int, Load::kSide> {};

// Whether a load policy has a prologue: one with side slots does, and one
// without them says so by static constexpr bool kPrologue = true (the
// column skeleton runs prologue(s, side, cx) behind the load's barrier).
template <class Load, class = void>
struct RxPrologue : std::bool_constant<(RxSide<Load>::value > 0)> {};
template <class Load>
struct RxPrologue<Load, std::void_t<decltype(Load::kPrologue)>>
    : std::bool_constant<Load::kPrologue> {};

// Whether a row load policy lays the tile's rows `pitch` elements apart
// (static constexpr bool kPitched = true and an int member pitch, a
// multiple of 32 no less than n) instead of n apart; rx_pitch gives the
// distance.
template <class Load, class = void>
struct RxPitched : std::false_type {};
template <class Load>
struct RxPitched<Load, std::void_t<decltype(Load::kPitched)>>
    : std::bool_constant<Load::kPitched> {};
template <class Load>
__host__ __device__ __forceinline__ int rx_pitch(const Load& ld, int n) {
  if constexpr (RxPitched<Load>::value) {
    return ld.pitch;
  } else {
    return n;
  }
}

// A stage of radix r is a prime stage (not a codelet) for odd r >= 11.
__host__ __device__ constexpr bool rx_prime(int r) { return r >= 11 && (r & 1); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// cos(2 pi k / 16) and sin(2 pi k / 16), rounded once
__host__ __device__ constexpr float rx_cos16(int k) {
  switch (k & 15) {
    case 0: return 1.f;
    case 1: case 15: return 0.92387953251128674f;
    case 2: case 14: return 0.70710678118654757f;
    case 3: case 13: return 0.38268343236508978f;
    case 4: case 12: return 0.f;
    case 5: case 11: return -0.38268343236508978f;
    case 6: case 10: return -0.70710678118654757f;
    case 7: case 9: return -0.92387953251128674f;
    default: return -1.f;
  }
}
__host__ __device__ constexpr float rx_sin16(int k) { return rx_cos16(k + 12); }

// a * W_16^K with W_16 = exp(kS 2 pi i / 16): the quarter turns as swaps
template <int kS, int K>
__device__ __forceinline__ float2 w16mul(float2 a) {
  constexpr int k = K & 15;
  if constexpr (k == 0) {
    return a;
  } else if constexpr (k == 4) {
    return kS > 0 ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  } else if constexpr (k == 8) {
    return make_float2(-a.x, -a.y);
  } else if constexpr (k == 12) {
    return kS > 0 ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
  } else {
    constexpr float c = rx_cos16(k), s = kS * rx_sin16(k);
    return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
  }
}

// The DFT-R of v in place, R a power of two <= 16: the DFTs of the even and
// odd elements, combined with W_R^k.
template <int R, int kS>
struct Pow2Dft {
  template <int K = 0>
  __device__ __forceinline__ static void combine(float2 (&v)[R], const float2 (&e)[R / 2],
                                                 const float2 (&o)[R / 2]) {
    if constexpr (K < R / 2) {
      const float2 t = w16mul<kS, K * (16 / R)>(o[K]);
      v[K] = cadd(e[K], t);
      v[K + R / 2] = csub(e[K], t);
      combine<K + 1>(v, e, o);
    }
  }
  __device__ __forceinline__ static void run(float2 (&v)[R]) {
    float2 e[R / 2], o[R / 2];
#pragma unroll
    for (int j = 0; j < R / 2; ++j) {
      e[j] = v[2 * j];
      o[j] = v[2 * j + 1];
    }
    Pow2Dft<R / 2, kS>::run(e);
    Pow2Dft<R / 2, kS>::run(o);
    combine(v, e, o);
  }
};

template <int kS>
struct Pow2Dft<1, kS> {
  __device__ __forceinline__ static void run(float2 (&)[1]) {}
};

// cos and sin of 2 pi u / P for P in {3, 5, 7, 9}, 0 <= u <= (P - 1) / 2,
// rounded once (u = 0 arises at P = 9, from j m = 9)
__host__ __device__ constexpr float rx_cos_odd(int p, int u) {
  return u == 0   ? 1.f
         : p == 3 ? -0.5f
         : p == 5 ? (u == 1 ? 0.30901699437494745f : -0.80901699437494734f)
         : p == 7 ? (u == 1 ? 0.62348980185873359f
                     : u == 2 ? -0.22252093395631434f
                              : -0.90096886790241903f)
                  : (u == 1 ? 0.76604444311897801f
                     : u == 2 ? 0.17364817766693041f
                     : u == 3 ? -0.5f
                              : -0.93969262078590832f);
}
__host__ __device__ constexpr float rx_sin_odd(int p, int u) {
  return u == 0   ? 0.f
         : p == 3 ? 0.86602540378443871f
         : p == 5 ? (u == 1 ? 0.95105651629515353f : 0.58778525229247325f)
         : p == 7 ? (u == 1 ? 0.78183148246802981f
                     : u == 2 ? 0.97492791218182362f
                              : 0.43388373911755823f)
                  : (u == 1 ? 0.64278760968653925f
                     : u == 2 ? 0.98480775301220802f
                     : u == 3 ? 0.86602540378443871f
                              : 0.34202014332566888f);
}

// The DFT-P of v in place, P in {3, 5, 7, 9}, in the conjugate-pair form
// (the head note), its constants folded at compile time.
template <int P, int kS>
__device__ __forceinline__ void odd_dft(float2 (&v)[P]) {
  constexpr int H = (P - 1) / 2;
  float2 a[H], b[H];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    a[j - 1] = cadd(v[j], v[P - j]);
    b[j - 1] = csub(v[j], v[P - j]);
  }
  const float2 x0 = v[0];
  float2 sum = x0;
#pragma unroll
  for (int j = 0; j < H; ++j) sum = cadd(sum, a[j]);
  v[0] = sum;
#pragma unroll
  for (int m = 1; m <= H; ++m) {
    float2 A = x0, B = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int u = (j * m) % P;
      const float c = rx_cos_odd(P, u <= H ? u : P - u);
      const float s = kS * (u <= H ? rx_sin_odd(P, u) : -rx_sin_odd(P, P - u));
      A.x = fmaf(a[j - 1].x, c, A.x);
      A.y = fmaf(a[j - 1].y, c, A.y);
      B.x = fmaf(b[j - 1].x, s, B.x);
      B.y = fmaf(b[j - 1].y, s, B.y);
    }
    v[m] = make_float2(A.x - B.y, A.y + B.x);
    v[P - m] = make_float2(A.x + B.y, A.y - B.x);
  }
}

template <int R, int kS>
__device__ __forceinline__ void codelet(float2 (&v)[R]) {
  if constexpr ((R & (R - 1)) == 0) {
    Pow2Dft<R, kS>::run(v);
  } else {
    odd_dft<R, kS>(v);
  }
}

// The two tile layouts: element q of a thread's transform is tile element
// at(q), d elements further on lies step(d) tile elements further on, and
// tile element e sits in shared-memory slot pad(e).
struct RowLayout {
  int base;        // tile element of the row's first element (c n)
  __device__ __forceinline__ int at(int q) const { return base + q; }
  __device__ __forceinline__ static int step(int d) { return d; }
  __device__ __forceinline__ static int pad(int e) { return rx_slot(e); }
};
struct ColLayout {
  int c, C;        // the column and the tile's column count
  __device__ __forceinline__ int at(int q) const { return q * C + c; }
  __device__ __forceinline__ int step(int d) const { return d * C; }
  __device__ __forceinline__ static int pad(int e) { return cx_slot(e); }
};

// Where a thread works: its transform in the tile and its place in it.
template <class Lay>
struct RadixCtx {
  using Layout = Lay;
  int n;           // transform length
  int tr;          // threads per transform
  int t;           // this thread's index in its transform
  Lay lay;         // the transform's place in the tile
  bool active;     // the transform is one of the tile's valid ones
  long long row;   // the transform's handle for Io::store (row index, column offset)
  __device__ __forceinline__ int slot(int q) const { return Lay::pad(lay.at(q)); }
};

// One stage of a codelet radix R after stages whose radices multiply to L.
// The thread takes butterflies i = t + u * tr = q L + k (u < ceil(kE / R),
// i < n / R; k and q carried from t's without a division per butterfly),
// holds them across the barrier and writes them in place; the last stage
// stores to device memory (or, kTileOut, writes io.out(k, v) in place: at
// the last stage q = 0 and k = i, so i + m n / R is the natural index).
template <int R, int kE, int kS, class Io, class Cx>
__device__ __forceinline__ void radix_stage(float2* s, const float2* __restrict__ tw,
                                            const Cx& cx, int L, bool last, const Io& io,
                                            float scale) {
  constexpr bool kTile = RxTileOut<Io>::value;
  constexpr int kB = (kE + R - 1) / R;
  const int nb = cx.n / R;
  const int q0 = cx.t / L, k0 = cx.t - q0 * L;
  const int dq = cx.tr / L, dk = cx.tr - dq * L;   // the step of i, as (q, k)
  const float2* __restrict__ w = tw + (L - 1);
  float2 v[kB][R];
  int o[kB];
  int q = q0, k = k0;
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int i = cx.t + u * cx.tr;
    o[u] = cx.lay.at(q * L * R + k);
    if (cx.active && i < nb) {
#pragma unroll
      for (int j = 0; j < R; ++j) v[u][j] = s[cx.slot(i + j * nb)];
      if (L > 1) {
#pragma unroll
        for (int j = 1; j < R; ++j) v[u][j] = cmul(v[u][j], __ldg(w + (j - 1) * L + k));
      }
      codelet<R, kS>(v[u]);
    }
    q += dq;
    k += dk;
    if (k >= L) {
      k -= L;
      ++q;
    }
  }
  if constexpr (!kTile) {
    if (last) {
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        const int i = cx.t + u * cx.tr;
        if (cx.active && i < nb) {
#pragma unroll
          for (int m = 0; m < R; ++m)
            io.store(cx.row, i + m * nb, make_float2(scale * v[u][m].x, scale * v[u][m].y));
        }
      }
      return;
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int i = cx.t + u * cx.tr;
    if (cx.active && i < nb) {
#pragma unroll
      for (int m = 0; m < R; ++m) {
        float2 w = v[u][m];
        if constexpr (kTile) {
          if (last) w = io.out(i + m * nb, w);
        }
        s[Cx::Layout::pad(o[u] + cx.lay.step(m * L))] = w;
      }
    }
  }
  __syncthreads();
}

// `count` stages of radix R in a row, from stage `st` of a plan of `stages`.
template <int R, int kE, int kS, class Io, class Cx>
__device__ __forceinline__ void radix_stages(int count, float2* s, const float2* __restrict__ tw,
                                             const Cx& cx, int& L, int& st, int stages,
                                             const Io& io, float scale) {
  for (int c = 0; c < count; ++c) {
    radix_stage<R, kE, kS>(s, tw, cx, L, ++st == stages, io, scale);
    L *= R;
  }
}

// Output pair (m, p - m) of butterfly i of a prime stage whose pairs a_j, b_j
// sit in place; cs is the coefficient row W_p^u.
template <class Cx>
__device__ __forceinline__ void prime_pair(const float2* s, const float2* cs, int p, int nb,
                                           const Cx& cx, int i, int m, float2& xm, float2& xpm) {
  const int h = (p - 1) / 2;
  float2 A = s[cx.slot(i)], B = make_float2(0.f, 0.f);
  int u = 0;
  for (int j = 1; j <= h; ++j) {
    u += m;
    if (u >= p) u -= p;
    const float2 w = cs[u];
    const float2 a = s[cx.slot(i + j * nb)];
    const float2 b = s[cx.slot(i + (p - j) * nb)];
    A.x = fmaf(a.x, w.x, A.x);
    A.y = fmaf(a.y, w.x, A.y);
    B.x = fmaf(b.x, w.y, B.x);
    B.y = fmaf(b.y, w.y, B.y);
  }
  xm = make_float2(A.x - B.y, A.y + B.x);
  xpm = make_float2(A.x + B.y, A.y - B.x);
}

// One stage of an odd prime 11 <= p <= 127: the twiddled pairs in place,
// then the outputs, m = 0 ... (p - 1) / 2 with X[p - m] beside X[m]; a
// stage before the last, or the last with kTileOut, holds its items (at most
// ceil(6 kE / 11) a thread) across the barrier.
template <int kE, class Io, class Cx>
__device__ __forceinline__ void prime_stage(float2* s, const float2* __restrict__ tw,
                                            const float2* cs, int p, const Cx& cx, int L,
                                            bool last, const Io& io, float scale) {
  constexpr bool kTile = RxTileOut<Io>::value;
  const int h = (p - 1) / 2;
  const int nb = cx.n / p;
  if (cx.active) {
    for (int it = cx.t; it < nb * h; it += cx.tr) {
      const int j = 1 + it / nb;
      const int i = it - (j - 1) * nb;
      const int qa = cx.slot(i + j * nb);
      const int qb = cx.slot(i + (p - j) * nb);
      float2 xa = s[qa], xb = s[qb];
      if (L > 1) {
        const float2* __restrict__ w = tw + (L - 1) + i % L;
        xa = cmul(xa, __ldg(w + (j - 1) * L));
        xb = cmul(xb, __ldg(w + (p - j - 1) * L));
      }
      s[qa] = cadd(xa, xb);
      s[qb] = csub(xa, xb);
    }
  }
  __syncthreads();
  const int items = nb * (h + 1);
  if constexpr (!kTile) {
    if (last) {
      if (cx.active) {
        for (int it = cx.t; it < items; it += cx.tr) {
          const int m = it / nb, i = it - m * nb;
          float2 xm, xpm;
          prime_pair(s, cs, p, nb, cx, i, m, xm, xpm);
          io.store(cx.row, i + m * nb, make_float2(scale * xm.x, scale * xm.y));
          if (m) io.store(cx.row, i + (p - m) * nb, make_float2(scale * xpm.x, scale * xpm.y));
        }
      }
      return;
    }
  }
  constexpr int kP = (6 * kE + 10) / 11;
  float2 hold[kP][2];
#pragma unroll
  for (int u = 0; u < kP; ++u) {
    const int it = cx.t + u * cx.tr;
    if (cx.active && it < items) {
      const int m = it / nb, i = it - m * nb;
      prime_pair(s, cs, p, nb, cx, i, m, hold[u][0], hold[u][1]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kP; ++u) {
    const int it = cx.t + u * cx.tr;
    if (cx.active && it < items) {
      const int m = it / nb, i = it - m * nb;
      const int k = i % L;
      const int o = cx.lay.at((i - k) * p + k);   // the last stage: (i - k) p + k = i
      float2 xm = hold[u][0], xpm = hold[u][1];
      if constexpr (kTile) {
        if (last) {
          xm = io.out(i + m * L, xm);
          if (m) xpm = io.out(i + (p - m) * L, xpm);
        }
      }
      s[Cx::Layout::pad(o + cx.lay.step(m * L))] = xm;
      if (m) s[Cx::Layout::pad(o + cx.lay.step((p - m) * L))] = xpm;
    }
  }
  __syncthreads();
}

// The order in which a plan's radices run (ops/hopper/fft.py::radix_plan):
// 16, 8, 4, 2, 9, 3, 5, 7, then the primes ascending.
__host__ __device__ constexpr int rx_rank(int r) {
  return r == 16 ? 0 : r == 8 ? 1 : r == 4 ? 2 : r == 2 ? 3 : r == 9 ? 4 : r == 3 ? 5
       : r == 5 ? 6 : r == 7 ? 7 : 8 + r;
}

// A plan's stage counts by radix (16, 8, 4, 2, 9, 3, 5, 7) into count, and
// each prime stage's coefficient row W_p^u (u < p) from the table (it
// follows the n entries of stage twiddles) into cs, in the plan's order.
// The caller's barrier publishes the rows.
__device__ __forceinline__ void radix_prepare(int (&count)[8], float2* cs,
                                              const float2* __restrict__ tab,
                                              const RadixPlan& plan, int n) {
#pragma unroll
  for (int j = 0; j < 8; ++j) count[j] = 0;
  for (int st = 0, off = n, pos = 0; st < plan.count; ++st) {
    const int p = plan.r[st];
    if (rx_prime(p)) {
      for (int u = threadIdx.x; u < p; u += blockDim.x) cs[pos + u] = tab[off + u];
      off += p;
      pos += p;
    } else {
      const int rank = rx_rank(p);
#pragma unroll
      for (int j = 0; j < 8; ++j) count[j] += rank == j;
    }
  }
}

// The prime stages' coefficient values of a plan (the cs rows).
__host__ __device__ inline int rx_coef_count(const RadixPlan& plan) {
  int c = 0;
  for (int st = 0; st < plan.count; ++st)
    if (rx_prime(plan.r[st])) c += plan.r[st];
  return c;
}

// A whole transform of every valid transform of the tile, in place: the
// stages radix by radix in the plan's order, each radix's stages in a loop
// of their own (no run-time switch over the radix), with the table tab and
// the counts and coefficient rows of radix_prepare. The last stage stores
// through io (times scale) or, kTileOut, leaves io.out(k, X[k]) in the tile
// behind a barrier.
template <int kE, int kS, class Io, class Cx>
__device__ __forceinline__ void radix_run(float2* s, const float2* __restrict__ tab,
                                          const float2* cs, const int (&count)[8],
                                          const RadixPlan& plan, const Cx& cx, const Io& io,
                                          float scale) {
  int L = 1, st = 0;
  const int stages = plan.count;
  radix_stages<16, kE, kS>(count[0], s, tab, cx, L, st, stages, io, scale);
  radix_stages<8, kE, kS>(count[1], s, tab, cx, L, st, stages, io, scale);
  radix_stages<4, kE, kS>(count[2], s, tab, cx, L, st, stages, io, scale);
  radix_stages<2, kE, kS>(count[3], s, tab, cx, L, st, stages, io, scale);
  radix_stages<9, kE, kS>(count[4], s, tab, cx, L, st, stages, io, scale);
  radix_stages<3, kE, kS>(count[5], s, tab, cx, L, st, stages, io, scale);
  radix_stages<5, kE, kS>(count[6], s, tab, cx, L, st, stages, io, scale);
  radix_stages<7, kE, kS>(count[7], s, tab, cx, L, st, stages, io, scale);
  for (const float2* pc = cs; st < stages; pc += plan.r[st - 1]) {
    const int p = plan.r[st];
    prime_stage<kE>(s, tab, pc, p, cx, L, ++st == stages, io, scale);
    L *= p;
  }
}

// The R2C's unpack from a tile whose transforms hold their half-length
// spectra Z in natural order (an Io with kTileOut, after radix_run's last
// barrier): a transform's threads hand its h + 1 bins to out(k, X[k]),
//   X[k] = (Z[k] + C[k]) / 2 - i W_n^k (Z[k] - C[k]) / 2,  k < h,
//   X[h] = Re Z[0] - Im Z[0],  C[k] = conj Z[(h - k) mod h],  u[k] = W_n^k.
template <class Cx, class Out>
__device__ __forceinline__ void r2c_unpack_tile(const float2* s, const Cx& cx,
                                                const float2* __restrict__ u, const Out& out) {
  if (!cx.active) return;
  const int h = cx.n;
  for (int k = cx.t; k <= h; k += cx.tr) {
    const float2 za = s[cx.slot(k < h ? k : 0)];
    if (k < h) {
      out(k, r2c_unpack_one(za, s[cx.slot(k ? h - k : 0)], __ldg(u + k)));
    } else {
      out(h, make_float2(za.x - za.y, 0.f));
    }
  }
}

// The C2R's inverse unpack in place (kernels 3 and 17), the prologue of the
// half-length inverse: a transform's tile holds S[k] for k < h = cx.n and
// its side slot nyq holds S[h]; each thread takes mirror pairs {k, h - k},
// k <= h / 2, and reads both bins before it writes either:
//   G[k] = A[k] S[k] + B[k] conj S[h - k],  ab[k] = (A.re, A.im, B.re, B.im),
// with the DC and Nyquist imaginary parts ignored (k = 0 pairs with nyq;
// k = h / 2 stands alone). Call it behind the load's barrier. Row k keeps
// post(k, G[k]) (G itself by default; kernel 21's chirp-z keeps
// conj(G[k]) times its entry chirp), h being cx.n or, given, `half`.
struct C2rKeep {
  __device__ __forceinline__ float2 operator()(int, float2 g) const { return g; }
};
template <class Cx, class Post = C2rKeep>
__device__ __forceinline__ void c2r_prologue_tile(float2* s, const float2* nyq, const Cx& cx,
                                                  const float4* __restrict__ ab,
                                                  const Post& post = Post{}, int half = 0) {
  if (!cx.active) return;
  const int h = half ? half : cx.n;
  for (int k = cx.t; k <= h / 2; k += cx.tr) {
    const int qa = cx.slot(k);
    float2 a = s[qa];
    if (k == 0) {
      const float2 b = make_float2(nyq->x, 0.f);
      a.y = 0.f;
      s[qa] = post(0, c2r_combine(__ldg(ab), a, b));
    } else {
      const int qb = cx.slot(h - k);
      const float2 b = s[qb];
      s[qa] = post(k, c2r_combine(__ldg(ab + k), a, b));
      if (2 * k != h) s[qb] = post(h - k, c2r_combine(__ldg(ab + h - k), b, a));
    }
  }
}

// A contiguous run of `total` complex64 values from src, 16-byte loads from
// the first 16-byte boundary on, four in flight a thread; put(e, v) takes
// element e (thread 0 also takes a head element before the boundary and an
// odd tail element).
template <class Put>
__device__ __forceinline__ void load_run16(const float2* __restrict__ src, int total,
                                           const Put& put) {
  constexpr int kLoads = 4;
  const int head = (reinterpret_cast<uintptr_t>(src) & 15) ? 1 : 0;
  const int pairs = (total - head) >> 1;
  const float4* src4 = reinterpret_cast<const float4*>(src + head);
  for (int q0 = threadIdx.x; q0 < pairs; q0 += kLoads * blockDim.x) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < pairs) v[u] = __ldcs(src4 + q);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < pairs) {
        const int e = head + 2 * q;
        put(e, make_float2(v[u].x, v[u].y));
        put(e + 1, make_float2(v[u].z, v[u].w));
      }
    }
  }
  if (threadIdx.x == 0) {
    if (head && total > 0) put(0, src[0]);
    if ((total - head) & 1) put(total - 1, src[total - 1]);
  }
}

// The row skeleton's load policies. load(s, side, row0, valid, n) fills
// the tile's `valid` rows (row c's element k at rx_slot(c n + k)) from rows
// row0 ... of the input; a policy with side slots parks each row's extra
// bin at side[c] and has a prologue.

// Complex64 (T, n) rows, contiguous (kernels 10, 8, 2 and 15): the tile's
// valid * n elements as one run.
struct RowLoad {
  const float2* __restrict__ x;
  __device__ __forceinline__ void load(float2* s, float2*, long long row0, int valid,
                                       int n) const {
    load_run16(x + row0 * n, valid * n, [=](int e, float2 v) { s[rx_slot(e)] = v; });
  }
};

// Kernel 3's rows: the (T, h + 1) complex64 half spectrum, contiguous, and
// the inverse unpack's ab rows. The tile's valid (h + 1)-bin rows are one
// run (a row of an odd h + 1 bins starts off a 16-byte boundary every
// other row); element e of the run is bin k = e - r (h + 1) of row
// r = e / (h + 1), the quotient a multiply-high by floor(2^32 / (h + 1)) + 1
// (exact while e (h + 1) < 2^32: a tile holds at most 20480 elements, so
// here e (h + 1) < 2^29), and bin h goes to the row's side slot.
struct C2rRowLoad {
  static constexpr int kSide = 1;
  const float2* __restrict__ x;
  const float4* __restrict__ ab;
  __device__ __forceinline__ void load(float2* s, float2* side, long long row0, int valid,
                                       int n) const {
    const int w = n + 1;
    const unsigned magic = 0xffffffffu / (unsigned)w + 1u;
    load_run16(x + row0 * w, valid * w, [=](int e, float2 v) {
      const int r = (int)__umulhi((unsigned)e, magic), k = e - r * w;
      if (k < n) {
        s[rx_slot(r * n + k)] = v;
      } else {
        side[r] = v;
      }
    });
  }
  template <class Cx>
  __device__ __forceinline__ void prologue(float2* s, const float2* side, const Cx& cx) const {
    c2r_prologue_tile(s, side, cx, ab);
  }
};

// One block per tile of at most `rows` rows of (T, n), the T rows spread
// evenly over the `tiles` blocks; tr = ceil(n / kE) threads per row. The
// table: the stage twiddles at 0 ... n - 2, then each prime stage's
// coefficient row (ops/hopper/fft.py::radix_consts). The load policy fills
// the tile (RowLoad: complex rows), row c at tile element c n or, for a
// pitched policy, c pitch; the tile's rows past the valid ones
// are neither loaded nor stored. A load policy with side slots gets them
// after the coefficient rows and runs its prologue(s, side, cx) on the
// loaded tile. An Io with kTileOut gets the tile of spectra, in natural
// order, in its epilogue(s, cx).
template <int kE, int kS, class Load, class Io>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
radix_rows_kernel(Load ld, Io io, const float2* __restrict__ tab, RadixPlan plan, int n,
                  long long T, long long tiles, int rows, float scale) {
  extern __shared__ float2 smem[];
  const long long row0 = blockIdx.x * T / tiles;
  const int valid = (int)((blockIdx.x + 1) * T / tiles - row0);
  const int tr = (n + kE - 1) / kE;
  const int c = (int)threadIdx.x / tr;
  const int pitch = rx_pitch(ld, n);
  const RadixCtx<RowLayout> cx{n, tr, (int)threadIdx.x - c * tr, RowLayout{c * pitch},
                               c < valid, row0 + c};
  float2* s = smem;
  float2* cs = smem + rx_tile_slots(rows * pitch);
  float2* side = cs + rx_coef_count(plan);
  int count[8];
  radix_prepare(count, cs, tab, plan, n);
  ld.load(s, side, row0, valid, n);
  __syncthreads();
  if constexpr (RxSide<Load>::value > 0) {
    ld.prologue(s, side + c * RxSide<Load>::value, cx);
    __syncthreads();
  }
  radix_run<kE, kS>(s, tab, cs, count, plan, cx, io, scale);
  if constexpr (RxTileOut<Io>::value) io.epilogue(s, cx);
}

// Dynamic shared memory of a block: the padded tile of `rows` rows `pitch`
// elements apart, the prime stages' coefficient rows and `side` slots a
// row.
inline long long radix_smem_bytes(const RadixPlan& plan, int pitch, int rows, int side = 0) {
  return (long long)(rx_tile_slots(rows * pitch) + rx_coef_count(plan) + side * rows) *
         sizeof(float2);
}

template <int kE, int kS, class Load, class Io>
cudaError_t radix_launch_es(Load ld, Io io, const float2* tab, const RadixPlan& plan,
                            long long T, int n, int rows, float scale, cudaStream_t stream) {
  const int tr = (n + kE - 1) / kE;
  const int threads = (rows * tr + 31) / 32 * 32;
  const long long smem = radix_smem_bytes(plan, rx_pitch(ld, n), rows, RxSide<Load>::value);
  const long long tiles = (T + rows - 1) / rows;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(radix_rows_kernel<kE, kS, Load, Io>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  radix_rows_kernel<kE, kS, Load, Io><<<(unsigned)tiles, threads, (size_t)smem, stream>>>(
      ld, io, tab, plan, n, T, tiles, rows, scale);
  return cudaGetLastError();
}

// The plan of `stages` radices whose product is n, each a codelet radix or
// an odd 11 <= p <= 127, in the kernel's order; false if it is not one.
inline bool radix_plan_of(const int* radices, int stages, int n, RadixPlan& plan) {
  if (stages < 1 || stages > kRadixMaxStages || n < 2 || n > 20480) return false;
  plan.count = stages;
  long long prod = 1;
  for (int st = 0; st < stages; ++st) {
    const int r = radices[st];
    const bool codelet_r = r == 2 || r == 4 || r == 8 || r == 16 || r == 3 || r == 5 ||
                           r == 7 || r == 9;
    if (!codelet_r && (!rx_prime(r) || r > kRadixMaxP)) return false;
    if (st > 0 && rx_rank(r) < rx_rank(plan.r[st - 1])) return false;
    plan.r[st] = r;
    prod *= r;
  }
  return prod == n;
}

// The launcher. ld: the load policy of T rows of length n (RowLoad:
// (T, n) complex64 rows, contiguous); tab: the plan's table (complex64);
// radices: the plan (`stages` radices whose product is n, each a codelet
// radix or an odd 11 <= p <= 127); rows: rows per block, at least one,
// whose tile fits (radix_smem_bytes) and takes at most 256 threads (512
// above n = 4096). Returns the cudaError_t of the launch.
template <class Load, class Io>
cudaError_t radix_rows_launch(Load ld, Io io, const float2* tab, const int* radices,
                              int stages, long long T, int n, int rows, int sign, float scale,
                              cudaStream_t stream) {
  RadixPlan plan{};
  if (T < 1 || rows < 1 || !radix_plan_of(radices, stages, n, plan))
    return cudaErrorInvalidValue;
  const int e = radix_per_thread(n);
  if (sign < 0)
    return e == 40 ? radix_launch_es<40, -1>(ld, io, tab, plan, T, n, rows, scale, stream)
         : e == 32 ? radix_launch_es<32, -1>(ld, io, tab, plan, T, n, rows, scale, stream)
                   : radix_launch_es<16, -1>(ld, io, tab, plan, T, n, rows, scale, stream);
  return e == 40 ? radix_launch_es<40, 1>(ld, io, tab, plan, T, n, rows, scale, stream)
       : e == 32 ? radix_launch_es<32, 1>(ld, io, tab, plan, T, n, rows, scale, stream)
                 : radix_launch_es<16, 1>(ld, io, tab, plan, T, n, rows, scale, stream);
}

// The column skeletons' complex load policy (kernels 1, 6, 4 and 7):
// element r of column col of b at x[(b n + r) L + col], loaded evict-first
// or (kLdg) through the read-only path.
template <bool kLdg>
struct CplxCol {
  const float2* __restrict__ x;
  long long L;
  int n;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * n * L + col;
  }
  __device__ __forceinline__ float2 at(long long p, int r) const {
    return kLdg ? __ldg(x + p + r * L) : __ldcs(x + p + r * L);
  }
};

// The column skeletons' real load policy (kernels 16 and 20 on
// radix_cols_kernel, kernel 20's chirp-z on fft_blue_radix.cu, kernel 22 on
// spectral_r2c_radix.cu): the real columns of (B, rows, L) float32: element
// r of column col of b as the pair (x[2r], x[2r + 1]) of its rows (kPairs:
// the half-length column of an even n) or as (x[r], 0), loaded evict-first
// or (kLdg, kernel 22 at one or two columns a tile) through the read-only
// path.
template <bool kPairs, bool kLdg = false>
struct RealCol {
  const float* __restrict__ x;
  long long L;
  int rows;
  __device__ __forceinline__ long long base(long long b, long long col) const {
    return b * rows * L + col;
  }
  __device__ __forceinline__ static float get(const float* q) {
    return kLdg ? __ldg(q) : __ldcs(q);
  }
  __device__ __forceinline__ float2 at(long long p, int r) const {
    if constexpr (kPairs) {
      const float* q = x + p + 2 * r * L;
      return make_float2(get(q), get(q + L));
    } else {
      return make_float2(get(x + p + r * L), 0.f);
    }
  }
};

// One block per (b, tile of at most C adjacent columns), the L columns
// spread evenly over the `tiles` tiles, each column a transform of length
// n; tr = ceil(n / kE) threads per column, thread c + C t taking column c's
// place t. The load policy gives the columns: ld.base(b, col) is column
// col's handle and ld.at(p, r) its element r, a tile row (C columns) read by
// consecutive threads, four elements in flight a thread; columns past the
// valid ones are zero and neither loaded nor stored (the handle is a
// long long offset, or a struct with operator+(int), as kernel 28's
// Dct4Handle, whose transform index rides beside it). A load policy with
// side slots (kSide = 1) also loads element n of each column into its side
// slot, after the coefficient rows, and runs its prologue(s, side, cx) on
// the loaded tile (as does one with kPrologue and no side slots). The Io
// stores the last stage's outputs at
// io.handle(b, col) (store(handle, k, v)), or, kTileOut, gets the tile of
// spectra in its epilogue(s, cx).
template <int kE, int kS, class Load, class Io>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
radix_cols_kernel(Load ld, Io io, const float2* __restrict__ tab, RadixPlan plan, int n,
                  long long L, long long tiles, int C, float scale) {
  extern __shared__ float2 smem[];
  const long long bb = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long col0 = tile * L / tiles;
  const int valid = (int)((tile + 1) * L / tiles - col0);
  const auto base = ld.base(bb, col0);
  const int tr = (n + kE - 1) / kE;
  const int cshift = 31 - __clz(C);   // C is a power of two: no division per element
  const int t = (int)threadIdx.x >> cshift, c = (int)threadIdx.x & (C - 1);
  const RadixCtx<ColLayout> cx{n, tr, t, ColLayout{c, C}, c < valid && t < tr,
                               io.handle(bb, col0) + c};
  float2* s = smem;
  float2* cs = smem + cx_tile_slots(n * C);
  float2* side = cs + rx_coef_count(plan);
  int count[8];
  radix_prepare(count, cs, tab, plan, n);
  // the tile, element e = (r, cc) at e = r C + cc
  constexpr int kLoads = 4;
  const int elems = n * C;
  for (int e0 = threadIdx.x; e0 < elems; e0 += kLoads * blockDim.x) {
    float2 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x, r = e >> cshift, cc = e & (C - 1);
      v[u] = make_float2(0.f, 0.f);
      if (e < elems && cc < valid) v[u] = ld.at(base + cc, r);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < elems) s[cx_slot(e)] = v[u];
    }
  }
  if constexpr (RxSide<Load>::value > 0) {
    static_assert(RxSide<Load>::value == 1, "one side slot a column");
    for (int cc = threadIdx.x; cc < C; cc += blockDim.x)
      side[cc] = cc < valid ? ld.at(base + cc, n) : make_float2(0.f, 0.f);
  }
  __syncthreads();
  if constexpr (RxPrologue<Load>::value) {
    ld.prologue(s, side + c, cx);
    __syncthreads();
  }
  radix_run<kE, kS>(s, tab, cs, count, plan, cx, io, scale);
  if constexpr (RxTileOut<Io>::value) io.epilogue(s, cx);
}

template <int kE, int kS, class Load, class Io>
cudaError_t radix_cols_launch_e(Load ld, Io io, const float2* tab, const RadixPlan& plan,
                                long long B, int n, long long L, int C, float scale,
                                cudaStream_t stream) {
  const int tr = (n + kE - 1) / kE;
  const int threads = (C * tr + 31) / 32 * 32;
  const long long smem =
      (long long)(cx_tile_slots(n * C) + rx_coef_count(plan) + RxSide<Load>::value * C) *
      sizeof(float2);
  const long long tiles = (L + C - 1) / C;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || B * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(radix_cols_kernel<kE, kS, Load, Io>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  radix_cols_kernel<kE, kS, Load, Io><<<(unsigned)(B * tiles), threads, (size_t)smem, stream>>>(
      ld, io, tab, plan, n, L, tiles, C, scale);
  return cudaGetLastError();
}

// The column tile's launcher: B L columns of length n (the plan's), C
// columns a tile, a power of two up to kRadixMaxCols with n C <= 20480 and
// at most 256 threads (512 above n C = 4096; 16, 32 or 40 elements a thread
// by n C). Returns the cudaError_t of the launch.
template <int kS, class Load, class Io>
cudaError_t radix_cols_launch(Load ld, Io io, const float2* tab, const RadixPlan& plan,
                              long long B, int n, long long L, int C, float scale,
                              cudaStream_t stream) {
  if (B < 1 || L < 1 || C < 1 || C > kRadixMaxCols || (C & (C - 1)) || (long long)n * C > 20480)
    return cudaErrorInvalidValue;
  const int e = radix_per_thread(n * C);
  return e == 40 ? radix_cols_launch_e<40, kS>(ld, io, tab, plan, B, n, L, C, scale, stream)
       : e == 32 ? radix_cols_launch_e<32, kS>(ld, io, tab, plan, B, n, L, C, scale, stream)
                 : radix_cols_launch_e<16, kS>(ld, io, tab, plan, B, n, L, C, scale, stream);
}

}  // namespace ndfft
