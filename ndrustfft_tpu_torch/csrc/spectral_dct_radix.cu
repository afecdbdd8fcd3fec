// Kernel 29 on the mixed-radix core's column tile: the fused cosine-basis
// pipeline s3 * DCT-III(H * s2 * DCT-II(x)) along the middle axis of a
// (B, n, L) float32 tensor (the rustdct convention; H real, (n, 1) or
// (n, L)), at every n = 128 k of ops/hopper/dct.py::dct_form whose half
// length h = n/2 = 64 k has a radix plan (dct.py::dct2_nat_radix: 259 of
// the 288 lengths, the odd k included). The 29 others keep the wide core's
// and the n-point forms (spectral_dct_mid.cu).
//
// Replaces ndrustfft_tpu/ops/pallas/dct.py::_spectral_dct_kernel_mid
// (:779, called at :870 by spectral_dct_pallas_mid) at those lengths. Its
// first Hopper forms ran the bts2 fixed core (40.76-41.17 ms at
// (1, 1024, 1048576), twice the public composition of kernel 27's two
// radix forms around a multiply), the wide core and the n-point form,
// whose every column streamed the F * 128 KB Wq table from L2 (about
// 1552 ms at (1, 31104, 31104), 447x its byte bound).
//
// What bounds it on this card: device memory. A column of x is read once,
// H once (n floats a column where H varies along the lanes, else once in
// all) and y written once: 12 n bytes a column at a lane-varying H, 8 n at
// a broadcast one, against two real FFTs' 5 n log2 n FP32 operations.
//
// The design: kernel 25's Makhoul R2C and kernel 26's Makhoul C2R
// (dct_mid_radix.cu, makhoul_cols.cuh) on one (h, C) column tile in shared
// memory, with the coefficient field kept out of device memory:
//   1. MakhoulCol's pairs z[t] = (x[src(2t)], x[src(2t + 1)]) into the tile
//      (read-only loads at C <= 2, evict-first above, as kernel 25);
//   2. the forward radix_run of h (sign -1), Z left in the tile in natural
//      order behind its barrier;
//   3. the pair pass in place (spectral.cuh::spectral_dct_pair): each thread
//      takes the mirror pairs {k, h - k}, k <= h/2, of its column, as
//      fft_radix.cuh::c2r_prologue_tile does, and writes G[k] and G[h - k]
//      back to their slots, H read through SpecMult, the DC and Nyquist
//      residues dropped;
//   4. the inverse transform of h on the same tile as conj(FFT_h(conj G))
//      with the one sign -1 table and prime rows (the pass writes conj G,
//      the epilogue reads conj z: kernel 11's inverse);
//   5. Dct3Rows' interleave y[interleave_dst(2l)] = Re z[l],
//      y[interleave_dst(2l + 1)] = Im z[l].
// Every constant comes from the host (ops/hopper/dct.py); columns a tile
// by dct.py::spectral_dct_cols.
//
// Both transforms run one out-of-line copy of radix_run (spectral_dct_fft).
// Inlined twice, as kernel 11 runs its two, ptxas spilled 4688, 8652 and
// 11524 bytes a thread at 16, 32 and 40 elements; out of line the kernel
// spills 92 and the function 2408, 4680 and 5784, and the kernel ran
// within 1% or up to 1.2x faster (time_kernels.py --scan-dct-mid on an
// H100). The sign +1 inverse with its own table (radix_prepare behind the
// pass) ran 0.96-1.11x the conjugate's time, at 16 more spill bytes.
#include "makhoul_cols.cuh"
#include "spectral.cuh"

namespace ndfft {

// Both transforms leave their outputs in the tile as they are.
struct SpecDctTile {
  static constexpr bool kTileOut = true;
  __device__ __forceinline__ float2 out(int, float2 v) const { return v; }
};

// The pair pass's tables: tw (h,) W_n^k; post (n,) P = s2 e^{-i pi k/2n};
// pre (h + 1,) Q = (s3/2) e^{i pi k/2n}; ab (h, 4) kernel 3's rows at scale 1.
struct SpecDctTabs {
  const float2* __restrict__ tw;
  const float2* __restrict__ post;
  const float2* __restrict__ pre;
  const float4* __restrict__ ab;
};

// One transform of h, sign -1, on every valid column of the tile, left in
// the tile behind its barrier; out of line: the kernel runs it twice.
template <int kE, class Cx>
__device__ __noinline__ void spectral_dct_fft(float2* s, const float2* __restrict__ tab,
                                              const float2* cs, const int (&count)[8],
                                              const RadixPlan& plan, Cx cx) {
  radix_run<kE, -1>(s, tab, cs, count, plan, cx, SpecDctTile{}, 1.f);
}

// One block per (b, tile of at most C adjacent columns), as
// radix_cols_kernel: tr = ceil(h / kE) threads a column, thread c + C t
// taking column c's place t; tab: the radix table of h, sign -1.
template <int kE, bool kLdg>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
spectral_dct_radix_kernel(MakhoulCol<kLdg> ld, Dct3Rows<true> io, SpecMult hm, SpecDctTabs k,
                          const float2* __restrict__ tab, RadixPlan plan, int h, long long L,
                          long long tiles, int C) {
  extern __shared__ float2 smem[];
  const long long bb = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long col0 = tile * L / tiles;
  const int valid = (int)((tile + 1) * L / tiles - col0);
  const long long base = ld.base(bb, col0);
  const int tr = (h + kE - 1) / kE;
  const int cshift = 31 - __clz(C);   // C is a power of two: no division per element
  const int t = (int)threadIdx.x >> cshift, c = (int)threadIdx.x & (C - 1);
  const RadixCtx<ColLayout> cx{h, tr, t, ColLayout{c, C}, c < valid && t < tr,
                               io.handle(bb, col0) + c};
  float2* s = smem;
  float2* cs = smem + cx_tile_slots(h * C);
  int count[8];
  radix_prepare(count, cs, tab, plan, h);
  // the tile, element e = (r, cc) at e = r C + cc, four loads in flight a
  // thread (radix_cols_kernel's load)
  constexpr int kLoads = 4;
  const int elems = h * C;
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
  __syncthreads();
  spectral_dct_fft<kE>(s, tab, cs, count, plan, cx);
  // conj G in place, the second transform's input
  if (cx.active) {
    const long long col = col0 + c;
    for (int kk = t; kk <= h / 2; kk += tr) {
      const int k2 = kk ? h - kk : 0;
      const int qa = cx.slot(kk), qb = cx.slot(k2);
      float2 gk, gm;
      spectral_dct_pair(kk, h, s[qa], s[qb], k.tw, k.post, k.pre, k.ab, hm, col, gk, gm);
      s[qa] = make_float2(gk.x, -gk.y);
      if (k2 != kk) s[qb] = make_float2(gm.x, -gm.y);
    }
  }
  __syncthreads();
  spectral_dct_fft<kE>(s, tab, cs, count, plan, cx);
  io.epilogue(s, cx);   // conj(FFT_h(conj G)) = IFFT_h(G), interleaved
}

template <int kE, bool kLdg>
cudaError_t spectral_dct_radix_launch(const MakhoulCol<kLdg>& ld, const Dct3Rows<true>& io,
                                      const SpecMult& hm, const SpecDctTabs& k,
                                      const float2* tab, const RadixPlan& plan, long long B,
                                      int h, long long L, int C, cudaStream_t stream) {
  const int tr = (h + kE - 1) / kE;
  const int threads = (C * tr + 31) / 32 * 32;
  const long long smem = (long long)(cx_tile_slots(h * C) + rx_coef_count(plan)) * sizeof(float2);
  const long long tiles = (L + C - 1) / C;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || B * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(spectral_dct_radix_kernel<kE, kLdg>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  spectral_dct_radix_kernel<kE, kLdg><<<(unsigned)(B * tiles), threads, (size_t)smem, stream>>>(
      ld, io, hm, k, tab, plan, h, L, tiles, C);
  return cudaGetLastError();
}

// 16, 32 or 40 elements a thread by the tile's h C elements, as
// radix_cols_launch.
template <bool kLdg>
cudaError_t spectral_dct_radix_dispatch(const MakhoulCol<kLdg>& ld, const Dct3Rows<true>& io,
                                        const SpecMult& hm, const SpecDctTabs& k,
                                        const float2* tab, const RadixPlan& plan, long long B,
                                        int h, long long L, int C, cudaStream_t st) {
  const int e = radix_per_thread(h * C);
  return e == 40   ? spectral_dct_radix_launch<40>(ld, io, hm, k, tab, plan, B, h, L, C, st)
         : e == 32 ? spectral_dct_radix_launch<32>(ld, io, hm, k, tab, plan, B, h, L, C, st)
                   : spectral_dct_radix_launch<16>(ld, io, hm, k, tab, plan, B, h, L, C, st);
}

}  // namespace ndfft

// x, y: (B, n, L) float32, contiguous, n = 2h; hr: H's float32 plane,
// (n, hc) with hc = 1 or L; table: the radix table of h, sign -1
// (ops/hopper/fft.py::radix_consts); radices: radix_plan(h), `stages` of
// them; tw: (h,) complex64 W_n^k; post: (n,) complex64 s2 e^{-i pi k/2n};
// ab: (h, 4) float32 kernel 3's rows at scale 1; pre: (h + 1,) complex64
// (s3/2) e^{i pi k/2n} (ops/hopper/dct.py). C: columns per tile, a power of
// two up to 256 with h C <= 20480 (dct.py::spectral_dct_cols); ldg: 1 loads
// x through the read-only path, 0 evict-first. Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ndfft_spectral_dct_radix(const void* x, void* y, const void* hr, long long hc,
                                        const void* table, const int* radices, int stages,
                                        const void* tw, const void* post, const void* ab,
                                        const void* pre, long long B, int n, long long L, int C,
                                        int ldg, void* stream) {
  using namespace ndfft;
  const int h = n / 2;
  const SpecMult hm = spec_mult(hr, nullptr, hc, L);
  RadixPlan plan{};
  if (hm.hr == nullptr || n % 2 || !radix_plan_of(radices, stages, h, plan) || B < 1 || L < 1 ||
      C < 1 || C > kRadixMaxCols || (C & (C - 1)) || (long long)h * C > 20480)
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float*>(x);
  const Dct3Rows<true> io{static_cast<float*>(y), L, n};
  const auto tp = static_cast<const float2*>(table);
  const SpecDctTabs k{static_cast<const float2*>(tw), static_cast<const float2*>(post),
                      static_cast<const float2*>(pre), static_cast<const float4*>(ab)};
  const auto st = static_cast<cudaStream_t>(stream);
  return ldg ? (int)spectral_dct_radix_dispatch(MakhoulCol<true>{xp, L, n}, io, hm, k, tp, plan, B,
                                                h, L, C, st)
             : (int)spectral_dct_radix_dispatch(MakhoulCol<>{xp, L, n}, io, hm, k, tp, plan, B, h,
                                                L, C, st);
}
