// Kernel 22 on the mixed-radix core's column tile: the fused real spectral
// pipeline y = C2R(H * R2C(x)) along the middle axis of a (B, n, L) float32
// tensor, the C2R times its scale, at every even n = 2h, h = 128 F that
// ops/hopper/rfft.py::_check_nat takes (h = 128 ... 20480, prime factors
// <= 128: each has a radix plan). H = hr + i hi is (h + 1, 1) or
// (h + 1, L), hi absent for a real H (spectral.cuh::SpecMult).
//
// Replaces ndrustfft_tpu/ops/pallas/rfft.py::_spectral_kernel_mid (:1021,
// built by _build_spectral_mid, pallas_call at :1138, called by
// spectral_pallas_mid). Its first Hopper forms ran two half-length bts2
// cores (a dense DFT-128 on the FP32 cores each) on one tile: 38.61 ms at
// (1, 1024, 1048576) with a broadcast real gain, 15x its byte bound, and
// the wide core 5.88 ms at (8, 768, 16384), 24x (PERF.md, kernel table
// row 22).
//
// What bounds it on this card: device memory. A column of x is read once,
// H once (h + 1 values a column where H varies along the lanes, else once
// in all) and y written once: 8 n bytes a column, against two real FFTs'
// 5 n log2 n FP32 operations.
//
// The design: kernel 16's load and half-length FFT, the pair pass, and
// kernel 17's half-length inverse and store, on one (h, C) column tile in
// shared memory (kernel 29's shape of work, spectral_dct_radix.cu):
//   1. RealCol's pairs z[t] = x[2t] + i x[2t + 1] into the tile (read-only
//      loads at C <= 2, evict-first above, as kernel 29);
//   2. the forward radix_run of h (sign -1), Z left in the tile in natural
//      order behind its barrier;
//   3. the pair pass in place (spectral.cuh::spectral_r2c_pair): each thread
//      takes the mirror pairs {k, h - k}, k <= h/2, of its column, goes from
//      Z[k], Z[h - k] through the unpack X, the product S = H X (Im S[0] := 0,
//      S[h] = Re H[h] X[h]) and kernel 17's inverse unpack to G[k], G[h - k]
//      in registers, and writes G back to both slots. Every pair closes on
//      itself (k = 0 takes Z[0] alone, k = h/2 is its own mirror), so the
//      pass needs only the barrier that follows the forward run;
//   4. the inverse radix_run of h on the sign +1 table (its prime stages'
//      coefficient rows beside the forward's): z = h IFFT_h(G);
//   5. the store y[2l] = Re z[l], y[2l + 1] = Im z[l] (the scale is in the
//      ab rows), consecutive threads on consecutive columns of a row, as
//      kernel 17's C2rColBins.
// Every constant comes from the host (ops/hopper/rfft.py); columns a tile
// by rfft.py::spectral_cols.
//
// Each transform is an out-of-line copy of radix_run
// (spectral.cuh::spectral_fft): inlined twice, kernel 29's spilled
// 4688-11524 bytes a thread. The inverse runs on its own sign +1 table, so
// each copy is called once: as conj(FFT(conj G)) on the forward table (one
// table and one copy, kernel 29's form) ptxas allocated the one copy for
// two call sites and spilled 2560, 4736 and 5848 bytes a thread in it at
// 16, 32 and 40 elements, against 92, 20 and 1044 in each of the two
// copies called once, and on an H100 that form ran 1.4-1.7x slower at the
// main shapes (PERF.md, kernel table row 22).
// The kernel itself takes 80, 128 and 128 registers and spills 156 bytes a
// thread at 16, 32 and 40 elements (ptxas -v; time_kernels.py --spectral).
// Every offset is a long long: path S2's (1024, 1024, 1024) field holds
// 2^30 floats, and the load addresses row 2r + 1.
#include "spectral.cuh"

namespace ndfft {

// The pair pass's tables: tw (h,) W_n^k; ab (h, 4) kernel 17's rows with the scale.
struct SpecR2cTabs {
  const float2* __restrict__ tw;
  const float4* __restrict__ ab;
};

// One block per (b, tile of at most C adjacent columns), as
// radix_cols_kernel: tr = ceil(h / kE) threads a column, thread c + C t
// taking column c's place t; tab: the radix table of h, sign -1; tinv: the
// sign +1 table.
template <int kE, bool kLdg>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
spectral_r2c_radix_kernel(RealCol<true, kLdg> ld, float* __restrict__ y, SpecMult hm,
                          SpecR2cTabs k, const float2* __restrict__ tab,
                          const float2* __restrict__ tinv, RadixPlan plan, int h, long long L,
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
  const RadixCtx<ColLayout> cx{h, tr, t, ColLayout{c, C}, c < valid && t < tr, 0};
  float2* s = smem;
  float2* cs = smem + cx_tile_slots(h * C);
  float2* csinv = cs + rx_coef_count(plan);
  int count[8];
  radix_prepare(count, cs, tab, plan, h);
  radix_prepare(count, csinv, tinv, plan, h);
  const int elems = h * C;
  tile_pass(elems, cshift, valid, [&](int r, int cc, int) { return ld.at(base + cc, r); },
            [&](int, int, int q, float2 v) { s[q] = v; });
  __syncthreads();
  spectral_fft<kE, -1>(s, tab, cs, count, plan, cx);
  // G in place, the second transform's input
  if (cx.active) {
    const long long col = col0 + c;
    for (int kk = t; kk <= h / 2; kk += tr) {
      const int k2 = kk ? h - kk : 0;
      const int qa = cx.slot(kk), qb = cx.slot(k2);
      float2 gk, gm;
      spectral_r2c_pair(kk, h, s[qa], s[qb], k.tw, k.ab, hm, col, gk, gm);
      s[qa] = gk;
      if (k2 != kk) s[qb] = gm;
    }
  }
  __syncthreads();
  spectral_fft<kE, 1>(s, tinv, csinv, count, plan, cx);
  // y[2l] + i y[2l + 1] = h IFFT_h(G)[l]
  float* yb = y + base;
  tile_pass(elems, cshift, valid, [&](int, int, int q) { return s[q]; },
            [&](int l, int cc, int, float2 z) {
              float* q = yb + 2 * l * L + cc;
              q[0] = z.x;
              q[L] = z.y;
            });
}

template <int kE, bool kLdg>
cudaError_t spectral_r2c_radix_launch(const RealCol<true, kLdg>& ld, float* y, const SpecMult& hm,
                                      const SpecR2cTabs& k, const float2* tab,
                                      const float2* tinv, const RadixPlan& plan, long long B,
                                      int h, long long L, int C, cudaStream_t stream) {
  const int tr = (h + kE - 1) / kE;
  const int threads = (C * tr + 31) / 32 * 32;
  const long long smem = spectral_smem_bytes(h * C, plan);
  const long long tiles = (L + C - 1) / C;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || B * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(spectral_r2c_radix_kernel<kE, kLdg>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  spectral_r2c_radix_kernel<kE, kLdg>
      <<<(unsigned)(B * tiles), threads, (size_t)smem, stream>>>(ld, y, hm, k, tab, tinv, plan,
                                                                 h, L, tiles, C);
  return cudaGetLastError();
}

// 16, 32 or 40 elements a thread by the tile's h C elements, as
// radix_cols_launch.
template <bool kLdg>
cudaError_t spectral_r2c_radix_dispatch(const RealCol<true, kLdg>& ld, float* y,
                                        const SpecMult& hm, const SpecR2cTabs& k,
                                        const float2* tab, const float2* tinv,
                                        const RadixPlan& plan, long long B, int h, long long L,
                                        int C, cudaStream_t st) {
  const int e = radix_per_thread(h * C);
  return e == 40 ? spectral_r2c_radix_launch<40, kLdg>(ld, y, hm, k, tab, tinv, plan, B, h, L,
                                                       C, st)
       : e == 32 ? spectral_r2c_radix_launch<32, kLdg>(ld, y, hm, k, tab, tinv, plan, B, h, L,
                                                       C, st)
                 : spectral_r2c_radix_launch<16, kLdg>(ld, y, hm, k, tab, tinv, plan, B, h, L,
                                                       C, st);
}

}  // namespace ndfft

// x, y: (B, n, L) float32, contiguous, n = 2h; hr, hi: H's float32 planes,
// (h + 1, hc) with hc = 1 or L (hi nullptr for a real H); table: the radix
// table of h, sign -1 (ops/hopper/fft.py::radix_consts); table_inv: the
// sign +1 table of h, the inverse's; radices: radix_plan(h),
// `stages` of them; tw: (h,) complex64 W_n^k; ab: (h, 4) float32 rows
// (A.re, A.im, B.re, B.im) with the scale folded in
// (ops/hopper/rfft.py::c2r_unpack_consts). C: columns per tile, a power of
// two up to 256 with h C <= 20480 (rfft.py::spectral_cols); ldg: 1
// loads x through the read-only path, 0 evict-first. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_spectral_r2c_radix(const void* x, void* y, const void* hr, const void* hi,
                                        long long hc, const void* table, const void* table_inv,
                                        const int* radices, int stages, const void* tw,
                                        const void* ab, long long B, int n, long long L, int C,
                                        int ldg, void* stream) {
  using namespace ndfft;
  const int h = n / 2;
  const SpecMult hm = spec_mult(hr, hi, hc, L);
  RadixPlan plan{};
  if (hm.hr == nullptr || table == nullptr || table_inv == nullptr || n % 2 ||
      !radix_plan_of(radices, stages, h, plan) || B < 1 || L < 1 || C < 1 || C > kRadixMaxCols ||
      (C & (C - 1)) || (long long)h * C > 20480)
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float*>(x);
  const auto yp = static_cast<float*>(y);
  const auto tp = static_cast<const float2*>(table);
  const auto ti = static_cast<const float2*>(table_inv);
  const SpecR2cTabs k{static_cast<const float2*>(tw), static_cast<const float4*>(ab)};
  const auto st = static_cast<cudaStream_t>(stream);
  return ldg ? (int)spectral_r2c_radix_dispatch(RealCol<true, true>{xp, L, n}, yp, hm, k, tp, ti,
                                                plan, B, h, L, C, st)
             : (int)spectral_r2c_radix_dispatch(RealCol<true, false>{xp, L, n}, yp, hm, k, tp,
                                                ti, plan, B, h, L, C, st);
}
