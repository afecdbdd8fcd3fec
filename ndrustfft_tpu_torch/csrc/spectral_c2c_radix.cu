// Kernel 14 on the mixed-radix core's column tile: the fused complex
// spectral pipeline y = scale * IFFT(H * FFT(x)) along the middle axis of a
// (B, n, L) complex64 tensor, the forward transform unnormalized, at every
// n = 128 F that ops/hopper/fft.py::core_f takes (128 ... 20480, prime
// factors <= 128: each has a radix plan). H is (n, 1) or (n, L), real or
// complex (spectral.cuh::SpecMult), the same block for every batch index.
//
// Replaces ndrustfft_tpu/ops/pallas/fft.py::_spectral_c2c_kernel_mid
// (:2000, built by _build_spectral_c2c_mid, pallas_call at :2065, called by
// spectral_c2c_pallas_mid). Its first Hopper forms ran two bts2 cores (a
// dense DFT-128 on the FP32 cores each) on one tile: 42.79 ms at
// (1, 1024, 525312) with a lane-varying real H, 13x its byte bound, and the
// wide core 22.04 ms at (8, 1280, 8192), 55x (PERF.md, kernel table row 14).
//
// What bounds it on this card: device memory. A column of x is read once,
// H once (n values a column where H varies along the lanes, else once in
// all) and y written once: 16 n bytes a column and 4 n (8 n complex) more
// for a lane-varying H, against two complex FFTs' 10 n log2 n FP32
// operations and the multiply's 6 n.
//
// The design: kernel 1's column tile (fft_mid_radix.cu) with two transforms
// and the multiply in between, the spectrum never leaving shared memory:
//   1. CplxCol's load of the (n, C) tile (read-only at C <= 2, evict-first
//      above, as kernel 1 takes it);
//   2. the forward radix_run of n (sign -1), X left in the tile in natural
//      order behind its barrier;
//   3. the multiply in place, s[k] = H[k, col] X[k], in the load's order:
//      consecutive threads on consecutive columns of one row k, so a warp
//      reads 32 / C runs of C adjacent floats of a lane-varying H. At C = 4
//      a run is half of a 32-byte sector; the neighbouring tile reads the
//      other half, from L2 where it still holds the sector (H is read
//      through the read-only path, four loads a thread in flight). The
//      stages' own mapping (thread c + C t on row t of column c) gives a
//      warp the same runs;
//   4. the inverse radix_run of n on the sign +1 table (its prime stages'
//      coefficient rows beside the forward's);
//   5. the store y = scale z, consecutive threads on consecutive columns of
//      a row, as kernel 7's epilogue without the twiddle.
// Columns a tile by kernel 1's rule, ops/hopper/fft.py::axis_mid_tile.
//
// Each transform is an out-of-line copy of radix_run
// (spectral.cuh::spectral_fft): inlined twice, kernel 29's spilled
// 4688-11524 bytes a thread. The inverse runs on its own sign +1 table, so
// each copy is called once: as conj(FFT(conj V)) on the forward table (one
// table and one copy, kernel 29's form) ptxas allocated the one copy for
// two call sites and spilled 2584, 4864 and 5856 bytes a thread in it at
// 16, 32 and 40 elements, against 244, 172 and 1180 in each of the two
// copies called once, and on an H100 that form ran 1.2-1.5x slower at the
// main shapes (PERF.md, kernel table row 14).
// The kernel itself takes 80, 128 and 128 registers and spills 64, 16 and
// 232 bytes a thread at 16, 32 and 40 elements (ptxas -v;
// time_kernels.py --spectral prints both kernels' figures).
// Every offset is a long long: path S1's spectrum holds 5.4e8 complex
// values.
#include "spectral.cuh"

namespace ndfft {

// One block per (b, tile of at most C adjacent columns), as
// radix_cols_kernel: tr = ceil(n / kE) threads a column, thread c + C t
// taking column c's place t; tab: the radix table of n, sign -1; tinv: the
// sign +1 table.
template <int kE, bool kLdg>
__global__ void __launch_bounds__(kRadixMaxThreads<kE>, kRadixMinBlocks<kE>)
spectral_c2c_radix_kernel(CplxCol<kLdg> ld, float2* __restrict__ y, SpecMult hm,
                          const float2* __restrict__ tab, const float2* __restrict__ tinv,
                          RadixPlan plan, int n, long long L, long long tiles, int C,
                          float scale) {
  extern __shared__ float2 smem[];
  const long long bb = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long col0 = tile * L / tiles;
  const int valid = (int)((tile + 1) * L / tiles - col0);
  const long long base = ld.base(bb, col0);
  const int tr = (n + kE - 1) / kE;
  const int cshift = 31 - __clz(C);   // C is a power of two: no division per element
  const int t = (int)threadIdx.x >> cshift, c = (int)threadIdx.x & (C - 1);
  const RadixCtx<ColLayout> cx{n, tr, t, ColLayout{c, C}, c < valid && t < tr, 0};
  float2* s = smem;
  float2* cs = smem + cx_tile_slots(n * C);
  float2* csinv = cs + rx_coef_count(plan);
  int count[8];
  radix_prepare(count, cs, tab, plan, n);
  radix_prepare(count, csinv, tinv, plan, n);
  const int elems = n * C;
  tile_pass(elems, cshift, valid, [&](int r, int cc, int) { return ld.at(base + cc, r); },
            [&](int, int, int q, float2 v) { s[q] = v; });
  __syncthreads();
  spectral_fft<kE, -1>(s, tab, cs, count, plan, cx);
  // H X in place, four loads of H in flight a thread
  tile_pass(elems, cshift, valid, [&](int r, int cc, int) { return hm.at(r, col0 + cc); },
            [&](int, int, int q, float2 g) { s[q] = cmul(g, s[q]); });
  __syncthreads();
  spectral_fft<kE, 1>(s, tinv, csinv, count, plan, cx);
  // y = scale n IFFT_n(H X)
  float2* yb = y + base;
  tile_pass(elems, cshift, valid, [&](int, int, int q) { return s[q]; },
            [&](int r, int cc, int, float2 z) {
              yb[r * L + cc] = make_float2(scale * z.x, scale * z.y);
            });
}

template <int kE, bool kLdg>
cudaError_t spectral_c2c_radix_launch(const CplxCol<kLdg>& ld, float2* y, const SpecMult& hm,
                                      const float2* tab, const float2* tinv,
                                      const RadixPlan& plan, long long B, int n, long long L,
                                      int C, float scale, cudaStream_t stream) {
  const int tr = (n + kE - 1) / kE;
  const int threads = (C * tr + 31) / 32 * 32;
  const long long smem = spectral_smem_bytes(n * C, plan);
  const long long tiles = (L + C - 1) / C;
  if (threads > kRadixMaxThreads<kE> || smem > kMaxSmemBytes || B * tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(spectral_c2c_radix_kernel<kE, kLdg>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  spectral_c2c_radix_kernel<kE, kLdg>
      <<<(unsigned)(B * tiles), threads, (size_t)smem, stream>>>(ld, y, hm, tab, tinv, plan, n,
                                                                 L, tiles, C, scale);
  return cudaGetLastError();
}

// 16, 32 or 40 elements a thread by the tile's n C elements, as
// radix_cols_launch.
template <bool kLdg>
cudaError_t spectral_c2c_radix_dispatch(const CplxCol<kLdg>& ld, float2* y, const SpecMult& hm,
                                        const float2* tab, const float2* tinv,
                                        const RadixPlan& plan, long long B, int n, long long L,
                                        int C, float scale, cudaStream_t st) {
  const int e = radix_per_thread(n * C);
  return e == 40 ? spectral_c2c_radix_launch<40, kLdg>(ld, y, hm, tab, tinv, plan, B, n, L, C,
                                                       scale, st)
       : e == 32 ? spectral_c2c_radix_launch<32, kLdg>(ld, y, hm, tab, tinv, plan, B, n, L, C,
                                                       scale, st)
                 : spectral_c2c_radix_launch<16, kLdg>(ld, y, hm, tab, tinv, plan, B, n, L, C,
                                                       scale, st);
}

}  // namespace ndfft

// x, y: (B, n, L) complex64, contiguous; hr, hi: H's float32 planes, (n, hc)
// with hc = 1 or L (hi nullptr for a real H); table: the radix table of n,
// sign -1 (ops/hopper/fft.py::radix_consts); table_inv: the sign +1 table
// of n, the inverse's; radices: radix_plan(n), `stages` of them;
// scale: the inverse's (1/n, a scalar policy's value, or 1). C: columns per
// tile, a power of two up to 256 with n C <= 20480 (fft.py::axis_mid_tile);
// ldg: 1 loads x through the read-only path, 0 evict-first. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ndfft_spectral_c2c_radix(const void* x, void* y, const void* hr, const void* hi,
                                        long long hc, const void* table, const void* table_inv,
                                        const int* radices, int stages, long long B, int n,
                                        long long L, int C, float scale, int ldg, void* stream) {
  using namespace ndfft;
  const SpecMult hm = spec_mult(hr, hi, hc, L);
  RadixPlan plan{};
  if (hm.hr == nullptr || table == nullptr || table_inv == nullptr ||
      !radix_plan_of(radices, stages, n, plan) || B < 1 || L < 1 || C < 1 || C > kRadixMaxCols ||
      (C & (C - 1)) || (long long)n * C > 20480)
    return (int)cudaErrorInvalidValue;
  const auto xp = static_cast<const float2*>(x);
  const auto yp = static_cast<float2*>(y);
  const auto tp = static_cast<const float2*>(table);
  const auto ti = static_cast<const float2*>(table_inv);
  const auto st = static_cast<cudaStream_t>(stream);
  return ldg ? (int)spectral_c2c_radix_dispatch(CplxCol<true>{xp, L, n}, yp, hm, tp, ti, plan,
                                                B, n, L, C, scale, st)
             : (int)spectral_c2c_radix_dispatch(CplxCol<false>{xp, L, n}, yp, hm, tp, ti, plan,
                                                B, n, L, C, scale, st);
}
