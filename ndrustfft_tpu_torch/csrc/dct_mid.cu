// Kernels 25 and 26: DCT-II and DCT-III along the middle axis of a
// (B, n, L) float32 tensor at the 29 lengths n = 128 * k (k <= 256, the
// JAX gate's split (128, k); the routes send n > 1100 here, kernel 27
// below) whose half length 64 k has no radix plan: k = 131 ... 251 prime,
// and 2 k for k = 131, 137, 139, 149, 151, 157. Both run on the radix
// column tile at every other length (dct_mid_radix.cu: MakhoulCol +
// Dct2Rows, Dct3Col + Dct3Rows), and their fixed-core forms here are gone.
//
// Kernel 25 replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel_mid
// (built by _build_dct2_mid, called by dct2_pallas_mid); kernel 26 replaces
// dct.py::_dct3_kernel_mid (built by _build_dct3_mid). Both compute the
// rustdct convention times a scale s, by the Makhoul passes of kernels 23/24
// (dct_nat.cu, whose header comment has the algebra) in the column-tile
// layout, one block per (b, tile of C columns), in two forms by n:
//
// * even k (n = 128 * 262, 274, 278, 298, 302, 314): the half-length
//   passes on the wide core (dct_wide.cuh, column layout).
// * odd k (n = 128 * 131 ... 128 * 251; h = 64 k is not 128 * F): the
//   n-point form on the wide core's real tile, as the TPU kernel computes
//   at every n (dct_wide.cuh). At odd k > 160 (n >= 20608) one column fills
//   a block (131 KB at n = 32640) and each column streams the whole Wq
//   table (F * 128 KB) from L2: these long forms are bound by that stream.
//
// What bounds them: the core's stage 2 on the FP32 CUDA cores
// (bts2_wide.cuh); device memory is read once and written once, the column
// loads and stores are whole rows of the tile's C columns, and every
// constant comes from the host (ops/hopper/dct.py).
#include "dct_wide.cuh"

// Kernels 25 and 26 on the wide core, half-length form: n = 2h, h = 128 * F,
// 1 <= F <= 160; x, y: (B, n, L); wq, wf, c1 and c2 as for
// ndfft_dct_nat_wide. C: columns per tile, a power of two <= 16 whose tile
// fits (bts2_wide.cuh::wide_smem_bytes).
extern "C" int ndfft_dct_mid_wide(int type3, const void* x, void* y, const void* wq,
                                  const void* wf, const void* c1, const void* c2, long long B,
                                  int n, long long L, int C, void* stream) {
  return ndfft::dct_wide_launch<false>(type3 != 0, false, x, y, wq, wf, c1, c2, B, n, L, C,
                                       stream);
}

// Kernels 25 and 26 in the n-point form on the real tile: n = 128 * F,
// 1 <= F <= 256; wq, wf and c as for ndfft_dct_nat_npoint. C: columns per
// tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_real_smem_bytes).
extern "C" int ndfft_dct_mid_npoint(int type3, const void* x, void* y, const void* wq,
                                    const void* wf, const void* c, long long B, int n,
                                    long long L, int C, void* stream) {
  return ndfft::dct_wide_launch<false>(type3 != 0, true, x, y, wq, wf, nullptr, c, B, n, L, C,
                                       stream);
}
