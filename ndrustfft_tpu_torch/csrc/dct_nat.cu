// Kernels 23 and 24 (DCT-II and DCT-III of contiguous float32 rows, even
// n = 128 * k, k <= 256: the JAX gate's split (128, k)) at the 29 lengths
// whose half length 64 k has no radix plan (odd prime k = 131 ... 251 in
// the n-point form, k = 262, 274, 278, 298, 302, 314 in the half-length
// form), on the wide core (dct_wide.cuh): the half-length form for even k
// (h = 128 * k/2), the n-point form on a real tile for odd k. At every
// other length both run on the radix row core (dct_rows_radix.cu), and
// their fixed-core forms here are gone.
//
// Kernel 23 replaces ndrustfft_tpu/ops/pallas/dct.py::_dct2_kernel (built by
// _build_dct2, called by dct2_pallas); kernel 24 replaces dct.py::_dct3_kernel
// (built by _build_dct3) together with dct3_pallas's interleave epilogue
// (dct.py:320-323), which here is the kernel's store. Both compute the
// rustdct convention times a scale s (the handler's policy: Default s = 2).
//
//   DCT-II  (Makhoul): v = [x0, x2, .., x_{n-2}, x_{n-1}, .., x3, x1];
//           V = FFT_n(v), a real input, by the half-length R2C (kernel 2's math):
//           z[t] = v[2t] + i v[2t+1], Z = FFT_h(z),
//           V[k] = (Z[k] + conj Z[-k]) / 2 - i W_n^k (Z[k] - conj Z[-k]) / 2;
//           y[k] = Re(P[k] V[k]) and y[n-k] = Re(P[n-k] conj V[k]), with the
//           post twiddle P[k] = s e^{-i pi k / 2n}.
//   DCT-III (the transpose): y[2t] = u[t], y[2t+1] = u[n-1-t], with
//           u = Re FFT_n(c e^{-i pi t / 2n}), c = x with x0 halved. u is the
//           unnormalized C2R of the Hermitian half spectrum
//           S[k] = Q[k] (x[k] - i x[n-k]),  Q[k] = (s/2) e^{+i pi k / 2n},
//           k = 0..h, x[n] := 0 (so S[0] = s x0 / 2 and S[h] is real), which
//           kernel 3's unpack and half-length inverse turn into u.
//
// What bounds these forms is the wide core's stage 2 (bts2_wide.cuh) and,
// in the n-point form at k > 160, the F * 128 KB Wq stream of every row.
#include "dct_wide.cuh"

// Kernels 23 (type3 = 0) and 24 (type3 = 1) on the wide core in the row
// layout, half-length form: n = 2h, h = 128 * F, 1 <= F <= 160. x, y: (T, n)
// float32; wq: (F, 128, 128) complex64 for h (sign -1 for DCT-II, +1 for
// DCT-III, unscaled); wf: (F, F) DFT-F of the same sign; c1: tw (h,) W_n^k
// (DCT-II) or ab (h, 4) kernel-3 rows at scale 1 (DCT-III); c2: post (n,)
// s e^{-i pi k / 2n} (DCT-II) or pre (h + 1,) (s/2) e^{+i pi k / 2n}
// (DCT-III). C: rows per tile, a power of two <= 16 whose tile fits
// (bts2_wide.cuh::wide_smem_bytes). Returns the cudaError_t of the launch.
extern "C" int ndfft_dct_nat_wide(int type3, const void* x, void* y, const void* wq,
                                  const void* wf, const void* c1, const void* c2, long long T,
                                  int n, int C, void* stream) {
  return ndfft::dct_wide_launch<true>(type3 != 0, false, x, y, wq, wf, c1, c2, 1, n, T, C,
                                      stream);
}

// Kernels 23 and 24 in the n-point form on the real tile: n = 128 * F,
// 1 <= F <= 256 (odd F <= 255 on the routes). wq: (F, 128, 128) complex64
// for n, sign -1, unscaled; wf: (F, F) DFT-F, sign -1; c: post (n,)
// s e^{-i pi k / 2n} (DCT-II) or the n-point chirp (F + 128,)
// e^{-i pi a / 2F}, then s e^{-i pi b / 2n} (DCT-III). C: rows per tile, a
// power of two <= 16 whose tile fits (bts2_wide.cuh::wide_real_smem_bytes).
extern "C" int ndfft_dct_nat_npoint(int type3, const void* x, void* y, const void* wq,
                                    const void* wf, const void* c, long long T, int n, int C,
                                    void* stream) {
  return ndfft::dct_wide_launch<true>(type3 != 0, true, x, y, wq, wf, nullptr, c, 1, n, T, C,
                                      stream);
}
