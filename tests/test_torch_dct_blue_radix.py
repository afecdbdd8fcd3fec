"""Kernel 12 on kernel 11's chirp-z column kernel (the real-to-real
chirp-z of the Makhoul DCT-II/III along a middle axis at M = chirp_m(n)),
on the CPU, where the wrapper runs its plain version:

* ``dct23_blue_mid_plain`` against the JAX package's K12 path
  (``dct23_blue_pallas_mid``, interpret mode) and, after the Makhoul
  permutations, against scipy's DCT-II/III in float64, at n = 1103 and
  2049, L <= 4, DCT-II with scale 2 and DCT-III unscaled and with scale 2;
* the convolution length M = chirp_m(n) at the 3264 lengths the route sends
  (n = 1101 ... 6782: 15 lengths M from 2304 to 14336, each a plan of
  register codelets whose column fits a tile) and the exit table's store.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 2e-6 of the peak against float64.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops import dct as tdct
from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.plan import factorize

torch.set_num_threads(1)

TOL = 5e-6


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n,nb,cols", [(1103, 2, 3), (2049, 1, 4)])
@pytest.mark.parametrize("dct_type,scale", [(2, 2.0), (3, None), (3, 2.0)])
def test_plain_matches_pallas_and_float64(n, nb, cols, dct_type, scale):
    x = np.random.default_rng(n + dct_type).standard_normal((nb, n, cols)).astype(np.float32)
    got = kdct.dct23_blue_mid_plain(torch.from_numpy(x), dct_type, scale)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _rel(got, ref_pfft.dct23_blue_pallas_mid(jnp.asarray(x), dct_type, scale)) <= TOL
    # the whole transform: the Makhoul permutations around the kernel
    s = 1.0 if scale is None else scale
    y = tdct.dct23_blue_mid(torch.from_numpy(x), dct_type, scale)
    want = sfft.dct(x.astype(np.float64), type=dct_type, axis=1) * (s / 2)
    assert _rel(y, want) <= 2e-6


def test_convolution_lengths_of_the_route():
    ns = [n for n in range(2, 8000) if n > api._DENSE_DCT_MAX
          and not (n % 2 == 0 and api._ts_ok(n)) and factorize(n) is None
          and api._blue_mid_ok(n)]
    assert (len(ns), ns[0], ns[-1]) == (3264, 1101, 6782)
    ms = sorted({kfft.chirp_m(n) for n in ns})
    assert ms == [2304, 2560, 4096, 4608, 5120, 6400, 6480, 8192, 8960, 9216, 10240, 11520,
                  12288, 12544, 14336]
    for n in ns:
        assert 2 * n - 1 <= kfft.chirp_m(n) <= 2 * (2 * n - 1)
    for mk in ms:
        plan = kfft.radix_plan(mk)
        assert plan and all(r in kfft.RADIX_CODELETS for r in plan)
        c = kdct.dct23_blue_cols(mk, 1, 10 ** 6, 132)
        assert mk * c <= kfft.RADIX_MAX_ELEMS and c & (c - 1) == 0
    assert kfft.chirp_m(2049) == 4608
    # every length the wrapper takes (blue_f) has M within a column tile
    assert max(kfft.chirp_m(n) for n in range(129, 7200) if kfft.blue_f(n)) <= 14336


def test_exit_table_store():
    """BlueReBins's store Re(conj(z) s b) = s (z.x b.x + z.y b.y) with the
    tile holding FFT_M(conj V) = M conj(IFFT_M(V)) and s = 1/M gives
    Re(IFFT_M(V) b), the plain version's."""
    g = np.random.default_rng(3)
    v = g.standard_normal(64) + 1j * g.standard_normal(64)
    b = g.standard_normal(64) + 1j * g.standard_normal(64)
    z = np.fft.fft(np.conj(v))
    s = 1.0 / 64
    np.testing.assert_allclose(s * (z.real * b.real + z.imag * b.imag),
                               (np.fft.ifft(v) * b).real, rtol=1e-12, atol=1e-12)
