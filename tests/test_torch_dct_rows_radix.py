"""Kernel 23 on the radix row core (the DCT-II of contiguous rows as the
Makhoul R2C at half length h = n/2), on the CPU, where the wrapper runs its
plain version:

* ``dct2_rows_radix_plain`` against ``dct2_pallas`` (the JAX package's
  ``_dct2_kernel``) in interpret mode and against scipy's DCT-II in float64,
  at n = 256, 384 (odd k), 640 and 1536, a few rows, with scale 2 and
  unscaled;
* the form function at all 288 lengths of ``dct_form``: the radix row core
  at the 259 whose h has a plan, the old forms at the 29 listed ones;
* the kernel's load map (``csrc/dct_rows_radix.cu::MakhoulRowLoad``: a
  16-byte quad q of a row fills tile slots q and h - 1 - q) against the
  plain version's Makhoul permutation, and the wrapper's CPU route;
* the remnant's half-length form (and kernel 25's) at k = 262, where the
  half length has no radix plan, against float64.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 2e-6 of the peak against float64.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import dct as ref_pdct

from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
# the 29 lengths n = 128 k whose half length 64 k has no radix plan: the
# odd primes k > 127 (the n-point form) and twice the primes 131 ... 157
# (the wide core's half-length form)
REMNANT_K = (131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211,
             223, 227, 229, 233, 239, 241, 251, 262, 274, 278, 298, 302, 314)


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


@pytest.mark.parametrize("n", [256, 384, 640, 1536])
@pytest.mark.parametrize("scale", [2.0, None])
def test_radix_plain_matches_pallas_and_float64(n, scale):
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got = kdct.dct2_rows_radix_plain(torch.from_numpy(x), scale)
    assert got.dtype == torch.float32 and got.shape == (3, n)
    assert _rel(got, ref_pdct.dct2_pallas(jnp.asarray(x), scale)) <= TOL
    s = 1.0 if scale is None else scale
    want = sfft.dct(x.astype(np.float64), type=2, axis=1) * (s / 2)     # rustdct = scipy / 2
    assert _rel(got, want) <= 2e-6


def test_form_at_every_length():
    ns = [n for n in range(128, 128 * 321, 128) if kdct.dct_form(n) is not None]
    assert len(ns) == 288
    radix = [n for n in ns if kdct.dct2_nat_radix(n)]
    assert len(radix) == 259
    assert sorted(set(ns) - set(radix)) == [128 * k for k in REMNANT_K]
    for n in radix:
        h = n // 2
        assert h % 2 == 0 and kfft.radix_plan(h) is not None
        assert h <= kfft.RADIX_MAX_ELEMS
    assert not kdct.dct2_nat_radix(200) and not kdct.dct2_nat_radix(128 * 321)


@pytest.mark.parametrize("n", [128, 384, 1536])
def test_kernel_load_map_is_the_makhoul_order(n):
    """MakhoulRowLoad's map: quad q of a row (x[4q ... 4q + 3]) gives
    z[q] = (x[4q], x[4q + 2]) and z[h - 1 - q] = (x[4q + 3], x[4q + 1]),
    which must be the complex pairs of x[perm]."""
    h = n // 2
    x = np.random.default_rng(n).standard_normal((2, n))
    quads = x.reshape(2, h // 2, 4)
    z = np.empty((2, h), np.complex128)
    q = np.arange(h // 2)
    z[:, q] = quads[:, :, 0] + 1j * quads[:, :, 2]
    z[:, h - 1 - q] = quads[:, :, 3] + 1j * quads[:, :, 1]
    v = x[:, kdct.makhoul_perm(n)]
    np.testing.assert_array_equal(z, v[:, 0::2] + 1j * v[:, 1::2])


@pytest.mark.parametrize("rows", [True, False])
def test_remnant_half_form_plain_matches_float64(rows):
    """The half-length form's plain version (kernel 23's remnant at even k
    and kernel 25) at k = 262, whose half length 128 * 131 has no radix
    plan: the bts2 column R2C, as the wide core runs it."""
    n = 128 * 262
    g = np.random.default_rng(7)
    x = g.standard_normal((2, n) if rows else (1, n, 2)).astype(np.float32)
    plain = kdct.dct2_nat_plain if rows else kdct.dct2_mid_plain
    got = plain(torch.from_numpy(x), 2.0)
    want = sfft.dct(x.astype(np.float64), type=2, axis=1)
    assert _rel(got, want) <= 2e-6


def test_wrapper_routes_on_the_cpu():
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.standard_normal((2, 768)).astype(np.float32))
    before = (kdct.dct2_nat.launches, kdct.dct2_nat.radix_launches)
    np.testing.assert_array_equal(kdct.dct2_nat(x, 2.0).numpy(),
                                  kdct.dct2_rows_radix_plain(x, 2.0).numpy())
    assert (kdct.dct2_nat.launches, kdct.dct2_nat.radix_launches) == before
    # a remnant length keeps the old plain version (the n-point form, k = 131)
    y = torch.from_numpy(g.standard_normal((1, 128 * 131)).astype(np.float32))
    assert kdct.dct_form(128 * 131) == ("npoint", 131)
    np.testing.assert_array_equal(kdct.dct2_nat_plain(y).numpy(),
                                  kdct._dct2_plain(y[:, :, None], None)[:, :, 0].numpy())
