"""Kernels 16 and 20 on the radix core's column tile
(``csrc/rfft_mid_radix.cu``): their plain version ``r2c_mid_radix_plain``
against the JAX package's Pallas kernels in interpret mode and against
float64 numpy, the census of the lengths each form takes, the columns a
tile, and the wrappers on a CPU tensor.

* ``r2c_pallas_mid`` (kernel 16's TPU kernel) at n = 512, 768, 1024, 1280;
* ``r2c_dense_pallas_mid`` (kernel 20's) at n = 4, 5, 8, 128, 129, 200, 255,
  256, 264, 1095, 1100 (odd n: the C2C of (x, 0), half its bins kept);
* ``numpy.fft.rfft`` in float64 at every 7th of kernel 20's 768 lengths on
  the radix column tile and every 5th of kernel 16's 153;
* the census: kernel 20's route takes 1094 lengths, 768 with a radix plan of
  their transform length (436 even at h = n/2, 332 odd at n) and 326 without
  (a prime factor above 127), which keep the dense product; kernel 16's 153
  lengths all have one;
* on a CPU tensor each wrapper runs the plain version of the form the card
  would run, and counts no launch.

Ragged L (130, 200) and B > 1 throughout. Tolerance: max |port - JAX| <=
5e-6 * max |JAX| at the JAX package's "highest" tier; 2e-6 of max |numpy|
against float64.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import rfft as ref_rfft

from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft
from ndrustfft_tpu_torch.plan import prime_factors

torch.set_num_threads(1)

TOL = 5e-6
TOL64 = 2e-6


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol=TOL):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@lru_cache(maxsize=None)
def _lengths(route: str, top: int):
    """The lengths n <= top whose float32 R2C along axis 1 of (1, n, 130)
    takes ``route`` on a CUDA tensor."""
    return tuple(n for n in range(2, top + 1)
                 if api._route("r2c", (1, n, 130), 1, torch.float32, "cuda") == route)


def _k20():
    return _lengths(api.R2C_DENSE_MID, krfft.DENSE_MAX_N)


def _k16():
    return _lengths(api.R2C_MID, 2 * kfft.GENERIC_MAX_N)


@lru_cache(maxsize=None)
def _k20_radix():
    return tuple(n for n in _k20() if krfft.r2c_mid_radix(n))


# --------------------------------------------------------------------------
# The plain version against the Pallas kernels and float64 numpy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 512, 130), (2, 768, 200), (2, 1024, 130),
                                   (1, 1280, 200)])
def test_plain_matches_r2c_pallas_mid(shape):
    """Kernel 16 at F = 2, 3, 4, 5."""
    x = _real(shape, sum(shape))
    sr, si = ref_rfft.r2c_pallas_mid(jnp.asarray(x), ref_plan.get_r2c_plan(shape[1]))
    got = krfft.r2c_mid_radix_plain(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    _close(got.numpy(), np.asarray(sr) + 1j * np.asarray(si))


@pytest.mark.parametrize("n", [4, 5, 8, 128, 129, 200, 255, 256, 264, 1095, 1100])
def test_plain_matches_r2c_dense_pallas_mid(n):
    """Kernel 20 at the half length (even n) and at n (odd n: 5, 129 = 3 *
    43, 255 = 3 * 5 * 17, 1095 = 3 * 5 * 73, with prime stages)."""
    assert krfft.r2c_mid_radix(n)
    shape = (2, n, 130 if n % 2 else 200)
    x = _real(shape, 7 * n)
    sr, si = ref_rfft.r2c_dense_pallas_mid(jnp.asarray(x), ref_plan.get_r2c_plan(n))
    got = krfft.r2c_mid_radix_plain(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (2, n // 2 + 1, shape[2])
    _close(got.numpy(), np.asarray(sr) + 1j * np.asarray(si))


@pytest.mark.parametrize("i", range(0, 768, 7))
def test_plain_matches_float64_at_kernel20_lengths(i):
    n = _k20_radix()[i]
    x = _real((2, n, 130), n)
    got = krfft.r2c_mid_radix_plain(torch.from_numpy(x))
    _close(got.numpy(), np.fft.rfft(x.astype(np.float64), axis=1), TOL64)


@pytest.mark.parametrize("i", range(0, 153, 5))
def test_plain_matches_float64_at_kernel16_lengths(i):
    n = _k16()[i]
    x = _real((1, n, 3), n + 1)
    got = krfft.r2c_mid_radix_plain(torch.from_numpy(x))
    _close(got.numpy(), np.fft.rfft(x.astype(np.float64), axis=1), TOL64)


# --------------------------------------------------------------------------
# The census of the two forms
# --------------------------------------------------------------------------


def test_census_of_kernel20():
    """1094 lengths 4 ... 1100: every one but 512, 768 and 1024 (kernel
    16's); the radix column tile iff radix_plan has the transform length."""
    k20 = _k20()
    assert len(k20) == 1094 and (k20[0], k20[-1]) == (4, 1100)
    assert set(range(4, 1101)) - set(k20) == {512, 768, 1024}
    radix = _k20_radix()
    assert (len(radix), len(k20) - len(radix)) == (768, 326)
    assert (sum(n % 2 == 0 for n in radix), sum(n % 2 for n in radix)) == (436, 332)
    for n in k20:
        length = n if n % 2 else n // 2
        assert krfft.r2c_mid_len(n) == length
        assert krfft.r2c_mid_radix(n) == (kfft.radix_plan(length) is not None), n
        if n not in radix:
            assert max(prime_factors(length)) > kfft.RADIX_MAX_P, n
    no_plan = [n for n in k20 if n not in radix]
    assert (sum(n % 2 == 0 for n in no_plan), no_plan[:3]) == (110, [131, 137, 139])


def test_census_of_kernel16():
    """153 lengths 512 ... 40960 (h = 128 * F with a plan), each with a radix
    plan of h."""
    k16 = _k16()
    assert len(k16) == 153 and (k16[0], k16[-1]) == (512, 40960)
    assert all(n % 256 == 0 and krfft.r2c_mid_radix(n) for n in k16)
    assert all(kfft.radix_plan(n // 2) is not None for n in k16)


def test_columns_a_tile():
    """radix_mid_cols at the transform length; every tile of both routes'
    lengths fits a block (at most 20480 elements, 256 threads in the
    16-element form, 512 above)."""
    for n in _k20_radix() + _k16():
        length = krfft.r2c_mid_len(n)
        for nb, cols in ((1, 130), (1, 1 << 18), (512, 512)):
            c = krfft.r2c_mid_cols(n, nb, cols, 132)
            assert c == kfft.radix_mid_cols(length, nb, cols, 132)
            assert c & (c - 1) == 0 and length * c <= kfft.RADIX_MAX_ELEMS
            assert kfft.radix_cols_threads(length, c) <= (
                kfft.RADIX_MAX_THREADS if length * c <= kfft.RADIX_WIDE_N else 512)
    # kernel 4's rule: a tile row of at least one 128-byte line of floats at
    # the short columns (32 columns at h = 128, 16 at h = 256 and n = 129),
    # 4 at h = 640 (F = 5): the counts that ran fastest on an H100
    assert krfft.r2c_mid_cols(256, 1, 65536, 132) == 32
    assert krfft.r2c_mid_cols(512, 1, 262144, 132) == 16
    assert krfft.r2c_mid_cols(512, 512, 512, 132) == 16
    assert krfft.r2c_mid_cols(129, 1, 65536, 132) == 16
    assert krfft.r2c_mid_cols(1280, 1, 1280, 132) == 4


# --------------------------------------------------------------------------
# The wrappers on a CPU tensor
# --------------------------------------------------------------------------


def _counts():
    return [(f.launches, f.radix_launches, getattr(f, "chirp_launches", 0))
            for f in (krfft.r2c_mid, krfft.r2c_dense_mid)]


@pytest.mark.parametrize("n", [512, 1280, 4, 129, 200, 256, 264, 262, 1097])
def test_wrappers_on_cpu_run_the_plain_version_of_their_form(n):
    """r2c_mid at every length runs r2c_mid_radix_plain, and r2c_dense_mid
    the plain version of the kernel that rfft.py::r2c_dense_form names (at
    262 = 2 * 131 and 1097, prime, no plan exists); no launch is counted."""
    x = torch.from_numpy(_real((2, n, 130), n + 2))
    before = _counts()
    fn = krfft.r2c_mid if n in _k16() else krfft.r2c_dense_mid
    want = (krfft.r2c_mid_radix_plain if fn is krfft.r2c_mid
            else krfft._R2C_DENSE_PLAIN[krfft.r2c_dense_form(n)])(x)
    assert torch.equal(fn(x), want)
    assert krfft.r2c_mid_radix(n) == (n not in (262, 1097))
    assert _counts() == before
