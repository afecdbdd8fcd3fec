"""Kernel 11 on the mixed-radix core's column tile (Bluestein's fused chirp-z
along a middle axis at a convolution length M = 128 * F, F outside
{4, 8, 16}) against the JAX package and numpy on the CPU, where the wrapper
runs its plain version:

* the plain version (the radix core's plain forward and inverse on each
  zero-padded column) against ``c2c_pallas_axis_mid_blue`` in interpret
  mode at the "highest" tier, at n = 131, 1031 and 2049 (F = 3, 17, 33),
  both signs, with and without the scale 1/n, at a ragged column count;
* the plain version against float64 numpy at n = 6781 (F = 106, the routes'
  largest) and at lengths whose M has a prime stage (F = 11, 13, 53);
* ``radix_plan(128 * F)`` for every F the route C2C_BLUE_MID sends to the
  radix form (101 values): it exists, has at most 8 stages and multiplies
  to M; the column tile of every such F fits a block;
* the wrapper on a CPU tensor: the plain version, no launch counted.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| (each side ~5e-7 against a
float64 oracle); 2e-6 against float64 numpy (float32 sums over at most
eight stages per direction).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.plan import factorize

torch.set_num_threads(1)

TOL = 5e-6
TOL_ORACLE = 2e-6


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _route_f():
    """{F: (smallest n, largest n)} of the Bluestein lengths that the route
    C2C_BLUE_MID sends to kernel 11's radix form (a prime factor above 128,
    the JAX kernel's bound, F outside {4, 8, 16})."""
    ends = {}
    for n in range(129, kfft.GENERIC_MAX_N + 1):
        if factorize(n) is None and api._blue_mid_ok(n):
            f = kfft.blue_f(n)
            if f not in kfft.C2C_F:
                lo, _ = ends.get(f, (n, n))
                ends[f] = (lo, n)
    return ends


def _radix_plain(x, sign, scale):
    """kernel 11's radix plain version, called by the route's wrapper."""
    return kfft.c2c_blue_mid_plain(torch.from_numpy(x), sign, scale)


@pytest.mark.parametrize("n", [131, 1031, 2049])
@pytest.mark.parametrize("sign,scale", [(-1, None), (+1, None), (-1, "inv_n"), (+1, "inv_n")])
def test_plain_matches_pallas(n, sign, scale):
    f = kfft.blue_f(n)
    assert f not in kfft.C2C_F and kfft.radix_plan(128 * f) is not None
    s = 1.0 / n if scale else None
    x = _cplx((2, n, 7), n + sign)
    got = _radix_plain(x, sign, s)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    yr, yi = ref_pfft.c2c_pallas_axis_mid_blue(jnp.asarray(x.real), jnp.asarray(x.imag),
                                               ref_plan.get_c2c_plan(n, sign), s)
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


def test_plain_runs_the_radix_convolution():
    """At every F the plain version is the radix form's chirp-z: at F = 17
    and at F = 8, which ran the bts2 core's until kernel 11 left it."""
    x = torch.from_numpy(_cplx((1, 1031, 3), 1))
    a, h = kfft._device_blue(1031, -1, x.device)
    want = kfft.chirp_z_radix_plain(x * a[:, None], h, 1.0) * a[:, None]
    assert torch.equal(kfft.c2c_blue_mid_plain(x, -1), want)
    x = torch.from_numpy(_cplx((1, 509, 3), 2))
    a, h = kfft._device_blue(509, -1, x.device)
    want = kfft.chirp_z_radix_plain(x * a[:, None], h, 1.0) * a[:, None]
    assert torch.equal(kfft.c2c_blue_mid_plain(x, -1), want)


@pytest.mark.parametrize("n", [6781, 647, 773, 3331])
def test_plain_matches_float64(n):
    """F = 106 (plan 16, 16, 53), 11 (16, 8, 11), 13 (16, 8, 13) and 53
    (16, 8, 53): the prime stage on the column's last pass."""
    f = kfft.blue_f(n)
    assert f in (106, 11, 13, 53) and max(kfft.radix_plan(128 * f)) > 7
    x = _cplx((1, n, 3), n)
    x64 = x.astype(np.complex128)
    _close(_radix_plain(x, -1, None), np.fft.fft(x64, axis=1), TOL_ORACLE)
    _close(_radix_plain(x, +1, 1.0 / n), np.fft.ifft(x64, axis=1), TOL_ORACLE)


def test_plan_for_every_route_f():
    ends = _route_f()
    assert len(ends) == 101 and min(ends) == 3 and max(ends) == 106
    assert ends[17] == (1028, 1087) and ends[106] == (6722, 6782)
    for f in ends:
        mk = 128 * f
        plan = kfft.radix_plan(mk)
        assert plan is not None and 1 <= len(plan) <= kfft.RADIX_MAX_STAGES, f
        assert math.prod(plan) == mk and len(plan) <= 5, (f, plan)


def test_column_tiles_fit_a_block():
    """For every F the route sends: the tile's elements, threads (256 at 16
    elements a thread, 512 at 32 or 40) and shared memory (the tile with one
    float2 of padding per 16 and the prime rows) fit; up to M = 4096 the
    tile keeps 16 elements a thread, above it one to four columns."""
    for f in _route_f():
        mk = 128 * f
        c = kfft.radix_mid_cols(mk, 1, 10 ** 6, 132)
        elems = mk * c
        assert elems <= kfft.RADIX_MAX_ELEMS
        assert kfft.radix_cols_threads(mk, c) <= (256 if elems <= kfft.RADIX_WIDE_N else 512)
        primes = sum(p for p in kfft.radix_plan(mk) if p not in kfft.RADIX_CODELETS)
        assert 8 * (elems + elems // 16 + 1 + primes) <= kfft.MAX_SMEM
        assert (elems <= kfft.RADIX_WIDE_N) == (mk <= kfft.RADIX_WIDE_N), (f, c)
        assert c == 8 or mk * 2 * c > (kfft.RADIX_WIDE_N if mk <= kfft.RADIX_WIDE_N else
                                       kfft.RADIX_MAX_ELEMS), (f, c)
    assert kfft.radix_mid_cols(2176, 1, 1024, 132) == 1
    assert kfft.radix_mid_cols(384, 1, 1024, 132) == 4       # 128 tiles of 8: halved
    assert kfft.radix_mid_cols(384, 2, 1024, 132) == 8
    assert kfft.radix_mid_cols(4224, 1, 1024, 132) == 4
    assert kfft.radix_mid_cols(13568, 1, 1024, 132) == 1
    assert kfft.radix_mid_cols(384, 2, 130, 132) == 1        # halved to fill 132 SMs


def test_wrapper_on_cpu_runs_the_plain_version():
    before = (kfft.c2c_blue_mid.launches, kfft.c2c_blue_mid.radix_launches)
    x = torch.from_numpy(_cplx((2, 131, 5), 3))
    assert torch.equal(kfft.c2c_blue_mid(x, +1, 0.5), kfft.c2c_blue_mid_plain(x, +1, 0.5))
    assert (kfft.c2c_blue_mid.launches, kfft.c2c_blue_mid.radix_launches) == before
