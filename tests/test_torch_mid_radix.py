"""Kernels 4 and 11 on the mixed-radix core's column tile, against the JAX
package on the CPU, where the wrappers run their plain versions:

* every length that the route C2C_DENSE_MID takes (412 lengths, 2 ... 511)
  and every Bluestein length of kernel 11 at F in {4, 8, 16} (57 lengths,
  M = 512, 1024, 2048) has a ``radix_plan``, and ``radix_mid_cols`` (for
  kernel 11 ``blue_radix_cols``) gives it a tile in the 16-element form
  (n C <= 4096, at most 256 threads), at least one 128-byte line a tile row
  for kernel 4 at n <= 256;
* kernel 4's plain version (the radix core's, on the moved columns)
  against ``c2c_pallas_axis_mid``'s dense body in interpret mode at the
  "highest" tier, at n = 2, 3, 15, 17, 129, 200, 256, 264 and 511, both
  signs, with and without the scale 1/n, at ragged column counts;
* kernel 11's plain version against ``c2c_pallas_axis_mid_blue`` in
  interpret mode at n = 193, 509 and 1021 (F = 4, 8, 16);
* the wrappers on a CPU tensor: the plain version, no launch counted; a
  length without a plan raises.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| (each side ~5e-7 against a
float64 oracle at these lengths).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
SMS = 132   # an H100 SXM's SMs


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


def _route(n):
    return api._route("fft", (1, n, 130), 1, torch.complex64, "cuda")


def _tile_ok(mk, c):
    """A tile of c columns of length mk in the 16-element form."""
    return (c & (c - 1)) == 0 and mk * c <= kfft.RADIX_WIDE_N and \
        kfft.radix_cols_threads(mk, c) <= kfft.RADIX_MAX_THREADS


def test_kernel_4_lengths_have_a_plan_and_a_tile():
    lengths = [n for n in range(2, 2049) if _route(n) == api.C2C_DENSE_MID]
    assert len(lengths) == 412 and lengths[0] == 2 and lengths[-1] == 511
    for n in lengths:
        assert kfft.radix_plan(n) is not None, n
        c = kfft.radix_mid_cols(n, 1, 1 << 20, SMS)
        assert _tile_ok(n, c) and c <= kfft.RADIX_MID_MAX_C, (n, c)
        # the widest tile that fits, up to the cap: a tile row of at least one
        # 128-byte line (16 columns) at n <= 256
        assert c == kfft.RADIX_MID_MAX_C or not _tile_ok(n, 2 * c), (n, c)
        assert n > 256 or c >= 16, (n, c)


def test_kernel_11_fixed_lengths_have_a_plan_and_a_tile():
    lengths = [n for n in range(129, 2049)
               if _route(n) == api.C2C_BLUE_MID and kfft.blue_f(n) in kfft.C2C_F]
    by_f = {f: [n for n in lengths if kfft.blue_f(n) == f] for f in kfft.C2C_F}
    assert {f: len(v) for f, v in by_f.items()} == {4: 11, 8: 21, 16: 25}
    assert (by_f[4][0], by_f[4][-1], by_f[8][0], by_f[8][-1], by_f[16][0], by_f[16][-1]) == \
        (193, 251, 449, 509, 964, 1021)
    # radix_mid_cols's rule gives 8, 4, 2 columns (the widest tile in the
    # 16-element form); kernel 11 takes 4, 2, 2 (blue_radix_cols), which ran
    # faster on an H100 at M = 512 and 1024
    for f, rule, c in ((4, 8, 4), (8, 4, 2), (16, 2, 2)):
        mk = kfft.M * f
        assert kfft.radix_plan(mk) == (16, 16, f // 2)
        assert kfft.radix_mid_cols(mk, 1, 259081, SMS) == rule
        assert _tile_ok(mk, rule) and not _tile_ok(mk, 2 * rule)
        assert kfft.blue_radix_cols(mk, 1, 259081, SMS) == c
    assert kfft.blue_radix_cols(1024, 1, 130, SMS) == 1         # 130 tiles of 1: fills 132 SMs
    assert kfft.blue_radix_cols(2176, 1, 1024, SMS) == kfft.radix_mid_cols(2176, 1, 1024, SMS)


@pytest.mark.parametrize("mk,groups,cols,want", [
    (256, 1, 65536, 16),     # the 256^3 paths' (1, 256, 65536), 16 columns of 256
    (256, 256, 129, 16),     # (256, 256, 129): 9 tiles of 14 or 15 columns a b
    (256, 1, 33024, 16),     # the one-column tail (1, 256, 33024)
    (128, 1, 16384, 32),
    (17, 1, 1 << 20, 32),    # the cap
    (2, 1, 1 << 20, 32),     # one thread a column
    (264, 1, 264, 2),        # fft2d at 264: 33 tiles of 8, halved to 132 tiles of 2
    (511, 1, 1 << 20, 8),
    (128, 1, 128, 1),        # fft2d at 128: at most 128 tiles, one column each
])
def test_radix_mid_cols_at_kernel_4_shapes(mk, groups, cols, want):
    assert kfft.radix_mid_cols(mk, groups, cols, SMS) == want


@pytest.mark.parametrize("n", [2, 3, 15, 17, 129, 200, 256, 264, 511])
@pytest.mark.parametrize("sign,scale", [(-1, None), (+1, None), (+1, "inv_n")])
def test_kernel_4_plain_matches_the_pallas_dense_body(n, sign, scale):
    assert _route(n) == api.C2C_DENSE_MID
    s = 1.0 / n if scale else None
    cols = 131 if n % 2 else 129
    x = _cplx((2, n, cols), n * 7 + sign)
    got = kfft.c2c_dense_mid(torch.from_numpy(x), sign, s)      # CPU: the plain version
    assert got.dtype == torch.complex64 and got.shape == x.shape
    assert torch.equal(got, kfft.c2c_radix_mid_plain(torch.from_numpy(x), sign, s))
    yr, yi = ref_pfft.c2c_pallas_axis_mid(jnp.asarray(x.real), jnp.asarray(x.imag),
                                          ref_plan.get_c2c_plan(n, sign), s)
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


@pytest.mark.parametrize("n", [193, 509, 1021])
@pytest.mark.parametrize("sign,scale", [(-1, None), (+1, "inv_n")])
def test_kernel_11_plain_matches_pallas_at_the_fixed_factors(n, sign, scale):
    assert kfft.blue_f(n) in kfft.C2C_F and _route(n) == api.C2C_BLUE_MID
    s = 1.0 / n if scale else None
    x = _cplx((2, n, 5), n + sign)
    got = kfft.c2c_blue_mid(torch.from_numpy(x), sign, s)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    yr, yi = ref_pfft.c2c_pallas_axis_mid_blue(jnp.asarray(x.real), jnp.asarray(x.imag),
                                               ref_plan.get_c2c_plan(n, sign), s)
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    fns = (kfft.c2c_dense_mid, kfft.c2c_blue_mid)
    before = [(f.launches, f.radix_launches) for f in fns]
    x = torch.from_numpy(_cplx((1, 200, 7), 5))
    assert torch.equal(kfft.c2c_dense_mid(x, -1), kfft.c2c_generic_mid_plain(x, -1))
    x = torch.from_numpy(_cplx((1, 509, 7), 6))
    assert torch.equal(kfft.c2c_blue_mid(x, +1, 0.5), kfft.c2c_blue_mid_plain(x, +1, 0.5))
    assert [(f.launches, f.radix_launches) for f in fns] == before


@pytest.mark.parametrize("n", [262, 513, 1])     # a prime stage 131 > 127; too long; no plan
def test_kernel_4_raises_without_a_radix_plan(n):
    with pytest.raises(ValueError):
        kfft.c2c_dense_mid(torch.zeros(1, n, 3, dtype=torch.complex64), -1)
