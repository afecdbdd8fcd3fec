"""Kernel 1 (``c2c_axis_mid``, the C2C along a middle axis at n = 128 * F)
on the radix core's column tile (``csrc/fft_mid_radix.cu``, kernel 6's
kernel), against the JAX package on the CPU, where the wrapper runs its
plain version ``c2c_radix_mid_plain``:

* the census: the route C2C_AXIS_MID takes 152 lengths, 384 ... 20480, each
  n = 128 * F with a ``radix_plan`` and a column tile from
  ``axis_mid_tile`` that a block takes (n C <= 20480, at most 256 threads
  in the 16-element form and 512 above);
* the plain version against ``c2c_pallas_axis_mid`` (its bts2 body) in
  interpret mode at n = 384, 512, 768, 1024, 2048 and 4096, both signs,
  the scales None, 1/n and 0.25, B = 2 and a ragged L = 130;
* the plain version against float64 numpy at every 8th of the 152 lengths;
* the folds' shape: a (1, n, cols) view at B = 1;
* the wrapper on a CPU tensor: the plain version, no launch counted; the
  lengths it does not take raise.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 2e-6 of max |numpy| against float64.
"""

from functools import lru_cache

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
TOL64 = 2e-6
SMS = 132   # an H100 SXM's SMs
C64 = torch.complex64


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


@lru_cache(maxsize=None)
def _k1():
    """The lengths n <= 20480 whose complex64 C2C along axis 1 of
    (1, n, 130) takes kernel 1 on a CUDA tensor."""
    return tuple(n for n in range(2, kfft.GENERIC_MAX_N + 1)
                 if api._route("fft", (1, n, 130), 1, C64, "cuda") == api.C2C_AXIS_MID)


# --------------------------------------------------------------------------
# The census
# --------------------------------------------------------------------------


def test_census_of_kernel1():
    k1 = _k1()
    assert len(k1) == 152 and (k1[0], k1[-1]) == (384, 20480)
    for n in k1:
        assert n % 128 == 0 and kfft.core_f(n) == n // 128, n
        plan = kfft.radix_plan(n)
        assert plan is not None and len(plan) <= kfft.RADIX_MAX_STAGES, n
        assert int(np.prod(plan)) == n


@pytest.mark.parametrize("nb,cols", [(1, 130), (1, 1 << 17), (768, 385), (1024, 513),
                                     (1, 4096), (257, 512)])
def test_columns_a_tile_fit_a_block(nb, cols):
    for n in _k1():
        c, ldg = kfft.axis_mid_tile(n, nb, cols, SMS)
        assert c >= 1 and c & (c - 1) == 0 and n * c <= kfft.RADIX_MAX_ELEMS, (n, c)
        assert kfft.radix_cols_threads(n, c) <= (
            kfft.RADIX_MAX_THREADS if n * c <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS)
        assert isinstance(ldg, bool) and (c <= 2 or not ldg)


def test_columns_a_tile_of_the_main_shapes():
    """The counts and loads that ran fastest, or within 8% of the fastest,
    on an H100 at the main paths' shapes (time_kernels.py --scan-cols): 8
    columns at n = 512 (16-element form), 4 at 768, 1024 and 4096, 2 at
    8192 and 1 at 20480 with the read-only load; fewer where the grid would
    leave SMs idle."""
    for shape, tile in (((1, 512, 131584), (8, False)), ((257, 512, 512), (8, False)),
                        ((768, 768, 385), (4, False)), ((1024, 1024, 513), (4, False)),
                        ((1, 2048, 65536), (4, False)), ((1, 4096, 4096), (4, False)),
                        ((1, 8192, 2048), (2, True)), ((1, 20480, 130), (1, True)),
                        ((1, 4096, 33), (1, True))):
        assert kfft.axis_mid_tile(shape[1], shape[0], shape[2], SMS) == tile, shape


# --------------------------------------------------------------------------
# The plain version against the Pallas kernel and float64 numpy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [384, 512, 768, 1024, 2048, 4096])
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("scale", [None, "inv_n", 0.25])
def test_plain_matches_c2c_pallas_axis_mid(n, sign, scale):
    assert ref_pfft.mid_kernel_kind(n) == "bts2"
    x = _cplx((2, n, 130), n + sign)
    s = 1.0 / n if scale == "inv_n" else scale
    got = kfft.c2c_axis_mid(torch.from_numpy(x), sign, s)      # CPU: the plain version
    assert got.dtype == C64 and got.shape == x.shape
    yr, yi = ref_pfft.c2c_pallas_axis_mid(jnp.asarray(x.real), jnp.asarray(x.imag),
                                          ref_plan.get_c2c_plan(n, sign), s)
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


@pytest.mark.parametrize("i", range(0, 152, 8))
def test_plain_matches_float64(i):
    n = _k1()[i]
    x = _cplx((1, n, 3), n)
    got = kfft.c2c_axis_mid_plain(torch.from_numpy(x), -1)
    _close(got, np.fft.fft(x.astype(np.complex128), axis=1), TOL64)


def test_plain_on_the_folds_view():
    """Kernel 9's (n, cols) as kernel 1's (1, n, cols) at n = 640 (F = 5)."""
    x = _cplx((640, 7), 5)
    got = kfft.c2c_axis_mid(torch.from_numpy(x).reshape(1, 640, 7), +1, 1 / 640)
    _close(got.reshape(640, 7), np.fft.ifft(x.astype(np.complex128), axis=0), TOL64)


# --------------------------------------------------------------------------
# The wrapper on a CPU tensor
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [384, 2048, 16256])
def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch(n):
    x = torch.from_numpy(_cplx((2, n, 5), n + 1))
    before = (kfft.c2c_axis_mid.launches, kfft.c2c_axis_mid.radix_launches)
    assert torch.equal(kfft.c2c_axis_mid(x, +1, 0.5), kfft.c2c_radix_mid_plain(x, +1, 0.5))
    assert (kfft.c2c_axis_mid.launches, kfft.c2c_axis_mid.radix_launches) == before
    assert not hasattr(kfft.c2c_axis_mid, "wide_launches")


@pytest.mark.parametrize("n", [200, 131 * 128, 161 * 128, 641])
def test_wrapper_rejects_what_the_kernel_does_not_take(n):
    with pytest.raises(ValueError):
        kfft.c2c_axis_mid(torch.zeros(1, n, 3, dtype=C64), -1)
