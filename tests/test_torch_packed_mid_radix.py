"""Kernel 18 (``r2c_packed_mid``, the packed R2C of DST-I's two streams
along a middle axis) on the radix core's column tile
(``csrc/rfft_mid_radix.cu``, kernel 16's kernel with a two-stream load and
the scale in its store), against the JAX package on the CPU, where the
wrapper runs its plain version ``r2c_packed_mid_plain``:

* the census: the route R2C_PACKED_MID (``nddst1`` along a middle axis)
  takes 153 lengths n = 255 ... 20479, each with streams of h = n + 1 =
  128 * F (F = 2 ... 160) that have a ``radix_plan`` and a column tile from
  ``packed_mid_cols`` that a block takes (h C <= 20480, at most 256 threads
  in the 16-element form and 512 above);
* the plain version against ``r2c_pallas_packed_mid`` in interpret mode at
  h = 256, 384 and 1024, the scales None and -0.5, B = 1 and 2, L = 128 and
  a ragged 130;
* the plain version against float64 numpy (the R2C of the interleaved
  column) at every 8th of the 153 half lengths;
* ``nddst1`` along a middle axis through the port against the JAX
  package's at n = 255, 383 and 1023, the route asserted;
* the wrapper on a CPU tensor: the plain version, no launch counted.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 2e-6 of max |numpy| against float64.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL64 = 2e-6
SMS = 132   # an H100 SXM's SMs
F32 = torch.float32


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


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@lru_cache(maxsize=None)
def _k18():
    """The lengths n < 20480 whose float32 DST-I along axis 1 of
    (1, n, 130) takes kernel 18 on a CUDA tensor."""
    return tuple(n for n in range(2, kfft.GENERIC_MAX_N)
                 if api._route("dst1", (1, n, 130), 1, F32, "cuda") == api.R2C_PACKED_MID)


# --------------------------------------------------------------------------
# The census
# --------------------------------------------------------------------------


def test_census_of_kernel18():
    k18 = _k18()
    assert len(k18) == 153 and (k18[0], k18[-1]) == (255, 20479)
    for n in k18:
        h = n + 1
        assert h % 128 == 0 and 2 <= h // 128 <= 160 and kfft.core_f(h) == h // 128, n
        plan = kfft.radix_plan(h)
        assert plan is not None and int(np.prod(plan)) == h, n


@pytest.mark.parametrize("nb,cols", [(1, 130), (1023, 1023), (1, 1046529), (1, 1535),
                                     (2, 1 << 16)])
def test_columns_a_tile_fit_a_block(nb, cols):
    for n in _k18():
        h = n + 1
        c = krfft.packed_mid_cols(h, nb, cols, SMS)
        assert c >= 1 and c & (c - 1) == 0 and h * c <= kfft.RADIX_MAX_ELEMS, (h, c)
        assert kfft.radix_cols_threads(h, c) <= (
            kfft.RADIX_MAX_THREADS if h * c <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS)


def test_columns_a_tile_of_the_main_shapes():
    """The counts that ran fastest, or within 9% of the fastest, on an H100
    (time_kernels.py --scan-cols): below h = 1024 kernel 16's rule (16 at
    h = 256, 8 at 384 and 512, 4 at 768); from h = 1024 on the widest tile
    up to 16 columns (16 at the Dirichlet solve's h = 1024, 8 at 1536 and
    2048, 4 at 4096, 2 at 8192); fewer where the grid would leave SMs idle."""
    for h, c in ((256, 16), (384, 8), (512, 8), (768, 4), (1024, 16), (1536, 8), (2048, 8),
                 (4096, 4), (8192, 2), (20480, 1)):
        assert krfft.packed_mid_cols(h, 1, (1 << 27) // h, SMS) == c, h
        assert krfft.packed_mid_cols(h, h, h - 1, SMS) == c, h
    assert krfft.packed_mid_cols(1024, 1, 1046529, SMS) == 16
    assert krfft.packed_mid_cols(10240, 1, 130, SMS) == 1


# --------------------------------------------------------------------------
# The plain version against the Pallas kernel and float64 numpy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h", [256, 384, 1024])
@pytest.mark.parametrize("scale", [None, -0.5])
@pytest.mark.parametrize("nb,cols", [(1, 128), (2, 130)])
def test_plain_matches_r2c_pallas_packed_mid(h, scale, nb, cols):
    xe = _real((nb, h, cols), h + nb + cols)
    xo = _real((nb, h, cols), h + nb + cols + 1)
    sr, si = ref_prfft.r2c_pallas_packed_mid(jnp.asarray(xe), jnp.asarray(xo), 2 * h,
                                             1.0 if scale is None else scale)
    got = krfft.r2c_packed_mid(torch.from_numpy(xe), torch.from_numpy(xo), scale)
    assert got.dtype == torch.complex64 and got.shape == (nb, h + 1, cols)
    _close(got, np.asarray(sr) + 1j * np.asarray(si))


@pytest.mark.parametrize("i", range(0, 153, 8))
def test_plain_matches_float64(i):
    h = _k18()[i] + 1
    xe, xo = _real((1, h, 3), h), _real((1, h, 3), h + 1)
    col = np.stack([xe, xo], axis=2).reshape(1, 2 * h, 3).astype(np.float64)
    got = krfft.r2c_packed_mid_plain(torch.from_numpy(xe), torch.from_numpy(xo), -0.5)
    _close(got, -0.5 * np.fft.rfft(col, axis=1), TOL64)


# --------------------------------------------------------------------------
# DST-I along a middle axis through the public function
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [255, 383, 1023])
@pytest.mark.parametrize("axis", [0, 1])
def test_nddst1_along_a_middle_axis_matches_the_jax_package(n, axis):
    shape = (n, 3, 130) if axis == 0 else (2, n, 130)
    assert api._route("dst1", shape, axis, F32, "cuda") == api.R2C_PACKED_MID
    x = _real(shape, n + axis)
    got = nd.nddst1(torch.from_numpy(x), nd.DstHandler(n), axis=axis)
    want = ref.nddst1(jnp.asarray(x), ref.DstHandler(n), axis=axis)
    assert got.dtype == F32 and got.shape == shape
    _close(got, want)


# --------------------------------------------------------------------------
# The wrapper on a CPU tensor
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h", [256, 1536, 20480])
def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch(h):
    xe = torch.from_numpy(_real((1, h, 3), h))
    xo = torch.from_numpy(_real((1, h, 3), h + 1))
    before = (krfft.r2c_packed_mid.launches, krfft.r2c_packed_mid.radix_launches)
    assert torch.equal(krfft.r2c_packed_mid(xe, xo, -0.5),
                       krfft.r2c_packed_mid_plain(xe, xo, -0.5))
    assert (krfft.r2c_packed_mid.launches, krfft.r2c_packed_mid.radix_launches) == before
    assert not hasattr(krfft.r2c_packed_mid, "wide_launches")
