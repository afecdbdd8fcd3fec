"""Kernel 19 (DCT-I along a middle axis, odd n = h + 1, h = 128 F) as
kernel 27's even-extension R2C on the radix column tile: its plain version
on the CPU against the JAX package's ``dct1_pallas_mid`` in interpret mode
and against float64 scipy, the scale it hands kernel 27, the lengths it
takes and its columns a tile.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 (the JAX
package at its "highest" tier); the float32 port against float64 scipy
within 2e-6 of the peak.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL_F64 = 2e-6


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


@pytest.mark.parametrize("n", [1153, 2049])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("cols", [128, 130])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_plain_matches_pallas(n, nb, cols, scale):
    x = _real((nb, n, cols), n + nb + cols + 5)
    got = krfft.dct1_mid_plain(torch.from_numpy(x), scale)
    assert got.dtype == torch.float32 and got.shape == (nb, n, cols)
    _close(got, ref_prfft.dct1_pallas_mid(jnp.asarray(x), scale))


@pytest.mark.parametrize("n", [1537, 20481])
def test_plain_matches_float64_oracle(n):
    """scale * Re R2C of the even extension is 2 * scale * the rustdct
    DCT-I, scipy's DCT-I at scale 1, on 2 columns."""
    sfft = pytest.importorskip("scipy.fft")
    x = _real((1, n, 2), n)
    _close(krfft.dct1_mid(torch.from_numpy(x), 1.0),
           sfft.dct(x.astype(np.float64), type=1, axis=1), TOL_F64)


@pytest.mark.parametrize("scale", [None, 1.0, 0.25, -3.0])
def test_scale_is_kernel_27s_at_twice_it(scale):
    """Kernel 27's DCT-I stores (s / 2) Re X; kernel 19 hands it s = 2 scale
    (the launch's scale mapping): the plain versions agree bit for bit."""
    x = torch.from_numpy(_real((2, 1153, 3), 11))
    s = 1.0 if scale is None else scale
    assert torch.equal(krfft.dct1_mid_plain(x, scale), kdct.dct_radix_plain(x, 1, 2.0 * s))


def test_every_routed_length_has_the_radix_tile():
    """The 146 lengths n = 1153 ... 20481 the routes send to kernel 19 (h =
    128 F, 9 <= F <= 160 with a plan) all take kernel 27's DCT-I on the
    radix column tile, never its dense product."""
    lengths = [128 * f + 1 for f in range(9, kfft.WIDE_MAX_F + 1) if kfft.core_f(128 * f)]
    assert len(lengths) == 146
    for n in lengths:
        assert kdct.dct_radix_len(n, 1) == n - 1, n


def test_columns_per_tile():
    """Kernel 18's rule at h: 8 columns at the 2049^2 x 257 solve's h = 2048
    (both shapes), 16 at h = 1152 and 1536 over many columns, one above
    h = 10240 (the read-only loads)."""
    assert krfft.dct1_mid_cols(2048, 2049, 257, 132) == 8
    assert krfft.dct1_mid_cols(2048, 1, 2049 * 257, 132) == 8
    assert krfft.dct1_mid_cols(1152, 1, 1 << 20, 132) == 16
    assert krfft.dct1_mid_cols(1536, 1, 1 << 20, 132) == 8
    assert krfft.dct1_mid_cols(20480, 1, 128, 132) == 1


def test_wrapper_on_cpu_counts_no_launch():
    before = (krfft.dct1_mid.launches, krfft.dct1_mid.radix_launches)
    x = torch.from_numpy(_real((1, 2049, 3), 4))
    assert torch.equal(krfft.dct1_mid(x, 0.5), krfft.dct1_mid_plain(x, 0.5))
    assert (krfft.dct1_mid.launches, krfft.dct1_mid.radix_launches) == before
