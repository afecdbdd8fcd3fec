"""Kernel 26 on the radix column tile (the DCT-III along a middle axis as
kernel 27's Makhoul C2R at half length h = n/2, past kernel 27's
n <= 1100), on the CPU, where the wrapper runs its plain version:

* ``dct3_mid`` (its plain version ``dct_radix_plain(x, 3)``) against
  ``dct3_pallas_mid`` (the JAX package's ``_dct3_kernel_mid``) in interpret
  mode and against scipy's DCT-III in float64, along axis 1 of (2, n, 3) at
  n = 1152 (odd k), 1280, 1536 and 2048, with scale 1/n and unscaled;
* the public ``nddct3`` / ``nddst3`` along axis 1 of (2, n, 128) at the same
  lengths against the JAX package (three columns take the engine's route;
  128 reach kernel 26);
* a remnant length, k = 131 (n = 16768, L = 1; no radix plan of 64 k: the
  n-point form), against float64;
* the form function at all 288 lengths of ``dct_form``: the radix column
  tile at the 259 whose h has a plan, the old forms at the 29 others, and
  the tile's column count (kernel 25's ``dct2_mid_cols``) at the main
  shapes;
* the wrapper's CPU route.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 2e-6 of the peak against float64.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.api import _jitted
from ndrustfft_tpu.ops.pallas import dct as ref_pdct

import ndrustfft_tpu_torch as port
from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops import engine
from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
F32 = torch.float32
LENGTHS = [1152, 1280, 1536, 2048]
# the 29 lengths n = 128 k whose half length 64 k has no radix plan
REMNANT_K = (131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211,
             223, 227, 229, 233, 239, 241, 251, 262, 274, 278, 298, 302, 314)


@pytest.fixture(scope="module", autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    _jitted.cache_clear()
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old
    _jitted.cache_clear()


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _scale(scale, n):
    return 1.0 / n if scale == "1/n" else None


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("scale", ["1/n", None])
def test_radix_plain_matches_pallas_and_float64(n, scale):
    s = _scale(scale, n)
    x = np.random.default_rng(n + 3).standard_normal((2, n, 3)).astype(np.float32)
    got = kdct.dct3_mid(torch.from_numpy(x), s)          # CPU: the plain version
    assert got.dtype == F32 and got.shape == (2, n, 3)
    np.testing.assert_array_equal(got.numpy(),
                                  kdct.dct_radix_plain(torch.from_numpy(x), 3, s).numpy())
    assert _rel(got, ref_pdct.dct3_pallas_mid(jnp.asarray(x), s)) <= TOL
    want = sfft.dct(x.astype(np.float64), type=3, axis=1) * ((1.0 if s is None else s) / 2)
    assert _rel(got, want) <= 2e-6          # rustdct = scipy / 2


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", ["nddct3", "nddst3"])
def test_public_mid_matches_reference(n, name):
    shape = (2, n, 128)
    for device_type in ("cpu", "cuda"):
        assert api._route(name[2:], shape, 1, F32, device_type) == api.DCT3_MID
    assert api._route(name[2:], (2, n, 3), 1, F32, "cuda") == api.ENGINE
    rh = (ref.DctHandler if "dct" in name else ref.DstHandler)(n)
    ph = (port.DctHandler if "dct" in name else port.DstHandler).from_reference(rh)
    x = np.random.default_rng(n + 5).standard_normal(shape).astype(np.float32)
    counts = engine.c2c.calls, kdct.dct3_mid.launches, kdct.dct3_mid.radix_launches
    got = getattr(port, name)(torch.from_numpy(x), ph, axis=1)
    assert got.dtype == F32
    assert _rel(got, getattr(ref, name)(jnp.asarray(x), rh, axis=1)) <= TOL
    # a CPU tensor: the kernel's plain version, no launch, no engine
    assert (engine.c2c.calls, kdct.dct3_mid.launches, kdct.dct3_mid.radix_launches) == counts


def test_remnant_length_matches_float64():
    n = 128 * 131
    assert kdct.launch_form(n, True, False) == "npoint"
    x = np.random.default_rng(131).standard_normal((1, n, 1)).astype(np.float32)
    got = kdct.dct3_mid(torch.from_numpy(x), 1.0 / n)
    want = sfft.dct(x.astype(np.float64), type=3, axis=1) / (2 * n)
    assert _rel(got, want) <= 2e-6


def test_form_at_every_length():
    ns = [n for n in range(128, 128 * 321, 128) if kdct.dct_form(n) is not None]
    assert len(ns) == 288
    radix = [n for n in ns if kdct.launch_form(n, True, False) == "radix"]
    assert len(radix) == 259
    assert radix == [n for n in ns if kdct.dct_radix_len(n, 3) is not None]
    rest = sorted(set(ns) - set(radix))
    assert rest == [128 * k for k in REMNANT_K]
    assert [kdct.launch_form(n, True, False) for n in rest] == ["npoint"] * 23 + ["wide"] * 6
    # the fixed core's lengths (h = 128 F, F = 2, 4, 8, 16) are radix ones now
    assert [kdct.launch_form(256 * f, True, False) for f in kfft.CORE_F if f > 1] == \
        ["radix"] * 4


def test_column_counts_at_the_main_shapes():
    """dct2_mid_cols at the shapes the main paths give kernel 26 on an H100
    (132 SMs), kernel 25's rule, the fastest counts of time_kernels.py
    --scan-dct-mid but at (1, 2048, 2048), where 16 ran 7% faster than the
    grid rule's 8: each a power of two whose tile fits a block."""
    for (nb, n, cols), c in (((1, 1536, 1536 * 1536), 16), ((1536, 1536, 1536), 16),
                             ((1, 2048, 2048), 8), ((1, 1152, 1152), 4),
                             ((1, 31104, 31104), 1)):
        h = n // 2
        got = kdct.dct2_mid_cols(h, nb, cols, 132)
        assert got == c, (n, got)
        assert h * got <= kfft.RADIX_MAX_ELEMS
        assert kfft.radix_cols_threads(h, got) <= 2 * kfft.RADIX_MAX_THREADS


def test_wrapper_routes_on_the_cpu():
    g = np.random.default_rng(8)
    x = torch.from_numpy(g.standard_normal((1, 1536, 4)).astype(np.float32))
    before = (kdct.dct3_mid.launches, kdct.dct3_mid.radix_launches)
    np.testing.assert_array_equal(kdct.dct3_mid(x, 0.5).numpy(),
                                  kdct.dct_radix_plain(x, 3, 0.5).numpy())
    assert (kdct.dct3_mid.launches, kdct.dct3_mid.radix_launches) == before
    # a remnant length keeps the old plain version (the n-point form, k = 131)
    y = torch.from_numpy(g.standard_normal((1, 128 * 131, 2)).astype(np.float32))
    np.testing.assert_array_equal(kdct.dct3_mid_plain(y).numpy(),
                                  kdct._dct3_plain(y, None).numpy())
