"""The real spectral step through the public functions: ndrustfft_tpu_torch
against ndrustfft_tpu (Pallas kernels in interpret mode, "highest" tier) on
the flagship 512^2 grid, with every normalization, handlers converted with
from_reference, the error strings, and the torch engine in float64.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| (each side measures
~7.5e-7 against a float64 oracle at this tier); float64 engine routes 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.api import _jitted

import ndrustfft_tpu_torch as port

torch.set_num_threads(1)

TOL = 5e-6
N = 512


@pytest.fixture(scope="module", autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    _jitted.cache_clear()
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old
    _jitted.cache_clear()


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.fixture(scope="module")
def grid():
    return np.random.default_rng(0).standard_normal((N, N)).astype(np.float32)


@pytest.fixture(scope="module")
def spectra(grid):
    """Forward spectrum of the flagship step from both packages."""
    want = ref.ndfft(ref.ndfft_r2c(jnp.asarray(grid), ref.R2cFftHandler(N), axis=1),
                     ref.FftHandler(N), axis=0)
    got = port.ndfft(port.ndfft_r2c(torch.from_numpy(grid), port.R2cFftHandler(N),
                                    axis=1), port.FftHandler(N), axis=0)
    return got, np.asarray(want)


def test_forward_spectrum_matches_reference(spectra, grid):
    got, want = spectra
    assert got.shape == (N, N // 2 + 1) and got.dtype == torch.complex64
    _close(got, want)
    oracle = np.fft.rfft2(grid.astype(np.float64), axes=(0, 1)).astype(np.complex64)
    _close(got, oracle)


_custom = port.Normalization.custom(lambda v: v * 0.5)
_ref_custom = ref.Normalization.custom(_custom.fn)


@pytest.mark.parametrize("norm", ["none", "default", "scalar", "custom"])
def test_inverse_step_matches_reference(spectra, grid, norm):
    rnorm = {"none": ref.Normalization.NONE, "default": ref.Normalization.DEFAULT,
             "scalar": ref.Normalization.scalar(0.5), "custom": _ref_custom}[norm]
    rhr = ref.R2cFftHandler(N).normalization(rnorm)
    rhc = ref.FftHandler(N).normalization(rnorm)
    hr = port.R2cFftHandler.from_reference(rhr)
    hc = port.FftHandler.from_reference(rhc)
    got_spec, want_spec = spectra
    want = ref.ndifft_r2c(ref.ndifft(jnp.asarray(want_spec), rhc, axis=0), rhr, axis=1)
    got = port.ndifft_r2c(port.ndifft(got_spec, hc, axis=0), hr, axis=1)
    assert got.dtype == torch.float32
    _close(got, want)
    if norm == "default":   # round trip
        _close(got, grid)


def test_size_mismatch_raises_the_reference_message():
    x = np.zeros((8, 6), np.complex64)
    with pytest.raises(ValueError) as want:
        ref.ndfft(jnp.asarray(x), ref.FftHandler(5), axis=1)
    with pytest.raises(ValueError) as got:
        port.ndfft(torch.from_numpy(x), port.FftHandler(5), axis=1)
    assert str(got.value) == str(want.value) == "Size mismatch in fft, got 6 expected 5"
    with pytest.raises(ValueError, match="Size mismatch in fft, got 6 expected 5"):
        port.ndifft_r2c(torch.from_numpy(x), port.R2cFftHandler(8), axis=1)
    with pytest.raises(TypeError, match="expects a real input"):
        port.ndfft_r2c(torch.from_numpy(x), axis=1)


@pytest.mark.parametrize("shape,axis", [((6, 10, 3), 1), ((7, 12), -1), ((9, 4), 0)])
def test_engine_routes_float64_match_reference(shape, axis):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    n = shape[axis]
    _close(port.ndfft(torch.from_numpy(x), axis=axis),
           ref.ndfft(jnp.asarray(x), axis=axis), 1e-12)
    _close(port.ndifft(torch.from_numpy(x), axis=axis),
           ref.ndifft(jnp.asarray(x), axis=axis), 1e-12)
    xr = x.real.copy()
    _close(port.ndfft_r2c(torch.from_numpy(xr), axis=axis),
           ref.ndfft_r2c(jnp.asarray(xr), axis=axis), 1e-12)
    spec = np.fft.rfft(xr, axis=axis)
    spec = spec + 1j * rng.standard_normal(spec.shape)   # non-Hermitian bins
    h = ref.R2cFftHandler(n).normalization(ref.Normalization.scalar(0.3))
    _close(port.ndifft_r2c(torch.from_numpy(spec), port.R2cFftHandler.from_reference(h),
                           axis=axis),
           ref.ndifft_r2c(jnp.asarray(spec), h, axis=axis), 1e-12)


def test_auto_handlers_and_input_promotion():
    x = np.arange(16, dtype=np.int32).reshape(2, 8)
    y = port.ndfft_r2c(torch.from_numpy(x))
    assert y.dtype == torch.complex64 and y.shape == (2, 5)
    back = port.ndifft_r2c(y)
    assert back.shape == (2, 8)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)
    z = port.ndfft(torch.ones(4, dtype=torch.float64), axis=0)
    assert z.dtype == torch.complex128 and abs(complex(z[0]) - 4.0) < 1e-12
    odd = port.ndifft_r2c(port.ndfft_r2c(torch.from_numpy(x[:, :7].astype(np.float64))),
                          n=7)
    np.testing.assert_allclose(odd.numpy(), x[:, :7], atol=1e-12)
