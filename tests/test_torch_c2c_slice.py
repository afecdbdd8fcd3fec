"""The complex n-D transform through the public functions: ndfft along every
axis, then ndifft back along every axis, ndrustfft_tpu_torch against
ndrustfft_tpu (Pallas kernels in interpret mode, "highest" tier) on small
2-D and 3-D complex64 arrays whose legs take kernels 1, 4, 8 and 10 (their
plain versions on the CPU), with every normalization and handlers converted
with from_reference; complex128 takes the torch engine on both sides.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in complex64 (each side
measures ~1e-6 against a float64 oracle at this tier), 1e-12 in complex128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.api import _jitted

import ndrustfft_tpu_torch as port
from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops import engine

torch.set_num_threads(1)

TOL = {np.complex64: 5e-6, np.complex128: 1e-12}

# the port's route of each leg on the CPU (the same as on a CUDA tensor)
SHAPES = {
    (128, 256): (api.C2C_DENSE_MID, api.C2C_DENSE_ROWS),
    (130, 1024): (api.C2C_DENSE_MID, api.C2C_ROWS),
    (8, 200, 130): (api.C2C_DENSE_MID, api.C2C_DENSE_MID, api.C2C_DENSE_ROWS),
    (512, 130): (api.C2C_AXIS_MID, api.C2C_DENSE_ROWS),
    (64, 128, 16): (api.C2C_DENSE_MID, api.C2C_DENSE_ROWS, api.C2C_DENSE_ROWS),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    _jitted.cache_clear()
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old
    _jitted.cache_clear()


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _field(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _forward(mod, x, handlers):
    for axis, h in enumerate(handlers):
        x = mod.ndfft(x, h, axis=axis)
    return x


def _inverse(mod, x, handlers):
    for axis in reversed(range(len(handlers))):
        x = mod.ndifft(x, handlers[axis], axis=axis)
    return x


@pytest.fixture(scope="module")
def spectra():
    """Forward spectrum of every shape along every axis, from both packages."""
    out = {}
    for shape in SHAPES:
        x = _field(shape, np.complex64)
        want = _forward(ref, jnp.asarray(x), [ref.FftHandler(n) for n in shape])
        got = _forward(port, torch.from_numpy(x), [port.FftHandler(n) for n in shape])
        out[shape] = x, got, np.asarray(want)
    return out


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_every_axis_matches_reference(spectra, shape):
    for axis, want_route in enumerate(SHAPES[shape]):
        assert api._route("fft", shape, axis, torch.complex64, "cpu") == want_route
        assert api._route("fft", shape, axis, torch.complex64, "cuda") == want_route
    x, got, want = spectra[shape]
    assert got.dtype == torch.complex64
    _close(got, want, TOL[np.complex64])
    _close(got, np.fft.fftn(x.astype(np.complex128)).astype(np.complex64), TOL[np.complex64])


_custom_fn = lambda v: v * 0.25 + 1.0   # noqa: E731  (affine: order matters)


@pytest.mark.parametrize("norm", ["default", "none", "scalar", "custom"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_inverse_every_axis_matches_reference(spectra, shape, norm):
    rnorm = {"none": ref.Normalization.NONE, "default": ref.Normalization.DEFAULT,
             "scalar": ref.Normalization.scalar(0.5),
             "custom": ref.Normalization.custom(_custom_fn)}[norm]
    rh = [ref.FftHandler(n).normalization(rnorm) for n in shape]
    ph = [port.FftHandler.from_reference(h) for h in rh]
    x, got_spec, want_spec = spectra[shape]
    want = _inverse(ref, jnp.asarray(want_spec), rh)
    got = _inverse(port, got_spec, ph)
    _close(got, want, TOL[np.complex64])
    if norm == "default":   # the round trip
        _close(got, x, TOL[np.complex64])


@pytest.mark.parametrize("shape", [(12, 10), (4, 6, 5), (130, 128)])
@pytest.mark.parametrize("norm", ["default", "scalar"])
def test_complex128_takes_the_engine_and_matches_reference(shape, norm):
    x = _field(shape, np.complex128)
    assert api._route("fft", shape, len(shape) - 1, torch.complex128, "cuda") == api.ENGINE
    rnorm = (ref.Normalization.DEFAULT if norm == "default"
             else ref.Normalization.scalar(0.3))
    rh = [ref.FftHandler(n).normalization(rnorm) for n in shape]
    ph = [port.FftHandler.from_reference(h) for h in rh]
    want = _forward(ref, jnp.asarray(x), rh)
    got = _forward(port, torch.from_numpy(x), ph)
    _close(got, want, TOL[np.complex128])
    _close(_inverse(port, got, ph), _inverse(ref, want, rh), TOL[np.complex128])


def test_default_axis_is_last_and_float32_input_is_promoted():
    x = np.random.default_rng(5).standard_normal((130, 256)).astype(np.float32)
    got = port.ndfft(torch.from_numpy(x))
    assert got.dtype == torch.complex64
    _close(got, np.asarray(ref.ndfft(jnp.asarray(x))), TOL[np.complex64])
    _close(port.ndifft(got), x.astype(np.complex64), TOL[np.complex64])


def test_engine_stays_off_the_kernel_routes():
    before = engine.c2c.calls
    x = torch.from_numpy(_field((130, 1024), np.complex64))
    port.ndifft(port.ndfft(x, axis=1), axis=0)
    port.ndfft(torch.from_numpy(_field((8, 200, 130), np.complex64)), axis=2)
    assert engine.c2c.calls == before
