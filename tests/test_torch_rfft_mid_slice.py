"""Real transforms along a middle axis through the public functions:
ndfft_r2c / ndifft_r2c off the last axis, ndrustfft_tpu_torch against
ndrustfft_tpu (Pallas kernels in interpret mode, "highest" tier), with every
normalization and handlers converted with from_reference:

* the reference's rfft2d protocol, R2C along axis 0 of n x n (kernels 20/21
  at 128 and 264, kernels 16/17 at 512);
* a (4, 512, L) field along axis 1;
* small 3-D real steps with the real axis first, whose legs take kernels
  16, 4, 8 and 17 (n = 512) or 20, 4, 8 and 21 (n = 256): their plain
  versions here, the same routes as on a CUDA tensor;
* a length with a prime factor above 128 (n = 131), which the JAX package
  runs on kernel 20 along a middle axis.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 (each side
measures <= 7e-7 against a float64 oracle at this tier).
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

TOL = 5e-6
F32, C64 = torch.float32, torch.complex64


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


def _real(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


_custom_fn = lambda v: v * 0.25 + 1.0   # noqa: E731  (affine: order matters)

NORMS = ["none", "default", "scalar", "custom"]


def _norm(name):
    return {"none": ref.Normalization.NONE, "default": ref.Normalization.DEFAULT,
            "scalar": ref.Normalization.scalar(0.5),
            "custom": ref.Normalization.custom(_custom_fn)}[name]


def _both_routes(kind, shape, axis, dtype, want, n=None):
    assert api._route(kind, shape, axis, dtype, "cpu", n=n) == want
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want


# the 2-D cases: shape, axis, the port's R2C route and C2R route
CASES_2D = {
    "rfft2d_128": ((128, 128), 0, api.R2C_DENSE_MID, api.C2R_DENSE_MID),
    "rfft2d_264": ((264, 264), 0, api.R2C_DENSE_MID, api.C2R_DENSE_MID),
    "rfft2d_512": ((512, 512), 0, api.R2C_MID, api.C2R_MID),
    "axis1_cols64": ((4, 512, 64), 1, api.R2C_NAT, api.C2R_NAT),    # < 128 columns: rows
    "axis1_cols130": ((4, 512, 130), 1, api.R2C_MID, api.C2R_MID),
    "bluestein_131": ((131, 130), 0, api.R2C_DENSE_MID, api.C2R_DENSE_MID),
}


@pytest.fixture(scope="module")
def spectra_2d():
    out = {}
    for name, (shape, axis, _, _) in CASES_2D.items():
        x = _real(shape)
        n = shape[axis]
        want = ref.ndfft_r2c(jnp.asarray(x), ref.R2cFftHandler(n), axis=axis)
        got = port.ndfft_r2c(torch.from_numpy(x), port.R2cFftHandler(n), axis=axis)
        out[name] = x, got, np.asarray(want)
    return out


@pytest.mark.parametrize("case", list(CASES_2D))
def test_forward_matches_reference(spectra_2d, case):
    shape, axis, r2c_route, _ = CASES_2D[case]
    _both_routes("r2c", shape, axis, F32, r2c_route)
    x, got, want = spectra_2d[case]
    assert got.dtype == torch.complex64
    _close(got, want)
    _close(got, np.fft.rfft(x.astype(np.float64), axis=axis).astype(np.complex64))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("case", list(CASES_2D))
def test_inverse_matches_reference(spectra_2d, case, norm):
    shape, axis, _, c2r_route = CASES_2D[case]
    n = shape[axis]
    x, got_spec, want_spec = spectra_2d[case]
    _both_routes("c2r", tuple(got_spec.shape), axis, C64, c2r_route, n=n)
    rh = ref.R2cFftHandler(n).normalization(_norm(norm))
    want = ref.ndifft_r2c(jnp.asarray(want_spec), rh, axis=axis)
    got = port.ndifft_r2c(got_spec, port.R2cFftHandler.from_reference(rh), axis=axis)
    assert got.dtype == torch.float32
    _close(got, want)
    if norm == "default":   # the round trip
        _close(got, x)


# the 3-D real steps with the real axis first: the route of each leg
STEPS_3D = {
    (512, 8, 128): (api.R2C_MID, api.C2C_DENSE_MID, api.C2C_DENSE_ROWS, api.C2R_MID),
    (256, 8, 128): (api.R2C_DENSE_MID, api.C2C_DENSE_MID, api.C2C_DENSE_ROWS,
                    api.C2R_DENSE_MID),
}


def _fwd3(mod, x, hr, hc1, hc2):
    return mod.ndfft(mod.ndfft(mod.ndfft_r2c(x, hr, axis=0), hc1, axis=1), hc2, axis=2)


def _inv3(mod, v, hr, hc1, hc2):
    return mod.ndifft_r2c(mod.ndifft(mod.ndifft(v, hc2, axis=2), hc1, axis=1), hr, axis=0)


@pytest.fixture(scope="module")
def spectra_3d():
    out = {}
    for shape in STEPS_3D:
        x = _real(shape)
        n0, n1, n2 = shape
        want = _fwd3(ref, jnp.asarray(x), ref.R2cFftHandler(n0), ref.FftHandler(n1),
                     ref.FftHandler(n2))
        got = _fwd3(port, torch.from_numpy(x), port.R2cFftHandler(n0), port.FftHandler(n1),
                    port.FftHandler(n2))
        out[shape] = x, got, np.asarray(want)
    return out


@pytest.mark.parametrize("shape", list(STEPS_3D))
def test_step_real_axis_first_forward_matches_reference(spectra_3d, shape):
    r2c, c2c1, c2c2, _ = STEPS_3D[shape]
    spec_shape = (shape[0] // 2 + 1,) + shape[1:]
    _both_routes("r2c", shape, 0, F32, r2c)
    _both_routes("fft", spec_shape, 1, C64, c2c1)
    _both_routes("fft", spec_shape, 2, C64, c2c2)
    x, got, want = spectra_3d[shape]
    _close(got, want)
    oracle = np.fft.rfftn(x.astype(np.float64), axes=(1, 2, 0)).astype(np.complex64)
    _close(got, oracle)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("shape", list(STEPS_3D))
def test_step_real_axis_first_inverse_matches_reference(spectra_3d, shape, norm):
    n0, n1, n2 = shape
    x, got_spec, want_spec = spectra_3d[shape]
    _both_routes("c2r", tuple(got_spec.shape), 0, C64, STEPS_3D[shape][3], n=n0)
    rh = (ref.R2cFftHandler(n0).normalization(_norm(norm)),
          ref.FftHandler(n1).normalization(_norm(norm)),
          ref.FftHandler(n2).normalization(_norm(norm)))
    ph = (port.R2cFftHandler.from_reference(rh[0]), port.FftHandler.from_reference(rh[1]),
          port.FftHandler.from_reference(rh[2]))
    want = _inv3(ref, jnp.asarray(want_spec), *rh)
    got = _inv3(port, got_spec, *ph)
    _close(got, want)
    if norm == "default":
        _close(got, x)


def test_engine_stays_off_the_mid_routes():
    calls = [f.calls for f in (engine.r2c, engine.c2r)]
    for n in (128, 201, 512):
        x = torch.from_numpy(_real((n, 130)))
        port.ndifft_r2c(port.ndfft_r2c(x, axis=0), port.R2cFftHandler(n), axis=0)
    assert [f.calls for f in (engine.r2c, engine.c2r)] == calls


def test_bluestein_length_plans_at_first_use():
    """A Bluestein length plans when its handler is built (the R2C handler
    planned at first use, and the routes that need the plan raised, before
    the plan was ported): the lane lowerings that run the chirp-z match the
    JAX package."""
    h = port.R2cFftHandler(131)
    assert h.m == 66
    x = _real((4, 131))
    want = ref.ndfft_r2c(jnp.asarray(x), ref.R2cFftHandler(131), axis=1)
    _close(port.ndfft_r2c(torch.from_numpy(x), h, axis=1), want)
    z = (x + 1j * x[::-1]).astype(np.complex64)
    _close(port.ndfft(torch.from_numpy(z), port.FftHandler(131), axis=1),
           ref.ndfft(jnp.asarray(z), ref.FftHandler(131), axis=1))
