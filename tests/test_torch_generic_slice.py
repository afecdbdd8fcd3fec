"""The generic two-factor schedule through the public functions,
ndrustfft_tpu_torch against ndrustfft_tpu (Pallas kernels in interpret
mode, "highest" tier) on the CPU, where the port's kernel routes run their
plain versions:

* ndfft / ndifft of 130 rows at n = 264 and 600 (kernel 8's generic
  schedule) and along axis 0 of 600 x 130 (kernel 6);
* ndfft_r2c / ndifft_r2c of 130 rows at n = 530 (kernel 15 at the odd
  h = 265, the C2R's extension on kernel 8 at 530) and n = 300 (kernel 15's
  dense product, kernel 8 at 300);
* nddct1 at 265 and nddst1 at 263 (kernel 15 at h = 264), nddct2 / nddct3
  at 600 (kernel 15 at h = 300, kernel 8 at 600), nddct4 at 1000 (kernel 8
  on 2 * 64 rows), and the nddct4 / nddst4 composite along axis 0 of
  1200 x 128 (kernel 6 at m = 600);
* a small 3-D real step on 600-length axes.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32.
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
from ndrustfft_tpu_torch.ops import dct as pdct
from ndrustfft_tpu_torch.ops import engine
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

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


def _cplx(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _both_routes(kind, shape, axis, dtype, want, n=None):
    assert api._route(kind, shape, axis, dtype, "cpu", n=n) == want
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want


@pytest.mark.parametrize("shape,axis,route", [((130, 264), 1, api.C2C_GENERIC_ROWS),
                                              ((130, 600), 1, api.C2C_GENERIC_ROWS),
                                              ((600, 130), 0, api.C2C_GENERIC_MID)])
@pytest.mark.parametrize("norm", ["default", "scalar"])
def test_c2c_matches_reference(shape, axis, route, norm):
    _both_routes("fft", shape, axis, C64, route)
    n = shape[axis]
    rnorm = ref.Normalization.DEFAULT if norm == "default" else ref.Normalization.scalar(0.5)
    rh = ref.FftHandler(n).normalization(rnorm)
    ph = port.FftHandler.from_reference(rh)
    x = _cplx(shape)
    kern = kfft.c2c_generic_rows if axis == 1 else kfft.c2c_generic_mid
    calls, launches = engine.c2c.calls, kern.launches
    got = port.ndfft(torch.from_numpy(x), ph, axis=axis)
    want = ref.ndfft(jnp.asarray(x), rh, axis=axis)
    _close(got, want)
    back = port.ndifft(got, ph, axis=axis)
    _close(back, ref.ndifft(want, rh, axis=axis))
    if norm == "default":
        _close(back, x)
    # a CPU tensor: the kernel's plain version, no launch, no engine
    assert (engine.c2c.calls, kern.launches) == (calls, launches)


@pytest.mark.parametrize("n,r2c_route", [(530, api.R2C_PACKED), (300, api.R2C_PACKED)])
def test_real_rows_match_reference(n, r2c_route):
    shape = (130, n)
    _both_routes("r2c", shape, 1, F32, r2c_route)
    _both_routes("c2r", (130, n // 2 + 1), 1, C64, api.C2R_LANE, n=n)
    x = _real(shape)
    rh = ref.R2cFftHandler(n)
    ph = port.R2cFftHandler(n)
    calls = engine.c2c.calls
    got = port.ndfft_r2c(torch.from_numpy(x), ph)
    want = ref.ndfft_r2c(jnp.asarray(x), rh)
    _close(got, want)
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1).astype(np.complex64), 2e-6)
    back = port.ndifft_r2c(got, ph)
    _close(back, ref.ndifft_r2c(want, rh))
    _close(back, x)
    assert engine.c2c.calls == calls


# (function, shape, axis) -> the route, along the last axis unless axis 0
R2R_CASES = [
    ("nddct1", (130, 265), 1, api.R2C_PACKED),     # h = 264 (m = 2, f = 132)
    ("nddst1", (130, 263), 1, api.R2C_PACKED),     # h = 264
    ("nddct2", (130, 600), 1, api.R2C_PACKED),     # h = 300 (m = 2, f = 150)
    ("nddct3", (130, 600), 1, api.DCT_LANE),       # n = 600 (m = 3, f = 200)
    ("nddct4", (64, 1000), 1, api.DCT_LANE),       # n = 1000 on 128 rows
    ("nddct4", (1200, 128), 0, api.DCT4_HALF_MID),  # m = 600 on kernel 6
    ("nddst4", (1200, 128), 0, api.DCT4_HALF_MID),
]


@pytest.mark.parametrize("name,shape,axis,route", R2R_CASES)
@pytest.mark.parametrize("norm", ["default", "none"])
def test_r2r_match_reference(name, shape, axis, route, norm):
    _both_routes(name[2:], shape, axis, F32, route)
    n = shape[axis]
    rcls, pcls = ((ref.DctHandler, port.DctHandler) if "dct" in name
                  else (ref.DstHandler, port.DstHandler))
    rnorm = ref.Normalization.DEFAULT if norm == "default" else ref.Normalization.NONE
    rh = rcls(n).normalization(rnorm)
    x = _real(shape)
    calls = engine.c2c.calls
    got = getattr(port, name)(torch.from_numpy(x), pcls.from_reference(rh), axis=axis)
    _close(got, getattr(ref, name)(jnp.asarray(x), rh, axis=axis))
    assert engine.c2c.calls == calls


def test_dct4_composite_is_the_half_length_c2c():
    """The composite's C2C is kernel 6's wrapper on (B, n/2, L)."""
    x = torch.from_numpy(_real((1200, 128)))
    want = port.nddct4(x, axis=0)
    got = pdct.dct4_half_mid(x.reshape(1, 1200, 128), 2.0).reshape(1200, 128)
    assert torch.equal(got, want)


STEP_SHAPE = (2, 600, 600)


def _fwd3(mod, x, hs):
    hr, h1, h0 = hs
    return mod.ndfft(mod.ndfft(mod.ndfft_r2c(x, hr, axis=2), h1, axis=1), h0, axis=0)


def _inv3(mod, v, hs):
    hr, h1, h0 = hs
    return mod.ndifft_r2c(mod.ndifft(mod.ndifft(v, h0, axis=0), h1, axis=1), hr, axis=2)


def test_step_600_axes_matches_reference():
    """R2C along axis 2 (kernel 15 at h = 300 on 1200 rows), C2C along axis
    1 (kernel 6 at (2, 600, 301)) and axis 0 (kernel 4 at n = 2), and the
    inverse with the C2R's extension on kernel 8 at n = 600."""
    n0, n1, n2 = STEP_SHAPE
    spec_shape = (n0, n1, n2 // 2 + 1)
    _both_routes("r2c", STEP_SHAPE, 2, F32, api.R2C_PACKED)
    _both_routes("fft", spec_shape, 1, C64, api.C2C_GENERIC_MID)
    _both_routes("fft", spec_shape, 0, C64, api.C2C_DENSE_MID)
    _both_routes("c2r", spec_shape, 2, C64, api.C2R_LANE, n=n2)
    x = _real(STEP_SHAPE)
    rh = (ref.R2cFftHandler(n2), ref.FftHandler(n1), ref.FftHandler(n0))
    ph = tuple(type_.from_reference(h) for type_, h in
               zip((port.R2cFftHandler, port.FftHandler, port.FftHandler), rh))
    kernels = (krfft.r2c_packed_generic, kfft.c2c_generic_mid, kfft.c2c_generic_rows)
    calls, launches = engine.c2c.calls, [k.launches for k in kernels]
    want = _fwd3(ref, jnp.asarray(x), rh)
    got = _fwd3(port, torch.from_numpy(x), ph)
    _close(got, want)
    _close(got, np.fft.rfftn(x.astype(np.float64)).astype(np.complex64), 2e-6)
    back = _inv3(port, got, ph)
    _close(back, _inv3(ref, want, rh))
    _close(back, x)
    assert (engine.c2c.calls, [k.launches for k in kernels]) == (calls, launches)
