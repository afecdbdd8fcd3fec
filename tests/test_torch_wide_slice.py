"""The bts2 core at any butterfly factor through the public functions,
ndrustfft_tpu_torch against ndrustfft_tpu (Pallas kernels in interpret
mode, "highest" tier) on the CPU, where the port's kernel routes run their
plain versions:

* ndfft / ndifft of 130 rows at n = 384 (kernel 10 at F = 3) and 4096
  (F = 32), and along axis 0 of 768 x 130 (kernel 1 at F = 6);
* ndfft_r2c / ndifft_r2c of 130 rows at n = 768 (kernels 2 and 3 at
  h = 384, F = 3);
* nddct1 at 769 (kernel 15 at h = 768) and nddct4 at 768 (kernel 10 at
  F = 6 on 2 * 64 rows);
* a small 3-D real step on 768-length axes.

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


@pytest.mark.parametrize("shape,axis,route", [((130, 384), 1, api.C2C_ROWS),
                                              ((130, 4096), 1, api.C2C_ROWS),
                                              ((768, 130), 0, api.C2C_AXIS_MID)])
@pytest.mark.parametrize("norm", ["default", "scalar"])
def test_c2c_matches_reference(shape, axis, route, norm):
    _both_routes("fft", shape, axis, C64, route)
    n = shape[axis]
    rnorm = ref.Normalization.DEFAULT if norm == "default" else ref.Normalization.scalar(0.5)
    rh = ref.FftHandler(n).normalization(rnorm)
    ph = port.FftHandler.from_reference(rh)
    x = _cplx(shape)
    kern = kfft.c2c_rows if axis == 1 else kfft.c2c_axis_mid
    counts = engine.c2c.calls, kern.launches, kern.radix_launches   # both on the radix core
    got = port.ndfft(torch.from_numpy(x), ph, axis=axis)
    want = ref.ndfft(jnp.asarray(x), rh, axis=axis)
    _close(got, want)
    back = port.ndifft(got, ph, axis=axis)
    _close(back, ref.ndifft(want, rh, axis=axis))
    if norm == "default":
        _close(back, x)
    # a CPU tensor: the kernel's plain version, no launch, no engine
    assert (engine.c2c.calls, kern.launches, kern.radix_launches) == counts


def test_real_rows_match_reference():
    n = 768
    _both_routes("r2c", (130, n), 1, F32, api.R2C_NAT)
    _both_routes("c2r", (130, n // 2 + 1), 1, C64, api.C2R_NAT, n=n)
    x = _real((130, n))
    rh, ph = ref.R2cFftHandler(n), port.R2cFftHandler(n)
    calls = engine.c2c.calls
    got = port.ndfft_r2c(torch.from_numpy(x), ph)
    want = ref.ndfft_r2c(jnp.asarray(x), rh)
    _close(got, want)
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1).astype(np.complex64), 2e-6)
    back = port.ndifft_r2c(got, ph)
    _close(back, ref.ndifft_r2c(want, rh))
    _close(back, x)
    assert engine.c2c.calls == calls


@pytest.mark.parametrize("name,shape,route", [("nddct1", (130, 769), api.R2C_PACKED),
                                              ("nddct4", (64, 768), api.DCT_LANE)])
@pytest.mark.parametrize("norm", ["default", "none"])
def test_r2r_match_reference(name, shape, route, norm):
    _both_routes(name[2:], shape, 1, F32, route)
    rnorm = ref.Normalization.DEFAULT if norm == "default" else ref.Normalization.NONE
    rh = ref.DctHandler(shape[1]).normalization(rnorm)
    x = _real(shape)
    calls = engine.c2c.calls
    got = getattr(port, name)(torch.from_numpy(x), port.DctHandler.from_reference(rh), axis=1)
    _close(got, getattr(ref, name)(jnp.asarray(x), rh, axis=1))
    assert engine.c2c.calls == calls


STEP_SHAPE = (2, 768, 768)


def _fwd3(mod, x, hs):
    hr, h1, h0 = hs
    return mod.ndfft(mod.ndfft(mod.ndfft_r2c(x, hr, axis=2), h1, axis=1), h0, axis=0)


def _inv3(mod, v, hs):
    hr, h1, h0 = hs
    return mod.ndifft_r2c(mod.ndifft(mod.ndifft(v, h0, axis=0), h1, axis=1), hr, axis=2)


def test_step_768_axes_matches_reference():
    """R2C along axis 2 (kernel 2 at h = 384 on 1536 rows), C2C along axis
    1 (kernel 1 at (2, 768, 385), F = 6) and axis 0 (kernel 4 at n = 2),
    and the inverse chain with kernel 3."""
    n0, n1, n2 = STEP_SHAPE
    spec_shape = (n0, n1, n2 // 2 + 1)
    _both_routes("r2c", STEP_SHAPE, 2, F32, api.R2C_NAT)
    _both_routes("fft", spec_shape, 1, C64, api.C2C_AXIS_MID)
    _both_routes("fft", spec_shape, 0, C64, api.C2C_DENSE_MID)
    _both_routes("c2r", spec_shape, 2, C64, api.C2R_NAT, n=n2)
    x = _real(STEP_SHAPE)
    rh = (ref.R2cFftHandler(n2), ref.FftHandler(n1), ref.FftHandler(n0))
    ph = tuple(type_.from_reference(h) for type_, h in
               zip((port.R2cFftHandler, port.FftHandler, port.FftHandler), rh))
    kernels = ((krfft.r2c_nat, "radix_launches"), (kfft.c2c_axis_mid, "radix_launches"),
               (krfft.c2r_nat, "radix_launches"))
    counts = engine.c2c.calls, [(k.launches, getattr(k, a)) for k, a in kernels]
    want = _fwd3(ref, jnp.asarray(x), rh)
    got = _fwd3(port, torch.from_numpy(x), ph)
    _close(got, want)
    _close(got, np.fft.rfftn(x.astype(np.float64)).astype(np.complex64), 2e-6)
    back = _inv3(port, got, ph)
    _close(back, _inv3(ref, want, rh))
    _close(back, x)
    assert (engine.c2c.calls, [(k.launches, getattr(k, a)) for k, a in kernels]) == counts
