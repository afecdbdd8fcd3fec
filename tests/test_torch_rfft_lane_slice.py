"""Real transforms and the DCT/DST lowerings along the last axis through the
public functions, ndrustfft_tpu_torch against ndrustfft_tpu (Pallas kernels
in interpret mode, "highest" tier), on the CPU, where the port's kernel
routes run their plain versions:

* ndfft_r2c / ndifft_r2c of 256 rows at n = 64, 128 and 200 (kernel 15's
  dense product), 256 (kernel 15 on the core, F = 1) and 129 (row pairs on
  kernel 8), with the C2R's Hermitian extension on kernel 8, under every
  normalization;
* nddct1..4 / nddst1..4 of 256 rows at n = 129, 130, 200, 256 and 513: the
  packed R2C (DCT-I, DST-I, DCT-II), row pairs (odd DCT-II), kernel 8 inside
  DCT-III/IV, and the lengths that still raise on a CUDA tensor;
* a small 3-D real step with the real axis last (kernel 15, kernel 8 on the
  moved middle axis, kernel 4 along axis 0, kernel 8 after the extension).

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32, 1e-12 in float64.
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

TOL = {np.float32: 5e-6, np.float64: 1e-12}
F32, C64 = torch.float32, torch.complex64
ROWS = 256        # >= 128 row pairs for the odd lengths


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


def _real(shape, dtype=np.float32):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(dtype)


_custom_fn = lambda v: v * 0.25 + 1.0   # noqa: E731  (affine: order matters)

NORMS = ["none", "default", "scalar", "custom"]


def _norm(name):
    return {"none": ref.Normalization.NONE, "default": ref.Normalization.DEFAULT,
            "scalar": ref.Normalization.scalar(0.5),
            "custom": ref.Normalization.custom(_custom_fn)}[name]


def _both_routes(kind, shape, axis, dtype, want, n=None):
    assert api._route(kind, shape, axis, dtype, "cpu", n=n) == want
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want


# n -> the R2C route and the C2R route of (256, n) along the last axis
R2C_CASES = {64: api.R2C_PACKED, 128: api.R2C_PACKED, 129: api.R2C_ROWPAIR,
             200: api.R2C_PACKED, 256: api.R2C_PACKED}


@pytest.fixture(scope="module")
def spectra():
    out = {}
    for n in R2C_CASES:
        for dtype in (np.float32, np.float64):
            x = _real((ROWS, n), dtype)
            want = ref.ndfft_r2c(jnp.asarray(x), ref.R2cFftHandler(n))
            got = port.ndfft_r2c(torch.from_numpy(x), port.R2cFftHandler(n))
            out[n, dtype] = x, got, np.asarray(want)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", list(R2C_CASES))
def test_forward_matches_reference(spectra, n, dtype):
    if dtype == np.float32:
        _both_routes("r2c", (ROWS, n), 1, F32, R2C_CASES[n])
    x, got, want = spectra[n, dtype]
    assert got.shape == (ROWS, n // 2 + 1)
    _close(got, want, TOL[dtype])
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1).astype(want.dtype), 2e-6)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("n", list(R2C_CASES))
def test_inverse_matches_reference(spectra, n, norm):
    x, got_spec, want_spec = spectra[n, np.float32]
    _both_routes("c2r", tuple(got_spec.shape), 1, C64, api.C2R_LANE, n=n)
    rh = ref.R2cFftHandler(n).normalization(_norm(norm))
    want = ref.ndifft_r2c(jnp.asarray(want_spec), rh)
    got = port.ndifft_r2c(got_spec, port.R2cFftHandler.from_reference(rh))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want, TOL[np.float32])
    if norm == "default":   # the round trip
        _close(got, x, TOL[np.float32])


def test_engine_stays_off_the_lane_routes(spectra):
    calls = engine.c2c.calls
    for n in R2C_CASES:
        _, spec, _ = spectra[n, np.float32]
        port.ndifft_r2c(spec, port.R2cFftHandler(n))
        port.ndfft_r2c(torch.from_numpy(_real((ROWS, n))))
    assert engine.c2c.calls == calls


# (function, n) -> the route of (256, n) along the last axis; a Bluestein
# half length (199 for DCT-I at 200; 131, 257, 257 * 2 for DST-I at 130,
# 256, 513) takes the lane's chirp-z, its sub-FFTs on K10; at 513 the
# generic schedule serves every other lowering (K15 at h = 512, K8 at n = 513)
_DCT_ROUTES = {
    129: (api.R2C_PACKED, api.R2C_ROWPAIR, api.DCT_LANE, api.DCT_LANE),
    130: (api.R2C_PACKED, api.R2C_PACKED, api.DCT_LANE, api.DCT_LANE),
    200: (api.BLUESTEIN_LANE, api.R2C_PACKED, api.DCT_LANE, api.DCT_LANE),
    256: (api.R2C_PACKED, api.DCT2_NAT, api.DCT3_NAT, api.DCT_LANE),
    513: (api.R2C_PACKED, api.R2C_ROWPAIR, api.DCT_LANE, api.DCT_LANE),
}
_DST1_ROUTES = {129: api.R2C_PACKED, 130: api.BLUESTEIN_LANE, 200: api.R2C_PACKED,
                256: api.BLUESTEIN_LANE, 513: api.BLUESTEIN_LANE}
FNS = [f"nd{fam}{t}" for fam in ("dct", "dst") for t in (1, 2, 3, 4)]


def _want_route(name, n):
    t = int(name[-1])
    if name == "nddst1":
        return _DST1_ROUTES[n]
    return _DCT_ROUTES[n][t - 1]


@pytest.mark.parametrize("n", list(_DCT_ROUTES))
@pytest.mark.parametrize("name", FNS)
def test_r2r_lanes_match_reference(name, n):
    shape = (ROWS, n)
    _both_routes(name[2:], shape, 1, F32, _want_route(name, n))
    x = _real(shape)
    _close(getattr(port, name)(torch.from_numpy(x)),
           getattr(ref, name)(jnp.asarray(x)), TOL[np.float32])


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", ["nddct1", "nddst1", "nddct4"])
def test_r2r_lane_normalizations_match_reference(name, norm):
    n = 129
    rcls = ref.DctHandler if "dct" in name else ref.DstHandler
    pcls = port.DctHandler if "dct" in name else port.DstHandler
    rh = rcls(n).normalization(_norm(norm))
    x = _real((2, 65, n))
    _close(getattr(port, name)(torch.from_numpy(x), pcls.from_reference(rh)),
           getattr(ref, name)(jnp.asarray(x), rh), TOL[np.float32])


# the 3-D real step with the real axis last: the route of each leg
STEP_SHAPE = (16, 12, 128)
STEP_ROUTES = (api.R2C_PACKED, api.C2C_DENSE_ROWS, api.C2C_DENSE_MID, api.C2R_LANE)


def _fwd3(mod, x, hr, hc1, hc0):
    return mod.ndfft(mod.ndfft(mod.ndfft_r2c(x, hr, axis=2), hc1, axis=1), hc0, axis=0)


def _inv3(mod, v, hr, hc1, hc0):
    return mod.ndifft_r2c(mod.ndifft(mod.ndifft(v, hc0, axis=0), hc1, axis=1), hr, axis=2)


@pytest.mark.parametrize("norm", ["default", "scalar"])
def test_step_real_axis_last_matches_reference(norm):
    n0, n1, n2 = STEP_SHAPE
    spec_shape = (n0, n1, n2 // 2 + 1)
    r2c, c2c1, c2c0, c2r = STEP_ROUTES
    _both_routes("r2c", STEP_SHAPE, 2, F32, r2c)
    _both_routes("fft", spec_shape, 1, C64, c2c1)        # 65 columns: the axis moves
    _both_routes("fft", spec_shape, 0, C64, c2c0)
    _both_routes("c2r", spec_shape, 2, C64, c2r, n=n2)
    x = _real(STEP_SHAPE)
    rh = (ref.R2cFftHandler(n2).normalization(_norm(norm)),
          ref.FftHandler(n1).normalization(_norm(norm)),
          ref.FftHandler(n0).normalization(_norm(norm)))
    ph = (port.R2cFftHandler.from_reference(rh[0]), port.FftHandler.from_reference(rh[1]),
          port.FftHandler.from_reference(rh[2]))
    want = _fwd3(ref, jnp.asarray(x), *rh)
    got = _fwd3(port, torch.from_numpy(x), *ph)
    _close(got, want, TOL[np.float32])
    _close(got, np.fft.rfftn(x.astype(np.float64)).astype(np.complex64), 2e-6)
    back = _inv3(port, got, *ph)
    _close(back, _inv3(ref, want, *rh), TOL[np.float32])
    if norm == "default":
        _close(back, x, TOL[np.float32])
