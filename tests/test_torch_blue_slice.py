"""Bluestein lengths (a prime factor above 128) through the public
functions against the JAX package on its XLA path (its Pallas kernels 11
and 12 are held against the port's plain versions in interpret mode in
``test_torch_blue.py``); on the CPU the port's kernel routes run their
plain versions:

* ``ndfft``/``ndifft`` at 131, 263, 509, 1031 and 2049 along the last axis
  of 128 rows (the engine's chirp-z, its sub-FFTs on kernel 10) and along
  axis 0 of (n, 128) (kernel 11), under the four normalization kinds;
* ``ndfft_r2c``/``ndifft_r2c`` at 262, 263 and 2062 along both axis kinds;
* ``nddct1..4``/``nddst1..4`` at Bluestein lengths along both axis kinds
  (kernel 12 for DCT-II/III and DST-II/III along a middle axis, the DCT-IV
  composite on kernel 11, the lanes elsewhere);
* the slice as a whole: a 131 x 130 x 129 ``fftn``/``ifftn`` round trip
  and a 2049 x 256 cell-centred Neumann solve (``dctn``/``idctn``: kernel
  12 on axis 0, kernels 23/24 on axis 1) against the JAX package's
  ``ndapi`` and the analytic solution;
* the route sweep over n = 2 ... 20480: no route of any kind raises for
  want of kernel 11 or 12 or the engine's Bluestein; every Bluestein length
  takes kernel 11 or 12, the lane's chirp-z (its sub-FFTs on the four-step
  where their length exceeds 20480), or the engine below 128 rows.

Each case asserts the route it takes on a CUDA tensor (``api._route``).
Tolerance: 5e-6 of max |JAX| in float32; 1e-5 of the analytic solution.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import ndapi as ref_ndapi

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api, gates
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.plan import blue_sub_len, factorize

torch.set_num_threads(1)

TOL = 5e-6
F32, C64 = torch.float32, torch.complex64


@pytest.fixture(autouse=True)
def _jax_xla():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = False
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


def _cplx(shape, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal(shape) + 1j * g.standard_normal(shape)).astype(np.complex64)


def _norms(mod):
    return {"default": mod.Normalization.DEFAULT, "none": mod.Normalization.NONE,
            "scalar": mod.Normalization.scalar(0.25),
            "custom": mod.Normalization.custom(lambda a: a * 3.0)}


# --------------------------------------------------------------------------
# The public functions against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [131, 263, 509, 1031, 2049])
@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("norm", ["default", "none", "scalar", "custom"])
def test_c2c_matches_the_jax_package(n, axis, norm):
    shape = (n, 128) if axis == 0 else (128, n)
    want_route = api.C2C_BLUE_MID if axis == 0 else api.BLUESTEIN_LANE
    assert api._route("fft", shape, axis, C64, "cuda") == want_route
    assert api._route("ifft", shape, axis, C64, "cuda") == want_route
    x = _cplx(shape, n + axis)
    hp = nd.FftHandler(n).normalization(_norms(nd)[norm])
    hr = ref.FftHandler(n).normalization(_norms(ref)[norm])
    y = nd.ndfft(torch.from_numpy(x), hp, axis=axis)
    _close(y, ref.ndfft(jnp.asarray(x), hr, axis=axis))
    _close(nd.ndifft(torch.from_numpy(x), hp, axis=axis), ref.ndifft(jnp.asarray(x), hr, axis=axis))


@pytest.mark.parametrize("n,shape,axis,route", [
    (262, (128, 262), 1, api.BLUESTEIN_LANE),      # h = 131: the packed R2C's C2C
    (263, (256, 263), 1, api.BLUESTEIN_LANE),      # odd: 128 row pairs
    (263, (4, 263), 1, api.ENGINE),                # 2 row pairs: the engine's chirp-z
    (2062, (128, 2062), 1, api.BLUESTEIN_LANE),    # h = 1031, M = 2304
    (262, (262, 128), 0, api.R2C_DENSE_MID),       # K20/K21 take any n <= 1100
    (2062, (2062, 128), 0, api.BLUESTEIN_LANE),    # beyond them: the lane after a moveaxis
])
def test_r2c_c2r_match_the_jax_package(n, shape, axis, route):
    assert api._route("r2c", shape, axis, F32, "cuda") == route
    m = n // 2 + 1
    spec_shape = shape[:axis % 2] + (m,) + shape[axis % 2 + 1:]
    c2r_route = {api.R2C_DENSE_MID: api.C2R_DENSE_MID}.get(route, route)
    assert api._route("c2r", spec_shape, axis, C64, "cuda", n=n) == c2r_route
    x = _real(shape, n)
    want = ref.ndfft_r2c(jnp.asarray(x), ref.R2cFftHandler(n), axis=axis)
    _close(nd.ndfft_r2c(torch.from_numpy(x), nd.R2cFftHandler(n), axis=axis), want)
    s = np.asarray(want).astype(np.complex64)
    _close(nd.ndifft_r2c(torch.from_numpy(s), nd.R2cFftHandler(n), axis=axis),
           ref.ndifft_r2c(jnp.asarray(s), ref.R2cFftHandler(n), axis=axis))


# kind -> (n, route along axis 0 of (n, 128), route along the last axis of (128, n))
_R2R = {
    "dct1": (1104, api.BLUESTEIN_LANE, api.BLUESTEIN_LANE),   # h = n - 1 = 1103
    "dct2": (2049, api.DCT23_BLUE_MID, api.BLUESTEIN_LANE),
    "dct3": (2049, api.DCT23_BLUE_MID, api.BLUESTEIN_LANE),
    "dct4": (2062, api.DCT4_HALF_MID, api.BLUESTEIN_LANE),    # m = n / 2 = 1031
    "dst1": (1102, api.BLUESTEIN_LANE, api.BLUESTEIN_LANE),   # n + 1 = 1103
    "dst2": (1153, api.DCT23_BLUE_MID, api.BLUESTEIN_LANE),
    "dst3": (1153, api.DCT23_BLUE_MID, api.BLUESTEIN_LANE),
    "dst4": (2062, api.DCT4_HALF_MID, api.BLUESTEIN_LANE),
}


@pytest.mark.parametrize("kind", list(_R2R))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("norm", ["default", "scalar"])
def test_r2r_matches_the_jax_package(kind, axis, norm):
    n, mid, lane = _R2R[kind]
    # DCT-II at odd n pairs the rows: 256 rows make the 128 pairs of the lane
    rows = 256 if kind in ("dct2", "dst2") else 128
    shape = (n, 128) if axis == 0 else (rows, n)
    assert api._route(kind, shape, axis, F32, "cuda") == (mid if axis == 0 else lane)
    x = _real(shape, n + axis)
    family = kind[:3]
    cls, ref_cls = ((nd.DctHandler, ref.DctHandler) if family == "dct"
                    else (nd.DstHandler, ref.DstHandler))
    got = getattr(nd, f"nd{kind}")(torch.from_numpy(x),
                                   cls(n).normalization(_norms(nd)[norm]), axis=axis)
    want = getattr(ref, f"nd{kind}")(jnp.asarray(x),
                                     ref_cls(n).normalization(_norms(ref)[norm]), axis=axis)
    _close(got, want)


# --------------------------------------------------------------------------
# The slice as a whole
# --------------------------------------------------------------------------


def test_fftn_round_trip_matches_the_jax_package():
    """131 x 130 x 129 complex64: axis 0 (n = 131) on kernel 11 at
    (1, 131, 16770); the other axes are no Bluestein lengths."""
    shape = (131, 130, 129)
    assert api._route("fft", shape, 0, C64, "cuda") == api.C2C_BLUE_MID
    x = _cplx(shape, 5)
    y = nd.fftn(torch.from_numpy(x))
    _close(y, ref_ndapi.fftn(jnp.asarray(x)))
    _close(nd.ifftn(y), x, 1e-5)


def test_neumann_solve_matches_jax_and_the_analytic_solution():
    """-lap_h u = f on a 2049 x 256 cell-centred grid (Neumann walls,
    x_j = (j + 1/2) / n): u is a sum of cosine modes, f its discrete
    Laplacian, so DCT-II (kernel 12 along axis 0, kernel 23 along axis 1),
    the division by the eigenvalues and DCT-III (kernels 12 and 24) return
    u to roundoff."""
    grid = (2049, 256)
    assert api._route("dct2", grid, 0, F32, "cuda") == api.DCT23_BLUE_MID
    assert api._route("dct3", grid, 0, F32, "cuda") == api.DCT23_BLUE_MID
    assert api._route("dct2", grid, 1, F32, "cuda") == api.DCT2_NAT
    modes = ((1, 2, 1.0), (5, 3, 0.5), (300, 40, 0.25))     # chip_smoke's modes

    def lam(k, n):
        return (2 - 2 * np.cos(np.pi * k / n)) * n * n

    def field(weight):
        pts = [(np.arange(m) + 0.5) / m for m in grid]
        return sum(amp * weight(a, b) * np.cos(a * np.pi * pts[0])[:, None]
                   * np.cos(b * np.pi * pts[1])[None, :] for a, b, amp in modes)

    u = field(lambda a, b: 1.0)
    f = field(lambda a, b: lam(a, grid[0]) + lam(b, grid[1]))
    lam2 = lam(np.arange(grid[0]), grid[0])[:, None] + lam(np.arange(grid[1]), grid[1])[None, :]
    lam2[0, 0] = np.inf
    f32 = f.astype(np.float32)
    fh = nd.dctn(torch.from_numpy(f32), 2)
    _close(fh, ref_ndapi.dctn(jnp.asarray(f32), 2))
    got = nd.idctn(fh / torch.from_numpy(lam2.astype(np.float32)), 2)
    _close(got, u, 1e-5)


# --------------------------------------------------------------------------
# The route sweep
# --------------------------------------------------------------------------


_KINDS = ("fft", "ifft", "r2c", "c2r") + tuple(f"{f}{t}" for f in ("dct", "dst")
                                               for t in (1, 2, 3, 4))


def _route_or_key(kind, shape, axis, n):
    dtype = C64 if kind in ("fft", "ifft", "c2r") else F32
    if kind == "c2r":
        shape = tuple(n // 2 + 1 if i == axis else s for i, s in enumerate(shape))
    return api._route(kind, shape, axis, dtype, "cuda", n=n if kind == "c2r" else None)


def test_no_route_needs_a_missing_bluestein_kernel():
    """Over n = 2 ... 20480, every kind on 128 rows, 4 rows and along axis 0
    of (n, 128): no route is "bluestein" or "dct23_blue_mid" (those keys are
    gone) and no call raises for want of kernels 11 or 12. A Bluestein n
    takes C2C_BLUE_MID (n <= 6784 along a middle axis), DCT23_BLUE_MID, the
    lane's chirp-z, or the engine below 128 rows except where its sub-FFT
    length blue_sub_len(n) exceeds 20480: there the sub-FFTs take the
    four-step, which has no batch gate, so every shape takes the lane's
    chirp-z. No route raises (the DCT long forms raised before they were
    ported)."""
    counts = {}
    for n in range(2, 20481):
        blue = factorize(n) is None
        for kind in _KINDS:
            for shape, axis in (((128, n), 1), ((4, n), 1), ((n, 128), 0)):
                route = _route_or_key(kind, shape, axis, n)
                assert route not in ("bluestein", "dct23_blue_mid")
                counts[route] = counts.get(route, 0) + 1
                if not (blue and kind in ("fft", "ifft")):
                    continue
                big = blue_sub_len(n) > kfft.GENERIC_MAX_N
                if axis == 0 and kfft.blue_f(n) is not None and n <= 6784:
                    assert route == api.C2C_BLUE_MID, (kind, n)
                elif big:
                    assert route == api.BLUESTEIN_LANE, (kind, shape, n, route)
                else:
                    want = api.ENGINE if shape[0] == 4 else api.BLUESTEIN_LANE
                    assert route == want, (kind, shape, n, route)
        if blue and 1100 < n <= 6784:
            for kind in ("dct2", "dct3", "dst2", "dst3"):
                assert _route_or_key(kind, (n, 128), 0, n) == api.DCT23_BLUE_MID
    assert set(counts) <= set(gates.ROUTES)
    assert "fourstep" not in counts and counts[api.BLUESTEIN_LANE] > 0
