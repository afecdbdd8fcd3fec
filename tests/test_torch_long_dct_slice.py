"""The long DCT forms through the public functions on CPU tensors, against
the JAX package (its Pallas kernels in interpret mode) and float64 oracles:

* ``nddct2`` / ``nddct3`` / ``nddst2`` / ``nddst3`` at n = 128 k with odd
  k > 160 (kernels 25/26 along axis 0, kernels 23/24 along the last axis,
  the DSTs by the flip/sign conjugation), ``nddct4`` / ``nddst4`` at
  n = 256 F with F > 160 (kernel 28's long form along axis 0), and
  ``ndspectral_dct`` / ``ndspectral_dst`` (kernel 29's n-point form);
* the slice's two paths at a small depth: the cell-centred Neumann Poisson
  solve on a 20608 x 130 grid (``dctn`` / ``idctn`` of type 2, and
  ``ndspectral_dct`` along axis 0 with a lane-varying 1/lambda), and the
  mixed Neumann-Dirichlet solve on a 65536 x 128 grid (DCT-IV along axis
  0, DCT-II along axis 1), against their analytic fields;
* every call routes without raising, and the routes are the kernels'.

On the card the same paths run at 31104^2 and 65536 x 8192
(``chip_smoke.py`` phase 4m).

Tolerance: 5e-6 of max |JAX| against the JAX package in float32; 2e-6
against float64 oracles; 1e-5 of the peak against the analytic solutions.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api, gates

torch.set_num_threads(1)

F32 = torch.float32


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind,shape,axis,route", [
    ("dct2", (20864, 128), 0, api.DCT2_MID),
    ("dst3", (20864, 128), 0, api.DCT3_MID),
    ("dct3", (128, 20864), 1, api.DCT3_NAT),
    ("dst2", (128, 20864), 1, api.DCT2_NAT),
    ("dct4", (41728, 128), 0, api.DCT4_MID),
    ("dst4", (41728, 128), 0, api.DCT4_MID)])
def test_public_long_lengths_match_jax(kind, shape, axis, route):
    """The long forms under the Default norm against the JAX package's
    public function on the same input (k = 163 and F = 163 are prime)."""
    n = shape[axis]
    assert api._route(kind, shape, axis, F32, "cuda") == route
    x = _real(shape, n + axis)
    cls, rcls = (nd.DctHandler, ref.DctHandler) if kind[:3] == "dct" else (nd.DstHandler,
                                                                          ref.DstHandler)
    got = getattr(nd, f"nd{kind}")(torch.from_numpy(x), cls(n), axis=axis)
    want = getattr(ref, f"nd{kind}")(jnp.asarray(x), rcls(n), axis)
    _close(got, want, 5e-6)


@pytest.mark.parametrize("kind,shape,axis", [
    ("dct2", (32640, 128), 0), ("dct3", (2, 32640, 128), 1), ("dst2", (128, 32640), 1),
    ("dct4", (65536, 128), 0), ("dst4", (65536, 128), 0)])
def test_public_long_lengths_match_float64(kind, shape, axis):
    """The longest forms (k = 255, F = 256) against scipy.fft in float64."""
    sfft = pytest.importorskip("scipy.fft")
    n = shape[axis]
    x = _real(shape, n + 2 * axis)
    oracle = sfft.dct if kind[:3] == "dct" else sfft.dst
    got = getattr(nd, f"nd{kind}")(torch.from_numpy(x), axis=axis)
    _close(got, oracle(x.astype(np.float64), type=int(kind[3]), axis=axis), 2e-6)


@pytest.mark.parametrize("kind", ["dct", "dst"])
def test_spectral_long_lengths_match_jax(kind):
    """ndspectral_dct / ndspectral_dst along axis 0 at n = 20608 with a
    lane-varying multiplier: one route, kernel 29's n-point form."""
    n = 20608
    assert api._spectral_route("dct", (n, 128), 0, F32, "cuda") == api.SPECTRAL_DCT_MID
    x = _real((n, 128), n + (kind == "dst"))
    hv = _real((n, 128), n + 5)
    got = getattr(nd, f"ndspectral_{kind}")(torch.from_numpy(x), torch.from_numpy(hv), axis=0)
    want = getattr(ref, f"ndspectral_{kind}")(jnp.asarray(x), jnp.asarray(hv), axis=0)
    _close(got, want, 5e-6)


def _eigs(n, shift):
    """The 3-point Laplacian's eigenvalues (2 - 2 cos(pi (k + shift)/n)) n^2
    on the cell-centred grid of spacing 1/n."""
    return (2 - 2 * np.cos(np.pi * (np.arange(n) + shift) / n)) * n * n


def _fields(n0, n1, modes, shift0):
    """f and u of -lap_h u = f for u = sum amp cos((a + shift0) pi x)
    cos(b pi y) on the cell centres, and the eigenvalues lambda[k0, k1]."""
    x0 = (np.arange(n0) + 0.5) / n0
    x1 = (np.arange(n1) + 0.5) / n1
    lam = _eigs(n0, shift0)[:, None] + _eigs(n1, 0)[None, :]
    u = sum(amp * np.cos((a + shift0) * np.pi * x0)[:, None] * np.cos(b * np.pi * x1)[None, :]
            for a, b, amp in modes)
    f = sum(amp * lam[a, b] * np.cos((a + shift0) * np.pi * x0)[:, None]
            * np.cos(b * np.pi * x1)[None, :] for a, b, amp in modes)
    return f.astype(np.float32), u, lam


def test_neumann_solve_at_a_long_length():
    """G1 at a small depth: the cell-centred Neumann solve on 20608 x 130
    (kernel 25/26's n-point form along axis 0), by dctn / idctn of type 2
    and by ndspectral_dct along axis 0 with the lane-varying 1/lambda
    between the axis-1 DCTs, against the analytic u and the JAX package."""
    n0, n1 = 20608, 130
    f, u, lam = _fields(n0, n1, ((1, 2, 1.0), (5, 3, 0.5), (300, 40, 0.25)), 0)
    lam[0, 0] = np.inf
    inv = (1.0 / lam).astype(np.float32)
    ft = torch.from_numpy(f)
    got = nd.idctn(nd.dctn(ft, 2) * torch.from_numpy(inv), 2)
    _close(got, u, 1e-5)
    want = ref.ndapi.idctn(ref.ndapi.dctn(jnp.asarray(f), 2) * jnp.asarray(inv), 2)
    _close(got, want, 5e-6)
    hd = nd.DctHandler(n1)
    hdi = hd.normalization(nd.Normalization.scalar(1.0 / n1))
    h0 = nd.DctHandler(n0)
    h0i = h0.normalization(nd.Normalization.scalar(1.0 / n0))
    spec = nd.ndspectral_dct(nd.nddct2(ft, hd, axis=1), torch.from_numpy(inv), h0, h0i, axis=0)
    _close(nd.nddct3(spec, hdi, axis=1), u, 1e-5)


def test_mixed_solve_at_a_long_length():
    """G2 at a small depth: the mixed Neumann-Dirichlet solve on 65536 x 128
    (kernel 28's long form, F = 256, along axis 0; DCT-II/III along axis 1),
    against the analytic u."""
    n0, n1 = 65536, 128
    f, u, lam = _fields(n0, n1, ((0, 2, 1.0), (5, 3, 0.5), (300, 40, 0.25)), 0.5)
    ft = torch.from_numpy(f)
    fh = nd.dctn(nd.dctn(ft, 4, axes=(0,)), 2, axes=(1,))
    got = nd.idctn(nd.idctn(fh / torch.from_numpy(lam.astype(np.float32)), 2, axes=(1,)), 4,
                   axes=(0,))
    _close(got, u, 1e-5)


_R2R = tuple(f"{f}{t}" for f in ("dct", "dst") for t in (1, 2, 3, 4))


@pytest.mark.parametrize("kind", _R2R)
def test_r2r_census_raises_nothing(kind):
    """Every n = 2 ... 65536 along the middle axis of (n, 128) and the last
    axis of (128, n) routes on "cuda" to one of ``gates.ROUTES``; the long
    lengths take the long forms (DCT-II/III and DST-II/III at n = 128 k,
    odd 161 <= k <= 255 on kernels 23 to 26; DCT-IV and DST-IV at n = 256 F,
    161 <= F <= 256 on kernel 28 along the middle axis)."""
    t = int(kind[3])
    longs = []
    for n in range(2, 65537):
        for shape, axis in (((n, 128), 0), ((128, n), 1)):
            route = api._route(kind, shape, axis, F32, "cuda")
            assert route in gates.ROUTES, (kind, shape, route)
            if route in (api.DCT2_MID, api.DCT3_MID, api.DCT2_NAT, api.DCT3_NAT, api.DCT4_MID) \
                    and (n > 40960 if t == 4 else n > 20480 and n // 128 % 2):
                longs.append((n, axis))
    if t in (2, 3):
        want = [(128 * k, axis) for k in range(161, 256, 2) for axis in (0, 1)]
    elif t == 4:
        want = [(256 * f, 0) for f in range(161, 257)]
    else:
        want = []
    assert longs == want


@pytest.mark.parametrize("kind", ["r2c", "c2c", "dct"])
def test_spectral_census_raises_nothing(kind):
    """Every n = 2 ... 65536 along the middle axis of (n, 128) and the last
    axis of (128, n): the spectral route on "cuda" is the fused kernel or
    COMPOSE, whose legs are routes of ``gates.ROUTES``; the DCT's long
    n-point lengths fuse along the middle axis (``ndspectral_dst`` takes the
    DCT's route)."""
    dtype = torch.complex64 if kind == "c2c" else F32
    fused_long = []
    for n in range(2, 65537):
        for shape, axis in (((n, 128), 0), ((128, n), 1)):
            route = api._spectral_route(kind, shape, axis, dtype, "cuda")
            if route == api.COMPOSE:
                if kind == "r2c":
                    legs = [api._route("r2c", shape, axis, F32, "cuda")]
                elif kind == "c2c":
                    legs = [api._route("fft", shape, axis, dtype, "cuda")]
                else:
                    legs = [api._route(k, shape, axis, F32, "cuda") for k in ("dct2", "dct3")]
                assert set(legs) <= set(gates.ROUTES), (kind, shape)
            elif kind == "dct" and n > 20480 and n // 128 % 2:
                fused_long.append(n)
    assert fused_long == ([128 * k for k in range(161, 256, 2)] if kind == "dct" else [])
