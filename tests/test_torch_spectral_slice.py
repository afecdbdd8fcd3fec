"""The fused spectral pipelines ``ndspectral_r2c``, ``ndspectral_c2c``,
``ndspectral_dct`` and ``ndspectral_dst`` on CPU tensors against the JAX
package's (on the CPU the fused routes run the plain versions of kernels
22, 14 and 29):

* along a middle axis where the port fuses (axis 0 of (n, 128), axis 1 of
  (2, n, 130): nb > 1 and a ragged column), with a broadcast and a
  lane-varying multiplier, real and complex, in float32 (5e-6 of max |JAX|)
  and float64 (1e-12, the public composition in both packages);
* every composition case: odd n, the last axis, fewer than 128 columns, a
  multiplier of the full shape, a custom norm; separate forward and inverse
  norms (which fuse); the output dtype on both routes with a float64
  multiplier; the error strings and exceptions in the JAX package's order;
* a CPU gradient through the fused route against the composition's;
* the five cases of ``examples/fused_filter.py`` as asserted results;
* the route census: every kind over n = 2 ... 40960 along a middle axis of
  128 columns on "cuda" launches nothing, raises nothing (the DCT's long
  n-point lengths included), fuses exactly where the JAX gates do, and its
  compositions' legs are routes of ``gates.ROUTES``.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import dct as ref_pdct
from ndrustfft_tpu.ops.pallas import fft as ref_pfft
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft
from ndrustfft_tpu.plan import get_r2c_plan as ref_r2c_plan

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api, gates
from ndrustfft_tpu_torch.ops.hopper import dct as kdct

torch.set_num_threads(1)

TOL = {np.float32: 5e-6, np.float64: 1e-12}
F32, C64 = torch.float32, torch.complex64
KINDS = ("r2c", "c2c", "dct", "dst")
FUSED = {"r2c": api.SPECTRAL_R2C_MID, "c2c": api.SPECTRAL_C2C_MID,
         "dct": api.SPECTRAL_DCT_MID, "dst": api.SPECTRAL_DCT_MID}


@pytest.fixture
def jax_interpret():
    """The JAX package's Pallas kernels in interpret mode (its fused routes
    on the CPU)."""
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _x(kind, shape, dtype, key):
    g = _rng(kind, shape, key)
    x = g.standard_normal(shape)
    if kind == "c2c":
        x = x + 1j * g.standard_normal(shape)
        return x.astype(np.complex64 if dtype == np.float32 else np.complex128)
    return x.astype(dtype)


def _rows(kind, n):
    return n // 2 + 1 if kind == "r2c" else n


def _mult(kind, shape, dtype, key, cplx=False):
    g = _rng("mult", kind, shape, key)
    h = g.uniform(0.5, 1.5, shape)
    if cplx:
        h = h + 1j * g.standard_normal(shape)
        return h.astype(np.complex64 if dtype == np.float32 else np.complex128)
    return h.astype(dtype)


def _fns(kind):
    name = f"ndspectral_{kind}"
    return getattr(nd, name), getattr(ref, name)


def _handlers(kind, n, norm="default"):
    """Port and JAX handlers of the kind at n with the norm "default",
    "none", "scalar" or "custom"."""
    cls = {"r2c": "R2cFftHandler", "c2c": "FftHandler", "dct": "DctHandler",
           "dst": "DstHandler"}[kind]
    rnorm = {"default": ref.Normalization.DEFAULT, "none": ref.Normalization.NONE,
             "scalar": ref.Normalization.scalar(0.3),
             "custom": ref.Normalization.custom(_custom_fn)}[norm]
    rh = getattr(ref, cls)(n).normalization(rnorm)
    return getattr(nd, cls).from_reference(rh), rh


_custom_fn = lambda v: v * 0.25 + 1.0   # noqa: E731  (not linear: order matters)


def _run(kind, x, h, axis, norm="default", inv_norm=None):
    """Both packages' outputs of one call, with handlers of ``norm`` (and
    ``inv_norm`` for the DCT/DST inverse)."""
    n = x.shape[axis]
    pfn, rfn = _fns(kind)
    ph, rh = _handlers(kind, n, norm)
    kw_p, kw_r = {}, {}
    if inv_norm is not None:
        kw_p["inv_handler"], kw_r["inv_handler"] = _handlers(kind, n, inv_norm)
    got = pfn(torch.from_numpy(x), torch.from_numpy(h), ph, axis=axis, **kw_p)
    want = rfn(jnp.asarray(x), jnp.asarray(h), rh, axis=axis, **kw_r)
    return got, want


def _route(kind, x, h, axis, norm="default", inv_norm=None):
    """The port's route of the call on a CUDA tensor of x's shape."""
    dtype = {np.dtype(np.float32): F32, np.dtype(np.complex64): C64}.get(x.dtype, torch.float64)
    custom = "custom" in (norm, inv_norm)
    n = x.shape[axis]
    fusable = not custom and api._spectral_mult_cols(
        torch.empty(x.shape, device="meta"), torch.empty(h.shape, device="meta"), axis,
        _rows(kind, n)) is not None
    return api._spectral_route("dct" if kind == "dst" else kind, x.shape, axis, dtype, "cuda",
                               fusable)


# --------------------------------------------------------------------------
# The fused routes
# --------------------------------------------------------------------------

_FUSED_N = {"r2c": (512, 768), "c2c": (384, 512), "dct": (256, 384, 512), "dst": (512,)}
_FUSED_CASES = [(kind, n) for kind in KINDS for n in _FUSED_N[kind]]


@pytest.mark.parametrize("kind,n", _FUSED_CASES)
@pytest.mark.parametrize("layout", ["axis0_bcast", "axis1_lane"])
def test_fused_route_matches_jax(kind, n, layout):
    """Axis 0 of (n, 128) with a (rows,) multiplier, or axis 1 of
    (2, n, 130) with a (rows, 130) one: the port's fused route against the
    JAX package, Default norms; complex multipliers for R2C and C2C."""
    shape, axis = ((n, 128), 0) if layout == "axis0_bcast" else ((2, n, 130), 1)
    rows = _rows(kind, n)
    hshape = (rows,) if layout == "axis0_bcast" else (rows, 130)
    x = _x(kind, shape, np.float32, layout)
    h = _mult(kind, hshape, np.float32, layout, cplx=kind in ("r2c", "c2c"))
    assert _route(kind, x, h, axis) == FUSED[kind]
    got, want = _run(kind, x, h, axis)
    assert got.dtype == (C64 if kind == "c2c" else F32)
    _close(got, want, TOL[np.float32])


@pytest.mark.parametrize("kind,norm,inv_norm", [
    (kind, norm, None) for kind in KINDS for norm in ("none", "scalar")] + [
    (kind, norm, inv) for kind in ("dct", "dst") for norm, inv in (("none", "scalar"),
                                                                   ("default", "none"))])
def test_fused_route_under_each_fusable_norm(kind, norm, inv_norm):
    """NONE and scalar norms fuse too (the scale rides the kernels'
    constants), and for the DCT/DST separate forward and inverse norms."""
    n = 512
    x = _x(kind, (n, 128), np.float32, norm)
    h = _mult(kind, (_rows(kind, n),), np.float32, norm)
    assert _route(kind, x, h, 0, norm, inv_norm) == FUSED[kind]
    got, want = _run(kind, x, h, 0, norm, inv_norm)
    _close(got, want, TOL[np.float32])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["axis0", "last"])
def test_float64_composes_and_matches_jax(kind, layout):
    n = 512
    shape, axis = ((n, 128), 0) if layout == "axis0" else ((6, n), 1)
    x = _x(kind, shape, np.float64, layout)
    h = _mult(kind, (_rows(kind, n),), np.float64, layout, cplx=kind == "c2c")
    assert _route(kind, x, h, axis) == api.COMPOSE
    got, want = _run(kind, x, h, axis)
    assert got.dtype == (torch.complex128 if kind == "c2c" else torch.float64)
    _close(got, want, TOL[np.float64])


# --------------------------------------------------------------------------
# The compositions
# --------------------------------------------------------------------------

_ODD = {"r2c": 513, "c2c": 509, "dct": 513, "dst": 511}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", ["odd_n", "last_axis", "few_cols", "full_shape", "custom"])
def test_composition_cases_match_jax(kind, case):
    """Each case the JAX package composes: an odd n (a length no fused
    kernel takes), the last axis, 64 < 128 columns, a multiplier of the
    full shape (nb > 1), a custom norm (the callable must see the true
    transform)."""
    n = _ODD[kind] if case == "odd_n" else 512
    shape, axis = {"odd_n": ((n, 130), 0), "last_axis": ((130, n), 1),
                   "few_cols": ((n, 64), 0), "full_shape": ((2, n, 130), 1),
                   "custom": ((n, 128), 0)}[case]
    rows = _rows(kind, n)
    hshape = (2, rows, 130) if case == "full_shape" else (rows,)
    norm = "custom" if case == "custom" else "default"
    x = _x(kind, shape, np.float32, case)
    h = _mult(kind, hshape, np.float32, case, cplx=kind in ("r2c", "c2c"))
    assert _route(kind, x, h, axis, norm) == api.COMPOSE
    got, want = _run(kind, x, h, axis, norm)
    _close(got, want, TOL[np.float32])


@pytest.mark.parametrize("kind", ["r2c", "c2c", "dct", "dst"])
@pytest.mark.parametrize("layout", ["fused", "compose"])
def test_output_dtype_on_both_routes(kind, layout, jax_interpret):
    """A float64 multiplier (complex128 for C2C): the fused routes return x's
    dtype, the compositions promote the product (float64 / complex128), in
    both packages (the JAX package's fused routes run here in interpret
    mode)."""
    n = 512
    shape, axis = ((n, 128), 0) if layout == "fused" else ((4, n), 1)
    x = _x(kind, shape, np.float32, "dtype")
    h = _mult(kind, (_rows(kind, n),), np.float64, "dtype", cplx=kind == "c2c")
    assert (_route(kind, x, h, axis) == api.COMPOSE) == (layout == "compose")
    got, want = _run(kind, x, h, axis)
    want_dtype = {"fused": {"c2c": C64}, "compose": {"c2c": torch.complex128}}[layout].get(
        kind, F32 if layout == "fused" else torch.float64)
    assert got.dtype == want_dtype
    assert np.dtype(want.dtype) == np.dtype(str(want_dtype).split(".")[1])
    _close(got, want, TOL[np.float32])


def test_real_multiplier_and_the_conjugation():
    """ndspectral_dst is a * ndspectral_dct(a x, flip(H)) with a = (-1)^t
    (the flip along the frequency axis of a lane-varying H), exactly the
    composition nddst3(H nddst2(x))."""
    n = 384
    x = torch.from_numpy(_x("dst", (2, n, 130), np.float32, "conj"))
    h = torch.from_numpy(_mult("dst", (n, 130), np.float32, "conj"))
    inv = nd.DstHandler(n).normalization(nd.Normalization.scalar(1.0 / n))
    y = nd.ndspectral_dst(x, h, None, inv, axis=1)
    want = nd.nddst3(h * nd.nddst2(x, axis=1), inv, axis=1)
    _close(y, want.numpy(), TOL[np.float32])


# --------------------------------------------------------------------------
# Errors, inputs, gradients
# --------------------------------------------------------------------------

_ERRORS = [
    ("r2c", lambda m: m.ndspectral_r2c(np.zeros((500, 128), np.float32), np.ones(257),
                                       m.R2cFftHandler(512), axis=0)),
    ("c2c", lambda m: m.ndspectral_c2c(np.zeros((500, 128), np.complex64), np.ones(512),
                                       m.FftHandler(512), axis=0)),
    ("r2c", lambda m: m.ndspectral_r2c(np.zeros((512, 128), np.complex64), np.ones(257),
                                       axis=0)),
    ("dct", lambda m: m.ndspectral_dct(np.zeros((512, 128), np.float32), np.ones(512),
                                       m.DctHandler(512), m.DctHandler(256), axis=0)),
    ("dst", lambda m: m.ndspectral_dst(np.zeros((512, 128), np.float32), np.ones(512),
                                       m.DstHandler(512), m.DstHandler(256), axis=0)),
    ("dct", lambda m: m.ndspectral_dct(np.zeros((512, 128), np.float32), np.ones(512) * 1j,
                                       axis=0)),
    ("dst", lambda m: m.ndspectral_dst(np.zeros((512, 128), np.float32), np.ones(512) * 1j,
                                       axis=0)),
    ("dct", lambda m: m.ndspectral_dct(np.zeros((500, 128), np.float32), np.ones(512),
                                       m.DctHandler(512), axis=0)),
    ("dst", lambda m: m.ndspectral_dst(np.zeros((500, 128), np.float32), np.ones(512),
                                       m.DstHandler(512), axis=0)),
    ("dct", lambda m: m.ndspectral_dct(np.zeros((512, 128), np.complex64), np.ones(512),
                                       axis=0)),
    ("r2c", lambda m: m.ndspectral_r2c(np.zeros((512, 128), np.float32), np.ones(257),
                                       axis=2)),
]


@pytest.mark.parametrize("case", range(len(_ERRORS)))
def test_errors_match_jax(case):
    """The same exception type and message in the JAX package's order of
    checks (the port's non-tensor input would go to the CUDA device, so its
    inputs are CPU tensors here)."""
    _, call = _ERRORS[case]

    class Port:
        def __getattr__(self, name):
            fn = getattr(nd, name)
            if not name.startswith("ndspectral"):
                return fn
            return lambda x, h, *a, **k: fn(torch.from_numpy(np.asarray(x)),
                                             torch.from_numpy(np.asarray(h)), *a, **k)

    class Jax:
        def __getattr__(self, name):
            fn = getattr(ref, name)
            if not name.startswith("ndspectral"):
                return fn
            return lambda x, h, *a, **k: fn(jnp.asarray(x), jnp.asarray(h), *a, **k)

    with pytest.raises((ValueError, TypeError)) as want:
        call(Jax())
    with pytest.raises(want.type) as got:
        call(Port())
    assert str(got.value) == str(want.value)


def test_non_tensor_input_goes_to_cuda():
    x = np.ones((512, 128), np.float32)
    if torch.cuda.is_available():
        assert nd.ndspectral_dct(x, np.ones(512), axis=0).device.type == "cuda"
        return
    for fn, rows in ((nd.ndspectral_r2c, 257), (nd.ndspectral_dct, 512),
                     (nd.ndspectral_dst, 512)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn(x, np.ones(rows), axis=0)
    y = nd.ndspectral_dct(torch.from_numpy(x), np.ones(512), axis=0)
    assert y.device.type == "cpu"


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_gradient_through_the_fused_route(kind):
    """A CPU tensor differentiates through the plain versions: the fused
    route's gradients in x and in the multiplier equal the composition's."""
    n = 384 if kind in ("c2c", "dct", "dst") else 512
    x = torch.from_numpy(_x(kind, (n, 128), np.float32, "grad"))
    h = torch.from_numpy(_mult(kind, (_rows(kind, n), 128), np.float32, "grad"))
    assert _route(kind, x.numpy(), h.numpy(), 0) == FUSED[kind]
    pfn, _ = _fns(kind)
    comp = {"r2c": lambda a, b: nd.ndifft_r2c(b * nd.ndfft_r2c(a, axis=0), axis=0),
            "c2c": lambda a, b: nd.ndifft(b * nd.ndfft(a, axis=0), axis=0),
            "dct": lambda a, b: nd.nddct3(b * nd.nddct2(a, axis=0), axis=0),
            "dst": lambda a, b: nd.nddst3(b * nd.nddst2(a, axis=0), axis=0)}[kind]
    grads = []
    for fn in (lambda a, b: pfn(a, b, axis=0), comp):
        a, b = x.clone().requires_grad_(), h.clone().requires_grad_()
        y = fn(a, b)
        (y.abs() ** 2).sum().backward()
        grads.append((a.grad, b.grad))
    for got, want in zip(*grads):
        _close(got, want.numpy(), 1e-5)


# --------------------------------------------------------------------------
# examples/fused_filter.py on the port
# --------------------------------------------------------------------------


def test_fused_filter_example_cases():
    """The five cases of examples/fused_filter.py (float64, the public
    composition), with the example's tolerances."""
    n = 256
    h = nd.R2cFftHandler(n)
    k = np.fft.rfftfreq(n, d=1.0 / n)
    t = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    x = np.sin(3 * t) + 0.5 * np.cos(7 * t) + 0.2 * np.sin(100 * t)
    xb = torch.from_numpy(np.broadcast_to(x, (4, n)).copy())
    keep = torch.from_numpy((k <= n // 3).astype(np.float64))
    y = nd.ndspectral_r2c(xb, keep, h, axis=1)
    comp = nd.ndifft_r2c(keep[None, :] * nd.ndfft_r2c(xb, h, axis=1), h, axis=1)
    assert float((y - comp).abs().max()) < 1e-12
    assert float((y[0] - torch.from_numpy(np.sin(3 * t) + 0.5 * np.cos(7 * t))).abs().max()) \
        < 1e-10
    xs = torch.from_numpy(np.broadcast_to(np.sin(3 * t), (4, n)).copy())
    dx = nd.ndspectral_r2c(xs, torch.from_numpy(1j * k), h, axis=1)
    assert float((dx[0] - torch.from_numpy(3.0 * np.cos(3 * t))).abs().max()) < 1e-9
    f = torch.from_numpy(np.broadcast_to(-9.0 * np.sin(3 * t), (4, n)).copy())
    inv_k2 = np.zeros_like(k)
    inv_k2[1:] = -1.0 / k[1:] ** 2
    u = nd.ndspectral_r2c(f, torch.from_numpy(inv_k2), h, axis=1)
    assert float((u[0] - torch.from_numpy(np.sin(3 * t))).abs().max()) < 1e-9
    nn = 128
    tc = (np.arange(nn) + 0.5) * np.pi / nn
    fb = torch.from_numpy(np.broadcast_to(9.0 * np.cos(3 * tc), (4, nn)).copy())
    lam = np.zeros(nn)
    lam[1:] = 1.0 / np.arange(1, nn) ** 2
    h2 = nd.DctHandler(nn).normalization(nd.Normalization.NONE)
    h3 = nd.DctHandler(nn).normalization(nd.Normalization.scalar(2.0 / nn))
    u = nd.ndspectral_dct(fb, torch.from_numpy(lam), h2, h3, axis=1)
    assert float((u[0] - torch.from_numpy(np.cos(3 * tc))).abs().max()) < 1e-9
    ny, nx = 64, 128
    ty = np.linspace(0, 2 * np.pi, ny, endpoint=False)
    tx = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    u_true = np.sin(3 * ty)[:, None] * np.cos(5 * tx)[None, :]
    ky = np.fft.fftfreq(ny, 1.0 / ny)
    kx = np.fft.rfftfreq(nx, 1.0 / nx)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    g = np.zeros((ny, kx.size))
    g[k2 > 0] = 1.0 / k2[k2 > 0]
    hx = nd.R2cFftHandler(nx)
    w = nd.ndfft_r2c(torch.from_numpy((3 ** 2 + 5 ** 2) * u_true), hx, axis=1)
    w = nd.ndspectral_c2c(w, torch.from_numpy(g + 0j), nd.FftHandler(ny), axis=0)
    u2 = nd.ndifft_r2c(w, hx, axis=1)
    assert float((u2 - torch.from_numpy(u_true)).abs().max()) < 1e-9


def test_fused_filter_cases_on_the_fused_routes():
    """The example's operators in float32 along axis 0 of fields with 128
    columns, where the port fuses: the low-pass and the derivative (K22),
    the Neumann solve (K29) and the 2-D Poisson solve with a lane-varying
    multiplier (K14), against the same oracles at float32's tolerance."""
    n = 512
    k = np.fft.rfftfreq(n, d=1.0 / n)
    t = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    cols = np.ones(128)
    x = (np.sin(3 * t) + 0.5 * np.cos(7 * t) + 0.2 * np.sin(200 * t))[:, None] * cols
    keep = torch.from_numpy((k <= n // 3).astype(np.float32))
    y = nd.ndspectral_r2c(torch.from_numpy(x.astype(np.float32)), keep, axis=0)
    assert api._spectral_route("r2c", x.shape, 0, F32, "cuda") == api.SPECTRAL_R2C_MID
    _close(y, (np.sin(3 * t) + 0.5 * np.cos(7 * t))[:, None] * cols, 1e-5)
    xs = (np.sin(3 * t)[:, None] * cols).astype(np.float32)
    dx = nd.ndspectral_r2c(torch.from_numpy(xs), torch.from_numpy((1j * k).astype(np.complex64)),
                           axis=0)
    # i k amplifies the float32 roundoff of bin k by k <= n/2: ~1e-7 * 256
    _close(dx, 3.0 * np.cos(3 * t)[:, None] * cols, 5e-5)
    nn = 512
    tc = (np.arange(nn) + 0.5) * np.pi / nn
    lam = np.zeros(nn, np.float32)
    lam[1:] = 1.0 / np.arange(1, nn) ** 2
    h2 = nd.DctHandler(nn).normalization(nd.Normalization.NONE)
    h3 = nd.DctHandler(nn).normalization(nd.Normalization.scalar(2.0 / nn))
    fb = (9.0 * np.cos(3 * tc)[:, None] * cols).astype(np.float32)
    u = nd.ndspectral_dct(torch.from_numpy(fb), torch.from_numpy(lam), h2, h3, axis=0)
    _close(u, np.cos(3 * tc)[:, None] * cols, 1e-5)
    ny, nx = 512, 256
    ty = np.linspace(0, 2 * np.pi, ny, endpoint=False)
    tx = np.linspace(0, 2 * np.pi, nx, endpoint=False)
    u_true = np.sin(3 * ty)[:, None] * np.cos(5 * tx)[None, :]
    ky = np.fft.fftfreq(ny, 1.0 / ny)
    kx = np.fft.rfftfreq(nx, 1.0 / nx)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    g = np.zeros((ny, kx.size), np.float32)
    g[k2 > 0] = 1.0 / k2[k2 > 0]
    f = torch.from_numpy(((3 ** 2 + 5 ** 2) * u_true).astype(np.float32))
    w = nd.ndfft_r2c(f, axis=1)
    assert api._spectral_route("c2c", w.shape, 0, C64, "cuda") == api.SPECTRAL_C2C_MID
    w = nd.ndspectral_c2c(w, torch.from_numpy(g), axis=0)
    _close(nd.ndifft_r2c(w, axis=1), u_true, 1e-5)


# --------------------------------------------------------------------------
# The route census
# --------------------------------------------------------------------------

_MAX_N = 40960


def _jax_fuses(kind, n):
    """The JAX package's gate of its fused kernel at n (float32)."""
    if kind == "r2c":
        return ref_prfft.rfft_nat_supported(ref_r2c_plan(n), jnp.float32)
    if kind == "c2c":
        return ref_pfft.spectral_c2c_mid_supported(n, jnp.float32)
    return ref_pdct.dct_pallas_supported(n, jnp.float32)


def _legs(kind, n):
    """The routes of the composition's legs on (1, n, 128) along axis 1."""
    shape = (1, n, 128)
    if kind == "r2c":
        return (api._route("r2c", shape, 1, F32, "cuda"),
                api._route("c2r", (1, n // 2 + 1, 128), 1, C64, "cuda", n=n))
    if kind == "c2c":
        return (api._route("fft", shape, 1, C64, "cuda"), api._route("ifft", shape, 1, C64, "cuda"))
    return (api._route("dct2", shape, 1, F32, "cuda"), api._route("dct3", shape, 1, F32, "cuda"))


@pytest.mark.parametrize("kind", ["r2c", "c2c", "dct"])
def test_route_census(kind, jax_interpret):
    """Every n = 2 ... 40960 along axis 1 of (1, n, 128) on "cuda": the route
    is the fused one or COMPOSE, and nothing raises (the DCT lengths
    n = 128 k with odd k > 160, which raised spectral_dct_long before the
    long n-point form was ported, fuse); the composition's legs are routes
    of ``gates.ROUTES``. The fused route is taken exactly where the JAX gate
    says: checked at every n for the DCT, and for R2C and C2C at every n the
    port fuses, every n <= 2048 and every multiple of 64 above (the JAX
    gates plan every length, ~4 minutes for the whole sweep)."""
    dtype = C64 if kind == "c2c" else F32
    fused = []
    for n in range(2, _MAX_N + 1):
        route = api._spectral_route(kind, (1, n, 128), 1, dtype, "cuda")
        if route == api.COMPOSE:
            assert set(_legs(kind, n)) <= set(gates.ROUTES), (kind, n)
        else:
            assert route == FUSED[kind], (kind, n)
            fused.append(n)
    if kind == "dct":
        want = [n for n in range(2, _MAX_N + 1) if _jax_fuses(kind, n)]
        assert fused == want
        assert [n for n in fused if kdct.dct_form(n)[0] == "npoint" and n > 20480] == \
            [128 * k for k in range(161, 256, 2)]
        assert fused[0] == 128 and len(fused) == 208 + 48
        return
    assert all(_jax_fuses(kind, n) for n in fused)
    sample = sorted(set(range(2, 2049)) | set(range(2048, _MAX_N + 1, 64)))
    assert [n for n in sample if _jax_fuses(kind, n)] == [n for n in sample if n in fused]
    assert len(fused) == {"r2c": 153, "c2c": 152}[kind]


def test_census_on_the_cpu_composes_the_long_dct():
    """The long n-point DCT lengths fuse on a CPU tensor as on a CUDA one
    (they composed on the CPU while the long form was not ported): one
    route per call on both devices, kernel 29's n-point form."""
    for n in (20352, 20608, 32640):
        for device_type in ("cpu", "cuda"):
            assert api._spectral_route("dct", (1, n, 128), 1, F32, device_type) == \
                api.SPECTRAL_DCT_MID
    assert not hasattr(gates, "UNPORTED")
    assert kdct.dct_form(20608) == ("npoint", 161)


@pytest.mark.parametrize("name", ["ndspectral_r2c", "ndspectral_c2c", "ndspectral_dct",
                                  "ndspectral_dst"])
def test_the_port_exports_the_fused_pipelines(name):
    """The four names the JAX package exports (its __init__.py) are the
    port's public functions, with the JAX package's parameters."""
    import inspect

    assert name in nd.__all__ and name in ref.__all__
    port_params = list(inspect.signature(getattr(nd, name)).parameters)
    ref_params = list(inspect.signature(getattr(ref, name)).parameters)
    assert port_params == ref_params
