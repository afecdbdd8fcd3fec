"""The four-step long C2C (kernels 7 and 13, ``engine._fourstep``) through
the public functions against the JAX package, whose four-step runs its
Pallas kernels in interpret mode; on the CPU the port's wrappers run their
plain versions:

* ``ndfft``/``ndifft`` (Default normalization) at 20736 (a dense K7 and
  K8's rows with a swap), 32768 (dense K7, K13 at F = 1), 36992 (wide K7 at
  F = 17, K8's rows of 17), 40960, 65536 (K13 at F = 2), 131072 (fixed K7,
  F = 4) and 147456 (wide K7 and K13 at F = 3), along the last axis and
  along axis 0, over 1 and 3 rows, and one row of 2^20 (fixed K7 and K13 at
  F = 8);
* the lane's chirp-z at the Bluestein length 10007 (its sub-FFTs of length
  M = 20736 on the four-step);
* ``ndfft_r2c``/``ndifft_r2c`` at 65536 (the packed lowering's and the
  Hermitian extension's C2C on the four-step), ``nddct4`` at 32768 and
  ``nddct2``/``nddct3`` at 65536 on 2 rows;
* the route sweep over n = 2 ... 20480 on the grid of
  ``test_no_route_needs_a_missing_bluestein_kernel`` and over n = 20481 ...
  65536 on 128 rows: no call raises the four-step key any more.

Each case asserts the route it takes on a CUDA tensor (``api._route``) and
that the torch engine does not run (``engine.c2c.calls``). Tolerance:
5e-6 of max |JAX| in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api, gates
from ndrustfft_tpu_torch.ops import engine

torch.set_num_threads(1)

TOL = 5e-6
F32, C64 = torch.float32, torch.complex64
_KINDS = ("fft", "ifft", "r2c", "c2r") + tuple(f"{f}{t}" for f in ("dct", "dst")
                                               for t in (1, 2, 3, 4))


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _rng(seed):
    return np.random.default_rng(seed)


def _crandn(shape, seed):
    g = _rng(seed)
    return (g.standard_normal(shape) + 1j * g.standard_normal(shape)).astype(np.complex64)


def _c2c_round_trip(x, n, axis, want_route, k13):
    """ndfft then ndifft of x along ``axis`` in both packages; the route on
    a CUDA tensor, the K7/K13 calls (the plain versions count nothing on the
    CPU, so the engine counter is what must not move) and both outputs."""
    assert api._route("fft", x.shape, axis, C64, "cuda") == want_route
    assert api._route("ifft", x.shape, axis, C64, "cuda") == want_route
    h, rh = nd.FftHandler(n), ref.FftHandler(n)
    calls = engine.c2c.calls
    y = nd.ndfft(torch.from_numpy(x), h, axis=axis)
    back = nd.ndifft(y, h, axis=axis)
    assert engine.c2c.calls == calls
    want = ref.ndfft(jnp.asarray(x), rh, axis)
    _close(y, want)
    _close(back, ref.ndifft(want, rh, axis))
    _close(back, x, 1e-5)
    if want_route == api.C2C_FOURSTEP:
        n1, n2 = gates._fourstep_split(n)
        assert (gates._twostep_split(n2) is not None) == k13


@pytest.mark.parametrize("n,k13", [(20736, False), (32768, True), (36992, False),
                                   (40960, False), (65536, True), (131072, True),
                                   (147456, True)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("batch", [1, 3])
def test_ndfft_four_step_lengths(n, k13, axis, batch):
    shape = (batch, n) if axis == 1 else (n, batch)
    _c2c_round_trip(_crandn(shape, n + batch + axis), n, axis, api.C2C_FOURSTEP, k13)


def test_ndfft_one_row_of_2_20():
    n = 1 << 20
    assert gates._fourstep_split(n) == (1024, 1024)
    _c2c_round_trip(_crandn((1, n), 20), n, 1, api.C2C_FOURSTEP, True)


@pytest.mark.parametrize("rows", [3, 128])
def test_lane_chirp_z_at_10007(rows):
    """n = 10007 is prime: the lane's chirp-z, whose sub-FFTs of length
    M = 20736 = 144 * 144 take the four-step (it raised before K7 was
    ported)."""
    assert gates.lane_c2c_route(20736, rows) == api.C2C_FOURSTEP
    x = _crandn((rows, 10007), rows)
    _c2c_round_trip(x, 10007, 1, api.BLUESTEIN_LANE, False)


def test_r2c_c2r_at_65536():
    n = 65536
    x = _rng(3).standard_normal((2, n)).astype(np.float32)
    assert api._route("r2c", x.shape, 1, F32, "cuda") == api.R2C_PACKED
    assert api._route("c2r", (2, n // 2 + 1), 1, C64, "cuda", n=n) == api.C2R_LANE
    h, rh = nd.R2cFftHandler(n), ref.R2cFftHandler(n)
    calls = engine.c2c.calls
    s = nd.ndfft_r2c(torch.from_numpy(x), h, axis=1)
    back = nd.ndifft_r2c(s, h, axis=1)
    assert engine.c2c.calls == calls
    want = ref.ndfft_r2c(jnp.asarray(x), rh, 1)
    _close(s, want)
    _close(back, ref.ndifft_r2c(want, rh, 1))


@pytest.mark.parametrize("kind,n,want_route", [("dct4", 32768, api.DCT_LANE),
                                               ("dct2", 65536, api.R2C_PACKED),
                                               ("dct3", 65536, api.DCT_LANE)])
def test_dct_lanes_at_four_step_lengths(kind, n, want_route):
    x = _rng(n).standard_normal((2, n)).astype(np.float32)
    assert api._route(kind, x.shape, 1, F32, "cuda") == want_route
    calls = engine.c2c.calls
    got = getattr(nd, f"nd{kind}")(torch.from_numpy(x), nd.DctHandler(n), axis=1)
    assert engine.c2c.calls == calls
    _close(got, getattr(ref, f"nd{kind}")(jnp.asarray(x), ref.DctHandler(n), 1))


def _route_or_key(kind, shape, axis, n):
    dtype = C64 if kind in ("fft", "ifft", "c2r") else F32
    if kind == "c2r":
        shape = tuple(n // 2 + 1 if i == axis else s for i, s in enumerate(shape))
    return api._route(kind, shape, axis, dtype, "cuda", n=n if kind == "c2r" else None)


def test_no_route_raises_the_four_step_key():
    """Over n = 2 ... 20480 on 128 rows, 4 rows and along axis 0 of (n, 128),
    over n = 20481 ... 65536 on 128 rows, and over a sample of n up to 2^22
    on 4 rows, no call of any kind raises for want of kernels 7 and 13 or
    any other (the DCT long forms raised before they were ported). Every
    four-step length of the complex transform takes C2C_FOURSTEP, and the
    other kinds' lowerings their own names."""
    counts = {}
    grid = [(n, ((128, n), 1), ((4, n), 1), ((n, 128), 0)) for n in range(2, 20481)]
    grid += [(n, ((128, n), 1)) for n in range(20481, 65537)]
    sample = _rng(13).integers(65537, (1 << 22) + 1, 200).tolist() + [1 << 20, 1 << 22]
    grid += [(n, ((4, n), 1)) for n in sample]
    for n, *cases in grid:
        for kind in _KINDS:
            for shape, axis in cases:
                route = _route_or_key(kind, shape, axis, n)
                counts[route] = counts.get(route, 0) + 1
                if kind not in ("fft", "ifft"):
                    assert route != api.C2C_FOURSTEP, (kind, n)
    assert set(counts) <= set(gates.ROUTES)
    assert counts[api.DCT4_MID] > 0 and counts[api.DCT2_MID] > 0
    assert counts[api.C2C_FOURSTEP] > 2 * 5000


def test_no_split_row_pass_takes_kernel_8():
    """Where n2 has no twostep split (n2 <= 256), the row pass runs over
    B n1 rows with n1 >= 128 at every four-step length, so even one row of
    n takes kernel 8's dense rows (or, at a prime n2 > 128 such as 137 in
    20550 = 150 * 137, the lane's chirp-z on kernel 10) and never the
    engine."""
    for n in range(20481, 65537):
        split = gates._fourstep_split(n)
        if split is None or gates._twostep_split(split[1]) is not None:
            continue
        n1, n2 = split
        assert n1 >= 128, n
        assert gates.lane_c2c_route(n2, n1) in (api.C2C_DENSE_ROWS, api.BLUESTEIN_LANE), n
    for n in (25000, 20550):          # (200, 125) and (150, 137)
        x = _crandn((1, n), 5)
        calls = engine.c2c.calls
        y = nd.ndfft(torch.from_numpy(x), nd.FftHandler(n), axis=1)
        assert engine.c2c.calls == calls
        _close(y, ref.ndfft(jnp.asarray(x), ref.FftHandler(n), 1))
