"""Kernels 3 and 17 on the radix core (``csrc/rfft_radix.cu`` on the row
core, ``csrc/rfft_mid_radix.cu`` on the column tile, the inverse unpack a
prologue in shared memory): their plain versions ``c2r_nat_plain`` and
``c2r_mid_plain`` against the JAX package's Pallas kernels in
interpret mode and against float64 numpy, the census of the lengths each
route takes, the columns a tile, and the wrappers on a CPU tensor.

* ``c2r_pallas_nat`` (kernel 3's TPU kernel) at h = 256, 384, 640, 1280
  over a ragged row count, and ``c2r_pallas_mid`` (kernel 17's) at
  (1, 513, 130), (2, 385, 200), (2, 641, 130), with the scales 1/n and -0.5;
* ``numpy.fft.irfft`` in float64 at every 5th of each route's 153 lengths;
* the census: the C2R along the last axis of (128, h + 1) takes kernel 3
  at exactly the 153 half lengths h = 128 * F, 256 ... 20480, with a plan,
  and along axis 1 of (1, h + 1, 130) kernel 17 at the same 153, each with
  a radix plan of h;
* the DC and Nyquist imaginary parts are ignored;
* on a CPU tensor each wrapper runs its plain version and counts no launch.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| at the JAX package's
"highest" tier; 2e-6 of max |numpy| against float64.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import rfft as ref_rfft

from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL64 = 2e-6
C64 = torch.complex64


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol=TOL):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _spec(shape, seed):
    """A complex64 half spectrum; bins along axis 1."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@lru_cache(maxsize=None)
def _halves(route: str):
    """The half lengths h <= 20480 whose float32 C2R of n = 2h takes
    ``route`` on a CUDA tensor: along the last axis of (128, h + 1) for
    C2R_NAT, along axis 1 of (1, h + 1, 130) for C2R_MID."""
    shape = (lambda m: (128, m)) if route == api.C2R_NAT else (lambda m: (1, m, 130))
    axis = 1
    return tuple(h for h in range(1, kfft.GENERIC_MAX_N + 1)
                 if api._route("c2r", shape(h + 1), axis, C64, "cuda", n=2 * h) == route)


# --------------------------------------------------------------------------
# The plain versions against the Pallas kernels and float64 numpy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,t", [(256, 131), (384, 33), (640, 7), (1280, 5)])
@pytest.mark.parametrize("scale", [None, "inv_n", -0.5])
def test_c2r_nat_plain_matches_pallas(h, t, scale):
    """Kernel 3 at F = 2, 3, 5, 10, a row count that no tile divides."""
    n = 2 * h
    spec = _spec((t, h + 1), h + t)
    s = 1.0 / n if scale == "inv_n" else scale
    want = ref_rfft.c2r_pallas_nat(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, s)
    got = krfft.c2r_nat_plain(torch.from_numpy(spec), n, s)
    assert got.dtype == torch.float32 and got.shape == (t, n)
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1, 513, 130), (2, 385, 200), (2, 641, 130)])
@pytest.mark.parametrize("scale", ["inv_n", -0.5])
def test_c2r_mid_plain_matches_pallas(shape, scale):
    """Kernel 17 at F = 4, 3, 5, ragged L and B > 1."""
    nb, m, cols = shape
    n = 2 * (m - 1)
    spec = _spec(shape, m + cols)
    s = 1.0 / n if scale == "inv_n" else scale
    want = ref_rfft.c2r_pallas_mid(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, s)
    got = krfft.c2r_mid_plain(torch.from_numpy(spec), n, s)
    assert got.dtype == torch.float32 and got.shape == (nb, n, cols)
    _close(got.numpy(), want)


@pytest.mark.parametrize("i", range(0, 153, 5))
def test_c2r_nat_plain_matches_float64(i):
    h = _halves(api.C2R_NAT)[i]
    n = 2 * h
    spec = _spec((3, h + 1), h)
    got = krfft.c2r_nat_plain(torch.from_numpy(spec), n, 1.0 / n)
    _close(got.numpy(), np.fft.irfft(spec.astype(np.complex128), n=n, axis=1), TOL64)


@pytest.mark.parametrize("i", range(0, 153, 5))
def test_c2r_mid_plain_matches_float64(i):
    h = _halves(api.C2R_MID)[i]
    n = 2 * h
    spec = _spec((1, h + 1, 3), h + 1)
    got = krfft.c2r_mid_plain(torch.from_numpy(spec), n, 1.0 / n)
    _close(got.numpy(), np.fft.irfft(spec.astype(np.complex128), n=n, axis=1), TOL64)


@pytest.mark.parametrize("kernel", ["c2r_nat", "c2r_mid"])
def test_dc_and_nyquist_imaginary_parts_are_ignored(kernel):
    n = 768
    shape = (5, n // 2 + 1) if kernel == "c2r_nat" else (2, n // 2 + 1, 130)
    spec = _spec(shape, 3)
    plain = krfft.c2r_nat_plain if kernel == "c2r_nat" else krfft.c2r_mid_plain
    want = plain(torch.from_numpy(spec), n, -0.5)
    spec[:, 0] += 100j
    spec[:, -1] -= 100j
    got = plain(torch.from_numpy(spec), n, -0.5)
    _close(got.numpy(), want.numpy(), 1e-6)
    _close(got.numpy(), -0.5 * n * np.fft.irfft(spec.astype(np.complex128), n=n, axis=1),
           TOL64)


# --------------------------------------------------------------------------
# The census and the columns a tile
# --------------------------------------------------------------------------


@pytest.mark.parametrize("route", [api.C2R_NAT, api.C2R_MID])
def test_census(route):
    """153 half lengths h = 128 * F, 256 ... 20480, each with a radix plan;
    the same for both routes."""
    halves = _halves(route)
    assert len(halves) == 153 and (halves[0], halves[-1]) == (256, 20480)
    assert all(h % 128 == 0 and kfft.core_f(h) is not None for h in halves)
    assert all(kfft.radix_plan(h) is not None for h in halves)
    assert halves == tuple(h for h in range(256, 20481, 128) if kfft.core_f(h) is not None)
    assert _halves(api.C2R_NAT) == _halves(api.C2R_MID)


def test_columns_a_tile():
    """Kernel 18's rule at every half length of the route: a power of two
    whose tile a block takes (at most 20480 elements, 256 threads in the
    16-element form, 512 above); kernel 16's count below h = 1024, up to
    16 columns from h = 1024 on."""
    for h in _halves(api.C2R_MID):
        for nb, cols in ((1, 130), (1, 1 << 18), (512, 512)):
            c = krfft.c2r_mid_cols(h, nb, cols, 132)
            assert c == krfft.packed_mid_cols(h, nb, cols, 132)
            assert c & (c - 1) == 0 and h * c <= kfft.RADIX_MAX_ELEMS
            assert kfft.radix_cols_threads(h, c) <= (
                kfft.RADIX_MAX_THREADS if h * c <= kfft.RADIX_WIDE_N else 512)
    assert krfft.c2r_mid_cols(256, 1, 262144, 132) == krfft.r2c_mid_cols(512, 1, 262144, 132)
    assert krfft.c2r_mid_cols(640, 1, 1280, 132) == krfft.r2c_mid_cols(1280, 1, 1280, 132)


# --------------------------------------------------------------------------
# The wrappers on a CPU tensor
# --------------------------------------------------------------------------


def _counts():
    return [(f.launches, f.radix_launches) for f in (krfft.c2r_nat, krfft.c2r_mid)]


@pytest.mark.parametrize("h", [256, 384, 20480])
def test_wrappers_on_cpu_run_the_plain_version(h):
    n = 2 * h
    rows = torch.from_numpy(_spec((3, h + 1), h + 5))
    cols = torch.from_numpy(_spec((1, h + 1, 5), h + 6))
    before = _counts()
    assert torch.equal(krfft.c2r_nat(rows, n, 1.0 / n), krfft.c2r_nat_plain(rows, n, 1.0 / n))
    assert torch.equal(krfft.c2r_mid(cols, n), krfft.c2r_mid_plain(cols, n))
    assert _counts() == before
