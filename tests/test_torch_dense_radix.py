"""Kernels 21 and 27 on the radix column tile (``csrc/rfft_mid_radix.cu``,
``csrc/dct_mid_radix.cu`` on ``csrc/fft_radix.cuh``): their plain versions
``c2r_dense_radix_plain`` and ``dct_radix_plain`` against the JAX package's
Pallas kernels in interpret mode and against float64 numpy/scipy, the plan
sets, the CPU wrappers' dispatch, and the public functions against the JAX
package.

* kernel 21 (the C2R along a middle axis, 4 <= n <= 1100) takes kernel 17's
  kernel at even n with a plan of h = n/2 and the length-n inverse of the
  Hermitian extension at odd n with a plan of n where the dense product is
  not faster (``fft.dense_beats_radix``): against ``c2r_dense_pallas_mid``
  at n = 4, 5, 128, 129, 255, 256, 264, 1100 (129 = 3 * 43 keeps the dense
  product; 1099 = 7 * 157 has no plan), and its radix plain version against
  ``numpy.fft.irfft`` at those and every 25th length with a plan;
* kernel 27 (the dense DCT gate, 2 <= n <= 1100) takes DCT-I at a plan of
  n - 1 (but where the dense product is faster) and DCT-II/III at even n
  with a plan of n/2: against ``dct_dense_pallas_mid`` at n = 3, 4, 129,
  130, 512, 513, 1024, 1025, and its radix plain version against
  ``scipy.fft.dct`` at those and every 25th length with a plan of each
  type;
* the plan sets: 439 even and 332 odd n with a plan in 4 ... 1100, of
  which the route sends 698 to kernel 21 on the radix column tile (512,
  768 and 1024 are kernel 17's, 61 odd n keep the dense product, 9 take
  the chirp-z); 772
  DCT-I lengths with a plan, 671 of them on the radix column tile, and
  439 DCT-II/III lengths of kernel 27;
* on a CPU tensor each wrapper runs the plain version of the kernel its
  route names at n, and counts no launch;
* ``ndifft_r2c``, ``nddct1..3`` and ``nddst2..3`` along axis 0 of (n, 130)
  and axis 1 of (2, n, 130) against the JAX package on the same inputs.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| at the JAX package's
"highest" tier; 1e-6 of the float64 peak on the radix forms.
"""

from functools import lru_cache

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.api import _jitted
from ndrustfft_tpu.ops.pallas import dct as ref_pdct
from ndrustfft_tpu.ops.pallas import rfft as ref_rfft

import ndrustfft_tpu_torch as port
from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL64 = 1e-6
C64, F32 = torch.complex64, torch.float32


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
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _spec(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@lru_cache(maxsize=None)
def _k21_lengths():
    """The n whose float32 C2R along axis 1 of (1, n//2+1, 130) takes
    C2R_DENSE_MID, and those of them with a radix plan."""
    lengths = tuple(n for n in range(2, 1101) if api._route(
        "c2r", (1, n // 2 + 1, 130), 1, C64, "cuda", n=n) == api.C2R_DENSE_MID)
    return lengths, tuple(n for n in lengths if krfft.r2c_mid_radix(n))


def _k27_plan(n, dct_type):
    """Kernel 27's radix column tile has a plan at (n, dct_type): of n - 1
    for DCT-I, of n/2 for DCT-II/III at even n."""
    h = n - 1 if dct_type == 1 else n // 2 if dct_type in (2, 3) and n % 2 == 0 else 0
    return h >= 2 and kfft.radix_plan(h) is not None


@lru_cache(maxsize=None)
def _k27_radix(dct_type, routed=True):
    """The n whose DCT-<type> along axis 1 of (1, n, 130) takes
    DCT_DENSE_MID on the radix column tile (``routed``), or with a plan
    for it."""
    return tuple(n for n in range(2, 1101)
                 if api._route(f"dct{dct_type}", (1, n, 130), 1, F32, "cuda") == api.DCT_DENSE_MID
                 and (kdct.dct_radix_len(n, dct_type) is not None if routed
                      else _k27_plan(n, dct_type)))


# --------------------------------------------------------------------------
# Kernel 21
# --------------------------------------------------------------------------

K21_SAMPLE = [4, 5, 128, 129, 255, 256, 264, 1099, 1100]


@pytest.mark.parametrize("n", K21_SAMPLE)
def test_c2r_dense_matches_pallas(n):
    """The CPU wrapper (the radix plain version, or at 129 and 1099 the
    dense one) against the Pallas kernel; the DC and (even n) Nyquist imaginary parts
    are ignored."""
    spec = _spec((1, n // 2 + 1, 130), n)
    spec[:, 0] += 3j
    if n % 2 == 0:
        spec[:, -1] -= 2j
    want = ref_rfft.c2r_dense_pallas_mid(jnp.asarray(spec.real), jnp.asarray(spec.imag), n,
                                         1.0 / n)
    got = krfft.c2r_dense_mid(torch.from_numpy(spec), n, 1.0 / n)
    assert got.dtype == F32 and got.shape == (1, n, 130)
    _close(got, want)


@pytest.mark.parametrize("n", sorted(set(K21_SAMPLE[:-2] + [1100]) |
                                     set(_k21_lengths()[1][::25])))
def test_c2r_radix_plain_matches_float64(n):
    assert krfft.r2c_mid_radix(n)
    spec = _spec((2, n // 2 + 1, 3), n + 1)
    got = krfft.c2r_dense_radix_plain(torch.from_numpy(spec), n, -0.5)
    _close(got, -0.5 * n * np.fft.irfft(spec.astype(np.complex128), n=n, axis=1), TOL64)


# --------------------------------------------------------------------------
# Kernel 27
# --------------------------------------------------------------------------

K27_SAMPLE = [3, 4, 129, 130, 512, 513, 1024, 1025]


@pytest.mark.parametrize("dct_type", [1, 2, 3])
@pytest.mark.parametrize("n", K27_SAMPLE)
def test_dct_dense_matches_pallas(dct_type, n):
    x = _real((1, n, 130), n * dct_type)
    got = kdct.dct_dense_mid(torch.from_numpy(x), dct_type, 2.0)
    assert got.dtype == F32 and got.shape == (1, n, 130)
    _close(got, ref_pdct.dct_dense_pallas_mid(jnp.asarray(x), dct_type, 2.0))


@pytest.mark.parametrize("dct_type,n", [(t, n) for t in (1, 2, 3)
                                        for n in sorted(set(K27_SAMPLE) |
                                                        set(_k27_radix(t, False)[::25]))
                                        if _k27_plan(n, t)])
def test_dct_radix_plain_matches_float64(dct_type, n):
    x = _real((2, n, 3), n + dct_type)
    got = kdct.dct_radix_plain(torch.from_numpy(x), dct_type, 2.0)
    _close(got, sfft.dct(x.astype(np.float64), type=dct_type, axis=1), TOL64)


# --------------------------------------------------------------------------
# The plan sets and the CPU wrappers
# --------------------------------------------------------------------------


def test_plan_sets():
    """Of 4 <= n <= 1100, 439 even n have a plan of n/2 and 332 odd n one of
    n; the route sends all but 512, 768 and 1024 (kernel 17's) to kernel 21,
    768 of its 1094 lengths with a plan, 698 of them to the radix column
    tile (the 61 odd n that fft.dense_beats_radix gives the dense product:
    a prime stage p >= 11 and n < 128 or n <= 3 p; the 9 that
    rfft.py::chirp_beats_radix gives the chirp-z). DCT-I has 772 lengths
    with a plan of n - 1, 671 on the tile; DCT-II/III 439 each."""
    plans = [n for n in range(4, 1101) if krfft.r2c_mid_radix(n)]
    assert (len([n for n in plans if n % 2 == 0]), len([n for n in plans if n % 2])) == (439, 332)
    lengths, radix = _k21_lengths()
    assert set(range(4, 1101)) - set(lengths) == {512, 768, 1024}
    assert (len(lengths), len(radix)) == (1094, 768)
    dense = [n for n in radix if krfft.c2r_dense_form(n) == "dense"]
    assert len(dense) == 61 and all(n % 2 for n in dense)
    assert (dense[0], dense[-1], 129 in dense, 215 in dense, 387 in dense) == (
        23, 381, True, False, False)
    assert len(_k27_radix(1, False)) == 772 and _k27_radix(1, False)[0] == 3
    assert len(_k27_radix(1)) == 671 and 130 not in _k27_radix(1)
    assert [len(_k27_radix(t)) for t in (2, 3)] == [439, 439]
    assert all(n % 2 == 0 for n in _k27_radix(2))
    assert not any(kdct.dct_radix_len(n, 4) for n in range(2, 1101))


# 635 = 5 * 127 has a plan, but kernel 21 runs the chirp-z there
# (rfft.py::chirp_beats_radix)
@pytest.mark.parametrize("n,radix", [(128, True), (129, False), (255, True), (262, False),
                                     (381, False), (635, False), (1099, False)])
def test_c2r_wrapper_dispatch(n, radix):
    spec = torch.from_numpy(_spec((1, n // 2 + 1, 5), n))
    fn = krfft.c2r_dense_mid
    before = (fn.launches, fn.radix_launches, fn.chirp_launches)
    got = fn(spec, n, 0.5)
    plain = krfft._C2R_DENSE_PLAIN[krfft.c2r_dense_form(n)]
    assert (krfft.c2r_dense_form(n) == "radix") == radix
    assert torch.equal(got, plain(spec, n, 0.5))
    assert (fn.launches, fn.radix_launches, fn.chirp_launches) == before


@pytest.mark.parametrize("dct_type,n,radix", [(1, 3, True), (1, 2, False), (1, 265, True),
                                              (1, 264, False), (1, 128, False), (1, 130, False),
                                              (1, 129, True), (2, 130, True), (3, 130, True),
                                              (2, 129, False), (3, 262, False), (4, 128, False)])
def test_dct_wrapper_dispatch(dct_type, n, radix):
    x = torch.from_numpy(_real((1, n, 5), n))
    fn = kdct.dct_dense_mid
    before = (fn.launches, fn.radix_launches)
    got = fn(x, dct_type, 2.0)
    plain = kdct.dct_radix_plain if radix else kdct.dct_dense_mid_plain
    assert (kdct.dct_radix_len(n, dct_type) is not None) == radix
    assert torch.equal(got, plain(x, dct_type, 2.0))
    assert (fn.launches, fn.radix_launches) == before


# --------------------------------------------------------------------------
# The public functions against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [6, 129, 255, 264])
@pytest.mark.parametrize("axis", [0, 1])
def test_ndifft_r2c_matches_reference(n, axis):
    shape = (n // 2 + 1, 130) if axis == 0 else (2, n // 2 + 1, 130)
    spec = _spec(shape, n + axis)
    full = tuple(n if d == axis else s for d, s in enumerate(shape))
    assert api._route("c2r", shape, axis, C64, "cuda", n=n) == api.C2R_DENSE_MID
    want = ref.ndifft_r2c(jnp.asarray(spec), ref.R2cFftHandler(n), axis=axis)
    got = port.ndifft_r2c(torch.from_numpy(spec), port.R2cFftHandler(n), axis=axis)
    assert tuple(got.shape) == full
    _close(got, want)


@pytest.mark.parametrize("kind", ["dct1", "dct2", "dct3", "dst2", "dst3"])
@pytest.mark.parametrize("n", [10, 129, 130])
@pytest.mark.parametrize("axis", [0, 1])
def test_dct_functions_match_reference(kind, n, axis):
    shape = (n, 130) if axis == 0 else (2, n, 130)
    x = _real(shape, n + axis)
    assert api._route(kind, shape, axis, F32, "cuda") == api.DCT_DENSE_MID
    dct = kind.startswith("dct")
    want = getattr(ref, "nd" + kind)(jnp.asarray(x), (ref.DctHandler if dct else ref.DstHandler)(n),
                                     axis=axis)
    got = getattr(port, "nd" + kind)(torch.from_numpy(x),
                                     (port.DctHandler if dct else port.DstHandler)(n), axis=axis)
    _close(got, want)
