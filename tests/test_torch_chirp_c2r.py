"""Kernel 21's chirp-z C2R and kernel 15's rows on the chirp-z
(``csrc/rfft_blue_radix.cu``) on the CPU, against the JAX package:

* the C2R's plain version ``c2r_blue_plain`` (the column's inverse as
  conj(FFT(conj V)) on kernel 20's forward chirp-z tables: kernel 17's
  inverse unpack at even n, the Hermitian extension at odd n) against
  ``ops/pallas/rfft.py::c2r_dense_pallas_mid`` in interpret mode and float64
  numpy at n = 262, 263, 449, 1094 and 1099 and at 129 = 3 * 43, one of the
  61 odd n with a plan that keep the dense product, under the scales None
  and 1/n, with DC and Nyquist imaginary parts that the result ignores;
* the rows' plain version ``r2c_packed_blue_plain`` against
  ``ops/pallas/rfft.py::r2c_pallas`` in interpret mode and float64 numpy at
  the prime half lengths h = 131, 173 and 251;
* the routes ``c2r_dense_form`` (K21's 1097 lengths 4 ... 1100) and
  ``packed_dense_form`` (K15's 254 dense-row half lengths), pinned to the
  chip's scan;
* on a CPU tensor each wrapper runs the plain version of the form its
  route names and counts no launch.

Tolerance: 5e-6 of max |JAX| at the JAX package's "highest" tier, 2e-6 of
max |numpy| against float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import rfft as ref_rfft

from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL64 = 2e-6
# kernel 21's lengths n = 4 ... 1100 and kernel 15's dense-row half lengths
# h <= 256 (not 128 F) by the kernel their wrappers run
K21_COUNTS = {"radix": 701, "chirp": 276, "dense": 120}
K15_COUNTS = {"radix": 229, "chirp": 25}


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _spec(shape, seed):
    rng = np.random.default_rng(seed)
    s = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    s[:, 0] += 3j       # the DC's imaginary part, to be ignored
    return s


@pytest.mark.parametrize("scale", [None, "1/n"])
@pytest.mark.parametrize("n", [262, 263, 449, 1094, 1099, 129])
def test_c2r_chirp_plain_matches_pallas_and_float64(n, scale):
    spec = _spec((1, n // 2 + 1, 130), n)
    if n % 2 == 0:
        spec[:, -1] -= 2j   # the Nyquist bin's imaginary part, to be ignored
    sc = None if scale is None else 1.0 / n
    got = krfft.c2r_blue_plain(torch.from_numpy(spec), n, sc)
    assert got.dtype == torch.float32 and got.shape == (1, n, 130)
    want = ref_rfft.c2r_dense_pallas_mid(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, sc)
    _close(got, want)
    full = np.fft.irfft(spec.astype(np.complex128), n=n, axis=1) * n
    _close(got, full * (1.0 if sc is None else sc), TOL64)


@pytest.mark.parametrize("h", [131, 173, 251])
def test_packed_chirp_plain_matches_pallas_and_float64(h):
    x = np.random.default_rng(h).standard_normal((9, 2 * h)).astype(np.float32)
    got = krfft.r2c_packed_blue_plain(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (9, h + 1)
    sr, si = ref_rfft.r2c_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                 ref_plan.get_r2c_plan(2 * h))
    _close(got, np.asarray(sr) + 1j * np.asarray(si))
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), TOL64)
    assert krfft.packed_dense_form(h) == "chirp" and kfft.radix_plan(h) is None


def test_route_counts():
    """Kernel 21's 1097 lengths and kernel 15's 254 dense-row half lengths
    by kernel: the counts the scan on an H100 fixed (PERF.md). Kernel 21's
    chirp-z takes every even n and odd n >= 449 without a plan and, as
    kernel 20's does, the 9 lengths with a plan whose transform length is
    a prime >= 97 or 5 * 127, 7 * 127; its product the odd n without a plan
    below 449 and the 61 odd n of fft.dense_beats_radix. Kernel 15's chirp-z
    takes h = 1, 31 and the primes 131 ... 251, its radix row core the
    229 others; no half length keeps the dense product."""
    forms = {n: krfft.c2r_dense_form(n) for n in range(4, 1101)}
    assert {f: list(forms.values()).count(f) for f in K21_COUNTS} == K21_COUNTS
    with_plan = [n for n, f in forms.items() if f == "chirp" and krfft.r2c_mid_radix(n)]
    assert with_plan == [194, 202, 206, 214, 218, 226, 254, 635, 889]
    assert with_plan == [n for n in range(4, 1101)
                         if krfft.r2c_mid_radix(n) and krfft.r2c_dense_form(n) == "chirp"]
    dense = [n for n, f in forms.items() if f == "dense"]
    assert all(n % 2 for n in dense) and len([n for n in dense if krfft.r2c_mid_radix(n)]) == 61
    assert max(n for n in dense if not krfft.r2c_mid_radix(n)) < krfft.CHIRP_MIN_ODD
    h = [h for h in range(1, 257) if not krfft.packed_core(h)]
    forms15 = {h: krfft.packed_dense_form(h) for h in h}
    assert {f: list(forms15.values()).count(f) for f in K15_COUNTS} == K15_COUNTS
    assert all((f == "radix") == krfft.packed_dense_radix(h) for h, f in forms15.items())
    assert [h for h, f in forms15.items() if f == "chirp"][:3] == [1, 31, 131]


@pytest.mark.parametrize("mk,rows", [(2, 32), (64, 8), (256, 2), (288, 8), (320, 8), (400, 8),
                                     (512, 1)])
def test_packed_blue_rows(mk, rows):
    """Kernel 15's chirp-z takes the fewest rows a tile whose threads fill
    whole warps, at most radix_mid_cols's count; few rows halve it so that
    every SM gets a tile."""
    assert krfft.packed_blue_rows(mk, 1 << 16, 132) == rows
    assert rows * -(-mk // 16) % 32 == 0 or rows == kfft.radix_mid_cols(mk, 1, 1 << 16, 132)
    assert krfft.packed_blue_rows(mk, 132, 132) == 1


def _counts():
    return (krfft.c2r_dense_mid.launches, krfft.c2r_dense_mid.radix_launches,
            krfft.c2r_dense_mid.chirp_launches, krfft.r2c_packed_dense.launches,
            krfft.r2c_packed_dense.radix_launches, krfft.r2c_packed_dense.chirp_launches)


@pytest.mark.parametrize("n", [262, 1099, 263, 129, 256, 255])
def test_wrappers_on_cpu_run_the_plain_version_and_count_no_launch(n):
    spec = torch.from_numpy(_spec((2, n // 2 + 1, 3), n))
    rows = torch.from_numpy(np.random.default_rng(n + 1).standard_normal(
        (3, 2 * (n // 2))).astype(np.float32))
    before = _counts()
    assert torch.equal(krfft.c2r_dense_mid(spec, n, 0.5),
                       krfft._C2R_DENSE_PLAIN[krfft.c2r_dense_form(n)](spec, n, 0.5))
    if n // 2 <= krfft.PACKED_DENSE_MAX_H:
        assert torch.equal(krfft.r2c_packed_dense(rows),
                           krfft._PACKED_DENSE_PLAIN[krfft.packed_dense_form(n // 2)](rows))
    assert _counts() == before
