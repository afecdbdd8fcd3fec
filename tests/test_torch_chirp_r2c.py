"""Kernel 15's dense rows on the radix row core and kernel 20's real-input
chirp-z (``csrc/fft_blue_radix.cu``) on the CPU, against the JAX package:

* the dense rows' wrapper ``r2c_packed_dense`` (its plain version on a CPU
  tensor: the radix row core's at h with a plan, the chirp-z's at h = 131
  and 251) against ``ops/pallas/rfft.py::r2c_pallas`` in interpret
  mode and float64 numpy, h = 2, 3, 64, 97, 100, 131, 251;
* the chirp-z's plain version ``r2c_blue_plain`` against
  ``r2c_dense_pallas_mid`` in interpret mode and float64 numpy at n = 131,
  262, 393, 1094 and 1099 (odd and even chirp lengths, M = 270 ... 2205);
* the host M rule (``fft.chirp_m``: the 7-smooth M of least modelled
  time), and the chirp and H tables bit for bit
  against the JAX package's ``plan.chirp`` and the float64 FFT of its
  inverse chirp wrapped into M (its plan's H expression), rounded once;
* the route sets of both wrappers, pinned to the chip's scan, and the dense
  rows' count a block;
* on a CPU tensor neither wrapper counts a launch.

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
# kernel 20's lengths n = 4 ... 1100 by the kernel its wrapper runs
K20_COUNTS = {"radix": 728, "chirp": 276, "dense": 93}


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


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("h", [2, 3, 64, 97, 100, 131, 251])
def test_dense_rows_plain_matches_pallas(h):
    x = _real((9, 2 * h), h)
    got = krfft.r2c_packed_dense(torch.from_numpy(x))      # CPU: the plain version
    assert got.dtype == torch.complex64 and got.shape == (9, h + 1)
    assert krfft.packed_dense_radix(h) == (h not in (131, 251))
    assert not krfft.packed_dense_radix(31) and not krfft.packed_dense_radix(1)
    sr, si = ref_rfft.r2c_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                 ref_plan.get_r2c_plan(2 * h))
    _close(got, np.asarray(sr) + 1j * np.asarray(si))
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), TOL64)


@pytest.mark.parametrize("n", [131, 262, 393, 1094, 1099])
def test_chirp_plain_matches_pallas_and_float64(n):
    x = _real((1, n, 130), n)
    got = krfft.r2c_blue_plain(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (1, n // 2 + 1, 130)
    sr, si = ref_rfft.r2c_dense_pallas_mid(jnp.asarray(x), ref_plan.get_r2c_plan(n))
    _close(got, np.asarray(sr) + 1j * np.asarray(si))
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), TOL64)


def _smooth(m):
    for p in (2, 3, 5, 7):
        while m % p == 0:
            m //= p
    return m == 1


def _cost(mk):
    return mk * sum(kfft.CHIRP_STAGE_PS[r] for r in kfft.radix_plan(mk))


@pytest.mark.parametrize("length,mk", [(131, 288), (393, 896), (547, 1280), (1099, 2304)])
def test_chirp_m_and_tables(length, mk):
    """M is the 7-smooth integer in [2L - 1, 2 (2L - 1)] (every stage a
    codelet) of least modelled time, the least such (270, 800, 1120, 2205)
    being slower; the chirp and H are the JAX package's plan tables rounded
    once."""
    assert kfft.chirp_m(length) == mk
    assert set(kfft.radix_plan(mk)) <= set(kfft.RADIX_CODELETS)
    rivals = [m for m in range(2 * length - 1, 2 * (2 * length - 1) + 1)
              if _smooth(m) and m <= 4096 and m != mk]
    assert all(_cost(m) > _cost(mk) or (_cost(m) == _cost(mk) and m > mk) for m in rivals)
    a, hh = krfft._device_r2c_blue(length, torch.device("cpu"))
    cr, ci = ref_plan.chirp(length, +1)          # the inverse chirp, wrapped into M
    pad = np.zeros(mk, np.complex128)
    pad[:length] = cr + 1j * ci
    pad[mk - length + 1:] = (cr + 1j * ci)[1:][::-1]
    spec = np.fft.fft(pad)
    for got, (re, im) in ((a, ref_plan.chirp(length, -1)), (hh, (spec.real, spec.imag))):
        assert np.array_equal(got.real.numpy(), np.asarray(re, np.float32))
        assert np.array_equal(got.imag.numpy(), np.asarray(im, np.float32))


def test_chirp_m_every_route_length():
    """At every chirp length of kernel 20 (n/2 at even n, n at odd n, n = 4
    ... 1100) M is 7-smooth, in [2L - 1, 2 (2L - 1)] and at most 4096 (a
    column's tile in the 16-element form)."""
    for n in range(4, 1101):
        length = krfft.r2c_mid_len(n)
        mk = kfft.chirp_m(length)
        assert 2 * length - 1 <= mk <= min(4096, 2 * (2 * length - 1)) and _smooth(mk), n
        assert set(kfft.radix_plan(mk)) <= set(kfft.RADIX_CODELETS), n


def test_route_sets():
    """Kernel 20's 1094 lengths by kernel, and kernel 15's 254 dense-row
    half lengths: the counts the scan on an H100 fixed (PERF.md)."""
    forms = [krfft.r2c_dense_form(n) for n in range(4, 1101)]
    assert len(forms) == 1097
    counts = {f: forms.count(f) for f in ("radix", "chirp", "dense")}
    assert counts == K20_COUNTS
    h = [h for h in range(1, 257) if not krfft.packed_core(h)]
    assert len(h) == 254 and sum(map(krfft.packed_dense_radix, h)) == 229


@pytest.mark.parametrize("h,rows", [(2, 256), (3, 180), (37, 20), (64, 8), (97, 9), (100, 9),
                                    (200, 7), (250, 2)])
def test_dense_rows_per_block(h, rows):
    """Kernel 15's dense rows take the small-tile count (512 elements)
    raised to the fewest rows that leave at most 1 lane in 16 idle; few
    rows halve the count so that every SM gets a block."""
    assert krfft.packed_dense_rows(h, 1 << 20, 132) == rows
    tr = -(-h // 16)
    assert rows * tr <= kfft.RADIX_MAX_THREADS and kfft.idle_lanes(rows * tr) <= 1 / 16
    assert krfft.packed_dense_rows(h, 132, 132) == 1


def _counts():
    return (krfft.r2c_dense_mid.launches, krfft.r2c_dense_mid.radix_launches,
            krfft.r2c_dense_mid.chirp_launches, krfft.r2c_packed_dense.launches,
            krfft.r2c_packed_dense.radix_launches)


@pytest.mark.parametrize("n", [262, 1097, 131, 256, 129])
def test_wrappers_on_cpu_run_the_plain_version_and_count_no_launch(n):
    x = torch.from_numpy(_real((2, n, 3), n))
    rows = torch.from_numpy(_real((3, 2 * (n // 2)), n + 1))
    before = _counts()
    assert torch.equal(krfft.r2c_dense_mid(x),
                       krfft._R2C_DENSE_PLAIN[krfft.r2c_dense_form(n)](x))
    if n // 2 <= krfft.PACKED_DENSE_MAX_H:
        krfft.r2c_packed_dense(rows)
    assert _counts() == before
