"""The R2C on the mixed-radix row core (its half-length C2C on the radix
core, its unpack the epilogue): kernel 2 and kernel 15 at every h = 128 * F,
and kernel 15 at a generic half length, against the JAX package and numpy
on the CPU, where the wrappers run their plain version:

* kernel 2's plain version against ``_r2c_kernel_nat`` through
  ``r2c_pallas_nat`` in interpret mode at h = 256, 512, 1024 (the bts2
  core's factors before) and h = 384, 640 (the wide core's), and against
  float64 numpy at h = 16384 (the 32768^2 step's rows);
* kernel 15 at h = 128 (``r2c_packed``) against ``_r2c_kernel`` through
  ``r2c_pallas``;
* every h = 128 * F that kernel 2's route (R2C_NAT) or kernel 15's
  (R2C_PACKED at ``packed_core``) sends has a radix plan of at most 5
  stages;
* the wrappers of kernels 2 and 15 on a CPU tensor: exactly the radix plain
  version, no launch counted;

* the plain version (the radix core's plain version of z = x[2t] + i
  x[2t + 1], then the unpack) against ``_r2c_kernel`` through the JAX
  package's ``r2c_pallas`` in interpret mode at the "highest" tier, at
  h = 265 (odd), 300 and 530;
* the plain version against float64 numpy at h = 11352 (two prime stages)
  and 20448 (the longest generic h, 40 elements a thread on the card);
* every h in 257 ... 20480 that ``gates.packed_lane(h, 128)`` sends to the
  generic form (1582 lengths) has a radix plan of at most 8 stages;
* the wrapper on a CPU tensor: the plain version, no launch counted.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| (each side ~5e-7 against a
float64 oracle); 2e-6 against float64 numpy.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch import gates
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL_ORACLE = 2e-6


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


def _generic_h():
    """Every half length h whose packed R2C over 128 rows kernel 15 takes in
    its generic form (not the core's h = 128 F, not the dense h <= 256)."""
    return [h for h in range(257, kfft.GENERIC_MAX_N + 1)
            if gates.packed_lane(h, 128) == gates.R2C_PACKED and gates.packed_kernel(h, 128)
            and not krfft.packed_core(h)]


@pytest.mark.parametrize("h,t", [(265, 16), (300, 7), (530, 5)])
def test_plain_matches_pallas_r2c(h, t):
    n = 2 * h
    _, meta = ref_prfft._half_fft_consts(h, -1, jnp.float32, "highest")
    assert meta[0] == "gen"
    x = np.random.default_rng(h).standard_normal((t, n)).astype(np.float32)
    got = krfft.r2c_packed_generic_plain(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (t, h + 1)
    yr, yi = ref_prfft.r2c_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                  ref_plan.get_r2c_plan(n))
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


@pytest.mark.parametrize("h", [11352, 20448])
def test_plain_matches_float64(h):
    x = np.random.default_rng(h).standard_normal((3, 2 * h)).astype(np.float32)
    got = krfft.r2c_packed_generic_plain(torch.from_numpy(x))
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), TOL_ORACLE)


def test_plain_is_the_radix_core_and_the_unpack():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 600)).astype(np.float32))
    z = torch.view_as_complex(x.reshape(4, 300, 2).contiguous())
    spec = kfft.c2c_radix_rows_plain(z, -1)
    want = krfft._unpack(spec, krfft._device_tw(600, x.device), -1)
    assert torch.equal(krfft.r2c_packed_generic_plain(x), want)


def test_every_generic_h_has_a_radix_plan():
    hs = _generic_h()
    assert len(hs) == 1582 and hs[0] == 258 and hs[-1] == 20448
    for h in hs:
        assert kfft.generic_split(h) is not None, h
        plan = kfft.radix_plan(h)
        assert plan is not None and 1 <= len(plan) <= kfft.RADIX_MAX_STAGES, h
        assert math.prod(plan) == h


def test_wrapper_on_cpu_runs_the_plain_version():
    before = krfft.r2c_packed_generic.launches
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 530)).astype(np.float32))
    assert torch.equal(krfft.r2c_packed_generic(x), krfft.r2c_packed_generic_plain(x))
    assert krfft.r2c_packed_generic.launches == before


@pytest.mark.parametrize("h,t", [(256, 130), (512, 9), (1024, 5), (384, 7), (640, 3)])
def test_kernel2_plain_matches_pallas_nat(h, t):
    """Kernel 2 at the bts2 core's former fixed h = 256, 512, 1024 and wide
    h = 384, 640 (F = 3, 5), ragged row counts."""
    n = 2 * h
    x = np.random.default_rng(h + t).standard_normal((t, n)).astype(np.float32)
    got = krfft.r2c_nat(torch.from_numpy(x))                # CPU: the plain version
    assert got.dtype == torch.complex64 and got.shape == (t, h + 1)
    sr, si = ref_prfft.r2c_pallas_nat(jnp.asarray(x), ref_plan.get_r2c_plan(n))
    _close(got, np.asarray(sr) + 1j * np.asarray(si))


def test_kernel2_plain_matches_float64_at_16384():
    """Kernel 2 at the 32768^2 step's h = 16384 (plan (16, 16, 16, 4); on the
    card one row a block of 512 threads of 32 elements)."""
    assert kfft.radix_plan(16384) == (16, 16, 16, 4)
    x = np.random.default_rng(16384).standard_normal((3, 32768)).astype(np.float32)
    got = krfft.r2c_nat(torch.from_numpy(x))
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), TOL_ORACLE)


def test_packed_plain_matches_pallas_r2c_at_128():
    """Kernel 15 at h = 128 (F = 1, the 256^3 step's rows): the JAX kernel's
    even/odd streams through ``_r2c_kernel``."""
    n = 256
    x = np.random.default_rng(n).standard_normal((130, n)).astype(np.float32)
    got = krfft.r2c_packed(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (130, 129)
    yr, yi = ref_prfft.r2c_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                  ref_plan.get_r2c_plan(n))
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


def test_every_kernel2_and_kernel15_h_has_a_radix_plan():
    """Every h = 128 * F of kernel 2's route and of kernel 15's h = 128 * F
    route over 128 rows: a radix plan of at most 5 stages whose radices
    multiply to h."""
    nat = [n // 2 for n in range(2, 2 * kfft.GENERIC_MAX_N + 1, 2)
           if gates.r2c_lane_route(n, 128) == gates.R2C_NAT]
    packed = [h for h in range(1, kfft.GENERIC_MAX_N + 1)
              if gates.packed_kernel(h, 128) and krfft.packed_core(h)]
    assert nat == [h for h in packed if h >= 256] and packed[0] == 128
    assert len(packed) == 154 and packed[-1] == kfft.GENERIC_MAX_N   # F = 1 ... 160 but 6 primes
    for h in packed:
        assert h % kfft.M == 0, h
        plan = kfft.radix_plan(h)
        assert plan is not None and 1 <= len(plan) <= 5, h
        assert math.prod(plan) == h


@pytest.mark.parametrize("fn", [krfft.r2c_nat, krfft.r2c_packed])
def test_kernel2_and_15_wrappers_on_cpu_run_the_radix_plain_version(fn):
    before = fn.launches, fn.radix_launches
    for h in (128 if fn is krfft.r2c_packed else 256, 384, 1024, 2048):
        x = torch.from_numpy(np.random.default_rng(h).standard_normal((3, 2 * h))
                             .astype(np.float32))
        assert torch.equal(fn(x), krfft.r2c_radix_plain(x))
    assert (fn.launches, fn.radix_launches) == before
