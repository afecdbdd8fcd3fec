"""Kernel 15 at a generic half length (the packed R2C whose half-length C2C
runs on the mixed-radix row core, its unpack the epilogue) against the JAX
package and numpy on the CPU, where the wrapper runs its plain version:

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
