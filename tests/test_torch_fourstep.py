"""Kernels 7 and 13 (the two passes of the four-step long C2C) against the
JAX package, on the CPU, where the wrappers run their plain versions:

* ``fourstep_mid`` (K7: the C2C along n1 of the (B, n1, n2) view times the
  exit twiddle W_n^{k1 t2}, on the radix column tile at every n1 here)
  against ``_build_call_axis_mid(..., four_n=n)`` in interpret mode at
  n1 = 144 and 256 (the JAX package's dense body), 384, 512, 640, 1024 and
  2176 (its bts2 body, F = 3 ... 17), with n2 = 17 ... 384 (ragged column
  tiles on the card), nb = 1 and 2, both signs;
* ``rows_store_t`` (K13: the row C2C of length n2 on the radix row core
  with the scale, stored transposed) against ``_build_call_lane_store_t``
  at n2 = 128 (F = 1), 256, 384 and 1024 with n1 = 144 (rows that cross a
  batch boundary inside a block on the card) and 256, scale 1 and 1/n;
* the exit-twiddle table bit for bit against ``_add_exit_tw``'s constants,
  the four-step split against ``fft.fourstep_split`` over every n from
  20481 to 65536 and a sample up to 2^22, and the four-step gate against
  ``fft.fourstep_supported``;
* the forms the wrappers pick and the shapes they refuse.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier.
"""

from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch import gates
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6


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


def _crandn(shape, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal(shape) + 1j * g.standard_normal(shape)).astype(np.complex64)


def _pair(x):
    return jnp.asarray(x.real), jnp.asarray(x.imag)


def _join(yr, yi):
    return np.asarray(yr) + 1j * np.asarray(yi)


# --------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n1,n2", [(144, 144), (256, 160), (384, 128), (512, 256),
                                   (640, 33), (1024, 130), (2176, 17)])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fourstep_mid_plain_matches_pallas(n1, n2, nb, sign):
    x = _crandn((nb, n1, n2), n1 + n2 + nb)
    run = ref_pfft._build_call_axis_mid(n1, sign, nb, n2, "float32", True,
                                        ref_pfft.dot_mode(), 1.0, four_n=n1 * n2)
    want = _join(*run(*_pair(x)))
    _close(kfft.fourstep_mid(torch.from_numpy(x), sign), want)


@pytest.mark.parametrize("n2", [128, 256, 384, 1024])
@pytest.mark.parametrize("n1,nb", [(144, 2), (256, 1)])
@pytest.mark.parametrize("sign,scale", [(-1, None), (+1, "inv_n")])
def test_rows_store_t_plain_matches_pallas(n2, n1, nb, sign, scale):
    s = 1.0 / (n1 * n2) if scale == "inv_n" else None
    x = _crandn((nb, n1, n2), n1 + n2)
    run = ref_pfft._build_call_lane_store_t(n2, sign, nb, n1, "float32", True,
                                            ref_pfft.dot_mode(), 1.0 if s is None else s)
    want = _join(*run(*_pair(x)))
    got = kfft.rows_store_t(torch.from_numpy(x), sign, s)
    assert got.shape == (nb, n2, n1) and got.is_contiguous()
    _close(got, want)


# --------------------------------------------------------------------------
# Tables, split and gate bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n1,n2", [(144, 144), (256, 128), (2176, 17), (1024, 1024),
                                   (2048, 2048)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_exit_twiddle_matches_add_exit_tw(n1, n2, sign):
    _, consts, _ = ref_pfft._add_exit_tw(None, [], [], n1, n2, n2, 1, sign, n1 * n2,
                                         jnp.dtype("float32"))
    re, im = kfft.fourstep_tw(n1, n2, sign)
    assert re.dtype == np.float32 and re.shape == (n1, n2)
    assert np.array_equal(re, consts[-2]) and np.array_equal(im, consts[-1])
    t = kfft.device_fourstep_tw(n1, n2, sign, torch.device("cpu"))
    assert np.array_equal(t.real.numpy(), re) and np.array_equal(t.imag.numpy(), im)


def test_fourstep_split_matches_the_jax_package():
    for n in range(20481, 65537):
        assert gates._fourstep_split(n) == ref_pfft.fourstep_split(n), n
    g = np.random.default_rng(11)
    sample = [1 << 17, 1 << 20, 1 << 22, 786432, 147456, 163840, 3 * (1 << 20)]
    sample += [int(v) for v in g.integers(65537, 1 << 22, 300)]
    for n in sample:
        assert gates._fourstep_split(n) == ref_pfft.fourstep_split(n), n


def test_fourstep_gate_matches_the_jax_package():
    """The port's four-step route (any batch) is the JAX package's
    fourstep_supported on a Cooley-Tukey plan in float32."""
    g = np.random.default_rng(12)
    ns = [20480, 20481, 20736, 32768, 32769, 65536, 1 << 22, (1 << 22) + 2]
    ns += [int(v) for v in g.integers(16384, 1 << 22, 200)]
    for n in ns:
        if ref_plan.factorize(n) is None:
            continue
        # fourstep_supported reads the plan's kind and length only (building
        # the plan of a long length costs seconds)
        want = ref_pfft.fourstep_supported(SimpleNamespace(kind="ct", n=n), jnp.float32)
        for batch in (1, 128):
            assert (gates._lane_c2c(n, batch) == "fourstep") == want, (n, batch)
            assert (gates.lane_c2c_route(n, batch) == gates.C2C_FOURSTEP) == want, n


# --------------------------------------------------------------------------
# Bodies and checks
# --------------------------------------------------------------------------


def test_fourstep_bodies():
    assert [kfft.fourstep_form(n) for n in (17, 131, 144, 251, 256, 384, 512, 640, 1024,
                                            2048, 2176, 4096)] == \
        ["radix", "dense", "radix", "dense"] + ["radix"] * 8
    assert kfft.fourstep_form(300) is None          # neither <= 256 nor 128 * F
    assert kfft.fourstep_form(128 * 33) is None     # n1 > 4096
    assert kfft.fourstep_form(0) is None
    # every split's n1 has a form, and its n2 one where it has a twostep split
    for n in range(20481, 65537, 7):
        split = gates._fourstep_split(n)
        if split is None:
            continue
        n1, n2 = split
        assert kfft.fourstep_form(n1) is not None, n
        if gates._twostep_split(n2) is not None:
            assert kfft.core_f(n2) is not None and n2 <= kfft.FOURSTEP_MAX_N2, n
        else:
            assert n2 <= 256, n


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(1, 300, 4, dtype=torch.complex64)
    with pytest.raises(ValueError, match="n1=300"):
        kfft.fourstep_mid(x, -1)
    with pytest.raises(ValueError, match="expected"):
        kfft.fourstep_mid(torch.zeros(256, 4, dtype=torch.complex64), -1)
    with pytest.raises(ValueError, match="n=200"):
        kfft.rows_store_t(torch.zeros(1, 4, 200, dtype=torch.complex64), -1)
    with pytest.raises(ValueError, match="16512"):
        kfft.rows_store_t(torch.zeros(1, 1, 128 * 129, dtype=torch.complex64), -1)
    with pytest.raises(ValueError, match="expected"):
        kfft.rows_store_t(torch.zeros(4, 256, dtype=torch.complex64), -1)
    meta = torch.zeros(1, 256, 4, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kfft.fourstep_mid(meta, -1)
    with pytest.raises(ValueError, match="unsupported device"):
        kfft.rows_store_t(meta.transpose(1, 2).contiguous(), -1)


def test_exit_twiddle_cache_keeps_the_newest_table(monkeypatch):
    cache = OrderedDict()
    monkeypatch.setattr(kfft, "_WQ_CACHE", cache)
    monkeypatch.setattr(kfft, "WQ_CACHE_BYTES", 32 << 20)     # one 2^22 table
    cpu = torch.device("cpu")
    kfft.device_wq(1024, -1, 1.0, cpu)
    kfft.device_fourstep_tw(256, 128, -1, cpu)
    assert list(cache) == [(1024, -1, 1.0, cpu), ("tw", 256, 128, -1, cpu)]
    big = kfft.device_fourstep_tw(2048, 2048, +1, cpu)
    assert list(cache.values()) == [big]
