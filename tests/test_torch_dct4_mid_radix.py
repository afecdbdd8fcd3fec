"""Kernel 28 (DCT-IV along a middle axis) on the radix column tile: its
single pass and its two-pass column four-step, through their plain versions
on the CPU, against the JAX package's ``dct4_pallas_mid`` in interpret mode
and against float64 oracles.

* the single pass's plain version at n = 1280, 2048 and 1536, nb = 1 and 2,
  L = 128 and a ragged 130;
* the four-step's plain version at forced short splits (hl = 1024 = 32 * 32,
  1280 = 10 * 128) against the single pass and the JAX kernel, and at
  n = 41216 and 65536 (its own splits, 161 * 128 and 128 * 256) against
  scipy's DCT-IV in float64;
* the four-step's algebra (split, twiddle, parking in y, exit) in float64
  against scipy's DCT-IV;
* for every split the wrapper takes, pass 2's tile reads the rows it writes
  (the in-place pass), and pass 1 writes every row once;
* ``dct4_form`` over F = 1 ... 256 and each form's tables bit for bit
  against their float64 expressions rounded once.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 (the JAX
package at its "highest" tier); the float32 port against float64 scipy
within 2e-6 of the peak; the float64 algebra within 1e-12 of the peak.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import dct as ref_pdct

from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
TOL_F64 = 2e-6      # the float32 plain versions against float64 scipy
TOL_ALGEBRA = 1e-12  # the four-step's algebra run in float64
PRIMES = (131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211,
          223, 227, 229, 233, 239, 241, 251)


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


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------------------
# The plain versions against the Pallas kernel and float64
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1280, 2048, 1536])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("cols", [128, 130])
def test_single_pass_plain_matches_pallas(n, nb, cols):
    assert kdct.dct4_form(n) == "radix"
    x = _real((nb, n, cols), n + nb + cols + 3)
    got = kdct.dct4_radix_plain(torch.from_numpy(x), 2.0)
    assert got.dtype == torch.float32 and got.shape == (nb, n, cols)
    _close(got, ref_pdct.dct4_pallas_mid(jnp.asarray(x), 2.0))


@pytest.mark.parametrize("n,h2", [(2048, 32), (2560, 128)])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("scale", [2.0, None])
def test_fourstep_plain_at_forced_splits(n, h2, nb, scale):
    """hl = 1024 = 32 * 32 and 1280 = 10 * 128 with a ragged L = 130:
    the four-step's plain version against the single pass's and the JAX
    kernel."""
    x = _real((nb, n, 130), n + nb + h2)
    got = kdct.dct4_fourstep_plain(torch.from_numpy(x), scale, h2)
    _close(got, kdct.dct4_radix_plain(torch.from_numpy(x), scale))
    _close(got, ref_pdct.dct4_pallas_mid(jnp.asarray(x), scale))


@pytest.mark.parametrize("n", [41216, 65536])
def test_fourstep_plain_matches_float64_oracle(n):
    """At F = 161 and 256, the wrapper's own split, on 2 columns: scipy's
    DCT-IV (twice the rustdct one, so scale 2)."""
    sfft = pytest.importorskip("scipy.fft")
    assert kdct.dct4_form(n) == "fourstep"
    x = _real((1, n, 2), n)
    _close(kdct.dct4_mid(torch.from_numpy(x), 2.0),
           sfft.dct(x.astype(np.float64), type=4, axis=1), TOL_F64)


@pytest.mark.parametrize("n,h2", [(2048, 32), (2560, 128), (41216, 128), (65536, 256),
                                  (65536, 64)])
def test_fourstep_algebra_in_float64(n, h2):
    """The four-step's split, twiddle W_hl^{s2 k1}, parking in y and exit
    (the port's own code) with float64 chirps and a float64 FFT per pass:
    scale * DCT-IV to float64 rounding."""
    sfft = pytest.importorskip("scipy.fft")
    x = np.random.default_rng(n + h2).standard_normal((2, n, 2))
    hl = n // 2
    s = np.arange(hl)
    w = torch.from_numpy(np.exp(-1j * np.pi * (4 * s + 1) / (4 * n)))
    tw = torch.from_numpy(np.exp(-2j * np.pi * s / hl))
    p = torch.from_numpy(0.5 * np.exp(1j * np.pi * s / n))
    got = kdct._dct4_fourstep(torch.from_numpy(x), h2, w, tw, p,
                              lambda v: torch.fft.fft(v, dim=1))
    _close(got, 0.25 * sfft.dct(x, type=4, axis=1), TOL_ALGEBRA)


# --------------------------------------------------------------------------
# The four-step's rows, the forms and the tables
# --------------------------------------------------------------------------


def _rows(n, s):
    """The two rows 2s and n - 1 - 2s of index s (Dct4Col's load and
    Dct4Rows's store in csrc/dct4_mid_radix.cu)."""
    s = np.asarray(s)
    return np.concatenate([2 * s, n - 1 - 2 * s])


def test_fourstep_pass2_reads_the_rows_it_writes():
    """For every split the wrapper takes: pass 2's transform (b, k1) loads
    element r at k' = k1 + m r and stores output j at k = c0 k1 + a j
    (m = h1, c0 = 1, a = h1, ndfft_dct4_mid_radix's pass 2), the same set
    of rows, and the h1 tiles cover the n rows once; pass 1 (k = h1 s2 + k1)
    writes every row once."""
    splits = 0
    for f in range(1, kfft.REAL_MAX_F + 1):
        n = 256 * f
        if kdct.dct4_form(n) != "fourstep":
            continue
        hl = n // 2
        h1, h2 = kdct.dct4_split(hl)
        assert h1 * h2 == hl and kdct.radix_plan(h1) and kdct.radix_plan(h2)
        seen = np.zeros(n, dtype=np.int64)
        r = np.arange(h2)
        for k1 in range(h1):
            read = _rows(n, k1 + h1 * r)
            wrote = _rows(n, 1 * k1 + h1 * r)
            assert set(read.tolist()) == set(wrote.tolist()), (n, k1)
            np.add.at(seen, wrote, 1)
        assert (seen == 1).all(), n
        s2, k1 = np.meshgrid(np.arange(h2), np.arange(h1), indexing="ij")
        park = np.sort(_rows(n, (h1 * s2 + k1).ravel()))
        assert np.array_equal(park, np.arange(n)), n
        assert int((s2 * k1).max()) < hl        # pass 1's twiddle index
        splits += 1
    assert splits == 153


def test_dct4_form_over_every_f():
    """Over the routes' F = 5 ... 256: 76 single passes (hl <= 10240), 153
    four-steps (74 of them at 10240 < hl <= 20480, where the single pass
    would hold one column a tile) and the 23 prime F without a plan (wide
    to 160, long above); F = 1 ... 4 take the single pass too."""
    forms = {f: kdct.dct4_form(256 * f) for f in range(1, kfft.REAL_MAX_F + 1)}
    routed = [forms[f] for f in range(5, kfft.REAL_MAX_F + 1)]
    assert routed.count("radix") == 76 and routed.count("fourstep") == 153
    assert sum(forms[f] == "fourstep" for f in range(81, kfft.WIDE_MAX_F + 1)) == 74
    assert sorted(f for f, v in forms.items() if v in ("wide", "long")) == list(PRIMES)
    assert all(forms[f] == ("long" if f > kfft.WIDE_MAX_F else "wide") for f in PRIMES)
    assert all(forms[f] == "radix" for f in range(1, 5))
    for f, form in forms.items():
        hl = 128 * f
        if form == "radix":
            assert hl <= kdct.DCT4_RADIX_MAX_HL and kdct.radix_plan(hl) is not None
        elif form == "fourstep":
            assert hl > kdct.DCT4_FOURSTEP_FROM and kdct.dct4_split(hl) is not None


@pytest.mark.parametrize("f", [5, 8, 80, 160, 161, 256])
@pytest.mark.parametrize("scale", [1.0, 2.0, 0.125])
def test_tables_of_each_form_bit_identical(f, scale):
    """The tables the form reads: the entry chirp e^{-i pi (4s+1)/(4n)} and
    the exit chirp scale * (cos, sin)(pi k/n) (the single pass and the
    four-step's pass 2), and the four-step's W_hl^u (the JAX package's
    _cis(2u, hl, -1)), each its float64 expression rounded once."""
    n = 256 * f
    hl = n // 2
    kv = np.arange(hl)
    wr, wi = kdct.dct4_chirp(n)
    w = np.exp(-1j * np.pi * (4 * kv + 1) / (4 * n))
    assert np.array_equal(wr, np.asarray(w.real, np.float32))
    assert np.array_equal(wi, np.asarray(w.imag, np.float32))
    pr, pi = kdct.dct4_post(n, scale)
    assert np.array_equal(pr, np.asarray(scale * np.cos(np.pi * kv / n), np.float32))
    assert np.array_equal(pi, np.asarray(scale * np.sin(np.pi * kv / n), np.float32))
    if kdct.dct4_form(n) == "fourstep":
        tr, ti = kdct.dct4_fourstep_tw(n)
        jr, ji = ref_plan._cis(2 * kv, hl, -1)
        assert np.array_equal(tr, np.asarray(jr, np.float32))
        assert np.array_equal(ti, np.asarray(ji, np.float32))
        dev = kdct._device_dct4("fourstep_tw", n, 1.0, torch.device("cpu"))
        assert dev.dtype == torch.complex64 and np.array_equal(dev.real.numpy(), tr)


def test_columns_per_tile():
    """The single pass takes kernel 25's rule at h = hl (the mixed solve's
    (2048, 2048, 256): 16 columns; two at hl = 10240, read-only); the
    four-step at G2's (1, 65536, 8192) splits hl = 128 * 256 and its passes
    take 32 columns at h1 = 128 and 16 at h2 = 256 (128- and 64-byte tile
    rows); an odd F keeps h2 = 128."""
    assert kdct.dct4_mid_cols(1024, 2048, 256, 132) == 16
    assert kdct.dct4_mid_cols(1024, 1, 2048 * 256, 132) == 16
    assert kdct.dct4_mid_cols(10240, 1, 8192, 132) == 2
    assert kdct.dct4_split(32768) == (128, 256)
    assert kdct.dct4_split(128 * 161) == (161, 128)
    assert kdct.dct4_fourstep_cols(128, 256, 8192, 132) == 32
    assert kdct.dct4_fourstep_cols(256, 128, 8192, 132) == 16


def test_wrapper_on_cpu_runs_the_form_plain():
    """On a CPU tensor the wrapper runs the plain version of its form and
    counts no launch."""
    counts = ("launches", "radix_launches", "fourstep_launches", "wide_launches",
              "long_launches")
    before = [getattr(kdct.dct4_mid, c) for c in counts]
    for n in (2048, 41216):
        x = torch.from_numpy(_real((1, n, 2), n))
        want = (kdct.dct4_radix_plain if n == 2048 else kdct.dct4_fourstep_plain)(x, 2.0)
        assert torch.equal(kdct.dct4_mid(x, 2.0), want)
    assert [getattr(kdct.dct4_mid, c) for c in counts] == before
