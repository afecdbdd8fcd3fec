"""The long DCT forms against the JAX package's Pallas kernels in interpret
mode on the CPU, where the wrappers run their plain versions:

* kernels 23 to 26 in the n-point form at odd k > 160 (n = 20608, 20864
  with the prime k = 163, and 32640 = 128 * 255): ``dct2_mid`` /
  ``dct3_mid`` against ``dct2_pallas_mid`` / ``dct3_pallas_mid``,
  ``dct2_nat`` / ``dct3_nat`` against ``dct2_pallas`` / ``dct3_pallas``;
* kernel 29's n-point form at the same lengths against
  ``spectral_dct_pallas_mid``, with a broadcast and a lane-varying H;
* kernel 28's long form (F = 161, 163, 256: n = 41216, 41728, 65536)
  against ``dct4_pallas_mid``;
* the tables bit for bit: the core's Wq and W_F at F = 163 and 255 against
  ``_bts2_consts``, the separable chirps against the JAX kernels' ``_cis``
  and exponential expressions, kernel 28's chirps at hl = 32768;
* the forms (``dct_form``, ``dct4_f``) and the real tile's shared memory.

The CUDA kernels themselves are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import dct as ref_pdct
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
LONG_N = (20608, 20864, 32640)       # n = 128 k, k = 161, 163 (prime), 255
LONG_N4 = (41216, 41728, 65536)      # n = 256 F, F = 161, 163 (prime), 256


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
# The plain versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", LONG_N)
@pytest.mark.parametrize("kernel,ref,scale", [(kdct.dct2_mid, ref_pdct.dct2_pallas_mid, 2.0),
                                              (kdct.dct3_mid, ref_pdct.dct3_pallas_mid, None)])
def test_mid_plain_matches_pallas(n, kernel, ref, scale):
    """Kernels 25/26 in the n-point form, nb = 2 at the prime k."""
    nb = 2 if n == 20864 else 1
    x = _real((nb, n, 3), n)
    got = kernel(torch.from_numpy(x), scale)
    assert got.dtype == torch.float32
    _close(got, ref(jnp.asarray(x), scale))


@pytest.mark.parametrize("n", LONG_N)
@pytest.mark.parametrize("kernel,ref,scale", [(kdct.dct2_nat, ref_pdct.dct2_pallas, None),
                                              (kdct.dct3_nat, ref_pdct.dct3_pallas, 2.0)])
def test_nat_plain_matches_pallas(n, kernel, ref, scale):
    """Kernels 23/24 in the n-point form on (3, n) rows."""
    x = _real((3, n), n + 1)
    _close(kernel(torch.from_numpy(x), scale), ref(jnp.asarray(x), scale))


@pytest.mark.parametrize("n", LONG_N)
@pytest.mark.parametrize("lane", [False, True])
def test_spectral_plain_matches_pallas(n, lane):
    """Kernel 29 in the n-point form: a broadcast H with the Default scales,
    a lane-varying H with s2 = 1 and s3 = 1/n."""
    x = _real((1, n, 3), n + 2)
    hv = _real((n, 3 if lane else 1), n + 3)
    s2, s3 = (None, 1.0 / n) if lane else (2.0, 2.0)
    got = kdct.spectral_dct_mid(torch.from_numpy(x), torch.from_numpy(hv), s2, s3)
    _close(got, ref_pdct.spectral_dct_pallas_mid(jnp.asarray(x), jnp.asarray(hv), s2, s3))


@pytest.mark.parametrize("n", LONG_N4)
@pytest.mark.parametrize("scale", [2.0, None])
def test_dct4_plain_matches_pallas(n, scale):
    """Kernel 28 at F = n/256 > 160: the four-step at F = 161 and 256, the
    long form at the prime 163."""
    assert kdct.dct4_f(n) == n // 256 > kfft.WIDE_MAX_F
    x = _real((1, n, 3), n + int(scale is None))
    _close(kdct.dct4_mid(torch.from_numpy(x), scale), ref_pdct.dct4_pallas_mid(jnp.asarray(x),
                                                                              scale))


# --------------------------------------------------------------------------
# Tables
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,sign", [(128 * 163, -1), (128 * 255, -1), (128 * 255, +1)])
def test_core_tables_bit_identical_to_bts2_consts(n, sign):
    """Wq and W_F at F = 163 (prime) and 255, the real tile's largest odd
    F, against the JAX package's ``_bts2_consts`` (mode "highest")."""
    f = n // 128
    wr, wi = kfft.wide_consts(n, sign)
    qr, qi = kfft.bts2_consts(n, sign, 1.0)
    consts, (m, f_ref) = ref_pfft._bts2_consts(n, sign, np.float32, "highest", 1.0)
    assert (m, f_ref) == (128, f) and len(consts) == 2 * f + 2
    assert np.array_equal(wr, consts[2 * f]) and np.array_equal(wi, consts[2 * f + 1])
    for q in range(f):
        assert np.array_equal(qr[q], consts[2 * q]) and np.array_equal(qi[q], consts[2 * q + 1])
    a, q = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
    assert np.array_equal(wr, wr[1][(a * q) % f]) and np.array_equal(wi, wi[1][(a * q) % f])


@pytest.mark.parametrize("n", LONG_N + (384, 1152))
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_npoint_chirp_is_the_jax_expressions(n, scale):
    """The n-point DCT-III's separable chirp: e^{-i pi a/(2F)} (a < F) is
    the JAX package's ``_cis(a, 2F, -1)``, and its b part at scale 1 is the
    JAX kernel's pre_b table ``_cis(j, 2n, -1)`` (dct.py::_build_dct3) for
    j < 128, bit for bit; their product is the one-table twiddle of the
    plain version within float32 rounding."""
    f = n // 128
    cr, ci = kdct.npoint_chirp(n, scale)
    assert cr.shape == (f + 128,) and cr.dtype == np.float32 and cr.flags["C_CONTIGUOUS"]
    ar, ai = ref_plan._cis(np.arange(f, dtype=np.int64), 2 * f, -1)
    assert np.array_equal(cr[:f], np.asarray(ar, np.float32))
    assert np.array_equal(ci[:f], np.asarray(ai, np.float32))
    br, bi = ref_plan._cis(np.arange(max(f, 128), dtype=np.int64), 2 * n, -1)
    assert np.array_equal(cr[f:], np.asarray(br[:128] * scale, np.float32))
    assert np.array_equal(ci[f:], np.asarray(bi[:128] * scale, np.float32))
    w = (cr[:f, None] + 1j * ci[:f, None]).astype(np.complex128) * (cr[f:] + 1j * ci[f:])
    pr, pi = kdct.dct3_pre_npoint(n, scale)
    one = (pr + 1j * pi).astype(np.complex128)
    one[0] *= 2                                   # the table folds the x0 halving
    assert np.abs(w.ravel() - one).max() <= 4e-7 * scale


@pytest.mark.parametrize("n", LONG_N4)
def test_dct4_long_chirps_are_the_jax_expressions(n):
    """Kernel 28's chirps at hl = n/2 up to 32768: the entry chirp of the
    plain version and the exit chirp are the JAX expressions bit for bit
    (as at F <= 160); the long form's separable chirp is the JAX kernel's
    a and b expressions (dct.py::_build_dct4_mid) over the port's split,
    its b part that kernel's b table for j < 128 bit for bit."""
    hl, f = n // 2, n // 256
    kv = np.arange(hl)
    pr, pi = kdct.dct4_post(n, 2.0)
    assert np.array_equal(pr, np.asarray(2.0 * np.cos(np.pi * kv / n), np.float32))
    assert np.array_equal(pi, np.asarray(2.0 * np.sin(np.pi * kv / n), np.float32))
    w = np.exp(-1j * np.pi * (4 * kv + 1) / (4 * n))
    wr, wi = kdct.dct4_chirp(n)
    assert np.array_equal(wr, np.asarray(w.real, np.float32))
    assert np.array_equal(wi, np.asarray(w.imag, np.float32))
    cr, ci = kdct.dct4_chirp_long(n)
    assert cr.shape == (f + 128,) and cr.dtype == np.float32
    jv = np.arange(f, dtype=np.float64)
    jb = np.exp(-1j * np.pi / (4 * n)) * np.exp(-1j * np.pi * jv / n)
    assert np.array_equal(cr[f:], np.asarray(jb.real[:128], np.float32))
    assert np.array_equal(ci[f:], np.asarray(jb.imag[:128], np.float32))
    ja = np.exp(-1j * np.pi * jv * 128 / n)
    assert np.array_equal(cr[:f], np.asarray(ja.real, np.float32))
    assert np.array_equal(ci[:f], np.asarray(ja.imag, np.float32))
    prod = (cr[:f, None] + 1j * ci[:f, None]).astype(np.complex128) * (cr[f:] + 1j * ci[f:])
    assert np.abs(prod.ravel() - w).max() <= 3e-7


# --------------------------------------------------------------------------
# Forms and the real tile
# --------------------------------------------------------------------------


def test_long_forms_and_their_tiles():
    """Every odd k in 161 ... 255 is an n-point form and every F in
    161 ... 256 a DCT-IV factor past the complex tile (the four-step, or
    the long form at a prime F); one real tile of the longest fits a block
    with room to spare, where a complex one would not, so the wrappers
    pick one transform per tile."""
    for k in range(161, 256, 2):
        assert kdct.dct_form(128 * k) == ("npoint", k)
    assert kdct.dct_form(128 * 257) is None and kdct.dct_form(128 * 322) is None
    assert [kdct.dct4_f(256 * f) for f in (161, 256, 257)] == [161, 256, None]
    for n in (32640, 32768):
        assert kfft.wide_bytes(n, 1) > kfft.MAX_SMEM
        assert kfft.wide_real_bytes(n, 1) <= 136 * 1024
        assert 2 * kfft.wide_real_bytes(n, 1) > kfft.MAX_SMEM
        assert kfft.wide_block(n, 1, 4096, 132, kfft.wide_real_bytes) == 1
    # (F, 128, 128) complex64 Wq at F = 256: 32 MB, kept in the device cache
    assert 256 * 128 * 128 * 8 < kfft.WQ_CACHE_BYTES


def test_long_wrappers_on_cpu_count_no_launch():
    before = [(w.launches, w.npoint_launches) for w in (kdct.dct2_mid, kdct.dct3_nat,
                                                        kdct.spectral_dct_mid)]
    before4 = (kdct.dct4_mid.launches, kdct.dct4_mid.long_launches,
               kdct.dct4_mid.fourstep_launches)
    x = torch.from_numpy(_real((1, 20608, 2), 7))
    kdct.dct2_mid(x, 2.0)
    kdct.dct3_nat(x[0].T.contiguous())
    kdct.spectral_dct_mid(x, torch.ones(20608, 1))
    kdct.dct4_mid(torch.from_numpy(_real((1, 41216, 2), 8)), 2.0)
    assert [(w.launches, w.npoint_launches) for w in (kdct.dct2_mid, kdct.dct3_nat,
                                                      kdct.spectral_dct_mid)] == before
    assert (kdct.dct4_mid.launches, kdct.dct4_mid.long_launches,
            kdct.dct4_mid.fourstep_launches) == before4
