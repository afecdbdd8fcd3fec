"""Kernels 25 and 26 (DCT-II/III along a middle axis) and the rest of
kernels 16/17 and 23/24 against the JAX package's Pallas kernels in
interpret mode on the CPU, where the wrappers run their plain versions:

* ``dct2_mid`` / ``dct3_mid`` against ``dct2_pallas_mid`` /
  ``dct3_pallas_mid`` at n = 1152, 1280 and 2048, L = 128 and a ragged 130,
  nb = 1 and 2: kernels 25 and 26 on the radix column tile at all three
  (the n-point form, the wide core's half length and the fixed core until
  they moved there);
* ``r2c_mid`` (the radix column tile) / ``c2r_mid`` (the wide core) against
  ``r2c_pallas_mid`` / ``c2r_pallas_mid`` at n = 768 and 1280;
* ``dct2_nat`` / ``dct3_nat`` against ``dct2_pallas`` / ``dct3_pallas`` at
  n = 128, 384, 768 and 1536, on the radix row core (the n-point and wide
  forms' lengths before it);
* the kernels' twiddle tables bit for bit against the JAX kernels' ``_cis``
  tables, and ``dct_form`` against the JAX gate;
* the wrappers' checks, launch counters and tile sizes.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier, where each side measures <= 5e-7 against a float64
oracle. The plain versions take float32 only, as the kernels do.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import dct as ref_pdct
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
F32, C64 = torch.float32, torch.complex64


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
# Kernels 25 and 26
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,form", [(1152, ("npoint", 9)), (1280, ("half", 5)),
                                    (2048, ("half", 8))])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("cols", [128, 130])
@pytest.mark.parametrize("kernel,ref,scale", [(kdct.dct2_mid, ref_pdct.dct2_pallas_mid, 2.0),
                                              (kdct.dct3_mid, ref_pdct.dct3_pallas_mid, None)])
def test_mid_plain_matches_pallas(n, form, nb, cols, kernel, ref, scale):
    assert kdct.dct_form(n) == form
    type3 = kernel is kdct.dct3_mid
    assert kdct.launch_form(n, type3, False) == "radix"
    x = _real((nb, n, cols), n + nb + cols)
    got = kernel(torch.from_numpy(x), scale)             # CPU: the plain version
    assert got.dtype == F32 and got.shape == (nb, n, cols)
    _close(got, ref(jnp.asarray(x), scale))


@pytest.mark.parametrize("n", [1152, 1280, 2048])
def test_mid_plain_matches_float64_oracle(n):
    """The scipy convention (Default = x2) and the round trip DCT-III(DCT-II)
    / (2n) = identity, in every form."""
    sfft = pytest.importorskip("scipy.fft")
    x = _real((2, n, 130), n)
    y = kdct.dct2_mid(torch.from_numpy(x), 2.0)
    _close(y, sfft.dct(x.astype(np.float64), type=2, axis=1), 2e-6)
    _close(kdct.dct3_mid(torch.from_numpy(x), 2.0),
           sfft.dct(x.astype(np.float64), type=3, axis=1), 2e-6)
    _close(kdct.dct3_mid(y, 1.0 / n), x, 2e-6)


def test_mid_is_the_row_kernels_on_a_transposed_view():
    """Kernels 25 and 26 are kernels 23's Makhoul R2C and 24's Makhoul C2R
    on the radix core in the column layout."""
    for n in (1152, 1280, 2048):
        x = torch.from_numpy(_real((2, n, 3), n))
        rows = x.transpose(1, 2).reshape(6, n)
        for mid, nat in ((kdct.dct2_mid, kdct.dct2_nat), (kdct.dct3_mid, kdct.dct3_nat)):
            torch.testing.assert_close(mid(x, 0.5).transpose(1, 2).reshape(6, n),
                                       nat(rows, 0.5), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# Kernels 16/17 on the wide core and 23/24 in their new forms
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 768, 130), (2, 1280, 129)])
def test_wide_r2c_mid_plain_matches_pallas(shape):
    """Kernel 16 at h = 384 (F = 3) and 640 (F = 5)."""
    assert kfft.core_f(shape[1] // 2) not in kfft.CORE_F
    x = _real(shape, sum(shape))
    sr, si = ref_prfft.r2c_pallas_mid(jnp.asarray(x), ref_plan.get_r2c_plan(shape[1]))
    got = krfft.r2c_mid(torch.from_numpy(x))
    assert got.dtype == C64 and got.shape == (shape[0], shape[1] // 2 + 1, shape[2])
    _close(got, np.asarray(sr) + 1j * np.asarray(si))


@pytest.mark.parametrize("shape", [(1, 768, 130), (2, 1280, 129)])
@pytest.mark.parametrize("scale", [None, "inv_n"])
def test_wide_c2r_mid_plain_matches_pallas(shape, scale):
    """Kernel 17 at F = 3 and 5, with DC and Nyquist imaginary parts that must
    be ignored."""
    nb, n, cols = shape
    rng = np.random.default_rng(n + cols)
    spec = (rng.standard_normal((nb, n // 2 + 1, cols))
            + 1j * rng.standard_normal((nb, n // 2 + 1, cols))).astype(np.complex64)
    spec[:, 0] += 100j
    spec[:, -1] += 100j
    s = 1.0 / n if scale else None
    want = ref_prfft.c2r_pallas_mid(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, s)
    got = krfft.c2r_mid(torch.from_numpy(spec), n, s)
    assert got.dtype == F32 and got.shape == shape
    _close(got, want)


@pytest.mark.parametrize("n,form", [(128, ("npoint", 1)), (384, ("npoint", 3)),
                                    (768, ("half", 3)), (1536, ("half", 6))])
@pytest.mark.parametrize("kernel,ref,scale", [(kdct.dct2_nat, ref_pdct.dct2_pallas, 2.0),
                                              (kdct.dct3_nat, ref_pdct.dct3_pallas, 0.5)])
def test_nat_plain_matches_pallas_in_the_new_forms(n, form, kernel, ref, scale):
    assert kdct.dct_form(n) == form
    assert kdct.launch_form(n, kernel is kdct.dct3_nat, True) == "radix"
    x = _real((130, n), n)
    got = kernel(torch.from_numpy(x), scale)
    assert got.dtype == F32 and got.shape == (130, n)
    _close(got, ref(jnp.asarray(x), scale))


# --------------------------------------------------------------------------
# Constants, forms, wrappers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [128, 1152, 1280])
def test_twiddles_bit_identical_to_the_jax_tables(n):
    """The DCT-II post twiddle is the JAX kernels' w table (_cis(k, 2n, -1),
    dct.py:_build_dct2) bit for bit; the n-point DCT-III pre twiddle is the
    same _cis values (the JAX kernel folds e^{-i pi t / 2n} into its stage
    constants), with entry 0 halved and the scale folded in exactly."""
    wr, wi = kdct.dct2_post(n, 1.0)
    jr, ji = ref_plan._cis(np.arange(n, dtype=np.int64), 2 * n, -1)
    assert np.array_equal(wr, np.asarray(jr, np.float32))
    assert np.array_equal(wi, np.asarray(ji, np.float32))
    pr, pi = kdct.dct3_pre_npoint(n, 1.0)
    assert pr[0] == np.float32(0.5) and pi[0] == 0.0
    assert np.array_equal(pr[1:], np.asarray(jr[1:], np.float32))
    assert np.array_equal(pi[1:], np.asarray(ji[1:], np.float32))
    qr, qi = kdct.dct3_pre_npoint(n, 2.0)
    assert np.array_equal(qr[1:], np.asarray(2.0 * jr[1:], np.float32))
    assert qr.dtype == np.float32 and qr.flags["C_CONTIGUOUS"]


def test_forms_cover_the_jax_gate():
    """Every even n the JAX gate dct_pallas_supported takes has a form, odd
    k > 160 included (the n-point form on the real tile; it had none before
    the long form was ported)."""
    for n in range(2, 32770, 2):
        if ref_pdct.dct_pallas_supported(n, jnp.float32):
            form = kdct.dct_form(n)
            k = n // 128
            assert form == (("half", k // 2) if k % 2 == 0 else ("npoint", k)), n


@pytest.mark.parametrize("call", [
    lambda: kdct.dct2_mid(torch.zeros(1152, 3)),                        # rank
    lambda: kdct.dct2_mid(torch.zeros(1, 1100, 3)),                     # not 128 * k
    lambda: kdct.dct3_mid(torch.zeros(1, 128 * 257, 3)),                # n-point, F > 256
    lambda: kdct.dct3_mid(torch.zeros(1, 1152, 3, device="meta")),      # device
    lambda: kdct.dct2_nat(torch.zeros(2, 1152, 3)),
])
def test_dct_mid_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_wrappers_on_cpu_count_no_launch():
    fns = (kdct.dct2_mid, kdct.dct3_mid, kdct.dct2_nat, kdct.dct3_nat, krfft.r2c_mid,
           krfft.c2r_mid)
    forms = ("launches", "wide_launches", "npoint_launches", "radix_launches")
    before = [[getattr(f, a, 0) for a in forms] for f in fns]
    kdct.dct2_mid(torch.zeros(1, 1152, 3))
    kdct.dct3_mid(torch.zeros(1, 1280, 3), 0.5)
    kdct.dct2_nat(torch.zeros(2, 384))
    kdct.dct3_nat(torch.zeros(2, 768))
    krfft.r2c_mid(torch.zeros(1, 768, 3))
    krfft.c2r_mid(torch.zeros(1, 385, 3, dtype=C64), 768)
    assert [[getattr(f, a, 0) for a in forms] for f in fns] == before


def test_tile_sizes_of_the_new_forms():
    # the 1536^3 solve: h = 768, 8 transforms (80 KB with the scratch) per tile
    assert kfft.wide_block(768, 1, 1536 * 1536, 132) == 8
    assert kfft.wide_block(768, 1536, 1536, 132) == 8
    # the n-point form at 1152 (F = 9): 4 columns; at 20352 (F = 159): one
    assert kfft.wide_block(1152, 1, 4096, 132) == 4
    assert kfft.wide_block(128 * 159, 1, 3, 132) == 1
    assert kfft.wide_bytes(128 * 159, 1) <= kfft.MAX_SMEM
