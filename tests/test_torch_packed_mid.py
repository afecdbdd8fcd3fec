"""Kernels 18, 19 and 28 (the packed R2C of DST-I's streams, DCT-I and
DCT-IV along a middle axis) against the JAX package's Pallas kernels in
interpret mode on the CPU, where the wrappers run their plain versions:

* ``r2c_packed_mid`` (on the radix column tile) against
  ``r2c_pallas_packed_mid`` at h = 256 (F = 2), 384 (F = 3) and 1024
  (F = 8), with scale -0.5 (DST-I's) and 1;
* ``dct1_mid`` against ``dct1_pallas_mid`` at n = 1153 (F = 9) and 2049
  (F = 16), both on the radix column tile;
* ``dct4_mid`` against ``dct4_pallas_mid`` at n = 1280 (F = 5), 1536
  (F = 6) and 2048 (F = 8), all in the single pass;
* each with nb = 1 and 2 and L = 128 and a ragged 130;
* the host tables bit for bit against the JAX builders' expressions, the
  plain versions against float64 oracles, the wrappers' checks, launch
  counters and tile sizes.

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
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch.ops import dst as tdst
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
# The plain versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h", [256, 384, 1024])
@pytest.mark.parametrize("scale", [-0.5, 1.0])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("cols", [128, 130])
def test_r2c_packed_mid_plain_matches_pallas(h, scale, nb, cols):
    xe = _real((nb, h, cols), h + nb + cols)
    xo = _real((nb, h, cols), h + nb + cols + 1)
    sr, si = ref_prfft.r2c_pallas_packed_mid(jnp.asarray(xe), jnp.asarray(xo), 2 * h, scale)
    got = krfft.r2c_packed_mid(torch.from_numpy(xe), torch.from_numpy(xo), scale)
    assert got.dtype == C64 and got.shape == (nb, h + 1, cols)
    _close(got, np.asarray(sr) + 1j * np.asarray(si))


@pytest.mark.parametrize("n", [1153, 2049])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("cols", [128, 130])
def test_dct1_mid_plain_matches_pallas(n, nb, cols):
    x = _real((nb, n, cols), n + nb + cols)
    got = krfft.dct1_mid(torch.from_numpy(x), 1.0)
    assert got.dtype == F32 and got.shape == (nb, n, cols)
    _close(got, ref_prfft.dct1_pallas_mid(jnp.asarray(x), 1.0))


@pytest.mark.parametrize("n", [1280, 1536, 2048])
@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("cols", [128, 130])
def test_dct4_mid_plain_matches_pallas(n, nb, cols):
    x = _real((nb, n, cols), n + nb + cols)
    got = kdct.dct4_mid(torch.from_numpy(x), 2.0)
    assert got.dtype == F32 and got.shape == (nb, n, cols)
    _close(got, ref_pdct.dct4_pallas_mid(jnp.asarray(x), 2.0))


# --------------------------------------------------------------------------
# Against float64 oracles, and the scales
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [255, 383, 1023])
def test_dst1_streams_through_k18_are_dst1(n):
    """The odd extension's streams through kernel 18 with scale -0.5 * 2,
    imaginary rows 1 .. n: scipy's DST-I, odd and even n (the even n's
    streams are the JAX package's other branch, checked on n - 1)."""
    sfft = pytest.importorskip("scipy.fft")
    for m in (n, n - 1):
        x = _real((2, m, 3), m)
        xe, xo = tdst.dst1_streams(torch.from_numpy(x))
        assert xe.shape == xo.shape == (2, m + 1, 3)
        ext = torch.stack([xe, xo], dim=2).reshape(2, 2 * m + 2, 3)
        want_ext = np.concatenate([np.zeros((2, 1, 3)), x, np.zeros((2, 1, 3)),
                                   -x[:, ::-1]], axis=1)
        assert np.array_equal(ext.numpy(), want_ext.astype(np.float32))
        if m == n:
            spec = krfft.r2c_packed_mid(xe, xo, -1.0)
            _close(spec.imag[:, 1:n + 1], sfft.dst(x.astype(np.float64), type=1, axis=1), 2e-6)


@pytest.mark.parametrize("n", [1153, 2049])
def test_dct1_mid_plain_matches_float64_oracle(n):
    sfft = pytest.importorskip("scipy.fft")
    x = _real((2, n, 3), n)
    _close(krfft.dct1_mid(torch.from_numpy(x), 1.0),
           sfft.dct(x.astype(np.float64), type=1, axis=1), 2e-6)
    torch.testing.assert_close(krfft.dct1_mid(torch.from_numpy(x), 0.25),
                               0.25 * krfft.dct1_mid(torch.from_numpy(x)), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n", [1280, 2048, 256 * 131])
def test_dct4_mid_plain_matches_float64_oracle(n):
    """Scipy's values (Default = x2) at F = 5, 8 and the prime 131 (no plan,
    no split other than (128, 131): the wide core takes it)."""
    sfft = pytest.importorskip("scipy.fft")
    x = _real((1, n, 2), n)
    _close(kdct.dct4_mid(torch.from_numpy(x), 2.0),
           sfft.dct(x.astype(np.float64), type=4, axis=1), 2e-6)


def test_packed_r2c_is_the_r2c_of_the_interleaved_column():
    """Kernel 18 on (xe, xo) is kernel 16 on the column they interleave: both
    are its R2C, held against float64 numpy. (Kernel 16 runs the radix
    column tile, kernel 18 the bts2 one, so their float32 roundings differ:
    each sits 1e-5 to 3e-5 from float64 here, ~3e-7 of the peak.)"""
    for h in (256, 384):
        xe = torch.from_numpy(_real((2, h, 3), h))
        xo = torch.from_numpy(_real((2, h, 3), h + 1))
        col = torch.stack([xe, xo], dim=2).reshape(2, 2 * h, 3)
        want = np.fft.rfft(col.numpy().astype(np.float64), axis=1)
        _close(krfft.r2c_packed_mid(xe, xo), want, 2e-6)
        _close(krfft.r2c_mid(col), want, 2e-6)
        _close(krfft.r2c_packed_mid(xe, xo, -0.5), -0.5 * want, 2e-6)


# --------------------------------------------------------------------------
# Constants, gates, wrappers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h", [256, 1024, 1152])
def test_unpack_twiddle_bit_identical_to_the_jax_tables(h):
    """Kernels 18 and 19 read W_{2h}^k, the JAX builders' _cis(2k, 2h, -1)
    (_build_r2c_packed_mid, _build_dct1_mid), with no scale in it."""
    k = np.arange(h, dtype=np.int64)
    jr, ji = ref_plan._cis(2 * k, 2 * h, -1)
    tw = krfft._device_tw(2 * h, torch.device("cpu"))
    assert np.array_equal(tw.real.numpy(), np.asarray(jr, np.float32))
    assert np.array_equal(tw.imag.numpy(), np.asarray(ji, np.float32))


@pytest.mark.parametrize("n", [1280, 2048, 4096])
@pytest.mark.parametrize("scale", [1.0, 2.0, 0.125])
def test_dct4_chirps_bit_identical_to_the_jax_expressions(n, scale):
    """The exit chirp is the JAX kernel's table scale * (cos, sin)(pi k/n)
    (dct.py:_build_dct4_mid); the entry chirp is the JAX composite's
    e^{-i pi (4s+1)/(4n)} (api.py:530-531), which the Pallas kernel folds
    into its separable stage constants."""
    hl = n // 2
    kv = np.arange(hl)
    pr, pi = kdct.dct4_post(n, scale)
    assert np.array_equal(pr, np.asarray(scale * np.cos(np.pi * kv / n), np.float32))
    assert np.array_equal(pi, np.asarray(scale * np.sin(np.pi * kv / n), np.float32))
    sv = np.arange(hl).reshape(1, hl, 1)
    w = np.exp(-1j * np.pi * (4 * sv + 1) / (4 * n))
    wr, wi = kdct.dct4_chirp(n)
    assert np.array_equal(wr, np.asarray(w.real, np.float32).ravel())
    assert np.array_equal(wi, np.asarray(w.imag, np.float32).ravel())
    assert wr.flags["C_CONTIGUOUS"] and pr.dtype == np.float32


def test_dct4_f_covers_the_jax_gate():
    """Every even n that dct4_mid_supported takes has a factor F <= 256, the
    long form beyond F = 160 (40960 < n <= 65536, which had none before
    that form was ported)."""
    fs = []
    for n in range(4, 65537, 2):
        if ref_pdct.dct4_mid_supported(n, jnp.float32):
            f = kdct.dct4_f(n)
            assert f is not None and n == 256 * f, n
            fs.append(f)
    assert max(fs) == 256 and sum(f > 160 for f in fs) == 96


@pytest.mark.parametrize("call", [
    lambda: krfft.r2c_packed_mid(torch.zeros(256, 3), torch.zeros(256, 3)),      # rank
    lambda: krfft.r2c_packed_mid(torch.zeros(1, 256, 3), torch.zeros(1, 256, 4)),
    lambda: krfft.r2c_packed_mid(torch.zeros(1, 200, 3), torch.zeros(1, 200, 3)),
    lambda: krfft.r2c_packed_mid(torch.zeros(1, 256, 3, device="meta"),
                                 torch.zeros(1, 256, 3, device="meta")),
    lambda: krfft.dct1_mid(torch.zeros(1, 1152, 3)),                  # n - 1 not 128 F
    lambda: krfft.dct1_mid(torch.zeros(1, 128 * 161 + 1, 3)),         # F > 160
    lambda: kdct.dct4_mid(torch.zeros(1, 256 * 257, 3)),              # F > 256
    lambda: kdct.dct4_mid(torch.zeros(1, 1000, 3)),
    lambda: kdct.dct4_mid(torch.zeros(1280, 3)),
])
def test_packed_mid_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_packed_mid_wrappers_reject_other_types():
    with pytest.raises(TypeError):
        krfft.r2c_packed_mid(torch.zeros(1, 256, 3, dtype=torch.float64),
                             torch.zeros(1, 256, 3, dtype=torch.float64))
    with pytest.raises(TypeError):
        krfft.dct1_mid(torch.zeros(1, 1025, 3, dtype=torch.float64))


def test_wrappers_on_cpu_count_no_launch():
    fns = ((krfft.r2c_packed_mid, "radix_launches"), (krfft.dct1_mid, "radix_launches"),
           (kdct.dct4_mid, "radix_launches"), (kdct.dct4_mid, "fourstep_launches"),
           (kdct.dct4_mid, "wide_launches"), (kdct.dct4_mid, "long_launches"))
    before = [(f.launches, getattr(f, a)) for f, a in fns]
    krfft.r2c_packed_mid(torch.zeros(1, 384, 3), torch.zeros(1, 384, 3), -0.5)
    krfft.dct1_mid(torch.zeros(1, 1153, 3))
    kdct.dct4_mid(torch.zeros(1, 2048, 3), 2.0)
    assert [(f.launches, getattr(f, a)) for f, a in fns] == before


def test_tile_sizes_of_the_paths():
    # the 1023^3 Dirichlet solve: K18 at h = 1024 on the radix column tile
    # (16 columns, 64 bytes a stream row)
    assert krfft.packed_mid_cols(1024, 1023, 1023, 132) == 16
    assert krfft.packed_mid_cols(1024, 1, 1023 * 1023, 132) == 16
    # the 2049^2 x 257 Neumann solve: K19 at h = 2048 on the radix column
    # tile (kernel 18's rule: 8 columns, 32 bytes a tile row)
    assert krfft.dct1_mid_cols(2048, 2049, 257, 132) == 8
    assert krfft.dct1_mid_cols(2048, 1, 2049 * 257, 132) == 8
    # the wide core's tiles (K22's wide form, K28's remnant) at h = 1152
    # (F = 9) and 20480 (one column per tile)
    assert kfft.wide_block(1152, 1, 1153, 132) == 4
    assert kfft.wide_block(20480, 1, 128, 132) == 1
    assert kfft.wide_block(20480, 1, 130, 132) == 1
