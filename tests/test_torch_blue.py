"""Kernels 11 and 12 (Bluestein's fused chirp-z along a middle axis: the
C2C and the real-to-real DCT-II/III core) and the Bluestein plan against
the JAX package, on the CPU, where the wrappers run their plain versions:

* ``c2c_blue_mid`` against ``c2c_pallas_axis_mid_blue`` in interpret mode
  at n = 131 (M = 384, the wide core, F = 3), 509 (M = 1024, the fixed
  core, F = 8), 1021 (F = 16) and 1031 (wide, F = 17), forward unscaled and
  inverse with scale 1/n;
* ``dct23_blue_mid`` against ``dct23_blue_pallas_mid`` at n = 1021, 1153
  and 2049 (the chirp-z on the radix core at M = chirp_m(n) = 2048, 2560,
  4608), DCT-II with scale 2 and DCT-III unscaled;
* each with nb = 1, L = 128 and nb = 2, L = 130 (a ragged column);
* the plan (``chirp_a``, ``chirp_b``, ``H``, ``M``) and the kernels' tables
  bit for bit against ``ndrustfft_tpu.plan.C2CPlan``, ``_blue_consts`` and
  ``_blue_rr_consts_cached`` (kernel 12's H at its own M = chirp_m(n)
  against float64 numpy); the convolution lengths, tiles and the wrappers'
  checks.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import plan as port_plan
from ndrustfft_tpu_torch.ops import dct as tdct
from ndrustfft_tpu_torch.ops import engine
from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
C64 = torch.complex64


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


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [131, 509, 1021, 1031])
@pytest.mark.parametrize("nb,cols", [(1, 128), (2, 130)])
@pytest.mark.parametrize("sign,scale", [(-1, None), (+1, "inv_n")])
def test_c2c_blue_mid_plain_matches_pallas(n, nb, cols, sign, scale):
    s = 1.0 / n if scale == "inv_n" else None
    g = _rng(n + cols)
    x = (g.standard_normal((nb, n, cols)) + 1j * g.standard_normal((nb, n, cols))).astype(
        np.complex64)
    yr, yi = ref_pfft.c2c_pallas_axis_mid_blue(jnp.asarray(x.real), jnp.asarray(x.imag),
                                               ref_plan.get_c2c_plan(n, sign), s)
    got = kfft.c2c_blue_mid(torch.from_numpy(x), sign, s)
    assert got.dtype == C64 and got.shape == x.shape
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


@pytest.mark.parametrize("n", [1021, 1153, 2049])
@pytest.mark.parametrize("nb,cols", [(1, 128), (2, 130)])
@pytest.mark.parametrize("dct_type,scale", [(2, 2.0), (3, None)])
def test_dct23_blue_mid_plain_matches_pallas(n, nb, cols, dct_type, scale):
    x = _rng(n + cols + dct_type).standard_normal((nb, n, cols)).astype(np.float32)
    want = ref_pfft.dct23_blue_pallas_mid(jnp.asarray(x), dct_type, scale)
    got = kdct.dct23_blue_mid(torch.from_numpy(x), dct_type, scale)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)


def test_plain_versions_match_float64_oracles():
    """K11's plain version is the DFT along dim 1; K12's is the Makhoul core:
    after the un-permutation, DCT-III, and on the permuted input, DCT-II."""
    g = _rng(7)
    x = g.standard_normal((2, 263, 129)) + 1j * g.standard_normal((2, 263, 129))
    for sign in (-1, 1):
        want = np.fft.fft(x, axis=1) if sign < 0 else np.fft.ifft(x, axis=1) * 263
        _close(kfft.c2c_blue_mid(torch.from_numpy(x.astype(np.complex64)), sign), want, 2e-6)
    r = g.standard_normal((1, 1153, 128))
    got = tdct.dct23_blue_mid(torch.from_numpy(r.astype(np.float32)), 2, 2.0)
    _close(got, sfft.dct(r, type=2, axis=1), 2e-6)
    got = tdct.dct23_blue_mid(torch.from_numpy(r.astype(np.float32)), 3, 2.0)
    _close(got, sfft.dct(r, type=3, axis=1), 2e-6)


# --------------------------------------------------------------------------
# The plan and the tables, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [131, 257, 263, 509, 1021, 2049, 6781, 10007])
@pytest.mark.parametrize("sign", [-1, 1])
def test_bluestein_plan_bit_identical(n, sign):
    p, r = port_plan.C2CPlan(n, sign), ref_plan.C2CPlan(n, sign)
    assert p.kind == r.kind == "bluestein"
    assert p.M == r.M == ref_plan.blue_sub_len(n)
    for name in ("chirp_a", "chirp_b", "H"):
        for a, b in zip(getattr(p, name), getattr(r, name)):
            assert a.dtype == np.float64 and np.array_equal(a, b), name
    assert (p.sub_fwd.n, p.sub_fwd.sign, p.sub_inv.sign) == (p.M, -1, 1)
    assert p.sub_fwd.kind == p.sub_inv.kind == "ct"


def test_sub_lengths_match_the_jax_package():
    for n in range(1, 20482):
        assert port_plan.next_smooth(n) == ref_plan.next_smooth(n)
        assert port_plan.blue_sub_len(n) == ref_plan.blue_sub_len(n), n
        assert kfft.blue_kernel_M(n) == ref_pfft.blue_kernel_M(n), n


def _blocks(consts, sections):
    out, i = [], 0
    for s in sections:
        out.append(consts[i:i + s])
        i += s
    return out


def _check_core(port_wq, ref_core, f, trim=None):
    """The port's (F, m, m) Wq pair against the JAX core tables: F pairs of
    (m, m) (or the first p_trim output columns), then the DFT-F at F not in
    {2, 4, 8, 16}."""
    re, im = port_wq
    for q in range(f):
        cols = ref_core[2 * q].shape[1]
        assert trim is None or cols == trim
        assert np.array_equal(re[q][:, :cols], ref_core[2 * q])
        assert np.array_equal(im[q][:, :cols], ref_core[2 * q + 1])


@pytest.mark.parametrize("n", [131, 509, 1021, 1031, 2049])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("scale", ["one", "inv_n"])
def test_blue_consts_bit_identical(n, sign, scale):
    s = 1.0 if scale == "one" else 1.0 / n
    mk = kfft.blue_kernel_M(n)
    consts, sections, kind, (m, f, p_trim) = ref_pfft._blue_consts(
        n, mk, sign, np.float32, "highest", s)
    (ca, fwd, h, inv, cb) = _blocks(consts, sections)
    a, hh, wq_f, wq_i = kfft.blue_consts(n, sign, s)
    for port, ref in ((a, ca), (a, cb), (hh, h)):
        assert np.array_equal(port[0], ref[0][:, 0]) and np.array_equal(port[1], ref[1][:, 0])
    assert mk == 128 * kfft.blue_f(n)
    if kind == "bts2":          # F <= 16: the JAX kernel's own core tables
        assert f == mk // 128
        _check_core(wq_f, fwd, f)
        _check_core(wq_i, inv, f, p_trim)
        if f not in (2, 4, 8, 16):
            wf = kfft.wide_consts(mk, -1)
            assert np.array_equal(wf[0], fwd[-2]) and np.array_equal(wf[1], fwd[-1])
    else:                       # the TPU's twostep body: its bts2 tables instead
        assert kind == "ts"
        for wq, sg, sc in ((wq_f, -1, 1.0), (wq_i, 1, s / mk)):
            ref, _ = ref_pfft._bts2_consts(mk, sg, np.float32, "highest", sc)
            _check_core(wq, ref, mk // 128)


@pytest.mark.parametrize("n", [1021, 1153, 2049])
@pytest.mark.parametrize("dct_type", [2, 3])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_blue_rr_consts_bit_identical(n, dct_type, scale):
    """Kernel 12's entry and exit tables are the JAX kernel's bit for bit;
    its H is FFT_M of the JAX plan's wrapped inverse chirp at its own
    M = chirp_m(n), in float64, rounded once."""
    consts, sections, kind, (m, f, p_trim), mk = ref_pfft._blue_rr_consts_cached(
        n, "float32", "highest", f"dct{dct_type}", scale)
    (ca, fwd, h, inv, cb) = _blocks(consts, sections)
    a, b, hh = kdct.blue_rr_consts(n, dct_type, scale)
    for port, ref in ((a, ca), (b, cb)):
        assert np.array_equal(port[0], ref[0][:, 0]) and np.array_equal(port[1], ref[1][:, 0])
    mc = kfft.chirp_m(n)
    cr, ci = ref_plan.chirp(n, 1)
    w = np.zeros(mc, np.complex128)
    w[:n] = cr + 1j * ci
    w[mc - n + 1:] = (cr[1:] + 1j * ci[1:])[::-1]
    want = np.fft.fft(w)
    assert np.array_equal(hh[0], want.real.astype(np.float32))
    assert np.array_equal(hh[1], want.imag.astype(np.float32))


# --------------------------------------------------------------------------
# The wrappers, tiles and the engine's chirp-z
# --------------------------------------------------------------------------


def test_blue_lengths_and_tiles():
    assert [kfft.blue_f(n) for n in (128, 131, 509, 1021, 1031, 2049, 6781, 7100, 8192)] == \
        [None, 3, 8, 16, 17, 33, 106, 111, None]
    # the gate's bound is the JAX package's one-column tile, F <= 111
    # (n <= 7104), and every length it takes has kernel 12's convolution
    # length within one column tile of the radix core
    assert kfft.BLUE_MAX_F == 111
    assert kfft.blue_f(7104) == 111 and kfft.blue_f(7105) is None
    for f in range(3, kfft.BLUE_MAX_F + 1):
        for n in (64 * f + 1, 64 * f + 64):
            if kfft.blue_f(n) == f:
                mk = kfft.chirp_m(n)
                assert mk <= kfft.RADIX_MAX_ELEMS and kfft.radix_plan(mk) is not None


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 509, 128, dtype=C64)
    with pytest.raises(ValueError, match="expected"):
        kfft.c2c_blue_mid(x[0], -1)
    with pytest.raises(ValueError, match="chirp-z"):
        kfft.c2c_blue_mid(torch.zeros(1, 127, 128, dtype=C64), -1)
    with pytest.raises(ValueError, match="chirp-z"):
        kdct.dct23_blue_mid(torch.zeros(1, 8191, 128), 2)
    with pytest.raises(ValueError, match="DCT-4"):
        kdct.dct23_blue_mid(torch.zeros(1, 509, 128), 4)
    before = (kfft.c2c_blue_mid.launches, kdct.dct23_blue_mid.launches)
    kfft.c2c_blue_mid(x, -1)
    kdct.dct23_blue_mid(torch.zeros(1, 509, 128), 2)
    assert (kfft.c2c_blue_mid.launches, kdct.dct23_blue_mid.launches) == before


def test_engine_chirp_z_runs_its_sub_ffts_on_the_row_kernels(monkeypatch):
    """Along the last axis over >= 128 rows the two length-M sub-FFTs go to
    kernel 10 (M = 1024 at n = 509): the einsum engine never runs. Below 128
    rows the engine takes them, as the JAX package runs XLA."""
    seen = []
    plain = engine._ROW_KERNELS[nd.gates.C2C_ROWS]
    monkeypatch.setitem(engine._ROW_KERNELS, nd.gates.C2C_ROWS,
                        lambda x, sign, scale: seen.append((x.shape, sign)) or
                        plain(x, sign, scale))
    g = _rng(3)
    x = g.standard_normal((128, 509)) + 1j * g.standard_normal((128, 509))
    calls = engine.c2c.calls
    y = nd.ndfft(torch.from_numpy(x.astype(np.complex64)))
    assert engine.c2c.calls == calls
    assert seen == [((128, 1024), -1), ((128, 1024), 1)]
    _close(y, np.fft.fft(x), 2e-6)
    nd.ndfft(torch.from_numpy(x[:4].astype(np.complex64)))
    assert engine.c2c.calls == calls + 2
