"""Kernels 14, 22 and 29 (the fused spectral pipelines along a middle axis)
against the JAX package, on the CPU, where the wrappers run their plain
versions:

* ``spectral_c2c_mid`` (K14, IFFT(H FFT(x))) against
  ``spectral_c2c_pallas_mid`` in interpret mode at n = 512 and 1024 (the
  fixed core) and 384, 640 (the wide core, F = 3 and 5);
* ``spectral_r2c_mid`` (K22, C2R(H R2C(x))) against ``spectral_pallas_mid``
  at n = 512, 1024 (fixed) and 768, 1280 (wide, h = 384 and 640), with a
  complex H whose DC and Nyquist rows have nonzero imaginary parts;
* ``spectral_dct_mid`` (K29, DCT-III(H DCT-II(x))) against
  ``spectral_dct_pallas_mid`` at n = 512, 1024 (the fixed half form), 256
  and 1280 (the wide half form, F = 1 and 5), 128, 384 and 640 (the n-point
  form, F = 1, 3 and 5);
* each on (2, n, 16) inputs from a numpy seed, with a broadcast (rows, 1)
  and a lane-varying (rows, 16) H, real and complex (K14, K22), and the
  scales 1, 1/n and a scalar (s2, s3 for K29: Default 2, NONE 1, scalars);
* the kernels' host tables bit for bit against the JAX builders' (the
  cores' Wq and DFT-F, the R2C unpack twiddle, the C2R combine's A and B
  rows, the DCT-II post twiddle); the wrappers' checks, and every C entry
  point's ctypes signature against its declaration in ``csrc``.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier.
"""

import re
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import dct as ref_pdct
from ndrustfft_tpu.ops.pallas import fft as ref_pfft
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch.ops.hopper import _build
from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
COLS = 16


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


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _mult(g, rows, kind):
    """(hr, hi) float32 of a multiplier of ``kind`` ("real"/"complex" and
    "bcast"/"lane"): (rows, 1) or (rows, COLS); hi None for a real H."""
    shape = (rows, 1 if kind.endswith("bcast") else COLS)
    hr = g.standard_normal(shape).astype(np.float32)
    hi = g.standard_normal(shape).astype(np.float32) if kind.startswith("complex") else None
    return hr, hi


HKINDS = ["real_bcast", "complex_bcast", "real_lane", "complex_lane"]
# the scale of each multiplier kind's case: 1, 1/n and a scalar policy's value
SCALES = {"real_bcast": None, "complex_bcast": "inv_n", "real_lane": 0.37,
          "complex_lane": "inv_n"}


def _scale(name, n):
    return 1.0 / n if name == "inv_n" else name


# --------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [384, 512, 640, 1024])
@pytest.mark.parametrize("hkind", HKINDS)
def test_spectral_c2c_mid_plain_matches_pallas(n, hkind):
    g = _rng("c2c", n, hkind)
    x = (g.standard_normal((2, n, COLS)) + 1j * g.standard_normal((2, n, COLS))).astype(
        np.complex64)
    hr, hi = _mult(g, n, hkind)
    s = _scale(SCALES[hkind], n)
    yr, yi = ref_pfft.spectral_c2c_pallas_mid(
        jnp.asarray(x.real), jnp.asarray(x.imag), jnp.asarray(hr),
        jnp.asarray(np.zeros_like(hr) if hi is None else hi), s)
    h = torch.from_numpy(hr) if hi is None else torch.complex(torch.from_numpy(hr),
                                                              torch.from_numpy(hi))
    got = kfft.spectral_c2c_mid(torch.from_numpy(x), h, s)
    assert got.dtype == torch.complex64
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


@pytest.mark.parametrize("n", [512, 768, 1024, 1280])
@pytest.mark.parametrize("hkind", HKINDS)
def test_spectral_r2c_mid_plain_matches_pallas(n, hkind):
    """A complex H has nonzero imaginary parts at DC and Nyquist: the kernel
    drops Im S[0] and takes Re H[h] X[h] at Nyquist, as the JAX kernel does."""
    g = _rng("r2c", n, hkind)
    m = n // 2 + 1
    x = g.standard_normal((2, n, COLS)).astype(np.float32)
    hr, hi = _mult(g, m, hkind)
    if hi is not None:
        hi[0] += 3.0
        hi[-1] -= 2.0
    s = _scale(SCALES[hkind], n)
    want = ref_prfft.spectral_pallas_mid(
        jnp.asarray(x), jnp.asarray(hr), jnp.asarray(np.zeros_like(hr) if hi is None else hi),
        n, s)
    got = krfft.spectral_r2c_mid(torch.from_numpy(x), torch.from_numpy(hr),
                                 None if hi is None else torch.from_numpy(hi), n, s)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("n", [128, 256, 384, 512, 640, 1024, 1280])
@pytest.mark.parametrize("hkind,s2,s3", [("real_bcast", 2.0, 2.0), ("real_lane", None, 0.37),
                                        ("real_lane", 0.5, None)])
def test_spectral_dct_mid_plain_matches_pallas(n, hkind, s2, s3):
    g = _rng("dct", n, hkind, s2, s3)
    x = g.standard_normal((2, n, COLS)).astype(np.float32)
    hv, _ = _mult(g, n, hkind)
    want = ref_pdct.spectral_dct_pallas_mid(jnp.asarray(x), jnp.asarray(hv), s2, s3)
    got = kdct.spectral_dct_mid(torch.from_numpy(x), torch.from_numpy(hv), s2, s3)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("n,form", [(128, ("npoint", 1)), (256, ("half", 1)),
                                    (384, ("npoint", 3)), (512, ("half", 2)),
                                    (1280, ("half", 5)), (20352, ("npoint", 159)),
                                    (32768, ("half", 128)), (20608, ("npoint", 161)),
                                    (32640, ("npoint", 255))])
def test_dct_forms_of_the_fused_lengths(n, form):
    """K29 takes every n the JAX gate takes in dct_form's forms, n = 128 up
    to the n-point F = 255 (odd k > 160 on the real tile, which had no form
    before the long n-point form was ported) and the half form at k = 256."""
    assert ref_pdct.dct_pallas_supported(n, jnp.float32)
    assert kdct.dct_form(n) == form


# --------------------------------------------------------------------------
# Tables bit for bit against the JAX builders'
# --------------------------------------------------------------------------


def _consts(run):
    """The constants a JAX builder's closure passes to its pallas_call."""
    cells = dict(zip(run.__code__.co_freevars, (c.cell_contents for c in run.__closure__)))
    return [np.asarray(c) for c in cells["consts"]]


def _check_core(wq, wf, ref, f):
    """The port's Wq pair (and DFT-F pair, or None) against the JAX core
    tables: F pairs of (m, m), then the DFT-F where the core has one."""
    for q in range(f):
        assert np.array_equal(wq[0][q], ref[2 * q]) and np.array_equal(wq[1][q], ref[2 * q + 1])
    if len(ref) == 2 * f + 2:
        assert np.array_equal(wf[0], ref[2 * f]) and np.array_equal(wf[1], ref[2 * f + 1])
    else:
        assert len(ref) == 2 * f


@pytest.mark.parametrize("n,scale", [(512, 1.0 / 512), (640, 0.37), (1024, 1.0)])
def test_spectral_c2c_tables_bit_identical(n, scale):
    run = ref_pfft._build_spectral_c2c_mid(n, 1, COLS, "float32", True, "highest", scale)
    consts = _consts(run)
    f = n // 128
    half = len(consts) // 2
    _check_core(kfft.bts2_consts(n, -1, 1.0), kfft.wide_consts(n, -1), consts[:half], f)
    _check_core(kfft.bts2_consts(n, +1, scale), kfft.wide_consts(n, +1), consts[half:], f)


@pytest.mark.parametrize("n,scale", [(512, 1.0 / 512), (768, 0.37), (1280, 1.0)])
def test_spectral_r2c_tables_bit_identical(n, scale):
    """The forward and inverse cores, the unpack twiddle W_n^k, and the C2R
    combine: the port's rows A[k], B[k] are twice the JAX kernel's a[k] and
    b[k] (the 1/2 of the unpack and the 2 of the half-length inverse cancel),
    which is exact in float32; the JAX kernel keeps B[-k] as c[k] and B[0]
    apart as b0."""
    run = ref_prfft._build_spectral_mid(n, 1, COLS, "float32", True, "highest", scale)
    consts = _consts(run)
    h = n // 2
    f = h // 128
    ncore = 2 * f + (2 if f not in (2, 4, 8, 16) else 0)
    fwd, (ur, ui) = consts[:ncore], consts[ncore:ncore + 2]
    inv = consts[ncore + 2:2 * ncore + 2]
    a_r, a_i, c_r, c_i, b0, mk = consts[2 * ncore + 2:]
    _check_core(kfft.bts2_consts(h, -1, 1.0), kfft.wide_consts(h, -1), fwd, f)
    _check_core(kfft.bts2_consts(h, +1, 1.0), kfft.wide_consts(h, +1), inv, f)
    tr, ti = krfft.unpack_twiddle(n)
    assert np.array_equal(tr, ur[:, 0]) and np.array_equal(ti, ui[:, 0])
    ab = krfft.c2r_unpack_consts(n, scale)
    assert np.array_equal(ab[:, 0], 2 * a_r[:, 0]) and np.array_equal(ab[:, 1], 2 * a_i[:, 0])
    k = np.arange(1, h)
    assert np.array_equal(ab[(-k) % h, 2], 2 * c_r[k, 0])
    assert np.array_equal(ab[(-k) % h, 3], 2 * c_i[k, 0])
    assert np.array_equal(ab[0, 2:], 2 * b0[:, 0])
    assert c_r[0, 0] == 0.0 and mk[0, 0] == 0.0 and np.all(mk[1:] == 1.0)


@pytest.mark.parametrize("n", [384, 1024, 1280])
@pytest.mark.parametrize("s2", [1.0, 2.0])
def test_spectral_dct_post_twiddle_bit_identical(n, s2):
    """The DCT-II post twiddle P = s2 e^{-i pi k/2n} is the JAX kernel's w
    table times s2 (a power of two here, so exact); the JAX kernel folds s2
    into its stage constants instead."""
    run = ref_pdct._build_spectral_dct_mid(n, 1, COLS, "float32", True, "highest", s2, 1.0)
    consts = _consts(run)
    wr, wi = kdct.dct2_post(n, s2)
    nc2 = next(i for i, c in enumerate(consts) if c.shape == (n, 1))
    assert np.array_equal(wr, s2 * consts[nc2][:, 0])
    assert np.array_equal(wi, s2 * consts[nc2 + 1][:, 0])
    h0 = consts[-1][:, 0]
    assert h0[0] == 0.5 and np.all(h0[1:] == 1.0)
    pr, _ = kdct.dct3_pre_npoint(n, 1.0)
    assert pr[0] == np.float32(0.5)        # the JAX kernel's h0 halving, folded in


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------


C64 = torch.complex64


@pytest.mark.parametrize("call", [
    lambda: kfft.spectral_c2c_mid(torch.zeros(512, 3, dtype=C64), torch.ones(512, 1)),
    lambda: kfft.spectral_c2c_mid(torch.zeros(1, 500, 3, dtype=C64), torch.ones(500, 1)),
    lambda: kfft.spectral_c2c_mid(torch.zeros(1, 512, 3, dtype=C64), torch.ones(511, 1)),
    lambda: kfft.spectral_c2c_mid(torch.zeros(1, 512, 3, dtype=C64), torch.ones(512, 2)),
    lambda: kfft.spectral_c2c_mid(torch.zeros(1, 512, 3, dtype=C64), torch.ones(512)),
    lambda: krfft.spectral_r2c_mid(torch.zeros(1, 512, 3), torch.ones(256, 1), None, 512),
    lambda: krfft.spectral_r2c_mid(torch.zeros(1, 512, 3), torch.ones(257, 1), None, 1024),
    lambda: krfft.spectral_r2c_mid(torch.zeros(1, 500, 3), torch.ones(251, 1), None, 500),
    lambda: krfft.spectral_r2c_mid(torch.zeros(1, 512, 3), torch.ones(257, 3),
                                   torch.ones(257, 1), 512),
    lambda: kdct.spectral_dct_mid(torch.zeros(1, 1100, 3), torch.ones(1100, 1)),
    lambda: kdct.spectral_dct_mid(torch.zeros(1, 128 * 257, 3), torch.ones(128 * 257, 1)),
    lambda: kdct.spectral_dct_mid(torch.zeros(1, 512, 3), torch.ones(1, 512)),
    lambda: kdct.spectral_dct_mid(torch.zeros(1, 512, 3, device="meta"),
                                  torch.ones(512, 1, device="meta")),
])
def test_spectral_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_spectral_wrappers_on_cpu_count_no_launch():
    before = (kfft.spectral_c2c_mid.launches, krfft.spectral_r2c_mid.launches,
              kdct.spectral_dct_mid.launches, kdct.spectral_dct_mid.npoint_launches)
    kfft.spectral_c2c_mid(torch.zeros(1, 384, 130, dtype=C64), torch.ones(384, 130))
    krfft.spectral_r2c_mid(torch.zeros(1, 768, 130), torch.ones(385, 1), torch.ones(385, 1),
                           768, 0.5)
    kdct.spectral_dct_mid(torch.zeros(1, 384, 130), torch.ones(384, 1), 2.0, 2.0)
    assert (kfft.spectral_c2c_mid.launches, krfft.spectral_r2c_mid.launches,
            kdct.spectral_dct_mid.launches, kdct.spectral_dct_mid.npoint_launches) == before


def test_real_multiplier_equals_its_complex_form():
    """A real H is the complex H with a zero imaginary plane, on every
    kernel that takes both."""
    g = _rng("real-complex")
    x = torch.from_numpy(g.standard_normal((2, 768, 130)).astype(np.float32))
    hr = torch.from_numpy(g.standard_normal((385, 130)).astype(np.float32))
    a = krfft.spectral_r2c_mid(x, hr, None, 768, 1 / 768)
    b = krfft.spectral_r2c_mid(x, hr, torch.zeros_like(hr), 768, 1 / 768)
    assert torch.equal(a, b)
    xc = torch.complex(x, x.flip(1))
    h = torch.from_numpy(g.standard_normal((768, 130)).astype(np.float32))
    a = kfft.spectral_c2c_mid(xc, h, 2 / 768)
    b = kfft.spectral_c2c_mid(xc, torch.complex(h, torch.zeros_like(h)), 2 / 768)
    assert torch.equal(a, b)


_CTYPE = {"long long": _build._LL, "int": _build._I, "float": _build._F}


def _c_entries():
    """{name: [ctypes type of each parameter]} of every extern "C" function
    declared in csrc/*.cu."""
    out = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            types = []
            for p in params:
                if "*" in p:
                    types.append(_build._P)
                else:
                    types.append(_CTYPE[p.rsplit(" ", 1)[0]])
            out[m.group(1)] = types
    return out


_ENTRIES = _c_entries()


def test_every_c_entry_point_has_a_signature():
    assert set(_ENTRIES) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_c_declaration(name):
    """Each ctypes signature names the C declaration's parameters in order:
    a pointer as c_void_p, long long as c_longlong, int as c_int, float as
    c_float (a wrong one passes a truncated pointer or a shifted argument)."""
    assert _build._SIGNATURES[name] == _ENTRIES[name]
