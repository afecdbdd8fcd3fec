"""Kernels 14 and 22 (the fused complex and real spectral pipelines along a
middle axis) on the radix column tile, on the CPU:

* a float64 numpy model of each kernel's column algorithm, step by step as
  ``csrc/spectral_c2c_radix.cu`` and ``csrc/spectral_r2c_radix.cu`` run it,
  against ``numpy.fft``: K14's forward FFT, the pass writing H X, the
  sign +1 transform and the store scale * z; K22's pairs
  z[t] = x[2t] + i x[2t + 1], the half-length FFT, the pair pass over the
  mirror pairs {k, h - k}, k <= h/2 (the unpack, H, kernel 17's inverse
  unpack with the DC and Nyquist rules) writing G, the sign +1 transform
  and the store (Re z, Im z).
  K14 at n = 384, 1024 and 16256 (127 is a prime stage), K22 at h = 256,
  640 and 20480, real and complex H, broadcast and lane-varying;
* the wrappers' plain versions (what the kernels are held against on the
  card) against the JAX package's kernels in interpret mode at the new
  lengths beside ``tests/test_torch_spectral.py``'s (K14 at n = 128 and
  2048, K22 at n = 2048 and 4096), and against the float64 model at every
  length above;
* the census: every length that ``api._spectral_route`` sends to K14 (152,
  n = 384 ... 20480) or K22 (153, n = 512 ... 40960) has a radix plan (of
  n, or of h = n/2), and the wrappers' length checks (``fft.core_f``)
  accept no n or h without one;
* the columns-a-tile rules at the main shapes and at L = 1, 3 and 130: C a
  power of two, n C or h C <= 20480, the tile's threads within the
  kernel's launch bound.

Tolerance: 1e-12 of the peak for the float64 model against numpy.fft, and
max |port - JAX| <= 5e-6 * max |JAX| in float32 (the plain versions
against the model likewise).
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import fft as ref_pfft
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL64 = 1e-12
COLS = 3
HKINDS = ["real_bcast", "complex_bcast", "real_lane", "complex_lane"]


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _mult(g, rows, kind, cols=COLS):
    """A float64 multiplier of ``kind``: (rows, 1) or (rows, cols), real or
    complex; a complex one has nonzero imaginary parts at its first and last
    rows (K22's DC and Nyquist)."""
    shape = (rows, 1 if kind.endswith("bcast") else cols)
    h = g.standard_normal(shape)
    if kind.startswith("complex"):
        h = h + 1j * g.standard_normal(shape)
        h[0] += 3j
        h[-1] -= 2j
    return h


# --------------------------------------------------------------------------
# The float64 models of the kernels' column algorithms
# --------------------------------------------------------------------------


def _fft(v, sign):
    """The length-n transform along axis 0 of sign -1 or +1, unnormalized."""
    return np.fft.fft(v, axis=0) if sign < 0 else np.fft.ifft(v, axis=0) * v.shape[0]


def k14_model(x, h, scale):
    """Kernel 14 on an (n, C) tile: X = FFT(x) (sign -1), the pass writing
    H X, the second transform (sign +1), the store scale z."""
    return scale * _fft(h * _fft(x, -1), +1)


def k22_model(x, h, scale):
    """Kernel 22 on an (n, C) real tile, n = 2h: the pairs, the half-length
    FFT, the pair pass over the mirror pairs {k, hl - k}, k <= hl/2, the
    second transform and the real store, as csrc/spectral_r2c_radix.cu."""
    n = x.shape[0]
    hl = n // 2
    z = _fft(x[0::2] + 1j * x[1::2], -1)
    k = np.arange(hl)
    tw = np.exp(-2j * np.pi * k / n)                 # W_n^k
    u = np.exp(2j * np.pi * k / n)                   # W_n^{-k}
    a, b = scale * (1 + 1j * u), scale * (1 - 1j * u)

    def unpack(k, m):       # X[k] from Z[k], Z[m], m = (hl - k) mod hl
        zk, cm = z[k], np.conj(z[m])
        return 0.5 * (zk + cm) - 0.5j * tw[k] * (zk - cm)

    g = np.empty_like(z)
    for kk in range(hl // 2 + 1):
        if kk == 0:           # X[0] and X[hl] = Re Z0 -+ Im Z0, both real
            s0 = h[0].real * (z[0].real + z[0].imag)
            sh = h[hl].real * (z[0].real - z[0].imag)
            g[0] = a[0] * s0 + b[0] * np.conj(sh)
            continue
        k2 = hl - kk
        sk = h[kk] * unpack(kk, k2)
        sm = h[k2] * unpack(k2, kk)
        g[kk] = a[kk] * sk + b[kk] * np.conj(sm)
        g[k2] = a[k2] * sm + b[k2] * np.conj(sk)
    w = _fft(g, +1)
    y = np.empty((n,) + x.shape[1:])
    y[0::2], y[1::2] = w.real, w.imag
    return y


def _numpy_c2c(x, h, scale):
    return np.fft.ifft(h * np.fft.fft(x, axis=0), axis=0) * (x.shape[0] * scale)


def _numpy_r2c(x, h, scale):
    """numpy's irfft drops the imaginary parts of the DC and Nyquist bins:
    Im S[0] := 0 and S[hl] = Re(H[hl] X[hl]) = Re H[hl] X[hl] (X[hl] real),
    the JAX kernel's rules."""
    n = x.shape[0]
    return np.fft.irfft(h * np.fft.rfft(x, axis=0), n=n, axis=0) * (n * scale)


@pytest.mark.parametrize("n", [384, 1024, 16256])
@pytest.mark.parametrize("hkind", HKINDS)
def test_k14_model_matches_numpy(n, hkind):
    g = _rng("k14", n, hkind)
    x = g.standard_normal((n, COLS)) + 1j * g.standard_normal((n, COLS))
    h = _mult(g, n, hkind)
    want = _numpy_c2c(x, h, 1.0 / n)
    assert _rel(k14_model(x, h, 1.0 / n), want) <= TOL64


@pytest.mark.parametrize("hl", [256, 640, 20480])
@pytest.mark.parametrize("hkind", HKINDS)
def test_k22_model_matches_numpy(hl, hkind):
    """The pair pass covers k = 0 (X[0] and the Nyquist X[hl] from Z[0],
    with H's imaginary parts there dropped) and k = hl/2 (its own mirror)."""
    g = _rng("k22", hl, hkind)
    n = 2 * hl
    x = g.standard_normal((n, COLS))
    h = _mult(g, hl + 1, hkind)
    want = _numpy_r2c(x, h, 0.37)
    assert _rel(k22_model(x, h, 0.37), want) <= TOL64


def test_k22_model_pair_pass_edges():
    """Perturbing H at k = 0, hl/2 and hl moves the model's output as numpy
    says: each edge of the pair pass is reached (H[0] and H[hl] through
    their real parts only)."""
    g = _rng("k22-edges")
    hl = 256
    x = g.standard_normal((2 * hl, 1))
    h = np.ones((hl + 1, 1), complex)
    for k in (0, hl // 2, hl):
        hk = h.copy()
        hk[k] = 0.5 + 2j
        got = k22_model(x, hk, 1.0)
        assert _rel(got, _numpy_r2c(x, hk, 1.0)) <= TOL64
        assert np.abs(got - k22_model(x, h, 1.0)).max() > 1e-3


# --------------------------------------------------------------------------
# The plain versions against the JAX kernels and the float64 models
# --------------------------------------------------------------------------


def _torch_h(h):
    return torch.from_numpy(h.astype(np.complex64) if np.iscomplexobj(h) else
                            h.astype(np.float32))


@pytest.mark.parametrize("n", [128, 2048])
@pytest.mark.parametrize("hkind", ["real_lane", "complex_bcast"])
def test_spectral_c2c_plain_matches_pallas(n, hkind):
    g = _rng("c2c-jax", n, hkind)
    x = (g.standard_normal((1, n, 130)) + 1j * g.standard_normal((1, n, 130))).astype(
        np.complex64)
    h = _mult(g, n, hkind, 130)
    hr, hi = h.real.astype(np.float32), np.imag(h).astype(np.float32)
    yr, yi = ref_pfft.spectral_c2c_pallas_mid(jnp.asarray(x.real), jnp.asarray(x.imag),
                                              jnp.asarray(hr), jnp.asarray(hi), 1.0 / n)
    got = kfft.spectral_c2c_mid(torch.from_numpy(x), _torch_h(h), 1.0 / n)
    assert _rel(got.numpy(), np.asarray(yr) + 1j * np.asarray(yi)) <= TOL


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("hkind", ["real_lane", "complex_bcast"])
def test_spectral_r2c_plain_matches_pallas(n, hkind):
    g = _rng("r2c-jax", n, hkind)
    x = g.standard_normal((1, n, 130)).astype(np.float32)
    h = _mult(g, n // 2 + 1, hkind, 130)
    hr, hi = h.real.astype(np.float32), np.imag(h).astype(np.float32)
    want = ref_prfft.spectral_pallas_mid(jnp.asarray(x), jnp.asarray(hr), jnp.asarray(hi), n,
                                         1.0 / n)
    got = krfft.spectral_r2c_mid(torch.from_numpy(x), torch.from_numpy(hr),
                                 torch.from_numpy(hi) if np.iscomplexobj(h) else None, n, 1.0 / n)
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("n", [384, 1024, 16256])
@pytest.mark.parametrize("hkind", HKINDS)
def test_spectral_c2c_plain_matches_model(n, hkind):
    g = _rng("c2c-model", n, hkind)
    x = (g.standard_normal((1, n, COLS)) + 1j * g.standard_normal((1, n, COLS))).astype(
        np.complex64)
    h = _mult(g, n, hkind)
    h32 = h.astype(np.complex64) if np.iscomplexobj(h) else h.astype(np.float32)
    got = kfft.spectral_c2c_mid(torch.from_numpy(x), _torch_h(h), 0.37)
    assert _rel(got.numpy()[0], k14_model(x[0].astype(complex), h32, 0.37)) <= TOL


@pytest.mark.parametrize("hl", [256, 640, 20480])
@pytest.mark.parametrize("hkind", HKINDS)
def test_spectral_r2c_plain_matches_model(hl, hkind):
    g = _rng("r2c-model", hl, hkind)
    n = 2 * hl
    x = g.standard_normal((1, n, COLS)).astype(np.float32)
    h = _mult(g, hl + 1, hkind)
    hr, hi = h.real.astype(np.float32), np.imag(h).astype(np.float32)
    got = krfft.spectral_r2c_mid(torch.from_numpy(x), torch.from_numpy(hr),
                                 torch.from_numpy(hi) if np.iscomplexobj(h) else None, n,
                                 1.0 / n)
    h32 = hr + 1j * hi.astype(np.float64) if np.iscomplexobj(h) else hr
    assert _rel(got.numpy()[0], k22_model(x[0].astype(float), h32, 1.0 / n)) <= TOL


# --------------------------------------------------------------------------
# The census and the columns-a-tile rules
# --------------------------------------------------------------------------


def _routed(kind):
    dtype = torch.complex64 if kind == "c2c" else torch.float32
    return [n for n in range(2, 40961)
            if api._spectral_route(kind, (1, n, 130), 1, dtype, "cuda") != api.COMPOSE]


def test_every_routed_length_has_a_radix_plan():
    """K14's route takes 152 lengths, n = 384 ... 20480, each 128 F with
    radix_plan(n); K22's 153, n = 512 ... 40960, each with radix_plan(n/2)."""
    k14, k22 = _routed("c2c"), _routed("r2c")
    assert (len(k14), k14[0], k14[-1]) == (152, 384, 20480)
    assert (len(k22), k22[0], k22[-1]) == (153, 512, 40960)
    assert all(n % 128 == 0 and kfft.radix_plan(n) is not None for n in k14)
    assert all(n % 256 == 0 and kfft.radix_plan(n // 2) is not None for n in k22)


def test_the_wrappers_take_no_length_without_a_radix_plan():
    """Every n (K14) and h (K22) that the wrappers' checks accept, the
    routes' lower ends included (n = 128, 256; h = 128), has a radix plan;
    the six prime F from 131 to 157 have neither."""
    taken = [n for n in range(1, kfft.GENERIC_MAX_N + 1) if kfft.core_f(n) is not None]
    assert taken[0] == 128 and all(kfft.radix_plan(n) is not None for n in taken)
    assert [f for f in range(1, 161) if kfft.core_f(128 * f) is None] == [
        131, 137, 139, 149, 151, 157]
    for n in (128, 256):
        kfft.spectral_c2c_mid(torch.zeros(1, n, 1, dtype=torch.complex64), torch.ones(n, 1))
    krfft.spectral_r2c_mid(torch.zeros(1, 256, 1), torch.ones(129, 1), None, 256)
    with pytest.raises(ValueError):
        kfft.spectral_c2c_mid(torch.zeros(1, 128 * 131, 1, dtype=torch.complex64),
                              torch.ones(128 * 131, 1))
    with pytest.raises(ValueError):
        krfft.spectral_r2c_mid(torch.zeros(1, 256 * 131, 1), torch.ones(128 * 131 + 1, 1),
                               None, 256 * 131)


def _launch_bound(elems):
    """The threads a block of the kernels may have at a tile of ``elems``
    elements (csrc/fft_radix.cuh::kRadixMaxThreads of radix_per_thread)."""
    return 256 if elems <= kfft.RADIX_WIDE_N else 512


@pytest.mark.parametrize("cols", [1, 3, 130])
def test_columns_a_tile_fit_the_kernels(cols):
    """At every routed length (and the wrappers' lower ends) over L = cols,
    B = 1 and 8, and at the main shapes: C is a power of two, n C (K14) or
    h C (K22) at most 20480, and the tile's threads within the launch
    bound; K14 takes the read-only load exactly at C <= 2, as K22 does."""
    sms = 132
    shapes14 = [(b, n, cols) for n in [128, 256] + _routed("c2c") for b in (1, 8)]
    shapes14 += [(1, 1024, 1024 * 513), (8, 1280, 8192)]
    for nb, n, L in shapes14:
        c, ldg = kfft.axis_mid_tile(n, nb, L, sms)
        assert c & (c - 1) == 0 and n * c <= kfft.RADIX_MAX_ELEMS, (n, L, c)
        assert kfft.radix_cols_threads(n, c) <= _launch_bound(n * c), (n, L, c)
        assert ldg == (c <= 2)
    shapes22 = [(b, n, cols) for n in [256] + _routed("r2c") for b in (1, 8)]
    shapes22 += [(1, 1024, 1024 * 1024), (1024, 1024, 1024), (8, 768, 16384)]
    for nb, n, L in shapes22:
        h = n // 2
        c = krfft.spectral_cols(h, nb, L, sms)
        assert c & (c - 1) == 0 and h * c <= kfft.RADIX_MAX_ELEMS, (n, L, c)
        assert kfft.radix_cols_threads(h, c) <= _launch_bound(h * c), (n, L, c)


def test_main_shapes_take_the_expected_tiles():
    """S1's (1, 1024, 525312): four columns a tile (16 elements a thread,
    256 threads); S2's (1, 1024, 1048576) and (1024, 1024, 1024): eight
    columns of h = 512 (256 threads); the formerly wide (8, 1280, 8192) and
    (8, 768, 16384): four and eight."""
    assert kfft.axis_mid_tile(1024, 1, 1024 * 513, 132) == (4, False)
    assert kfft.axis_mid_tile(1280, 8, 8192, 132) == (4, False)
    assert krfft.spectral_cols(512, 1, 1024 * 1024, 132) == 8
    assert krfft.spectral_cols(512, 1024, 1024, 132) == 8
    assert krfft.spectral_cols(384, 8, 16384, 132) == 8
    assert kfft.radix_cols_threads(1024, 4) == 256 and kfft.radix_cols_threads(512, 8) == 256


def test_wrappers_count_one_form():
    """Every launch is a radix launch: the wrappers keep ``launches`` and no
    wide counter."""
    for w in (kfft.spectral_c2c_mid, krfft.spectral_r2c_mid):
        assert w.launches >= 0 and not hasattr(w, "wide_launches")
