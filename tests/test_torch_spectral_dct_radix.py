"""Kernel 29 on the radix column tile (the fused cosine-basis pipeline
s3 * DCT-III(H * s2 * DCT-II(x)) along a middle axis as kernel 25's Makhoul
R2C, the pair pass and kernel 26's Makhoul C2R on one tile), on the CPU,
where the wrapper runs its plain version:

* ``spectral_dct_mid`` (its plain version, the two radix forms' arithmetic
  ``dct_radix_plain(dct_radix_plain(x, 2, s2) * H, 3, s3)``) against
  ``spectral_dct_pallas_mid`` (the JAX package's
  ``_spectral_dct_kernel_mid``) in interpret mode along axis 1 of
  (2, n, 16) at n = 256, 384 (odd k), 1152 (odd k) and 2048, with a (n, 1)
  and a (n, 16) H and two (s2, s3) pairs;
* the public ``ndspectral_dct`` / ``ndspectral_dst`` along axis 0 of
  (n, 128) against the JAX package;
* a float64 numpy model of the kernel's algorithm (the Makhoul pairs, the
  forward FFT of h, the pair pass in place over the mirror pairs
  {k, h - k}, the inverse as conj(FFT(conj G)) or as the sign +1 FFT, the
  interleave) against scipy's DCTs;
* a remnant length, k = 131 (n = 16768, L = 1; no radix plan of 64 k: the
  n-point form), against float64;
* the form at all 288 lengths of ``dct_form``, the column count
  ``rfft.spectral_cols`` at the main shapes and the wrapper's CPU route.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 2e-6 of the peak against float64; 1e-12 for the
float64 model.
"""

import numpy as np
import pytest
import scipy.fft as sfft
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.api import _jitted
from ndrustfft_tpu.ops.pallas import dct as ref_pdct

import ndrustfft_tpu_torch as port
from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops import engine
from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
F32 = torch.float32
COLS = 16
REMNANT_K = (131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211,
             223, 227, 229, 233, 239, 241, 251, 262, 274, 278, 298, 302, 314)


@pytest.fixture(scope="module", autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    _jitted.cache_clear()
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old
    _jitted.cache_clear()


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _oracle(x, hv, s2, s3):
    """s3 * DCT-III(H * s2 * DCT-II(x)) along axis 0 in float64, the rustdct
    convention (scipy's unnormalized DCT / 2)."""
    a2 = 1.0 if s2 is None else s2
    a3 = 1.0 if s3 is None else s3
    y = sfft.dct(x.astype(np.float64), type=2, axis=0) * (a2 / 2)
    return sfft.dct(y * hv, type=3, axis=0) * (a3 / 2)


@pytest.mark.parametrize("n", [256, 384, 1152, 2048])
@pytest.mark.parametrize("hcols", [1, COLS])
@pytest.mark.parametrize("s2,s3", [(2.0, "1/2n"), (None, 0.37)])
def test_radix_plain_matches_pallas(n, hcols, s2, s3):
    s3 = 1.0 / (2 * n) if s3 == "1/2n" else s3
    assert kdct.launch_form(n, False, False) == "radix"
    g = np.random.default_rng(n + hcols)
    x = g.standard_normal((2, n, COLS)).astype(np.float32)
    hv = g.standard_normal((n, hcols)).astype(np.float32)
    got = kdct.spectral_dct_mid(torch.from_numpy(x), torch.from_numpy(hv), s2, s3)
    assert got.dtype == F32 and got.shape == (2, n, COLS)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        got.numpy(),
        kdct.dct_radix_plain(kdct.dct_radix_plain(xt, 2, s2) * torch.from_numpy(hv), 3,
                             s3).numpy())
    assert _rel(got, ref_pdct.spectral_dct_pallas_mid(jnp.asarray(x), jnp.asarray(hv), s2,
                                                      s3)) <= TOL
    want = np.stack([_oracle(x[b], hv, s2, s3) for b in range(2)])
    assert _rel(got, want) <= 2e-6


@pytest.mark.parametrize("n", [384, 1152])
@pytest.mark.parametrize("name", ["ndspectral_dct", "ndspectral_dst"])
def test_public_spectral_matches_reference(n, name):
    shape = (n, 128)
    for device_type in ("cpu", "cuda"):
        assert api._spectral_route("dct", shape, 0, F32, device_type) == api.SPECTRAL_DCT_MID
    g = np.random.default_rng(n + len(name))
    x = g.standard_normal(shape).astype(np.float32)
    hv = g.standard_normal(shape).astype(np.float32)
    cls = "DctHandler" if name.endswith("dct") else "DstHandler"
    rh = getattr(ref, cls)(n)
    rhi = rh.normalization(ref.Normalization.scalar(1.0 / (2 * n)))
    ph, phi = (getattr(port, cls).from_reference(h) for h in (rh, rhi))
    counts = (engine.c2c.calls, kdct.spectral_dct_mid.launches,
              kdct.spectral_dct_mid.radix_launches)
    got = getattr(port, name)(torch.from_numpy(x), torch.from_numpy(hv), ph, phi, axis=0)
    assert got.dtype == F32
    want = getattr(ref, name)(jnp.asarray(x), jnp.asarray(hv), rh, rhi, axis=0)
    assert _rel(got, want) <= TOL
    # a CPU tensor: the kernel's plain version, no launch, no engine
    assert (engine.c2c.calls, kdct.spectral_dct_mid.launches,
            kdct.spectral_dct_mid.radix_launches) == counts


def _kernel_model(x, hv, s2, s3, conj):
    """The kernel's algorithm in float64 on the columns of x (n, L), H (n, 1)
    or (n, L): the Makhoul pairs z, Z = FFT_h(z), the pair pass in place (one
    mirror pair {k, h - k} at a time, both read before either is written,
    spectral.cuh::spectral_dct_pair), the inverse of h as conj(FFT(conj G))
    (``conj``) or the sign +1 FFT, and the interleave."""
    n = x.shape[0]
    h = n // 2
    v = x[kdct.makhoul_perm(n)]
    s = np.fft.fft(v[0::2] + 1j * v[1::2], axis=0)            # the tile: Z
    kk = np.arange(n)
    tw = np.exp(-2j * np.pi * np.arange(h) / n)                 # W_n^k
    post = s2 * np.exp(-1j * np.pi * kk / (2 * n))              # P
    pre = (s3 / 2) * np.exp(1j * np.pi * np.arange(h + 1) / (2 * n))   # Q
    u = np.exp(2j * np.pi * np.arange(h) / n)                   # W_n^-k
    a, b = 1 + 1j * u, 1 - 1j * u                               # the ab rows

    def spec(j, wa, wb):             # S[j] = Q[j] (w[j] - i w[n - j])
        return pre[j] * (wa - 1j * wb)

    def spec_of(j, vv):              # w[j] = H[j] Re(P[j] V), w[n-j] = H[n-j] Re(P[n-j] conj V)
        return spec(j, hv[j] * (post[j] * vv).real, hv[n - j] * (post[n - j] * vv.conj()).real)

    def unpack(za, zm, w):           # the R2C unpack of Z[k], Z[h - k]
        return 0.5 * (za + zm.conj()) - 0.5j * w * (za - zm.conj())

    for k in range(h // 2 + 1):
        k2 = (h - k) % h
        za, zm = s[k].copy(), s[k2].copy()
        if k == 0:
            s0 = spec(0, hv[0] * post[0].real * (za.real + za.imag), 0.0).real
            wh = hv[h] * post[h].real * (za.real - za.imag)
            sh = spec(h, wh, wh).real
            g = [(0, a[0] * s0 + b[0] * sh)]
        else:
            sk = spec_of(k, unpack(za, zm, tw[k]))
            sm = sk if k2 == k else spec_of(k2, unpack(zm, za, tw[k2]))
            g = [(k, a[k] * sk + b[k] * sm.conj())]
            if k2 != k:
                g.append((k2, a[k2] * sm + b[k2] * sk.conj()))
        for j, gj in g:
            s[j] = gj.conj() if conj else gj
    z = np.fft.fft(s, axis=0).conj() if conj else np.fft.ifft(s, axis=0) * h
    uu = np.stack([z.real, z.imag], axis=1).reshape(n, -1)      # u[2l], u[2l + 1]
    y = np.empty_like(uu)
    y[0::2] = uu[:h]                                            # y[2t] = u[t]
    y[1::2] = uu[::-1][:h]                                      # y[2t + 1] = u[n - 1 - t]
    return y


@pytest.mark.parametrize("n", [128, 384, 1152])
@pytest.mark.parametrize("conj", [True, False])
def test_kernel_model_matches_float64(n, conj):
    """The pair pass in place: the kernel's order of reads and writes over
    the mirror pairs (k = 0 with the DC and Nyquist residues, k = h/2 alone
    at even h), with either inverse, gives the composition exactly."""
    g = np.random.default_rng(n + conj)
    x = g.standard_normal((n, 5))
    for hv in (g.standard_normal((n, 1)), g.standard_normal((n, 5))):
        got = _kernel_model(x, hv, 2.0, 1.0 / n, conj)
        assert _rel(got, _oracle(x, hv, 2.0, 1.0 / n)) <= 1e-12


def test_remnant_length_matches_float64():
    n = 128 * 131
    assert kdct.launch_form(n, False, False) == "npoint"
    g = np.random.default_rng(131)
    x = g.standard_normal((1, n, 1)).astype(np.float32)
    hv = (1.0 + g.random((n, 1))).astype(np.float32)
    got = kdct.spectral_dct_mid(torch.from_numpy(x), torch.from_numpy(hv), 2.0, 1.0 / (2 * n))
    assert _rel(got, _oracle(x[0], hv, 2.0, 1.0 / (2 * n))[None]) <= 2e-6


def test_form_at_every_length():
    """Kernel 29 takes the 288 lengths of ``dct_form``: the radix column
    tile at the 259 lengths of kernels 25 and 26 (the fixed core's among
    them), the wide core and the n-point form at the 29 others; the public
    route fuses where the JAX gate does, k <= 256."""
    ns = [n for n in range(128, 128 * 321, 128) if kdct.dct_form(n) is not None]
    assert len(ns) == 288
    fused = [n for n in ns
             if api._spectral_route("dct", (n, 128), 0, F32, "cuda") == api.SPECTRAL_DCT_MID]
    assert fused == [n for n in ns if n <= 128 * 256]
    radix = [n for n in ns if kdct.dct2_nat_radix(n)]
    assert len(radix) == 259
    assert [n for n in ns if n not in radix] == [128 * k for k in REMNANT_K]
    assert all(256 * f in radix for f in kfft.CORE_F)


def test_column_counts_at_the_main_shapes():
    """rfft.spectral_cols at the shapes the main paths give kernel 29 on an
    H100 (132 SMs), the fastest counts of time_kernels.py --scan-dct-mid
    (8 and 16 tie at (1, 2048, 4096)): each a power of two whose tile fits
    a block; 8 columns from h = 640 on, the 16-element form below."""
    for (nb, n, cols), c in (((1, 1024, 1024 * 1024), 8), ((1, 2048, 4096), 8),
                             ((8, 1280, 8192), 8), ((1, 1152, 1152), 4),
                             ((1, 31104, 31104), 1)):
        h = n // 2
        got = krfft.spectral_cols(h, nb, cols, 132)
        assert got == c, (n, got)
        assert h * got <= kfft.RADIX_MAX_ELEMS
        assert kfft.radix_cols_threads(h, got) <= 2 * kfft.RADIX_MAX_THREADS


def test_wrapper_routes_on_the_cpu():
    g = np.random.default_rng(9)
    x = torch.from_numpy(g.standard_normal((1, 1536, 4)).astype(np.float32))
    hv = torch.from_numpy(g.standard_normal((1536, 1)).astype(np.float32))
    before = (kdct.spectral_dct_mid.launches, kdct.spectral_dct_mid.radix_launches)
    np.testing.assert_array_equal(
        kdct.spectral_dct_mid(x, hv, 2.0, 0.5).numpy(),
        kdct.dct_radix_plain(kdct.dct_radix_plain(x, 2, 2.0) * hv, 3, 0.5).numpy())
    assert (kdct.spectral_dct_mid.launches, kdct.spectral_dct_mid.radix_launches) == before
    # a remnant length keeps the bts2 forms' plain arithmetic (the n-point form, k = 131)
    y = torch.from_numpy(g.standard_normal((1, 128 * 131, 2)).astype(np.float32))
    hy = torch.ones(128 * 131, 1)
    np.testing.assert_array_equal(kdct.spectral_dct_mid_plain(y, hy).numpy(),
                                  kdct._dct3_plain(kdct._dct2_plain(y, None) * hy, None).numpy())
