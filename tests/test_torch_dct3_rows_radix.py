"""Kernel 24 on the radix row core (the DCT-III of contiguous rows as the
Makhoul C2R at half length h = n/2), on the CPU, where the wrapper runs its
plain version:

* ``dct3_rows_radix_plain`` against ``dct3_pallas`` (the JAX package's
  ``_dct3_kernel`` with its interleave) in interpret mode and against
  scipy's DCT-III in float64, at n = 256, 384 (odd k), 640, 1536 and 2304,
  a few rows, with scale 1/n and unscaled;
* the public ``nddct3`` / ``nddst3`` over 128 rows at the same lengths
  against the JAX package, unnormalized and with the scalar 1/n;
* the form function at all 288 lengths of ``dct_form``: the radix row core
  at the 259 whose h has a plan, the old forms at the 29 others;
* a host-side model of the kernel's load (``csrc/dct_rows_radix.cu::
  Dct3RowLoad``: float m of a row into slot m's real half, the side slot or
  slot n - m's imaginary half), its prologue and its store
  (``Dct3RowBins``: quad p = (Re z[p], Im z[h-1-p], Im z[p], Re z[h-1-p]))
  against the plain version's Makhoul permutation and float64;
* the wrapper's CPU route.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 2e-6 of the peak against float64.
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
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
F32 = torch.float32
LENGTHS = [256, 384, 640, 1536, 2304]
# the 29 lengths n = 128 k whose half length 64 k has no radix plan
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


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("scale", ["inv_n", None])
def test_radix_plain_matches_pallas_and_float64(n, scale):
    s = 1.0 / n if scale == "inv_n" else None
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got = kdct.dct3_rows_radix_plain(torch.from_numpy(x), s)
    assert got.dtype == F32 and got.shape == (3, n)
    assert _rel(got, ref_pdct.dct3_pallas(jnp.asarray(x), s)) <= TOL
    want = sfft.dct(x.astype(np.float64), type=3, axis=1) * ((1.0 if s is None else s) / 2)
    assert _rel(got, want) <= 2e-6          # rustdct = scipy / 2


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("name", ["nddct3", "nddst3"])
@pytest.mark.parametrize("norm", ["none", "inv_n"])
def test_public_rows_match_reference(n, name, norm):
    shape = (128, n)
    for device_type in ("cpu", "cuda"):
        assert api._route(name[2:], shape, 1, F32, device_type) == api.DCT3_NAT
    rcls = ref.DctHandler if "dct" in name else ref.DstHandler
    rh = rcls(n)
    rh = rh.normalization(ref.Normalization.NONE if norm == "none"
                          else ref.Normalization.scalar(1.0 / n))
    ph = (port.DctHandler if "dct" in name else port.DstHandler).from_reference(rh)
    x = np.random.default_rng(n + 1).standard_normal(shape).astype(np.float32)
    counts = engine.c2c.calls, kdct.dct3_nat.launches, kdct.dct3_nat.radix_launches
    got = getattr(port, name)(torch.from_numpy(x), ph, axis=1)
    assert got.dtype == F32
    assert _rel(got, getattr(ref, name)(jnp.asarray(x), rh, axis=1)) <= TOL
    # a CPU tensor: the kernel's plain version, no launch, no engine
    assert (engine.c2c.calls, kdct.dct3_nat.launches, kdct.dct3_nat.radix_launches) == counts


def test_form_at_every_length():
    ns = [n for n in range(128, 128 * 321, 128) if kdct.dct_form(n) is not None]
    assert len(ns) == 288
    radix = [n for n in ns if kdct.launch_form(n, True, True) == "radix"]
    assert len(radix) == 259
    assert radix == [n for n in ns if kdct.dct2_nat_radix(n)]
    rest = sorted(set(ns) - set(radix))
    assert rest == [128 * k for k in REMNANT_K]
    assert [kdct.launch_form(n, True, True) for n in rest] == \
        ["npoint"] * 23 + ["wide"] * 6
    assert kdct.launch_form(1024, True, True) == "radix"       # the fixed core's is gone


@pytest.mark.parametrize("n", [128, 384, 1536])
def test_kernel_model_is_the_plain_version(n):
    """Dct3RowLoad's map, its prologue and Dct3RowBins' quads in float64
    numpy: slot k holds (x[k], x[n - k]) (k < h; slot 0's imaginary half is
    never read), the side slot x[h]; the prologue's S of each slot is the
    plain version's half spectrum, its G kernel 3's inverse unpack; the
    inverse FFT of G stored as quads is scipy's DCT-III (to the rounding of
    the float32 tables Q and ab)."""
    h = n // 2
    x = np.random.default_rng(n).standard_normal((2, n))
    slots = np.full((2, h, 2), np.nan)
    side = np.full(2, np.nan)
    for m in range(n):                  # the load: float m of a row, from its quad
        if m < h:
            slots[:, m, 0] = x[:, m]
        elif m == h:
            side[:] = x[:, m]
        else:
            slots[:, n - m, 1] = x[:, m]
    k = np.arange(1, h)
    np.testing.assert_array_equal(slots[:, 1:, 0], x[:, 1:h])
    np.testing.assert_array_equal(slots[:, k, 1], x[:, n - k])
    assert np.isnan(slots[:, 0, 1]).all()
    # the prologue: S from the slots (S[0] and S[h] real), then G
    qr, qi = (np.asarray(v, np.float64) for v in kdct.dct3_pre(n, 1.0))
    q = qr + 1j * qi
    spec = np.empty((2, h + 1), np.complex128)
    spec[:, :h] = q[:h] * (slots[:, :, 0] - 1j * np.nan_to_num(slots[:, :, 1]))
    spec[:, h] = q[h] * (side - 1j * side)
    spec[:, 0] = spec[:, 0].real
    spec[:, h] = spec[:, h].real
    want_spec = kdct._dct3_spec(torch.from_numpy(x.astype(np.float32))[:, :, None], 1.0)
    np.testing.assert_allclose(spec, want_spec[:, :, 0].numpy(), rtol=0, atol=1e-6)
    ab = krfft.c2r_unpack_consts(n, 1.0).astype(np.float64)
    a, b = ab[:, 0] + 1j * ab[:, 1], ab[:, 2] + 1j * ab[:, 3]
    mirror = np.concatenate([spec[:, h:h + 1], spec[:, 1:h][:, ::-1]], axis=1)  # S[h - k]
    g = a * spec[:, :h] + b * np.conj(mirror)
    z = np.fft.ifft(g, axis=1) * h                   # the inverse radix run, unnormalized
    # the store: quad p of the output row from z[p] and z[h - 1 - p]
    p = np.arange(h // 2)
    zp, zm = z[:, p], z[:, h - 1 - p]
    y = np.stack([zp.real, zm.imag, zp.imag, zm.real], axis=2).reshape(2, n)
    u = np.stack([z.real, z.imag], axis=2).reshape(2, n)
    np.testing.assert_array_equal(y, u[:, np.argsort(kdct.makhoul_perm(n))])
    assert _rel(y, sfft.dct(x, type=3, axis=1) / 2) <= 2e-7     # the float32 tables


def test_wrapper_routes_on_the_cpu():
    g = np.random.default_rng(6)
    x = torch.from_numpy(g.standard_normal((2, 768)).astype(np.float32))
    before = (kdct.dct3_nat.launches, kdct.dct3_nat.radix_launches)
    np.testing.assert_array_equal(kdct.dct3_nat(x, 0.5).numpy(),
                                  kdct.dct3_rows_radix_plain(x, 0.5).numpy())
    assert (kdct.dct3_nat.launches, kdct.dct3_nat.radix_launches) == before
    # a remnant length keeps the old plain version (the n-point form, k = 131)
    y = torch.from_numpy(g.standard_normal((1, 128 * 131)).astype(np.float32))
    np.testing.assert_array_equal(kdct.dct3_nat_plain(y).numpy(),
                                  kdct._dct3_plain(y[:, :, None], None)[:, :, 0].numpy())
    want = sfft.dct(y.double().numpy(), type=3, axis=1) / 2
    assert _rel(kdct.dct3_nat(y), want) <= 2e-6
