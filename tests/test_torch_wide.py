"""The lengths n = 128 * F with F outside the bts2 fixed core's factors,
which its wide core took (kernel 1 at those F now runs the mixed-radix
column tile, kernels 10, 2/15 and 3 its row core), against the JAX package
on the CPU:

* the plain versions of ``c2c_rows``, ``c2c_axis_mid``, ``r2c_nat``,
  ``c2r_nat`` and ``r2c_packed`` against ``c2c_pallas``,
  ``c2c_pallas_axis_mid``, ``r2c_pallas_nat``, ``c2r_pallas_nat`` and
  ``r2c_pallas`` in interpret mode (their bts2 bodies with the dense DFT-F
  stage 1 of ``_combine_f``), at F = 3, 5, 6, 9, 18, 32, 127 and 160;
* ``wide_consts`` and ``bts2_consts`` bit for bit against ``_bts2_consts``
  (its Wf and Wq), C-contiguous;
* the wrappers' checks, launch counters, tile sizes and the Wq cache;
* the routes: over n = 2 ... 20480 no C2C, R2C, C2R, DCT-I, DCT-II or
  DCT-III raises K1b, and no DCT-II/III raises K25/K26.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| at the JAX package's
"highest" tier, where each side measures ~5e-7 against a float64 oracle.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_pfft
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch import api
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


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _split(y):
    return np.asarray(y[0]) + 1j * np.asarray(y[1])


_SIGN_SCALE = [(-1, None), (+1, "inv_n")]


@pytest.mark.parametrize("t,n", [(128, 384), (130, 1152), (128, 4096), (128, 20480)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_rows_plain_matches_pallas_twostep(t, n, sign, scale):
    """Kernel 10 at F = 3, 9, 32 and 160 (n = 20480, the gate's largest)."""
    assert kfft.core_f(n) not in kfft.C2C_F
    x = _cplx((t, n), t + n + sign)
    s = 1.0 / n if scale else None
    got = kfft.c2c_rows(torch.from_numpy(x), sign, s)        # CPU: the plain version
    assert got.dtype == C64 and got.shape == (t, n)
    want = _split(ref_pfft.c2c_pallas(jnp.asarray(x.real), jnp.asarray(x.imag),
                                      ref_plan.get_c2c_plan(n, sign), s))
    _close(got, want)


@pytest.mark.parametrize("shape,sign,scale", [((1, 768, 130), -1, None),
                                              ((1, 768, 130), +1, "inv_n"),
                                              ((2, 640, 129), -1, None),
                                              ((2, 640, 129), +1, "inv_n"),
                                              ((1, 16256, 128), -1, None)])
def test_mid_plain_matches_pallas_bts2(shape, sign, scale):
    """Kernel 1 at F = 6, 5 and the prime 127 (its radix plan's last stage is
    the prime 127) against the JAX package's bts2 body."""
    assert ref_pfft.mid_kernel_kind(shape[1]) == "bts2"
    x = _cplx(shape, sum(shape) + sign)
    s = 1.0 / shape[1] if scale else None
    got = kfft.c2c_axis_mid(torch.from_numpy(x), sign, s)
    assert got.dtype == C64 and got.shape == shape
    want = _split(ref_pfft.c2c_pallas_axis_mid(jnp.asarray(x.real), jnp.asarray(x.imag),
                                               ref_plan.get_c2c_plan(shape[1], sign), s))
    _close(got, want)


@pytest.mark.parametrize("n", [768, 2304])
def test_r2c_nat_plain_matches_pallas(n):
    """Kernel 2 at h = 384 (F = 3) and 1152 (F = 9)."""
    x = np.random.default_rng(n).standard_normal((130, n)).astype(np.float32)
    got = krfft.r2c_nat(torch.from_numpy(x))
    assert got.dtype == C64 and got.shape == (130, n // 2 + 1)
    _close(got, _split(ref_prfft.r2c_pallas_nat(jnp.asarray(x), ref_plan.get_r2c_plan(n))))


@pytest.mark.parametrize("n", [768, 2304])
@pytest.mark.parametrize("scale", [None, "inv_n"])
def test_c2r_nat_plain_matches_pallas(n, scale):
    spec = _cplx((130, n // 2 + 1), n + 1)
    spec[:, 0] += 100j         # DC and Nyquist imaginary parts that must be ignored
    spec[:, -1] += 100j
    s = 1.0 / n if scale else None
    got = krfft.c2r_nat(torch.from_numpy(spec), n, s)
    assert got.dtype == F32 and got.shape == (130, n)
    want = ref_prfft.c2r_pallas_nat(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, s)
    _close(got, want)


def test_packed_plain_matches_pallas_r2c():
    """Kernel 15 at h = 384: the JAX kernel's twostep half-length FFT at
    F = 3, the port's kernel 2 code on the radix row core."""
    n = 768
    _, meta = ref_prfft._half_fft_consts(n // 2, -1, jnp.float32, "highest")
    assert meta[0] == "ts" and meta[2] == 3
    x = np.random.default_rng(7).standard_normal((130, n)).astype(np.float32)
    got = krfft.r2c_packed(torch.from_numpy(x))
    want = _split(ref_prfft.r2c_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                       ref_plan.get_r2c_plan(n)))
    _close(got, want)
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), 2e-6)


@pytest.mark.parametrize("n,sign,scale", [(384, -1, 1.0), (640, +1, 1 / 640),
                                          (768, -1, 1.0), (4096, +1, 0.25),
                                          (16256, -1, 1.0), (20480, +1, 1 / 20480)])
def test_consts_bit_identical_to_bts2_consts(n, sign, scale):
    wr, wi = kfft.wide_consts(n, sign)
    qr, qi = kfft.bts2_consts(n, sign, scale)
    f = n // 128
    assert wr.shape == (f, f) and qr.shape == (f, 128, 128)
    for a in (wr, wi, qr, qi):
        assert a.dtype == np.float32 and a.flags["C_CONTIGUOUS"]
    consts, (m, f_ref) = ref_pfft._bts2_consts(n, sign, np.float32, "highest", scale)
    assert (m, f_ref) == (128, f) and len(consts) == 2 * f + 2    # Wq per q, then Wf
    assert np.array_equal(wr, consts[2 * f]) and np.array_equal(wi, consts[2 * f + 1])
    for q in range(f):
        assert np.array_equal(qr[q], consts[2 * q]) and np.array_equal(qi[q], consts[2 * q + 1])
    # the kernel reads row 1: W_F^{a q} is W_F^{(a q) mod F} bit for bit
    a, q = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
    assert np.array_equal(wr, wr[1][(a * q) % f]) and np.array_equal(wi, wi[1][(a * q) % f])


@pytest.mark.parametrize("call", [
    lambda: kfft.c2c_rows(torch.zeros(3, 200, dtype=C64), -1),                # not 128 * F
    lambda: kfft.c2c_rows(torch.zeros(3, 131 * 128, dtype=C64), -1),          # no plan
    lambda: kfft.c2c_rows(torch.zeros(3, 161 * 128, dtype=C64), -1),          # n > 20480
    lambda: kfft.c2c_axis_mid(torch.zeros(1, 131 * 128, 3, dtype=C64), -1),
    lambda: kfft.c2c_axis_mid(torch.zeros(1, 161 * 128, 3, dtype=C64), -1),
    lambda: krfft.r2c_nat(torch.zeros(2, 2 * 131 * 128)),
    lambda: krfft.r2c_nat(torch.zeros(2, 2 * 161 * 128)),
    lambda: krfft.c2r_nat(torch.zeros(2, 131 * 128 + 1, dtype=C64), 2 * 131 * 128),
    lambda: krfft.c2r_nat(torch.zeros(2, 193, dtype=C64), 384),               # h = 192
    lambda: krfft.r2c_packed(torch.zeros(3, 2 * 131 * 128)),
    lambda: kfft.c2c_rows(torch.zeros(3, 384, dtype=C64, device="meta"), -1),
    lambda: kfft.c2c_axis_mid(torch.zeros(1, 384, 3, dtype=C64, device="meta"), -1),
    lambda: krfft.r2c_nat(torch.zeros(2, 768, device="meta")),
    lambda: krfft.c2r_nat(torch.zeros(2, 385, dtype=C64, device="meta"), 768),
])
def test_wide_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_wide_wrappers_on_cpu_count_no_launch():
    radix = (kfft.c2c_axis_mid, kfft.c2c_rows, krfft.r2c_nat, krfft.c2r_nat,
             krfft.r2c_packed)   # kernels 1, 10, 2, 3, 15
    rows = [(f.launches, f.radix_launches) for f in radix]
    kfft.c2c_axis_mid(torch.zeros(1, 384, 3, dtype=C64), -1)
    kfft.c2c_rows(torch.zeros(3, 640, dtype=C64), +1, 0.5)
    krfft.r2c_nat(torch.zeros(2, 768))
    krfft.c2r_nat(torch.zeros(2, 385, dtype=C64), 768)
    krfft.r2c_packed(torch.zeros(2, 768))
    assert [(f.launches, f.radix_launches) for f in radix] == rows


def test_wide_block_sizes():
    # the 768^3 step: 8 columns of 768 (80 KB with the scratch) per tile
    assert kfft.wide_block(768, 768, 385, 132) == 8
    assert kfft.wide_block(768, 1, 295680, 132) == 8
    assert kfft.wide_block(384, 1, 589824, 132) == 8           # K2/K3 at h = 384
    # n = 4096: two transforms per tile; halved while the grid leaves SMs idle
    assert kfft.wide_block(4096, 1, 4096, 132) == 2
    assert kfft.wide_block(4096, 1, 33, 132) == 1
    # one transform per tile beyond 96 KB (n = 20480: 169 KB)
    assert kfft.wide_block(20480, 1, 128, 132) == 1
    assert kfft.wide_bytes(20480, 1) <= kfft.MAX_SMEM
    assert kfft.wide_bytes(768, 8) <= kfft.GENERIC_SMEM < kfft.wide_bytes(768, 16)


def test_wq_cache_holds_at_most_its_bytes(monkeypatch):
    monkeypatch.setattr(kfft, "_WQ_CACHE", OrderedDict())
    monkeypatch.setattr(kfft, "WQ_CACHE_BYTES", 5 << 19)          # 2.5 tables of 1 MB
    cpu = torch.device("cpu")
    first = kfft.device_wq(1024, -1, 1.0, cpu)
    assert kfft.device_wq(1024, -1, 1.0, cpu) is first           # a hit
    kfft.device_wq(1024, +1, 1.0, cpu)
    kfft.device_wq(1024, -1, 0.5, cpu)                            # evicts the first
    assert list(kfft._WQ_CACHE) == [(1024, +1, 1.0, cpu), (1024, -1, 0.5, cpu)]
    big = kfft.device_wq(4096, -1, 1.0, cpu)                      # 4 MB: kept alone
    assert list(kfft._WQ_CACHE.values()) == [big]
    assert torch.equal(kfft.device_wq(1024, -1, 1.0, cpu), first)  # rebuilt the same


def _raise_item(kind, shape, axis, dtype, n=None):
    """The route on a CUDA tensor (no route raises any more)."""
    return api._route(kind, shape, axis, dtype, "cuda", n=n)


def test_no_c2c_rfft_lane_or_dct1_length_raises_k1b():
    """Over n = 2 ... 20480 on (128, n) rows and along the middle axis of
    (4, n, 128): no C2C, R2C, C2R, DCT-I, DCT-II or DCT-III raises K1b (the
    wide core takes every n = 128 * F the JAX gates reach, K16/K17 and
    K23/K24 included), and no DCT-II/III raises K25/K26; the middle-axis R2C
    takes K16 at every natural-layout half length, and DCT-II takes K23 (rows)
    and K25 (middle axis) exactly where dct_pallas_supported's split holds."""
    wide = {"k16": 0, "k23": 0, "k25": 0, "c2c_wide": 0}
    for n in range(2, 20481):
        for shape, axis in (((128, n), 1), ((4, n, 128), 1)):
            assert _raise_item("fft", shape, axis, C64) != "K1b", n
            assert _raise_item("r2c", shape, axis, F32) != "K1b", n
            assert _raise_item("c2r", shape[:axis] + (n // 2 + 1,) + shape[axis + 1:], axis,
                               C64, n) != "K1b", n
            for kind in ("dct1", "dct2", "dct3", "dst2", "dst3"):
                assert _raise_item(kind, shape, axis, F32) not in ("K1b", "K25", "K26"), n
        k16 = api._nat_f(n) is not None
        assert (_raise_item("r2c", (4, n, 128), 1, F32) == api.R2C_MID) == k16, n
        k23 = n % 2 == 0 and api._ts_ok(n)
        assert (_raise_item("dct2", (128, n), 1, F32) == api.DCT2_NAT) == k23, n
        assert (_raise_item("dct2", (4, n, 128), 1, F32) == api.DCT2_MID) == (k23 and n > 1100), n
        wide["k16"] += k16 and api._nat_f(n) not in kfft.CORE_F
        wide["k23"] += k23 and not (n % 256 == 0 and n // 256 in (1, 2, 4, 8, 16))
        wide["k25"] += k23 and n > 1100
        wide["c2c_wide"] += kfft.core_f(n) not in (None, 4, 8, 16) and n > 256
    assert wide == {"k16": 75, "k23": 155, "k25": 152, "c2c_wide": 149}
