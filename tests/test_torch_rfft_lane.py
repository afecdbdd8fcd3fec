"""Kernel 15 (the packed R2C of rows) and the lane lowerings' pieces against
the JAX package on the CPU:

* the plain versions of ``r2c_packed`` (the core, h = 128 * F) and
  ``r2c_packed_dense`` (every other h <= 256) against
  ``ops/pallas/rfft.py::r2c_pallas`` in interpret mode, on the even/odd
  streams of the same rows, at h = 64, 100, 128, 129, 256 and 512;
* kernel 2's constants at F = 1 (h = 128) bit for bit against the JAX
  kernel's dense lane DFT and unpack twiddle;
* the engine's row pairs (odd n) against the JAX engine's ``_r2c_rowpair``,
  and its packed R2C and C2C dispatch against the JAX engine;
* the gates of ``gates.py`` against the JAX package's gate functions
  (``pallas_supported``, ``rfft_pallas_supported``, ``rfft_nat_supported``,
  and the half-length FFT that ``_half_fft_consts`` picks for kernel 15).

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier, 1e-12 in float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops import engine as ref_engine
from ndrustfft_tpu.ops.pallas import fft as ref_pfft
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch import gates
from ndrustfft_tpu_torch.ops import engine
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft
from ndrustfft_tpu_torch.plan import get_c2c_plan, get_r2c_plan

torch.set_num_threads(1)

TOL = {np.float32: 5e-6, np.float64: 1e-12}
F32, C64 = torch.float32, torch.complex64


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol=TOL[np.float32]):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _pallas_r2c(x):
    """The JAX kernel 15 on the even/odd streams of the rows of x."""
    sr, si = ref_prfft.r2c_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                  ref_plan.get_r2c_plan(x.shape[1]))
    return np.asarray(sr) + 1j * np.asarray(si)


# --------------------------------------------------------------------------
# Kernel 15's plain versions against the Pallas kernel
# --------------------------------------------------------------------------


@pytest.mark.parametrize("h,rows", [(64, 130), (100, 9), (128, 130), (129, 16), (256, 12),
                                    (512, 10)])
def test_packed_plain_matches_pallas(h, rows):
    x = _real((rows, 2 * h), h + rows)
    fn = krfft.r2c_packed if krfft.packed_core(h) else krfft.r2c_packed_dense
    got = fn(torch.from_numpy(x))                         # CPU: the plain version
    assert got.dtype == C64 and got.shape == (rows, h + 1)
    _close(got, _pallas_r2c(x))
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), 2e-6)


@pytest.mark.parametrize("h", [128, 256])
def test_dense_and_core_agree_where_both_take_h(h):
    """At the core's h <= 256 the dense product computes the same function."""
    x = torch.from_numpy(_real((7, 2 * h), h))
    _close(krfft.r2c_packed_dense(x), krfft.r2c_packed(x), 2e-6)


def test_f1_constants_bit_identical_to_the_jax_kernel():
    """Kernel 15 at h = 128 runs kernel 2's core at F = 1: its stage-2 table
    is the JAX kernel's dense lane DFT-128, and its unpack twiddle the JAX
    kernel's W_256^k, bit for bit."""
    re, im = kfft.bts2_consts(128, -1, 1.0)
    assert re.shape == (1, 128, 128)
    f, m, _, lane, _ = ref_pfft._plan_consts(128, -1, np.float32)
    assert (f, m) == (128, 1)                 # the dense lane DFT, one stage
    assert np.array_equal(re[0], lane[0]) and np.array_equal(im[0], lane[1])
    ur, ui = krfft.unpack_twiddle(256)
    wr, wi = ref_plan._cis(2 * np.arange(128, dtype=np.int64), 256, -1)
    assert np.array_equal(ur, np.asarray(wr, np.float32))
    assert np.array_equal(ui, np.asarray(wi, np.float32))


@pytest.mark.parametrize("fn,n", [(krfft.r2c_packed, 384), (krfft.r2c_packed, 257),
                                  (krfft.r2c_packed_dense, 514),
                                  (krfft.r2c_packed_dense, 129)])
def test_packed_wrappers_reject_lengths_they_do_not_take(fn, n):
    with pytest.raises(ValueError, match=f"n={n}"):
        fn(torch.zeros(3, n))
    with pytest.raises(TypeError):
        fn(torch.zeros(3, 256, dtype=torch.float64))


def test_packed_wrappers_count_only_kernel_launches():
    before = krfft.r2c_packed.launches, krfft.r2c_packed_dense.launches
    krfft.r2c_packed(torch.zeros(3, 256))
    krfft.r2c_packed_dense(torch.zeros(3, 128))
    assert (krfft.r2c_packed.launches, krfft.r2c_packed_dense.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        krfft.r2c_packed(torch.zeros(3, 256, device="meta"))


# --------------------------------------------------------------------------
# The engine's lane lowerings against the JAX engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rows,n", [(130, 129), (7, 201), (2, 9), (129, 64 + 1)])
def test_rowpair_matches_jax(rows, n, dtype):
    x = _real((rows, n), rows + n, dtype)
    sr, si = ref_engine._r2c_rowpair(jnp.asarray(x), ref_plan.get_r2c_plan(n))
    got = engine._r2c_rowpair(torch.from_numpy(x), get_r2c_plan(n))
    assert got.shape == (rows, n // 2 + 1)
    _close(got, np.asarray(sr) + 1j * np.asarray(si), TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(130, 256), (2, 65, 200), (130, 130), (5, 64)])
def test_packed_r2c_matches_jax(shape, dtype):
    """engine.r2c_packed takes natural rows; the JAX engine's the streams."""
    x = _real(shape, sum(shape), dtype)
    n = shape[-1]
    sr, si = ref_engine.r2c_packed(jnp.asarray(x[..., 0::2]), jnp.asarray(x[..., 1::2]),
                                   ref_plan.get_r2c_plan(n))
    got = engine.r2c_packed(torch.from_numpy(x), get_r2c_plan(n))
    _close(got, np.asarray(sr) + 1j * np.asarray(si), TOL[dtype])


@pytest.mark.parametrize("shape,sign,scale", [((130, 256), -1, None), ((3, 50, 128), +1, 0.5),
                                              ((129, 1024), +1, 1 / 1024),
                                              ((5, 200), -1, None)])
def test_c2c_dispatch_matches_jax(shape, sign, scale):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    n = shape[-1]
    yr, yi = ref_engine.c2c(jnp.asarray(x.real), jnp.asarray(x.imag),
                            ref_plan.get_c2c_plan(n, sign), scale)
    before = engine.c2c.calls
    got = engine.c2c(torch.from_numpy(x), get_c2c_plan(n, sign), scale)
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))
    rows = x.size // n
    # the engine runs only where the JAX engine runs XLA (rows < 128); K10
    # takes n = 1024, K8 the others
    assert engine.c2c.calls - before == (0 if rows >= 128 else 1)
    want = gates.ENGINE if rows < 128 else \
        gates.C2C_ROWS if n == 1024 else gates.C2C_DENSE_ROWS
    assert gates.lane_c2c_route(n, rows) == want


# --------------------------------------------------------------------------
# The gates against the JAX package's
# --------------------------------------------------------------------------


def test_gates_match_the_jax_package():
    f32 = jnp.float32
    for n in list(range(2, 1300)) + [2048, 2050, 4096, 8192, 20480, 20482, 32768]:
        if ref_plan.factorize(n) is None:
            continue
        assert gates._kernel_ok(n) == ref_pfft.pallas_supported(
            ref_plan.get_c2c_plan(n, -1), f32), n
        if n % 2 == 0 and ref_plan.factorize(n // 2) is not None:
            plan = ref_plan.get_r2c_plan(n)
            assert gates._kernel_ok(n // 2) == ref_prfft.rfft_pallas_supported(plan, f32), n
            assert (gates._nat_f(n) is not None) == ref_prfft.rfft_nat_supported(plan, f32), n


@pytest.mark.parametrize("h", list(range(2, 300, 7)) + [128, 256, 257, 264, 300, 384,
                                                         512, 640, 1024, 2048, 4096])
def test_packed_route_follows_the_jax_half_fft(h):
    """Kernel 15's three half-length FFTs (rfft._half_fft_consts): the dense
    lane DFT (generic schedule with one stage) for h <= 256, the twostep core
    for h > 256 with a split, the generic schedule otherwise; the port takes
    all three, the core at every factor (fixed or wide)."""
    if not gates._kernel_ok(h):
        return
    _, meta = ref_prfft._half_fft_consts(h, -1, jnp.float32, "highest")
    route = gates.packed_lane(h, gates.MIN_BATCH)
    if meta[0] == "ts":
        assert route == gates.R2C_PACKED, h
        assert krfft.packed_core(h) and meta[2] == h // kfft.M, h
    else:
        dense = meta[4] == 1                   # m == 1: one lane DFT of length h
        assert dense == (h <= krfft.PACKED_DENSE_MAX_H), h
        assert route == gates.R2C_PACKED, h
