"""Plain versions of the C2C kernels 10, 8 and 4 against the JAX package's
Pallas kernels (interpret mode); their constants and the wrappers' checks.

* kernel 10 (``c2c_rows``, the mixed-radix row core's plain version)
  against ``c2c_pallas``'s twostep kernel at n = 512, 1024, 2048;
* kernel 8 (``c2c_dense_rows``, the mixed-radix row core's plain version)
  against ``c2c_pallas``'s lane-last kernel at n <= 256 (its dense lane
  DFT), and against float64 numpy at n = 2, 3, 15, 16, 17, 129, 254, 256;
* kernel 4 (``c2c_dense_mid``) against ``c2c_pallas_axis_mid``'s dense body.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| at the JAX package's
"highest" dot tier, where each side measures ~1e-6 against a float64 oracle;
3e-5 at the default "high" (bf16x3) tier, which measures ~5e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_fft

from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL_HIGHEST = 5e-6
TOL_HIGH = 3e-5


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _close(got, want, tol):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _ref_rows(x, sign, scale):
    yr, yi = ref_fft.c2c_pallas(jnp.asarray(x.real), jnp.asarray(x.imag),
                                ref_plan.get_c2c_plan(x.shape[1], sign), scale)
    return np.asarray(yr) + 1j * np.asarray(yi)


def _ref_mid(x, sign, scale):
    yr, yi = ref_fft.c2c_pallas_axis_mid(
        jnp.asarray(x.real), jnp.asarray(x.imag),
        ref_plan.get_c2c_plan(x.shape[1], sign), scale)
    return np.asarray(yr) + 1j * np.asarray(yi)


_SIGN_SCALE = [(-1, None), (+1, "inv_n"), (-1, "inv_n")]


@pytest.mark.parametrize("t,n", [(130, 512), (128, 1024), (129, 2048)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_c2c_rows_plain_matches_pallas_twostep(t, n, sign, scale):
    rng = np.random.default_rng(t + n + sign)
    x = _cplx(rng, (t, n))
    s = 1.0 / n if scale else None
    got = kfft.c2c_rows(torch.from_numpy(x), sign, s)     # CPU: plain version
    assert got.dtype == torch.complex64 and got.shape == (t, n)
    _close(got.numpy(), _ref_rows(x, sign, s), TOL_HIGHEST)


@pytest.mark.parametrize("t,n", [(130, 128), (128, 200), (131, 256), (128, 2)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_c2c_dense_rows_plain_matches_pallas_lane_last(t, n, sign, scale):
    rng = np.random.default_rng(t * n - sign)
    x = _cplx(rng, (t, n))
    s = 1.0 / n if scale else None
    got = kfft.c2c_dense_rows(torch.from_numpy(x), sign, s)
    assert got.dtype == torch.complex64 and got.shape == (t, n)
    _close(got.numpy(), _ref_rows(x, sign, s), TOL_HIGHEST)


@pytest.mark.parametrize("n", [2, 3, 15, 16, 17, 129, 254, 256])
def test_c2c_dense_rows_plain_matches_float64_oracle(n):
    """Kernel 8's plain version at n <= 256, where a thread of the kernel
    holds one row of n < 16 in its 16 slots: single-stage plans (2, 3, 16,
    17), a prime 127 stage (254) and two stages of 16 (256); forward
    unscaled, inverse with 1/n (a round trip)."""
    rng = np.random.default_rng(n)
    x = _cplx(rng, (7, n))
    assert kfft.radix_plan(n) is not None
    y = kfft.c2c_dense_rows(torch.from_numpy(x), -1)
    _close(y.numpy(), np.fft.fft(x.astype(np.complex128), axis=1), 2e-6)
    _close(kfft.c2c_dense_rows(y, +1, 1.0 / n).numpy(), x, 2e-6)


@pytest.mark.parametrize("shape", [(1, 128, 130), (2, 200, 257), (1, 264, 130),
                                   (1, 264, 257), (3, 128, 257)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_c2c_dense_mid_plain_matches_pallas(shape, sign, scale):
    rng = np.random.default_rng(sum(shape) + sign)
    x = _cplx(rng, shape)
    s = 1.0 / shape[1] if scale else None
    got = kfft.c2c_dense_mid(torch.from_numpy(x), sign, s)
    assert got.dtype == torch.complex64 and got.shape == shape
    _close(got.numpy(), _ref_mid(x, sign, s), TOL_HIGHEST)


@pytest.mark.parametrize("kernel,shape", [("rows", (128, 1024)), ("dense_rows", (128, 256)),
                                          ("dense_mid", (1, 264, 130))])
def test_c2c_plain_matches_pallas_high_tier(kernel, shape):
    ref_config.matmul_precision = "high"
    rng = np.random.default_rng(7)
    x = _cplx(rng, shape)
    s = 1.0 / shape[-2 if kernel == "dense_mid" else -1]
    fn = {"rows": kfft.c2c_rows, "dense_rows": kfft.c2c_dense_rows,
          "dense_mid": kfft.c2c_dense_mid}[kernel]
    want = (_ref_mid if kernel == "dense_mid" else _ref_rows)(x, +1, s)
    _close(fn(torch.from_numpy(x), +1, s).numpy(), want, TOL_HIGH)


@pytest.mark.parametrize("fn,shape,axis", [(kfft.c2c_rows, (130, 2048), 1),
                                           (kfft.c2c_dense_rows, (130, 200), 1),
                                           (kfft.c2c_dense_mid, (2, 264, 130), 1)])
def test_c2c_plain_matches_float64_oracle(fn, shape, axis):
    rng = np.random.default_rng(11)
    x = _cplx(rng, shape)
    want = np.fft.fft(x.astype(np.complex128), axis=axis)
    _close(fn(torch.from_numpy(x), -1).numpy(), want, 2e-6)
    n = shape[axis]
    back = fn(fn(torch.from_numpy(x), -1), +1, 1.0 / n).numpy()
    _close(back, x, 2e-6)


@pytest.mark.parametrize("n,sign,scale", [(128, -1, 1.0), (264, +1, 1 / 264),
                                          (200, +1, 0.25), (2, -1, 1.0)])
def test_dense_consts_bit_identical_to_the_jax_tables(n, sign, scale):
    w = kfft.dense_consts(n, sign, scale)
    assert w.dtype == np.complex64 and w.shape == (n, n)
    assert w.flags["C_CONTIGUOUS"]
    wr, wi = ref_plan.dft_matrix(n, sign)     # _build_call_axis_mid's dense table
    assert np.array_equal(w.real, np.asarray(wr * scale, np.float32))
    assert np.array_equal(w.imag, np.asarray(wi * scale, np.float32))
    assert np.array_equal(w, w.T)


def test_rows_are_kernel_1_on_a_one_column_view():
    """The bts2 row tile (kernel 13's rows; kernel 10's until it moved onto
    the radix row core) runs the bts2 column tile's core and constants
    (kernel 7's body; kernel 1's until it moved onto the radix column tile)
    on rows: its plain version is the column core's on a (T, n, 1) view, bit
    for bit. Kernel 10's and kernel 1's plain versions, the radix core's,
    agree with it to float32."""
    x = torch.from_numpy(_cplx(np.random.default_rng(4), (5, 1024)))
    rows = kfft._bts2_rows_plain(x, +1, 1 / 1024)
    col = x.reshape(5, 1024, 1)
    assert torch.equal(rows, kfft.bts2_plain(col, kfft.device_wq(1024, +1, 1 / 1024, col.device),
                                             +1).reshape(5, 1024))
    _close(kfft.c2c_rows(x, +1, 1 / 1024).numpy(), rows.numpy(), TOL_HIGHEST)
    _close(kfft.c2c_axis_mid(col, +1, 1 / 1024).reshape(5, 1024).numpy(), rows.numpy(),
           TOL_HIGHEST)


def test_c2c_wrappers_on_cpu_count_no_launch():
    fns = (kfft.c2c_rows, kfft.c2c_dense_rows, kfft.c2c_dense_mid)
    before = [f.launches for f in fns]
    kfft.c2c_rows(torch.zeros(3, 512, dtype=torch.complex64), -1)
    kfft.c2c_dense_rows(torch.zeros(3, 200, dtype=torch.complex64), -1)
    kfft.c2c_dense_mid(torch.zeros(1, 264, 3, dtype=torch.complex64), +1, 0.5)
    assert [f.launches for f in fns] == before


@pytest.mark.parametrize("call", [
    lambda: kfft.c2c_rows(torch.zeros(3, 200, dtype=torch.complex64), -1),       # no split
    lambda: kfft.c2c_rows(torch.zeros(3, 131 * 128, dtype=torch.complex64), -1),  # no plan
    lambda: kfft.c2c_rows(torch.zeros(1, 3, 512, dtype=torch.complex64), -1),
    lambda: kfft.c2c_dense_rows(torch.zeros(3, 513, dtype=torch.complex64), -1),
    lambda: kfft.c2c_dense_rows(torch.zeros(512, dtype=torch.complex64), -1),
    lambda: kfft.c2c_dense_mid(torch.zeros(1, 600, 3, dtype=torch.complex64), -1),
    lambda: kfft.c2c_dense_mid(torch.zeros(128, 3, dtype=torch.complex64), -1),
    lambda: kfft.c2c_rows(torch.zeros(3, 512, dtype=torch.complex64, device="meta"), -1),
    lambda: kfft.c2c_dense_rows(torch.zeros(3, 64, dtype=torch.complex64, device="meta"), -1),
    lambda: kfft.c2c_dense_mid(
        torch.zeros(1, 64, 3, dtype=torch.complex64, device="meta"), -1),
])
def test_c2c_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_block_rows_fills_the_card():
    assert kfft.dense_tile(256, 1, 65536, 132) == 8   # 1024 blocks of 128 x 128
    assert kfft.dense_tile(264, 1, 264, 132) == 4     # 9 -> 25 blocks of 64 x 64
