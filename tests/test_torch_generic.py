"""The lengths of the JAX package's generic two-factor schedule (kernel 8
at n > 256 without a split, kernel 6, kernel 15 at such a half length)
against the JAX package on the CPU:

* the plain versions of ``c2c_generic_rows``, ``c2c_generic_mid`` and
  ``r2c_packed_generic`` against ``c2c_pallas``, ``c2c_pallas_axis_mid`` and
  ``r2c_pallas`` in interpret mode (their generic bodies; the port runs the
  mixed-radix core's plain version on rows, and kernel 6 on each column as
  a row), kernel 6's at n = 600, 1000, 1200 and 1016 (a 127 stage);
* the wrappers' checks and launch counters, the tile sizes
  (``radix_block``, ``radix_mid_cols``), and that every length the routes
  send to these kernels is one they take;
* the plain versions against a float64 oracle at n = 11352, 19272 and
  20480 (m = 129 and 219 are split in two by the JAX planner).

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| at the JAX package's
"highest" tier, where each side measures ~5e-7 against a float64 oracle;
2e-6 against the float64 oracle (the radix stages' float32 sums).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_pfft
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch import api, gates
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6
TOL_ORACLE = 2e-6


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


@pytest.mark.parametrize("t,n", [(16, 264), (16, 600), (8, 1200)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_rows_plain_matches_pallas_lane_last(t, n, sign, scale):
    x = _cplx((t, n), t + n + sign)
    s = 1.0 / n if scale else None
    got = kfft.c2c_generic_rows(torch.from_numpy(x), sign, s)     # CPU: the plain version
    assert got.dtype == torch.complex64 and got.shape == (t, n)
    want = _split(ref_pfft.c2c_pallas(jnp.asarray(x.real), jnp.asarray(x.imag),
                                      ref_plan.get_c2c_plan(n, sign), s))
    _close(got, want)


@pytest.mark.parametrize("shape", [(1, 600, 130), (2, 520, 129)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_mid_plain_matches_pallas_axis_mid(shape, sign, scale):
    assert ref_pfft.mid_kernel_kind(shape[1]) == "generic"
    x = _cplx(shape, sum(shape) + sign)
    s = 1.0 / shape[1] if scale else None
    got = kfft.c2c_generic_mid(torch.from_numpy(x), sign, s)
    assert got.dtype == torch.complex64 and got.shape == shape
    want = _split(ref_pfft.c2c_pallas_axis_mid(jnp.asarray(x.real), jnp.asarray(x.imag),
                                               ref_plan.get_c2c_plan(shape[1], sign), s))
    _close(got, want)


@pytest.mark.parametrize("n", [530, 600])
def test_packed_plain_matches_pallas_r2c(n):
    """h = 265 (odd) and 300: _half_fft_consts takes the generic schedule."""
    h = n // 2
    _, meta = ref_prfft._half_fft_consts(h, -1, jnp.float32, "highest")
    assert meta[0] == "gen" and (meta[-2], meta[-1]) == kfft.generic_split(h)
    x = np.random.default_rng(n).standard_normal((16, n)).astype(np.float32)
    got = krfft.r2c_packed_generic(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (16, h + 1)
    want = _split(ref_prfft.r2c_pallas(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]),
                                       ref_plan.get_r2c_plan(n)))
    _close(got, want)
    _close(got, np.fft.rfft(x.astype(np.float64), axis=1), TOL_ORACLE)


@pytest.mark.parametrize("n", [600, 1000, 1200, 1016])
@pytest.mark.parametrize("sign,scale", [(-1, 0.5), (+1, "inv_n")])
def test_mid_radix_plain_matches_pallas_axis_mid(n, sign, scale):
    """Kernel 6's plain version (the radix core on each column) against the
    JAX package's generic middle-axis kernel: (m, f) = (3, 200), (4, 250),
    (5, 240), (4, 254) there; radix plans (8, 3, 5, 5), (8, 5, 5, 5),
    (16, 3, 5, 5) and (8, 127) here."""
    assert ref_pfft.mid_kernel_kind(n) == "generic"
    x = _cplx((1, n, 130), n - sign)
    s = 1.0 / n if scale == "inv_n" else scale
    got = kfft.c2c_generic_mid(torch.from_numpy(x), sign, s)
    assert got.dtype == torch.complex64 and got.shape == (1, n, 130)
    want = _split(ref_pfft.c2c_pallas_axis_mid(jnp.asarray(x.real), jnp.asarray(x.imag),
                                               ref_plan.get_c2c_plan(n, sign), s))
    _close(got, want)


@pytest.mark.parametrize("n", [11352, 20480])
@pytest.mark.parametrize("sign", [-1, +1])
def test_mid_radix_plain_matches_float64_oracle(n, sign):
    """Kernel 6's plain version at a two-factor m (11352 = 129 * 88, plan
    (8, 3, 11, 43)) and at the longest length (20480, plan (16, 16, 16, 5))
    against numpy in float64, with a scale."""
    x = _cplx((1, n, 3), n + sign)
    got = kfft.c2c_generic_mid(torch.from_numpy(x), sign, 0.25)
    x64 = x.astype(np.complex128)
    want = 0.25 * (np.fft.fft(x64, axis=1) if sign < 0 else n * np.fft.ifft(x64, axis=1))
    _close(got, want, TOL_ORACLE)


def test_lane_factor_matches_the_jax_package():
    for n in list(range(2, 1400)) + list(range(11340, 11400)) + [20480, 19343]:
        assert kfft.lane_factor(n) == ref_pfft._lane_factor(n), n


def test_every_generic_route_is_a_length_the_kernels_take():
    """Over the gate's range 257 ... 20480, every length that the routes send
    to the generic kernels (1582 along rows, 1402 along a middle axis, 1582
    half lengths of the packed R2C) has a generic schedule with m <= 224."""
    counts = {api.C2C_GENERIC_ROWS: 0, api.C2C_GENERIC_MID: 0, "packed": 0}
    for n in range(257, kfft.GENERIC_MAX_N + 1):
        for shape, axis in (((128, n), 1), ((n, 128), 0)):
            route = api._route("fft", shape, axis, torch.complex64, "cuda")
            if route in counts:
                assert kfft.generic_split(n) is not None, (n, route)
                counts[route] += 1
        packed = (gates._kernel_ok(n) and not krfft.packed_core(n)
                  and gates.packed_lane(n, gates.MIN_BATCH) == gates.R2C_PACKED)
        if packed:
            assert kfft.generic_split(n) is not None, n
            counts["packed"] += 1
    assert counts == {api.C2C_GENERIC_ROWS: 1582, api.C2C_GENERIC_MID: 1402, "packed": 1582}


@pytest.mark.parametrize("rows", [True, False])
@pytest.mark.parametrize("n,m", [(11352, 129), (19272, 219)])
def test_plain_versions_match_float64_oracle_with_two_factor_m(n, m, rows):
    """The smallest and the largest m of the gate's range, both split in two
    by the JAX planner (129 = 43 * 3, 219 = 73 * 3)."""
    assert kfft.generic_split(n) == (m, 88) and len(ref_plan.factorize(m)) == 2
    shape = (2, n) if rows else (1, n, 3)
    x = _cplx(shape, 5)
    fn = kfft.c2c_generic_rows if rows else kfft.c2c_generic_mid
    _close(fn(torch.from_numpy(x), -1), np.fft.fft(x.astype(np.complex128), axis=1),
           TOL_ORACLE)
    back = fn(fn(torch.from_numpy(x), -1), +1, 1.0 / n)
    _close(back, x, TOL_ORACLE)


def test_packed_plain_matches_float64_oracle_with_two_factor_m():
    x = np.random.default_rng(6).standard_normal((2, 2 * 11352)).astype(np.float32)
    _close(krfft.r2c_packed_generic(torch.from_numpy(x)),
           np.fft.rfft(x.astype(np.float64), axis=1), TOL_ORACLE)


@pytest.mark.parametrize("call", [
    lambda: kfft.c2c_generic_rows(torch.zeros(3, 256, dtype=torch.complex64), -1),
    lambda: kfft.c2c_generic_rows(torch.zeros(3, 514, dtype=torch.complex64), -1),  # 2 * 257
    lambda: kfft.c2c_generic_rows(torch.zeros(1, 19343, dtype=torch.complex64), -1),  # m = 667
    lambda: kfft.c2c_generic_rows(torch.zeros(1, 20482, dtype=torch.complex64), -1),
    lambda: kfft.c2c_generic_rows(torch.zeros(1, 3, 600, dtype=torch.complex64), -1),
    lambda: kfft.c2c_generic_mid(torch.zeros(3, 600, dtype=torch.complex64), -1),
    lambda: kfft.c2c_generic_mid(torch.zeros(1, 200, 3, dtype=torch.complex64), -1),
    lambda: kfft.c2c_generic_rows(torch.zeros(3, 600, dtype=torch.complex64, device="meta"), -1),
    lambda: kfft.c2c_generic_mid(torch.zeros(1, 600, 3, dtype=torch.complex64, device="meta"),
                                 -1),
    lambda: krfft.r2c_packed_generic(torch.zeros(3, 512)),       # h = 256
    lambda: krfft.r2c_packed_generic(torch.zeros(3, 601)),       # odd n
    lambda: krfft.r2c_packed_generic(torch.zeros(3, 600, device="meta")),
])
def test_generic_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_packed_generic_rejects_other_dtypes():
    with pytest.raises(TypeError):
        krfft.r2c_packed_generic(torch.zeros(3, 600, dtype=torch.float64))


def test_generic_wrappers_on_cpu_count_no_launch():
    fns = (kfft.c2c_generic_rows, kfft.c2c_generic_mid, krfft.r2c_packed_generic)
    before = [f.launches for f in fns]
    kfft.c2c_generic_rows(torch.zeros(3, 600, dtype=torch.complex64), -1)
    kfft.c2c_generic_mid(torch.zeros(1, 600, 3, dtype=torch.complex64), +1, 0.5)
    krfft.r2c_packed_generic(torch.zeros(3, 530))
    assert [f.launches for f in fns] == before


def test_generic_block_sizes():
    # the 600^3 step's R2C: kernel 15 at h = 300 on the radix row core, 3
    # rows of 300 (57 threads: 7 of 64 lanes idle) over 360000 rows
    assert kfft.radix_block(300, 360000, 132) == 3
    assert kfft.radix_block(600, 8, 132) == 1
    # kernel 8 at n <= 256 (RADIX_SMALL_TILE): 2 rows of 256, 3 of 129, 256
    # rows of 2 (one thread each, the thread bound)
    assert kfft.radix_block(256, 65536, 132) == 2
    assert kfft.radix_block(129, 8321, 132) == 3
    assert kfft.radix_block(2, 1 << 20, 132) == 256
    # kernel 6's column tile: 4 columns of 600 in the 16-element form at the
    # 600^3 step's (600, 600, 301) and (1, 600, 180600), the ragged L = 301
    # spread over 76 tiles of 3 or 4 columns
    assert kfft.radix_mid_cols(600, 600, 301, 132) == 4
    assert kfft.radix_mid_cols(600, 1, 180600, 132) == 4
    assert kfft.radix_cols_threads(600, 4) == 160
    # halved while the grid would leave SMs idle (3 x 4 tiles of 2); above
    # n = 4096 at most 20480 elements in 512 threads: 2 columns to
    # n = 10240, then one
    assert kfft.radix_mid_cols(1200, 3, 7, 132) == 1
    assert kfft.radix_mid_cols(8192, 64, 1000, 132) == 2
    assert kfft.radix_mid_cols(11352, 4, 1000, 132) == 1
    assert kfft.radix_mid_cols(20480, 1, 5, 132) == 1
    for n in (600, 1016, 4096, 6000, 10240, 20480):
        c = kfft.radix_mid_cols(n, 1000, 1000, 132)
        assert n * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(n, c) <= 512
