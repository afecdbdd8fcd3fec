"""The mixed-radix Stockham row core (kernel 10 at every n = 128 * F,
kernel 8 at every n) against the JAX package and numpy on the CPU:

* ``radix_plan`` over every length the two routes send (C2C_ROWS and
  C2C_GENERIC_ROWS, found by ``gates.lane_c2c_route(n, 128)`` over
  257 ... 20480): the radices multiply to n, each is a codelet or a prime
  <= 127, at most 8 stages, in the kernel's order; and over kernel 8's
  lengths n <= 256 and kernel 6's middle-axis lengths;
* ``radix_consts`` against an independent float64 numpy expression rounded
  once: equal;
* the plain version against ``c2c_pallas`` in interpret mode at the
  "highest" tier (the twostep kernel at F = 3, 5, 9, 13; the lane kernel's
  generic schedule at 258 ... 1200), both signs, with and without 1/n;
* the plain version against float64 numpy at the longest and least smooth
  lengths, and at kernel 10's n = 512, 1024, 2048 (the bts2 core's lengths
  until kernel 10 moved onto the radix core), both signs, with and without
  1/n;
* the wrappers on a CPU tensor: the radix plain version, no launch.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| (each side measures ~5e-7
against a float64 oracle); 2e-6 against the float64 oracle (float32 sums
over at most 8 stages).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch import api, gates
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
TOL_ORACLE = 2e-6


def _route_lengths():
    """Every n in 257 ... 20480 whose last-axis C2C over 128 rows runs on the
    radix core."""
    out = []
    for n in range(257, kfft.GENERIC_MAX_N + 1):
        if gates.lane_c2c_route(n, 128) in (gates.C2C_ROWS, gates.C2C_GENERIC_ROWS):
            out.append(n)
    return out


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _cplx(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_plan_covers_every_route_length():
    lengths = _route_lengths()
    assert len(lengths) == 1734
    for n in lengths:
        plan = kfft.radix_plan(n)
        assert plan is not None and 1 <= len(plan) <= kfft.RADIX_MAX_STAGES, n
        assert math.prod(plan) == n, (n, plan)
        primes = [r for r in plan if r not in kfft.RADIX_CODELETS]
        assert all(r <= kfft.RADIX_MAX_P and all(r % d for d in range(2, r)) for r in primes)
        # the kernel's order: powers of two, then 9s, 3, 5s, 7s, then primes
        order = [(0 if r & (r - 1) == 0 else 1 if r in (9, 3, 5, 7) else 2) for r in plan]
        assert order == sorted(order), (n, plan)
        if primes:
            assert plan[-len(primes):] == tuple(sorted(primes)), (n, plan)


@pytest.mark.parametrize("route,count", [("c2c_dense_rows", 232), ("c2c_generic_mid", 1402)])
def test_plan_covers_the_dense_rows_and_middle_axis_routes(route, count):
    """Kernel 8 at n <= 256 (C2C_DENSE_ROWS over 128 rows) and kernel 6
    (C2C_GENERIC_MID along axis 1 of (1, n, 130)) run the radix core at
    every length their routes send: each has a plan of at most 8 stages
    whose radices multiply to n."""
    if route == gates.C2C_DENSE_ROWS:
        lengths = [n for n in range(2, 257) if gates.lane_c2c_route(n, 128) == route]
    else:
        lengths = [n for n in range(257, kfft.GENERIC_MAX_N + 1)
                   if api._route("fft", (1, n, 130), 1, torch.complex64, "cuda") == route]
    assert len(lengths) == count
    for n in lengths:
        plan = kfft.radix_plan(n)
        assert plan is not None and len(plan) <= kfft.RADIX_MAX_STAGES, n
        assert math.prod(plan) == n, (n, plan)


@pytest.mark.parametrize("n,plan", [(4096, (16, 16, 16)), (600, (8, 3, 5, 5)),
                                    (16256, (16, 8, 127)), (20480, (16, 16, 16, 5)),
                                    (384, (16, 8, 3)), (1152, (16, 8, 9)),
                                    (20448, (16, 2, 9, 71)), (14641, (11, 11, 11, 11)),
                                    (512, (16, 16, 2)), (1024, (16, 16, 4)),
                                    (2048, (16, 16, 8))])
def test_plan_examples(n, plan):
    assert kfft.radix_plan(n) == plan


def test_plan_refuses_what_the_kernel_does_not_take():
    assert kfft.radix_plan(131 * 2) is None          # a prime above 127
    assert kfft.radix_plan(1) is None
    assert kfft.radix_plan(2 * 3 * 5 * 7 * 11 * 13 * 17 * 19 * 23) is None   # 9 stages


@pytest.mark.parametrize("n", [384, 600, 1152, 4096, 16256, 18304, 20448, 14641])
@pytest.mark.parametrize("sign", [-1, +1])
def test_table_matches_float64_numpy(n, sign):
    """Each entry W_N^u = exp(sign 2 pi i u / N), u reduced mod N, with the
    angle written as (pi / N) * 2u in float64 (the rounding every table of
    the port uses: its near-zero cosines differ in float32 under another
    association), then rounded once."""
    re, im = kfft.radix_consts(n, sign)
    plan = kfft.radix_plan(n)

    def cis(u, big_n):
        ang = sign * (np.pi / big_n) * (2 * (u % big_n)).astype(np.float64)
        return np.cos(ang) + 1j * np.sin(ang)

    want = []
    lead = 1
    for r in plan:
        j = np.arange(1, r)[:, None]
        k = np.arange(lead)[None, :]
        want.append(cis(j * k, r * lead).ravel())
        lead *= r
    want.append(np.ones(1))
    for p in plan:
        if p not in kfft.RADIX_CODELETS:
            want.append(cis(np.arange(p), p))
    want = np.concatenate(want)
    assert re.dtype == im.dtype == np.float32 and re.shape == (n + sum(
        p for p in plan if p not in kfft.RADIX_CODELETS),)
    np.testing.assert_array_equal(re, want.real.astype(np.float32))
    np.testing.assert_array_equal(im, want.imag.astype(np.float32))


_SIGN_SCALE = [(-1, None), (+1, None), (-1, "inv_n"), (+1, "inv_n")]


@pytest.mark.parametrize("t,n", [(16, 384), (8, 640), (8, 1152), (4, 1664),
                                 (16, 258), (16, 264), (16, 600), (8, 1000), (8, 1200)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_plain_matches_pallas(t, n, sign, scale):
    """The twostep kernel at F = 3, 5, 9, 13 and the lane kernel's generic
    schedule at 258 (2 * 3 * 43), 264, 600, 1000, 1200."""
    route = gates.lane_c2c_route(n, 128)
    assert route == (gates.C2C_ROWS if n % kfft.M == 0 else gates.C2C_GENERIC_ROWS)
    x = _cplx((t, n), t + n + sign)
    s = 1.0 / n if scale else None
    got = kfft.c2c_radix_rows_plain(torch.from_numpy(x), sign, s)
    assert got.dtype == torch.complex64 and got.shape == (t, n)
    yr, yi = ref_pfft.c2c_pallas(jnp.asarray(x.real), jnp.asarray(x.imag),
                                 ref_plan.get_c2c_plan(n, sign), s)
    _close(got, np.asarray(yr) + 1j * np.asarray(yi))


@pytest.mark.parametrize("n", [16256, 20480, 11352, 19272, 12928, 20448])
def test_plain_matches_float64(n):
    """The longest lengths, the largest prime (127), two prime stages
    (11352 = 8 * 3 * 11 * 43, 19272 = 8 * 3 * 11 * 73), 128 * 101 and 20448 =
    16 * 2 * 9 * 71."""
    x = _cplx((3, n), n)
    x64 = x.astype(np.complex128)
    for sign in (-1, +1):
        got = kfft.c2c_radix_rows_plain(torch.from_numpy(x), sign, 1.0 / n if sign > 0 else None)
        want = np.fft.fft(x64, axis=1) if sign < 0 else np.fft.ifft(x64, axis=1)
        _close(got, want, TOL_ORACLE)


@pytest.mark.parametrize("t,n", [(130, 512), (33, 1024), (9, 2048)])
@pytest.mark.parametrize("sign,scale", _SIGN_SCALE)
def test_kernel10_lengths_plain_matches_float64(t, n, sign, scale):
    """Kernel 10 at n = 512, 1024, 2048 (plans (16, 16, 2), (16, 16, 4),
    (16, 16, 8)), the lengths the bts2 core took before: the unnormalized
    DFT of either sign, times 1/n where asked, against float64 numpy."""
    assert gates.lane_c2c_route(n, 128) == gates.C2C_ROWS
    x = _cplx((t, n), t * n + sign)
    s = 1.0 / n if scale else None
    got = kfft.c2c_rows(torch.from_numpy(x), sign, s)      # CPU: the plain version
    assert got.dtype == torch.complex64 and got.shape == (t, n)
    x64 = x.astype(np.complex128)
    want = np.fft.fft(x64, axis=1) if sign < 0 else np.fft.ifft(x64, axis=1) * n
    _close(got, want * (s or 1.0), TOL_ORACLE)


def test_wrappers_on_cpu_run_the_radix_plain_version():
    counts = (kfft.c2c_rows.launches, kfft.c2c_rows.radix_launches,
              kfft.c2c_generic_rows.launches)
    for fn, n in ((kfft.c2c_rows, 384), (kfft.c2c_rows, 20480), (kfft.c2c_generic_rows, 600),
                  (kfft.c2c_generic_rows, 11352)):
        x = torch.from_numpy(_cplx((3, n), n))
        assert torch.equal(fn(x, +1, 0.5), kfft.c2c_radix_rows_plain(x, +1, 0.5))
    # the bts2 core's former lengths run the radix plain version too
    for n in (512, 1024, 2048):
        x = torch.from_numpy(_cplx((3, n), 1))
        assert torch.equal(kfft.c2c_rows(x, -1), kfft.c2c_radix_rows_plain(x, -1))
        assert torch.equal(kfft.c2c_rows(x, +1, 1 / n), kfft.c2c_radix_rows_plain(x, +1, 1 / n))
    assert (kfft.c2c_rows.launches, kfft.c2c_rows.radix_launches,
            kfft.c2c_generic_rows.launches) == counts


def test_block_rows():
    # (4096, 4096): one row a block; (360000, 600): 3 rows of 38 threads (114
    # of a block's 128 lanes busy, one in eight at most idle); 1000 rows of
    # 264: 5 rows of 17 threads (85 of 96) fill 132 SMs with 200 tiles; 130
    # rows of 384: 4 halved to 1; 2 rows of 20480: one each; kernel 10's
    # n = 512, 1024, 2048 one row of whole warps; kernel 2's h = 384 four
    # rows of 24 threads (three warps), h = 768 two of 48, h = 640 three of
    # 40 (120 of 128)
    assert kfft.radix_block(4096, 4096, 132) == 1
    assert kfft.radix_block(600, 360000, 132) == 3
    assert kfft.radix_block(264, 1000, 132) == 5
    assert kfft.radix_block(384, 130, 132) == 1
    assert kfft.radix_block(20480, 2, 132) == 1
    for n in (512, 1024, 2048):
        assert kfft.radix_block(n, 262144, 132) == 1
    assert [kfft.radix_block(h, 589824, 132) for h in (384, 768, 640)] == [4, 2, 3]
    # the threads of a tile fit the 256 of a block (16 elements each)
    for n in range(257, kfft.RADIX_WIDE_N + 1):
        assert kfft.radix_block(n, 10 ** 6, 132) * -(-n // 16) <= kfft.RADIX_MAX_THREADS
