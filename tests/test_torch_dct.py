"""The DCT kernels' plain versions against the JAX package's Pallas kernels
(interpret mode, "highest" tier), their constants bit for bit, the wrappers'
checks, and the torch engine lowerings of ops/dct.py and ops/dst.py against
the JAX package's.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 (each side
measures <= 5e-7 against scipy in float64 at these sizes); 1e-12 for the
float64 lowerings.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops import dct as ref_dct
from ndrustfft_tpu.ops import dst as ref_dst
from ndrustfft_tpu.ops.pallas import dct as ref_pdct

from ndrustfft_tpu_torch.ops import dct as port_dct
from ndrustfft_tpu_torch.ops import dst as port_dst
from ndrustfft_tpu_torch.ops.hopper import dct as kdct

torch.set_num_threads(1)

TOL = 5e-6


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
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dct_type", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [2, 5, 129, 130])
@pytest.mark.parametrize("cols", [8, 130])
@pytest.mark.parametrize("scale", [None, 2.0])
def test_dct_dense_plain_matches_pallas(dct_type, n, cols, scale):
    x = _rand((2, n, cols), n * cols + dct_type)
    got = kdct.dct_dense_mid(torch.from_numpy(x), dct_type, scale)   # CPU: plain
    _close(got, ref_pdct.dct_dense_pallas_mid(jnp.asarray(x), dct_type, scale))


@pytest.mark.parametrize("kernel,ref", [(kdct.dct2_nat, ref_pdct.dct2_pallas),
                                        (kdct.dct3_nat, ref_pdct.dct3_pallas)])
@pytest.mark.parametrize("t,n", [(8, 256), (130, 256), (8, 1024), (130, 1024)])
def test_dct_nat_plain_matches_pallas(kernel, ref, t, n):
    x = _rand((t, n), t + n)
    scale = 2.0 if t == 8 else None
    got = kernel(torch.from_numpy(x), scale)
    assert got.shape == (t, n) and got.dtype == torch.float32
    _close(got, ref(jnp.asarray(x), scale))


@pytest.mark.parametrize("dct_type", [1, 2, 3, 4])
@pytest.mark.parametrize("n,scale", [(2, 1.0), (129, 2.0), (1025, 2.0), (64, 0.3)])
def test_dense_matrix_bit_identical(dct_type, n, scale):
    want = np.asarray((ref_pdct._dct_dense_matrix(n, dct_type) * scale).T, np.float32)
    got = kdct.dense_consts(n, dct_type, scale)
    assert got.flags["C_CONTIGUOUS"] and np.array_equal(got, want)


@pytest.mark.parametrize("n", [256, 512, 1024, 4096])
def test_makhoul_tables_bit_identical(n):
    # the DCT-II post twiddle: the JAX kernel's table (dct.py:237-240)
    k = np.arange(n, dtype=np.int64)
    wr, wi = ref_plan._cis(k, 2 * n, -1)
    pr, pi = kdct.dct2_post(n)
    assert np.array_equal(pr, np.asarray(wr, np.float32))
    assert np.array_equal(pi, np.asarray(wi, np.float32))
    # the DCT-III twiddle: the conjugate of the lowering's pre twiddle, whose
    # 1/2 at scale 2 is exact
    cr, ci = ref_dct._dct3_consts(n)
    qr, qi = kdct.dct3_pre(n, 2.0)
    assert np.array_equal(qr, np.asarray(cr[:n // 2 + 1], np.float32))
    assert np.array_equal(qi, -np.asarray(ci[:n // 2 + 1], np.float32))
    # the permutations
    x = np.arange(n)
    perm = kdct.makhoul_perm(n)
    assert np.array_equal(x[perm], np.asarray(ref_dct._evenodd_perm(jnp.asarray(x))))
    assert np.array_equal(x[np.argsort(perm)],
                          np.asarray(ref_dct._evenodd_unperm(jnp.asarray(x), n)))


def test_wrappers_on_cpu_count_no_launch():
    fns = (kdct.dct_dense_mid, kdct.dct2_nat, kdct.dct3_nat)
    before = [f.launches for f in fns]
    kdct.dct_dense_mid(torch.zeros(1, 5, 3), 1)
    kdct.dct2_nat(torch.zeros(2, 256))
    kdct.dct3_nat(torch.zeros(2, 512))
    assert before == [f.launches for f in fns]


@pytest.mark.parametrize("call", [
    lambda: kdct.dct_dense_mid(torch.zeros(5, 3), 2),
    lambda: kdct.dct_dense_mid(torch.zeros(1, 5, 3), 5),
    lambda: kdct.dct_dense_mid(torch.zeros(1, 1, 3), 1),
    lambda: kdct.dct_dense_mid(torch.zeros(1, 5, 3, device="meta"), 2),
    lambda: kdct.dct2_nat(torch.zeros(2, 200)),             # not 128 * k
    lambda: kdct.dct2_nat(torch.zeros(2, 128 * 257)),       # n-point beyond the real tile
    lambda: kdct.dct3_nat(torch.zeros(2, 130)),
    lambda: kdct.dct3_nat(torch.zeros(2, 2, 256)),
    lambda: kdct.dct2_nat(torch.zeros(2, 256, device="meta")),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, TOL)])
@pytest.mark.parametrize("n", [1, 2, 5, 8, 12, 33])
def test_engine_lowerings_match_reference(dtype, tol, n):
    ref_config.pallas_interpret = False
    x = _rand((3, n), n, dtype)
    for t in (1, 2, 3, 4):
        for port_fns, ref_fns in ((port_dct.DCT_FNS, ref_dct.DCT_FNS),
                                  (port_dst.DST_FNS, ref_dst.DST_FNS)):
            if port_fns is port_dct.DCT_FNS and t == 1 and n < 2:
                with pytest.raises(ValueError, match="DCT-I requires length >= 2"):
                    port_fns[t](torch.from_numpy(x))
                continue
            for scale in (None, 2.0):
                _close(port_fns[t](torch.from_numpy(x), scale),
                       ref_fns[t](jnp.asarray(x), scale), tol)
