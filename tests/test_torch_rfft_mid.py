"""Plain versions of the middle-axis R2C/C2R kernels 16, 17, 20 and 21
against the JAX package's Pallas kernels (interpret mode); their tables, the
wrappers' checks, and the routes against the JAX package's gates. (Kernels
16 and 20 on the radix column tile: tests/test_torch_r2c_mid_radix.py.)

* kernels 16/17 (``r2c_mid``/``c2r_mid``) against ``r2c_pallas_mid`` /
  ``c2r_pallas_mid`` at n = 512, 1024, 2048, ragged column counts, B > 1;
* kernels 20/21 (``r2c_dense_mid``/``c2r_dense_mid``) against
  ``r2c_dense_pallas_mid`` / ``c2r_dense_pallas_mid`` at 4 <= n <= 1100,
  odd n included, and their tables bit for bit against the JAX tables.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| at the JAX package's
"highest" dot tier, where each side measures <= 7e-7 against a float64
oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import rfft as ref_rfft

from ndrustfft_tpu_torch import api
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
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _spec(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _scale(scale, n):
    return {"none": None, "inv_n": 1.0 / n, "scalar": 0.3}[scale]


# --------------------------------------------------------------------------
# Kernels 16 and 17
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 512, 130), (2, 512, 200), (1, 1024, 130),
                                   (2, 1024, 128), (1, 2048, 130)])
def test_r2c_mid_plain_matches_pallas(shape):
    x = _real(shape, sum(shape))
    sr, si = ref_rfft.r2c_pallas_mid(jnp.asarray(x), ref_plan.get_r2c_plan(shape[1]))
    got = krfft.r2c_mid(torch.from_numpy(x))            # CPU: plain version
    assert got.dtype == torch.complex64
    assert got.shape == (shape[0], shape[1] // 2 + 1, shape[2])
    _close(got.numpy(), np.asarray(sr) + 1j * np.asarray(si))


@pytest.mark.parametrize("shape", [(1, 512, 130), (2, 1024, 200), (1, 2048, 130)])
@pytest.mark.parametrize("scale", ["none", "inv_n", "scalar"])
def test_c2r_mid_plain_matches_pallas(shape, scale):
    nb, n, cols = shape
    spec = _spec((nb, n // 2 + 1, cols), n + cols)
    s = _scale(scale, n)
    want = ref_rfft.c2r_pallas_mid(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, s)
    got = krfft.c2r_mid(torch.from_numpy(spec), n, s)
    assert got.dtype == torch.float32 and got.shape == shape
    _close(got.numpy(), want)


@pytest.mark.parametrize("n", [512, 4096])
def test_mid_plain_matches_float64_oracle(n):
    """F = 2 and F = 16, the core's ends, against numpy in float64; the
    round trip through kernel 17 with the 1/n scale."""
    x = _real((2, n, 130), n)
    spec = krfft.r2c_mid(torch.from_numpy(x))
    _close(spec.numpy(), np.fft.rfft(x.astype(np.float64), axis=1), 2e-6)
    _close(krfft.c2r_mid(spec, n, 1.0 / n).numpy(), x, 2e-6)


def test_c2r_mid_ignores_dc_and_nyquist_imag():
    n = 1024
    spec = _spec((2, n // 2 + 1, 130), 12)
    spec[:, 0] += 100j
    spec[:, -1] += 100j
    got = krfft.c2r_mid(torch.from_numpy(spec), n, 1.0 / n).numpy()
    want = ref_rfft.c2r_pallas_mid(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, 1.0 / n)
    _close(got, want)
    _close(got, np.fft.irfft(spec.astype(np.complex128), n=n, axis=1))


def test_mid_is_the_row_kernels_on_a_transposed_view():
    """Kernel 16 is the radix R2C of rows (kernel 2's) in the radix core's
    column layout, and kernel 17 the bts2 C2R of rows (kernel 3's) in kernel
    1's: the same arithmetic on every column. The bts2 R2C of rows (kernel
    16's former core) computes the same function."""
    x = torch.from_numpy(_real((2, 512, 3), 5))
    rows = krfft.r2c_nat(x.transpose(1, 2).reshape(6, 512))
    mid = krfft.r2c_mid(x)
    torch.testing.assert_close(mid.transpose(1, 2).reshape(6, 257), rows,
                               rtol=0, atol=2e-5)
    z = torch.view_as_complex(x.transpose(1, 2).reshape(6, 256, 2).contiguous())
    bts2 = krfft._unpack(kfft._bts2_rows_plain(z, -1), krfft._device_tw(512, z.device), -1)
    _close(rows.numpy(), bts2.numpy())
    s = torch.from_numpy(_spec((2, 257, 3), 6))
    rows = krfft.c2r_nat(s.transpose(1, 2).reshape(6, 257), 512, 0.5)
    torch.testing.assert_close(krfft.c2r_mid(s, 512, 0.5).transpose(1, 2).reshape(6, 512),
                               rows, rtol=0, atol=2e-5)


# --------------------------------------------------------------------------
# Kernels 20 and 21
# --------------------------------------------------------------------------

DENSE_N = [4, 5, 128, 201, 256, 264, 1100]


@pytest.mark.parametrize("n", DENSE_N)
def test_r2c_dense_mid_plain_matches_pallas(n):
    x = _real((2, n, 130), n)
    sr, si = ref_rfft.r2c_dense_pallas_mid(jnp.asarray(x), ref_plan.get_r2c_plan(n))
    got = krfft.r2c_dense_mid(torch.from_numpy(x))
    assert got.dtype == torch.complex64 and got.shape == (2, n // 2 + 1, 130)
    _close(got.numpy(), np.asarray(sr) + 1j * np.asarray(si))


@pytest.mark.parametrize("n", DENSE_N)
@pytest.mark.parametrize("scale", ["none", "inv_n", "scalar"])
def test_c2r_dense_mid_plain_matches_pallas(n, scale):
    spec = _spec((2, n // 2 + 1, 130), 3 * n)
    s = _scale(scale, n)
    want = ref_rfft.c2r_dense_pallas_mid(jnp.asarray(spec.real), jnp.asarray(spec.imag), n, s)
    got = krfft.c2r_dense_mid(torch.from_numpy(spec), n, s)
    assert got.dtype == torch.float32 and got.shape == (2, n, 130)
    _close(got.numpy(), want)


@pytest.mark.parametrize("n", [5, 201, 264])
def test_dense_plain_matches_float64_oracle(n):
    x = _real((1, n, 130), n + 1)
    spec = krfft.r2c_dense_mid(torch.from_numpy(x))
    _close(spec.numpy(), np.fft.rfft(x.astype(np.float64), axis=1), 2e-6)
    spec[:, 0] += 100j          # ignored, as is an even n's Nyquist imag
    if n % 2 == 0:
        spec[:, -1] += 100j
    _close(krfft.c2r_dense_mid(spec, n, 1.0 / n).numpy(), x, 2e-6)


@pytest.mark.parametrize("n", [4, 5, 128, 201, 264, 1100])
@pytest.mark.parametrize("scale", [1.0, 1 / 264, 0.3])
def test_dense_tables_bit_identical_to_the_jax_tables(n, scale):
    w = krfft.r2c_dense_consts(n)
    assert w.dtype == np.float32 and w.shape == (n, 2 * (n // 2 + 1))
    assert w.flags["C_CONTIGUOUS"]
    assert np.array_equal(w, np.asarray(ref_rfft._r2c_dense_w(n), np.float32))
    w2 = krfft.c2r_dense_consts(n, scale)
    assert w2.dtype == np.float32 and w2.shape == (2 * (n // 2 + 1), n)
    assert w2.flags["C_CONTIGUOUS"]
    assert np.array_equal(w2, np.asarray(ref_rfft._c2r_dense_w(n, scale), np.float32))


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------


def test_mid_wrappers_on_cpu_count_no_launch():
    fns = (krfft.r2c_mid, krfft.c2r_mid, krfft.r2c_dense_mid, krfft.c2r_dense_mid)
    forms = ("launches", "radix_launches", "wide_launches")
    before = [[getattr(f, a, 0) for a in forms] for f in fns]
    krfft.r2c_mid(torch.zeros(1, 512, 3))
    krfft.c2r_mid(torch.zeros(1, 257, 3, dtype=C64), 512)
    krfft.r2c_dense_mid(torch.zeros(1, 201, 3))
    krfft.r2c_dense_mid(torch.zeros(1, 262, 3))             # no radix plan: the dense product
    krfft.c2r_dense_mid(torch.zeros(1, 101, 3, dtype=C64), 201, 0.5)
    assert [[getattr(f, a, 0) for a in forms] for f in fns] == before


@pytest.mark.parametrize("call", [
    lambda: krfft.r2c_mid(torch.zeros(512, 3)),                                   # rank
    lambda: krfft.r2c_mid(torch.zeros(1, 2 * 131 * 128, 3)),                      # no plan
    lambda: krfft.r2c_mid(torch.zeros(1, 2 * 161 * 128, 3)),                      # F > 160
    lambda: krfft.r2c_mid(torch.zeros(1, 513, 3)),                                # odd
    lambda: krfft.r2c_mid(torch.zeros(1, 512, 3, device="meta")),                 # device
    lambda: krfft.c2r_mid(torch.zeros(257, 3, dtype=C64), 512),
    lambda: krfft.c2r_mid(torch.zeros(1, 256, 3, dtype=C64), 512),                # m != n/2+1
    lambda: krfft.c2r_mid(torch.zeros(1, 193, 3, dtype=C64), 384),                # h = 192
    lambda: krfft.c2r_mid(torch.zeros(1, 257, 3, dtype=C64, device="meta"), 512),
    lambda: krfft.r2c_dense_mid(torch.zeros(201, 3)),
    lambda: krfft.r2c_dense_mid(torch.zeros(1, 3, 3)),                            # n < 4
    lambda: krfft.r2c_dense_mid(torch.zeros(1, 1101, 3)),                         # n > 1100
    lambda: krfft.r2c_dense_mid(torch.zeros(1, 201, 3, device="meta")),
    lambda: krfft.c2r_dense_mid(torch.zeros(1, 101, 3, dtype=C64), 203),
    lambda: krfft.c2r_dense_mid(torch.zeros(1, 2, 3, dtype=C64), 3),
    lambda: krfft.c2r_dense_mid(torch.zeros(101, 3, dtype=C64), 201),
    lambda: krfft.c2r_dense_mid(torch.zeros(1, 101, 3, dtype=C64, device="meta"), 201),
])
def test_mid_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("call", [
    lambda: krfft.r2c_mid(torch.zeros(1, 512, 3, dtype=torch.float64)),
    lambda: krfft.c2r_mid(torch.zeros(1, 257, 3, dtype=torch.complex128), 512),
    lambda: krfft.r2c_dense_mid(torch.zeros(1, 201, 3, dtype=C64)),
    lambda: krfft.c2r_dense_mid(torch.zeros(1, 101, 3), 201),
])
def test_mid_wrappers_reject_other_dtypes(call):
    with pytest.raises(TypeError):
        call()


# --------------------------------------------------------------------------
# Routes against the JAX package's gates
# --------------------------------------------------------------------------


_MID = (api.R2C_MID, api.C2R_MID, api.R2C_DENSE_MID, api.C2R_DENSE_MID)


def _port_route(kind, n):
    """The port's route of an R2C/C2R along axis 0 with 256 columns on a
    CUDA tensor."""
    shape = (n, 256) if kind == "r2c" else (n // 2 + 1, 256)
    dtype = F32 if kind == "r2c" else C64
    return api._route(kind, shape, 0, dtype, "cuda", n=n)


@pytest.mark.parametrize("kind", ["r2c", "c2r"])
def test_mid_gates_match_the_jax_package(kind):
    f32 = jnp.float32
    for n in list(range(2, 1101)) + [1104, 1152, 2048, 4096, 6144, 8192]:
        nat = ref_rfft.rfft_nat_supported(ref_plan.get_r2c_plan(n), f32)
        dense = ref_rfft.rfft_dense_mid_supported(n, f32)
        got = _port_route(kind, n)
        if nat:     # K16/K17 at every factor: the fixed core or the wide one
            assert got == (api.R2C_MID if kind == "r2c" else api.C2R_MID), (n, got)
        elif dense:
            assert got == (api.R2C_DENSE_MID if kind == "r2c" else api.C2R_DENSE_MID), (n, got)
        else:
            assert got not in _MID, (n, got)


@pytest.mark.parametrize("kind,n", [("r2c", 768), ("c2r", 768), ("r2c", 8192), ("c2r", 8192),
                                    ("r2c", 1536), ("c2r", 6144)])
def test_mid_route_outside_the_core_factors_raises(kind, n):
    """The JAX package runs these half lengths (F = 3, 32, 6, 24) on kernels
    16/17 with stage 1 as a dot; the port runs them on the wide core, so a
    CUDA tensor takes K16/K17 and raises nothing, and a CPU tensor runs the
    same wrappers' plain versions, which match the float64 FFT."""
    shape = (n, 256) if kind == "r2c" else (n // 2 + 1, 256)
    dtype = F32 if kind == "r2c" else C64
    want = api.R2C_MID if kind == "r2c" else api.C2R_MID
    assert api._route(kind, shape, 0, dtype, "cuda", n=n) == want
    assert api._route(kind, shape, 0, dtype, "cpu", n=n) == want
    assert kfft.core_f(n // 2) not in kfft.CORE_F
