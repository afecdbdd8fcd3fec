"""Plain versions of the three Hopper kernels against the JAX package's
Pallas kernels (interpret mode); the wrappers' checks and the build.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| at the JAX package's
"highest" dot tier, where each side measures ~7.5e-7 against a float64
oracle; 3e-5 at the default "high" (bf16x3) tier, which measures ~5e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_fft
from ndrustfft_tpu.ops.pallas import rfft as ref_rfft

from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

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


def _ref_c2c_mid(x, sign, scale):
    yr, yi = ref_fft.c2c_pallas_axis_mid(
        jnp.asarray(x.real), jnp.asarray(x.imag),
        ref_plan.get_c2c_plan(x.shape[1], sign), scale)
    return np.asarray(yr) + 1j * np.asarray(yi)


@pytest.mark.parametrize("shape", [(1, 512, 257), (3, 1024, 130)])
@pytest.mark.parametrize("sign,scale", [(-1, None), (+1, "inv_n"), (+1, 0.25)])
def test_c2c_axis_mid_plain_matches_pallas(shape, sign, scale):
    rng = np.random.default_rng(shape[1] + sign)
    x = _cplx(rng, shape)
    s = 1.0 / shape[1] if scale == "inv_n" else scale
    got = kfft.c2c_axis_mid(torch.from_numpy(x), sign, s)   # CPU: plain version
    assert got.dtype == torch.complex64
    _close(got.numpy(), _ref_c2c_mid(x, sign, s), TOL_HIGHEST)


def test_c2c_axis_mid_plain_matches_pallas_high_tier():
    ref_config.matmul_precision = "high"
    rng = np.random.default_rng(3)
    x = _cplx(rng, (1, 512, 257))
    got = kfft.c2c_axis_mid(torch.from_numpy(x), +1, 1.0 / 512)
    _close(got.numpy(), _ref_c2c_mid(x, +1, 1.0 / 512), TOL_HIGH)


@pytest.mark.parametrize("t,n", [(130, 512), (128, 1024)])
def test_r2c_nat_plain_matches_pallas(t, n):
    rng = np.random.default_rng(t + n)
    x = rng.standard_normal((t, n)).astype(np.float32)
    sr, si = ref_rfft.r2c_pallas_nat(jnp.asarray(x), ref_plan.get_r2c_plan(n))
    got = krfft.r2c_nat(torch.from_numpy(x))
    assert got.shape == (t, n // 2 + 1) and got.dtype == torch.complex64
    _close(got.numpy(), np.asarray(sr) + 1j * np.asarray(si), TOL_HIGHEST)


def _ref_c2r(spec, n, scale):
    return np.asarray(ref_rfft.c2r_pallas_nat(
        jnp.asarray(spec.real), jnp.asarray(spec.imag), n, scale))


@pytest.mark.parametrize("t,n", [(130, 512), (128, 1024)])
@pytest.mark.parametrize("scale", [None, "inv_n"])
def test_c2r_nat_plain_matches_pallas(t, n, scale):
    rng = np.random.default_rng(t * n)
    spec = _cplx(rng, (t, n // 2 + 1))
    s = 1.0 / n if scale else None
    got = krfft.c2r_nat(torch.from_numpy(spec), n, s)
    assert got.shape == (t, n) and got.dtype == torch.float32
    _close(got.numpy(), _ref_c2r(spec, n, s), TOL_HIGHEST)


def test_c2r_nat_ignores_dc_and_nyquist_imag():
    # the pin of tests/test_pallas.py::test_pallas_nat_c2r_dc_nyquist_pin_large_n
    rng = np.random.default_rng(12)
    n, m = 1024, 513
    spec = _cplx(rng, (16, m))
    spec[:, 0] += 100j
    spec[:, -1] += 100j
    got = krfft.c2r_nat(torch.from_numpy(spec), n, 1.0 / n).numpy()
    _close(got, _ref_c2r(spec, n, 1.0 / n), TOL_HIGHEST)
    _close(got, np.fft.irfft(spec.astype(np.complex128), n=n, axis=1), TOL_HIGHEST)


def test_wrappers_on_cpu_count_no_launch():
    before = (kfft.c2c_axis_mid.launches, krfft.r2c_nat.launches,
              krfft.c2r_nat.launches)
    kfft.c2c_axis_mid(torch.zeros(1, 512, 3, dtype=torch.complex64), -1)
    krfft.r2c_nat(torch.zeros(2, 512))
    krfft.c2r_nat(torch.zeros(2, 257, dtype=torch.complex64), 512)
    assert before == (kfft.c2c_axis_mid.launches, krfft.r2c_nat.launches,
                      krfft.c2r_nat.launches)


@pytest.mark.parametrize("call", [
    lambda: kfft.c2c_axis_mid(torch.zeros(1, 200, 3, dtype=torch.complex64), -1),  # no split
    lambda: kfft.c2c_axis_mid(torch.zeros(384, 3, dtype=torch.complex64), -1),
    lambda: krfft.r2c_nat(torch.zeros(2, 500)),
    lambda: krfft.c2r_nat(torch.zeros(2, 200, dtype=torch.complex64), 512),
    lambda: kfft.c2c_axis_mid(
        torch.zeros(1, 512, 3, dtype=torch.complex64, device="meta"), -1),
    lambda: krfft.r2c_nat(torch.zeros(2, 512, device="meta")),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from ndrustfft_tpu_torch.ops.hopper import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("NDRUSTFFT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def _fake_nvcc(tmp_path, fail_on=None):
    """A stand-in nvcc that writes its -o target (and fails on one source)."""
    script = tmp_path / "bin" / "nvcc"
    script.parent.mkdir()
    fail = f'case "$*" in *{fail_on}*) echo "error in {fail_on}"; exit 2;; esac\n' if fail_on else ""
    script.write_text('#!/bin/sh\n' + fail + 'while [ $# -gt 0 ]; do\n'
                      '  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi; shift\n'
                      'done\necho "ptxas info    : Used 32 registers"\n')
    script.chmod(0o755)
    return script.parent


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    from ndrustfft_tpu_torch.ops.hopper import _build

    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path)))
    monkeypatch.setenv("NDRUSTFFT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    out = _build.build()
    assert out == _build.library_path() and out.read_text() == "built\n"
    lines = [ln for ln in (out.parent / "nvcc.log").read_text().splitlines()
             if ln.startswith(str(tmp_path))]
    cu = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert sorted(ln.split()[-1].rsplit("/", 1)[-1] for ln in lines[:-1]) == cu
    assert " -c " in lines[0] and " -shared " in lines[-1]
    assert sorted(p.name for p in out.parent.iterdir()) == sorted([out.name, "nvcc.log"])


def test_build_failure_names_the_source(monkeypatch, tmp_path):
    from ndrustfft_tpu_torch.ops.hopper import _build

    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path, fail_on="dct_nat.cu")))
    monkeypatch.setenv("NDRUSTFFT_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="dct_nat.cu"):
        _build.build()
    assert not _build.library_path().exists()
