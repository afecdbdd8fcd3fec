"""ndrustfft_tpu_torch plan layer, constants, normalization and handlers
against the JAX package: every constant table must be bit-identical."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ndrustfft_tpu as ref
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import fft as ref_fft

import ndrustfft_tpu_torch as port
from ndrustfft_tpu_torch import plan as port_plan
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

PKG = Path(port.__file__).resolve().parent


@pytest.mark.parametrize("n", [1, 2, 12, 128, 264, 512, 1000, 1024, 2048,
                               4096, 65536, 257, 509, 2 * 131])
def test_factorize_matches_reference(n):
    assert port_plan.factorize(n) == ref_plan.factorize(n, 128)


@pytest.mark.parametrize("f", [2, 3, 8, 16, 128])
@pytest.mark.parametrize("sign", [-1, 1])
def test_dft_matrix_bit_identical(f, sign):
    for a, b in zip(port_plan.dft_matrix(f, sign), ref_plan.dft_matrix(f, sign)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("f,m", [(2, 128), (8, 128), (4, 256), (32, 32)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_stage_twiddle_bit_identical(f, m, sign):
    for a, b in zip(port_plan.stage_twiddle(f, m, sign),
                    ref_plan.stage_twiddle(f, m, sign)):
        assert np.array_equal(a, b)


def test_c2c_plan_stages_bit_identical():
    for n in (1024, 600):
        p, r = port_plan.get_c2c_plan(n, -1), ref_plan.get_c2c_plan(n, -1)
        assert [s[:2] for s in p.stages] == [s[:2] for s in r.stages]
        for a, b in zip(p.base, r.base):
            assert np.array_equal(a, b)


def test_bluestein_plan_not_ported():
    """A length with a prime factor above 128 plans Bluestein's chirp-z (it
    raised before the plan was ported): its tables and sub-FFT length are
    the JAX plan's bit for bit (every length in tests/test_torch_blue.py)."""
    p, r = port_plan.C2CPlan(509, -1), ref_plan.C2CPlan(509, -1)
    assert p.kind == r.kind == "bluestein" and p.M == r.M == 1024
    for name in ("chirp_a", "chirp_b", "H"):
        for a, b in zip(getattr(p, name), getattr(r, name)):
            assert np.array_equal(a, b), name


@pytest.mark.parametrize("n", [256, 512, 1024, 2048])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("scale", ["one", "inv_n", "quarter"])
def test_bts2_consts_bit_identical(n, sign, scale):
    s = {"one": 1.0, "inv_n": 1.0 / n, "quarter": 0.25}[scale]
    consts, (m, f) = ref_fft._bts2_consts(n, sign, np.float32, "highest", s)
    assert (m, f) == (128, n // 128)
    re, im = kfft.bts2_consts(n, sign, s)
    assert re.dtype == np.float32 and re.shape == (f, m, m)
    for q in range(f):
        assert np.array_equal(re[q], consts[2 * q])
        assert np.array_equal(im[q], consts[2 * q + 1])


@pytest.mark.parametrize("n", [512, 1024, 2048])
def test_unpack_twiddle_bit_identical(n):
    k = np.arange(n // 2, dtype=np.int64)
    ur, ui = ref_plan._cis(2 * k, n, -1)
    re, im = krfft.unpack_twiddle(n)
    assert np.array_equal(re, np.asarray(ur, np.float32))
    assert np.array_equal(im, np.asarray(ui, np.float32))


def test_normalization_hash_and_equality():
    N = port.Normalization
    fn = lambda v: v * 2.0  # noqa: E731
    assert N.DEFAULT == N("default") and hash(N.DEFAULT) == hash(N("default"))
    assert N.scalar(0.5) == N.scalar(0.5) and N.scalar(0.5) != N.scalar(0.25)
    assert N.custom(fn) == N.custom(fn) and N.custom(fn) != N.custom(lambda v: v)
    assert repr(N.NONE) == "Normalization.NONE"
    with pytest.raises(ValueError):
        N("bogus")


def test_handlers_from_reference():
    fn = lambda v: v * 3.0  # noqa: E731
    cases = [
        (ref.FftHandler(512), port.FftHandler),
        (ref.R2cFftHandler(512).normalization(ref.Normalization.NONE),
         port.R2cFftHandler),
        (ref.FftHandler(64).normalization(ref.Normalization.scalar(0.5)),
         port.FftHandler),
        (ref.R2cFftHandler(10).normalization(ref.Normalization.custom(fn)),
         port.R2cFftHandler),
    ]
    for h, cls in cases:
        p = cls.from_reference(h)
        assert type(p) is cls and p.n == h.n
        assert p.norm.kind == h.norm.kind and p.norm.value == h.norm.value
        assert p.norm.fn is h.norm.fn
        if cls is port.R2cFftHandler:
            assert p.m == h.m
    a = port.FftHandler(8).normalization(port.Normalization.NONE)
    assert a == port.FftHandler(8).normalization(port.Normalization.NONE)
    assert hash(a) == hash(port.FftHandler(8).normalization(port.Normalization.NONE))
    assert a != port.FftHandler(8)
    with pytest.raises(ValueError):
        port.FftHandler(0)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_package_never_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "ndrustfft_tpu"), (path, mod)
    code = ("import sys, ndrustfft_tpu_torch, ndrustfft_tpu_torch.ops.hopper.rfft; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ndrustfft_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(PKG.parent), timeout=120)


def test_chip_smoke_never_imports_jax():
    mods = list(_imports(PKG.parent / "chip_smoke.py"))
    assert "torch" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "ndrustfft_tpu")]
