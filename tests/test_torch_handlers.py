"""The handlers' ``warmup`` and the dtype vocabulary of ndrustfft_tpu_torch,
against the JAX package's contract (``ndrustfft_tpu/handlers.py::warmup``,
``ndrustfft_tpu/__init__.py``'s dtype exports), on the CPU.

``warmup(shape, axis, float64, run, device)`` runs every kind a handler
serves, forward and inverse (an R2C handler's inverse on ``m`` bins), once
on zeros of ``shape`` when ``run`` is true; on a CPU device with
``run=False`` it runs nothing. Both modes count no kernel launch on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api, handlers
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

# handler, its length, the forward input's shape and axis, and the public
# functions it serves (forward, inverse)
_CASES = {
    "fft": (nd.FftHandler, 600, (2, 600, 130), 1, ("ndfft", "ndifft")),
    "r2c": (nd.R2cFftHandler, 600, (128, 600), 1, ("ndfft_r2c", "ndifft_r2c")),
    "dct": (nd.DctHandler, 256, (256, 130), 0, ("nddct1", "nddct2", "nddct3", "nddct4")),
    "dst": (nd.DstHandler, 256, (128, 256), -1, ("nddst1", "nddst2", "nddst3", "nddst4")),
}


def _record(monkeypatch, names):
    """Wrap each public function in ``names``: calls -> [(name, shape,
    dtype, device, axis)]."""
    calls = []
    for name in names:
        fn = getattr(api, name)

        def wrapped(x, handler=None, axis=-1, _fn=fn, _name=name, **kw):
            calls.append((_name, tuple(x.shape), x.dtype, x.device.type, axis))
            assert not x.any()
            return _fn(x, handler, axis=axis, **kw)

        monkeypatch.setattr(api, name, wrapped)
    return calls


def _launches():
    return {k: v for k, v in handlers._launch_counts().items() if k[1].endswith("launches")}


@pytest.mark.parametrize("run", [True, False])
@pytest.mark.parametrize("kind", sorted(_CASES))
def test_warmup_runs_every_kind_on_zeros(kind, run, monkeypatch):
    cls, n, shape, axis, names = _CASES[kind]
    h = cls(n)
    calls = _record(monkeypatch, names)
    before = _launches()
    assert h.warmup(shape, axis=axis, run=run, device="cpu") is h
    ax = axis % len(shape)
    want = []
    if run:
        for name in names:
            s = list(shape)
            if name == "ndifft_r2c":
                s[ax] = h.m
            cplx = name in ("ndfft", "ndifft", "ndifft_r2c")
            want.append((name, tuple(s), torch.complex64 if cplx else torch.float32, "cpu", ax))
    assert calls == want
    assert _launches() == before        # the plain versions launch nothing


def test_warmup_float64_runs_the_double_kinds(monkeypatch):
    calls = _record(monkeypatch, ("ndfft_r2c", "ndifft_r2c"))
    nd.R2cFftHandler(16).warmup((4, 16), axis=1, float64=True, device="cpu")
    assert [c[1:3] for c in calls] == [((4, 16), torch.float64), ((4, 9), torch.complex128)]


def test_warmup_prepares_the_routes_tables():
    """On the CPU the plain versions build their tables as they run: after
    FftHandler(600).warmup along a middle axis of 130 columns (kernel 6),
    the radix tables of 600 for both signs are in the device-table cache."""
    kfft._WQ_CACHE.clear()
    nd.FftHandler(600).warmup((2, 600, 130), axis=1, device="cpu")
    assert {("radix", 600, s, torch.device("cpu")) for s in (-1, +1)} <= set(kfft._WQ_CACHE)
    nd.FftHandler(1200).warmup((2, 1200, 130), axis=1, run=False, device="cpu")
    assert ("radix", 1200, -1, torch.device("cpu")) not in kfft._WQ_CACHE


def test_warmup_defaults_to_the_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")
    with pytest.raises((RuntimeError, AssertionError)):
        nd.FftHandler(16).warmup((4, 16))


def test_dtype_reexports():
    # the JAX package's dtype vocabulary (tests/test_docs_and_policies.py),
    # as torch dtypes
    assert nd.complex64 is torch.complex64
    assert nd.float64 is torch.float64
    assert nd.complex_dtype(nd.float32) == torch.complex64
    assert nd.complex_dtype(np.float64) == torch.complex128
    assert nd.real_dtype(np.complex128) == torch.float64
    assert nd.real_dtype(np.float32) == torch.float32
    names = ("float32", "float64", "complex64", "complex128", "complex_dtype", "real_dtype")
    assert set(names) <= set(nd.__all__)
    assert "df64" not in nd.__all__


@pytest.mark.parametrize("d", [np.float32, np.float64, np.complex64, np.complex128])
def test_dtype_pairs_match_the_jax_package(d):
    """complex_dtype and real_dtype name the same pair as the JAX package's
    for numpy and torch dtypes alike."""
    t = torch.from_numpy(np.empty(0, d)).dtype
    for arg in (d, t):
        assert nd.complex_dtype(arg) == torch.from_numpy(
            np.empty(0, jnp.dtype(ref.complex_dtype(d)))).dtype
        assert nd.real_dtype(arg) == torch.from_numpy(
            np.empty(0, jnp.dtype(ref.real_dtype(d)))).dtype
