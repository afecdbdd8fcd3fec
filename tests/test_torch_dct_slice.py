"""The DCT/DST family through the public functions: ndrustfft_tpu_torch
against ndrustfft_tpu on the CPU, on every axis of small 2-D and 3-D shapes
(the kernels' plain versions where the port routes to a kernel, the torch
engine elsewhere), with every normalization, handlers converted with
from_reference, the error strings, a 16^3 Neumann Poisson solve, and the
rule that a non-tensor input goes to the CUDA device.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32, 1e-12 in float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref

import ndrustfft_tpu_torch as port
from ndrustfft_tpu_torch import api

torch.set_num_threads(1)

TOL = {np.float32: 5e-6, np.float64: 1e-12}
FNS = [f"nd{fam}{t}" for fam in ("dct", "dst") for t in (1, 2, 3, 4)]


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _rand(shape, seed, dtype):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,axis", [((12, 10), 0), ((12, 10), 1), ((4, 6, 5), 0),
                                        ((4, 6, 5), 1), ((4, 6, 5), 2)])
@pytest.mark.parametrize("name", FNS)
def test_small_shapes_every_axis_match_reference(name, shape, axis, dtype):
    x = _rand(shape, sum(shape) + axis, dtype)
    _close(getattr(port, name)(torch.from_numpy(x), axis=axis),
           getattr(ref, name)(jnp.asarray(x), axis=axis), TOL[dtype])


# float32 shapes whose port routes on the CPU run the kernels' plain
# versions: the dense DCT along a middle axis of (3, 129, 128) with DST-I's
# packed R2C (K15, h = 130) on the moved axis, and DCT-II/III of 130 rows of
# 512 with DCT-IV's C2C on K10; DCT-I and DST-I of rows of 512 take kernel
# 15's generic schedule (h = 511 and 513, no split)
_ROUTES = {(3, 129, 128): {**dict.fromkeys(["dct1", "dct2", "dct3", "dct4", "dst2",
                                            "dst3", "dst4"], api.DCT_DENSE_MID),
                           "dst1": api.R2C_PACKED},
           (130, 512): {"dct1": api.R2C_PACKED, "dst1": api.R2C_PACKED,
                        "dct2": api.DCT2_NAT, "dst2": api.DCT2_NAT,
                        "dct3": api.DCT3_NAT, "dst3": api.DCT3_NAT,
                        "dct4": api.DCT_LANE, "dst4": api.DCT_LANE}}


@pytest.mark.parametrize("shape,axis", [((3, 129, 128), 1), ((130, 512), 1)])
@pytest.mark.parametrize("name", FNS)
def test_kernel_routes_match_reference(name, shape, axis):
    want_route = _ROUTES[shape].get(name[2:], api.ENGINE)
    assert api._route(name[2:], shape, axis, torch.float32, "cpu") == want_route
    x = _rand(shape, len(name), np.float32)
    _close(getattr(port, name)(torch.from_numpy(x), axis=axis),
           getattr(ref, name)(jnp.asarray(x), axis=axis), TOL[np.float32])


_custom_fn = lambda v: v * 0.25 + 1.0   # noqa: E731  (not linear: order matters)


@pytest.mark.parametrize("norm", ["none", "default", "scalar", "custom"])
@pytest.mark.parametrize("name", FNS)
def test_every_normalization_matches_reference(name, norm):
    rnorm = {"none": ref.Normalization.NONE, "default": ref.Normalization.DEFAULT,
             "scalar": ref.Normalization.scalar(0.3),
             "custom": ref.Normalization.custom(_custom_fn)}[norm]
    rcls = ref.DctHandler if "dct" in name else ref.DstHandler
    pcls = port.DctHandler if "dct" in name else port.DstHandler
    rh = rcls(129).normalization(rnorm)
    ph = pcls.from_reference(rh)
    assert type(ph) is pcls and ph.n == 129 and ph.norm.kind == norm
    x = _rand((3, 129, 128), 7, np.float32)
    _close(getattr(port, name)(torch.from_numpy(x), ph, axis=1),
           getattr(ref, name)(jnp.asarray(x), rh, axis=1), TOL[np.float32])
    x64 = _rand((6, 9), 8, np.float64)
    rh9 = rcls(9).normalization(rnorm)
    _close(getattr(port, name)(torch.from_numpy(x64), pcls.from_reference(rh9), axis=1),
           getattr(ref, name)(jnp.asarray(x64), rh9, axis=1), TOL[np.float64])


@pytest.mark.parametrize("family", ["dct", "dst"])
def test_error_messages_match_reference(family):
    x = np.zeros((8, 6), np.float32)
    rcls = getattr(ref, f"{family.capitalize()}Handler")
    pcls = getattr(port, f"{family.capitalize()}Handler")
    rfn, pfn = getattr(ref, f"nd{family}2"), getattr(port, f"nd{family}2")
    with pytest.raises(ValueError) as want:
        rfn(jnp.asarray(x), rcls(5), axis=1)
    with pytest.raises(ValueError) as got:
        pfn(torch.from_numpy(x), pcls(5), axis=1)
    assert str(got.value) == str(want.value) == f"Size mismatch in {family}, got 6 expected 5"
    with pytest.raises(TypeError, match=f"nd{family} expects a real input array"):
        pfn(torch.zeros(4, 6, dtype=torch.complex64), axis=1)


def test_dct1_length_one_raises_the_reference_message():
    with pytest.raises(ValueError) as want:
        ref.nddct1(jnp.ones((4, 1)), axis=1)
    with pytest.raises(ValueError) as got:
        port.nddct1(torch.ones(4, 1), axis=1)
    assert str(got.value) == str(want.value) == "DCT-I requires length >= 2, got 1"


def _neumann_solve(m, fns, handlers, tensor, n):
    """-lap u = f spectrally on n^3 cell centres, as a user composes it:
    DCT-II on axes 2, 1, 0; divide by pi^2 |k|^2 (zero mode 0); DCT-III back."""
    dct2, dct3 = fns
    hf, hi = handlers
    k2 = (np.arange(n) * np.pi) ** 2
    lam = k2[:, None, None] + k2[None, :, None] + k2[None, None, :]
    inv = np.where(lam > 0, 1.0 / np.where(lam > 0, lam, 1.0), 0.0).astype(np.float32)
    fh = dct2(dct2(dct2(m, hf, axis=2), hf, axis=1), hf, axis=0)
    uh = fh * tensor(inv)
    return dct3(dct3(dct3(uh, hi, axis=0), hi, axis=1), hi, axis=2)


def test_neumann_poisson_16_cubed_matches_reference():
    n = 16
    xc = (np.arange(n) + 0.5) / n
    u = np.cos(np.pi * xc)[:, None, None] * np.cos(2 * np.pi * xc)[None, :, None] \
        * np.cos(3 * np.pi * xc)[None, None, :]
    f = (np.pi ** 2 * 14 * u).astype(np.float32)
    rh = ref.DctHandler(n)
    rhi = rh.normalization(ref.Normalization.scalar(1.0 / n))
    want = _neumann_solve(jnp.asarray(f), (ref.nddct2, ref.nddct3), (rh, rhi),
                          jnp.asarray, n)
    got = _neumann_solve(torch.from_numpy(f), (port.nddct2, port.nddct3),
                         (port.DctHandler.from_reference(rh),
                          port.DctHandler.from_reference(rhi)), torch.from_numpy, n)
    _close(got, want, TOL[np.float32])
    assert np.abs(got.numpy() - u).max() <= 1e-5


def test_non_tensor_input_goes_to_cuda():
    x = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    if torch.cuda.is_available():
        assert port.nddct2(x).device.type == "cuda"
        return
    for fn in (port.nddct2, port.nddst3, port.ndfft, port.ndfft_r2c):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn(x)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.nddct1([1.0, 2.0, 3.0])
    y = port.nddct2(torch.from_numpy(x))
    assert y.device.type == "cpu"
    _close(y, ref.nddct2(jnp.asarray(x)), TOL[np.float32])
