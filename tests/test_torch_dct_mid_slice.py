"""DCT-II/III and DST-II/III along a middle axis above K27's cap (kernels
25/26) and along the last axis at the lengths kernels 23/24 newly take,
through the public functions: ndrustfft_tpu_torch against ndrustfft_tpu
(Pallas kernels in interpret mode, "highest" tier) on the CPU, where the
port's kernel routes run their plain versions:

* nddct2 / nddct3 / nddst2 / nddst3 along axis 0 of (1152, 128), (1280, 130)
  (ragged columns) and (2048, 128), and along axis 1 of (2, 1152, 128),
  under the four normalizations (none, Default, scalar, custom): the
  DCT-II kinds on kernel 25's radix column tile, the DCT-III kinds on
  kernel 26's (the lengths of its n-point form, the wide core's half
  length and the fixed core until they moved there);
* the slice as a whole: 2-D Neumann Poisson solves at 1152 x 384 and
  1280 x 768 (K25, K26, K23 and K24 on the radix cores; K26's n-point and
  wide forms before), against the JAX package and the analytic solution.

Each case asserts its route on a CUDA tensor (api._route) and the form its
kernel launches there (dct.py::launch_form). Tolerance:
max |port - JAX| <= 5e-6 * max |JAX| in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.api import _jitted

import ndrustfft_tpu_torch as port
from ndrustfft_tpu_torch import api
from ndrustfft_tpu_torch.ops import engine
from ndrustfft_tpu_torch.ops.hopper import dct as kdct

torch.set_num_threads(1)

TOL = 5e-6
F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    _jitted.cache_clear()
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old
    _jitted.cache_clear()


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape):
    return np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)


_custom_fn = lambda v: v * 0.25 + 1.0   # noqa: E731  (not linear: order matters)


def _norm(norm):
    return {"none": ref.Normalization.NONE, "default": ref.Normalization.DEFAULT,
            "scalar": ref.Normalization.scalar(0.3),
            "custom": ref.Normalization.custom(_custom_fn)}[norm]


@pytest.mark.parametrize("shape,axis,form", [((1152, 128), 0, "npoint"),
                                             ((1280, 130), 0, "half"),
                                             ((2048, 128), 0, "half"),
                                             ((2, 1152, 128), 1, "npoint")])
@pytest.mark.parametrize("name", ["nddct2", "nddct3", "nddst2", "nddst3"])
@pytest.mark.parametrize("norm", ["none", "default", "scalar", "custom"])
def test_mid_matches_reference(shape, axis, form, name, norm):
    n = shape[axis]
    route = api.DCT2_MID if name[-1] == "2" else api.DCT3_MID
    for device_type in ("cpu", "cuda"):
        assert api._route(name[2:], shape, axis, F32, device_type) == route
    assert kdct.dct_form(n)[0] == form
    type3 = route == api.DCT3_MID
    assert kdct.launch_form(n, type3, False) == "radix"
    rcls = ref.DctHandler if "dct" in name else ref.DstHandler
    pcls = port.DctHandler if "dct" in name else port.DstHandler
    rh = rcls(n).normalization(_norm(norm))
    ph = pcls.from_reference(rh)
    x = _real(shape)
    kern = kdct.dct2_mid if route == api.DCT2_MID else kdct.dct3_mid
    counts = engine.c2c.calls, kern.launches
    got = getattr(port, name)(torch.from_numpy(x), ph, axis=axis)
    _close(got, getattr(ref, name)(jnp.asarray(x), rh, axis=axis))
    # a CPU tensor: the kernel's plain version, no launch, no engine
    assert (engine.c2c.calls, kern.launches) == counts


def _neumann_2d(mod, f, handlers):
    """-lap u = f on n0 x n1 cell centres, as a user composes it: DCT-II on
    axes 1 and 0, divide by pi^2 |k|^2 (zero mode 0), DCT-III back."""
    hf0, hf1, hi0, hi1 = handlers
    n0, n1 = f.shape
    k0 = (np.arange(n0) * np.pi) ** 2
    k1 = (np.arange(n1) * np.pi) ** 2
    lam = k0[:, None] + k1[None, :]
    inv = np.where(lam > 0, 1.0 / np.where(lam > 0, lam, 1.0), 0.0).astype(np.float32)
    tensor = torch.from_numpy if mod is port else jnp.asarray
    fh = mod.nddct2(mod.nddct2(f, hf1, axis=1), hf0, axis=0)
    return fh, mod.nddct3(mod.nddct3(fh * tensor(inv), hi0, axis=0), hi1, axis=1)


@pytest.mark.parametrize("shape,routes", [
    ((1152, 384), ("radix", "radix")),      # K26 at the n-point form's length; all radix
    ((1280, 768), ("radix", "radix")),      # K26 at the wide core's half length; all radix
])
def test_neumann_2d_matches_reference(shape, routes):
    n0, n1 = shape
    assert (kdct.launch_form(n0, True, False), kdct.launch_form(n1, True, True)) == routes
    assert kdct.launch_form(n0, False, False) == kdct.launch_form(n1, False, True) == "radix"
    for kind, r0, r1 in (("dct2", api.DCT2_MID, api.DCT2_NAT),
                         ("dct3", api.DCT3_MID, api.DCT3_NAT)):
        assert api._route(kind, shape, 0, F32, "cuda") == r0
        assert api._route(kind, shape, 1, F32, "cuda") == r1
    x0 = (np.arange(n0) + 0.5) / n0
    x1 = (np.arange(n1) + 0.5) / n1
    u = np.cos(3 * np.pi * x0)[:, None] * np.cos(5 * np.pi * x1)[None, :] \
        + 0.5 * np.cos(7 * np.pi * x0)[:, None] * np.cos(2 * np.pi * x1)[None, :]
    f = (np.pi ** 2 * (34 * np.cos(3 * np.pi * x0)[:, None] * np.cos(5 * np.pi * x1)[None, :]
                       + 0.5 * 53 * np.cos(7 * np.pi * x0)[:, None]
                       * np.cos(2 * np.pi * x1)[None, :])).astype(np.float32)
    rhs = []
    for n in shape:
        h = ref.DctHandler(n)
        rhs.append((h, h.normalization(ref.Normalization.scalar(1.0 / n))))
    rh = (rhs[0][0], rhs[1][0], rhs[0][1], rhs[1][1])
    ph = tuple(port.DctHandler.from_reference(h) for h in rh)
    calls = engine.c2c.calls
    want_fh, want = _neumann_2d(ref, jnp.asarray(f), rh)
    got_fh, got = _neumann_2d(port, torch.from_numpy(f), ph)
    assert engine.c2c.calls == calls
    _close(got_fh, want_fh)
    _close(got, want)
    assert np.abs(got.numpy() - u).max() <= 1e-5 * np.abs(u).max()
