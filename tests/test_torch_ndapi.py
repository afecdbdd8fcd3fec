"""The multi-axis functions (``ndapi.py``: ``fftn`` ... ``idstn``) and the
``_par`` names against the JAX package on the CPU at small sizes: each
function against ``ndrustfft_tpu.ndapi`` on the same inputs (float32 and
complex64, every DCT/DST type, all axes and a subset), the round trips, and
each ``_par`` name as its serial twin.

Tolerance: 5e-6 of max |JAX| in float32 and complex64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import ndapi as ref_ndapi

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api

torch.set_num_threads(1)

TOL = 5e-6
SHAPE = (6, 10, 8)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _complex(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("fn", ["fftn", "ifftn"])
@pytest.mark.parametrize("axes", [None, (2, 0)])
def test_complex_functions_match_the_jax_package(fn, axes):
    x = _complex(SHAPE, 1)
    got = getattr(nd, fn)(torch.from_numpy(x), axes=axes)
    assert got.dtype == torch.complex64
    _close(got, getattr(ref_ndapi, fn)(jnp.asarray(x), axes=axes))


@pytest.mark.parametrize("axes", [None, (0, 1), (2, 1)])
def test_real_functions_match_the_jax_package(axes):
    x = _real(SHAPE, 2)
    spec = nd.rfftn(torch.from_numpy(x), axes=axes)
    ref_spec = ref_ndapi.rfftn(jnp.asarray(x), axes=axes)
    _close(spec, ref_spec)
    back = nd.irfftn(spec, axes=axes)
    _close(back, ref_ndapi.irfftn(ref_spec, axes=axes))
    _close(back, x, 2e-6)


def test_irfftn_odd_last_length():
    x = _real((6, 9), 3)
    spec = nd.rfftn(torch.from_numpy(x))
    _close(nd.irfftn(spec, n_last=9), ref_ndapi.irfftn(jnp.asarray(spec.numpy()), n_last=9))
    _close(nd.irfftn(spec, n_last=9), x, 2e-6)


@pytest.mark.parametrize("family", ["dct", "dst"])
@pytest.mark.parametrize("t", [1, 2, 3, 4])
@pytest.mark.parametrize("axes", [None, (1,), (2, 0)])
def test_r2r_functions_match_the_jax_package(family, t, axes):
    x = _real(SHAPE, 10 * t + (family == "dst"))
    fwd = getattr(nd, f"{family}n")(torch.from_numpy(x), t, axes=axes)
    ref_fwd = getattr(ref_ndapi, f"{family}n")(jnp.asarray(x), t, axes=axes)
    assert fwd.dtype == torch.float32
    _close(fwd, ref_fwd)
    inv = getattr(nd, f"i{family}n")(fwd, t, axes=axes)
    _close(inv, getattr(ref_ndapi, f"i{family}n")(ref_fwd, t, axes=axes))
    _close(inv, x, 2e-6)


def test_r2r_functions_take_their_kernels_along_a_middle_axis():
    """dstn/idstn of type 1 at 255 along axis 0 take kernel 18's route, as
    nddst1 does; the inverse folds 1/(2 (n + 1)) into the handler."""
    x = _real((255, 128), 4)
    assert api._route("dst1", x.shape, 0, torch.float32, "cuda") == api.R2C_PACKED_MID
    fwd = nd.dstn(torch.from_numpy(x), 1, axes=(0,))
    _close(fwd, ref_ndapi.dstn(jnp.asarray(x), 1, axes=(0,)))
    _close(nd.idstn(fwd, 1, axes=(0,)), x, 2e-6)


@pytest.mark.parametrize("name", ["ndfft", "ndifft", "ndfft_r2c", "ndifft_r2c",
                                  "nddct1", "nddct2", "nddct3", "nddct4",
                                  "nddst1", "nddst2", "nddst3", "nddst4"])
def test_par_names_are_the_serial_functions(name):
    assert getattr(nd, f"{name}_par") is getattr(nd, name)
    assert getattr(api, f"{name}_par") is getattr(api, name)
    assert f"{name}_par" in nd.__all__


def test_non_tensor_input_needs_a_card():
    """A list goes to the CUDA device, as in the per-axis functions; without
    a card that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        nd.dctn([[1.0, 2.0], [3.0, 4.0]])
