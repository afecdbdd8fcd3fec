"""Kernels 5 and 9 of the JAX package, folded into the port's kernel 1.

The JAX package's ``_kernel_axis_mid_ts`` and ``_kernel_axis_mid_bts``
(kernel 5, reached through ``_build_call_axis_mid(..., mid_body="ts" or
"bts")``) and ``_kernel_axis0`` (kernel 9, ``_build_call_axis0``, the C2C
along axis 0 of (n, cols)) compute the C2C of kernel 1
(``_kernel_axis_mid_bts2``) with other bodies, which only the TPU needed.
The port has no kernel of its own for them: the same function runs on
kernel 1 (``ops/hopper/fft.py::c2c_axis_mid``), kernel 9's (n, cols) as the
(1, n, cols) view. Here each JAX kernel, in interpret mode, is held against
kernel 1's plain version at n = 512, 1024 and 2048, both signs, the inverse
scaled by 1/n.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32.
"""

import numpy as np
import pytest
import torch

from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _input(shape, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal(shape) + 1j * g.standard_normal(shape)).astype(np.complex64)


def _close(got, want_re, want_im):
    want = np.asarray(want_re) + 1j * np.asarray(want_im)
    got = got.numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err


def _scale(sign, n):
    return 1.0 if sign < 0 else 1.0 / n


@pytest.mark.parametrize("body", ["ts", "bts"])
@pytest.mark.parametrize("n", [512, 1024, 2048])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k5_bodies_are_kernel_1(body, n, sign):
    """Kernel 5 (the ts and bts bodies of the middle-axis C2C) against
    kernel 1's plain version on (2, n, 130)."""
    x = _input((2, n, 130), n + (body == "bts"))
    s = _scale(sign, n)
    run = ref_pfft._build_call_axis_mid(n, sign, 2, 130, "float32", True, "highest", s, 0,
                                        body)
    yr, yi = run(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
    _close(kfft.c2c_axis_mid(torch.from_numpy(x), sign, s), yr, yi)


@pytest.mark.parametrize("n", [512, 1024, 2048])
@pytest.mark.parametrize("sign", [-1, +1])
def test_k9_axis0_is_kernel_1(n, sign):
    """Kernel 9 (the C2C along axis 0 of (n, cols)) against kernel 1's
    plain version on the (1, n, cols) view."""
    cols = 256
    x = _input((n, cols), 3 * n)
    s = _scale(sign, n)
    run = ref_pfft._build_call_axis0(n, sign, cols, "float32", True, "highest", s)
    yr, yi = run(np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag))
    got = kfft.c2c_axis_mid(torch.from_numpy(x).reshape(1, n, cols), sign, s)
    _close(got.reshape(n, cols), yr, yi)
