"""DST-I, DCT-I, DCT-IV and DST-IV along a middle axis through the public
functions (kernels 18, 19 and 28; their plain versions on the CPU) against
the JAX package, whose Pallas kernels run in interpret mode:

* ``nddst1``, ``nddct1``, ``nddct4`` and ``nddst4`` along axis 0 and along
  axis 1 of a 3-D input under the four normalization kinds, each case
  asserting the route it takes on a CUDA tensor (``api._route``);
* the slice as a whole: a 3-D Dirichlet Poisson solve at 255 x 255 x 127
  (``dstn``/``idstn``: kernel 18 on axis 0; axis 1 has 127 < 128 columns
  and moves, as in the JAX package, so kernel 15 takes it and axis 2) and
  a 2-D vertex-centred Neumann solve at 1153 x 256 (``dctn``/``idctn`` of
  type 1: kernel 19 on axis 0), against the JAX package's ``ndapi`` and the
  analytic solutions;
* the route sweep over n = 2 ... 65536: no DST-I, DCT-I, DCT-IV or DST-IV
  along a middle axis raises K18, K19 or K28, and exactly the 96 lengths
  40960 < n <= 65536 take K28's long form.

Tolerance: 5e-6 of max |JAX| in float32; 1e-5 of the analytic solution.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import ndrustfft_tpu as ref
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import ndapi as ref_ndapi

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch import api

torch.set_num_threads(1)

TOL = 5e-6
F32 = torch.float32


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
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _norms(mod):
    """The four normalization kinds of the package ``mod`` (the port or the
    JAX package), in one order."""
    return {"default": mod.Normalization.DEFAULT, "none": mod.Normalization.NONE,
            "scalar": mod.Normalization.scalar(0.25),
            "custom": mod.Normalization.custom(lambda a: a * 3.0)}


# kind -> (n, the route along a middle axis)
_CASES = {"dst1": (255, api.R2C_PACKED_MID), "dct1": (1153, api.DCT1_MID),
          "dct4": (1280, api.DCT4_MID), "dst4": (1536, api.DCT4_MID)}


@pytest.mark.parametrize("kind", list(_CASES))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("norm", ["default", "none", "scalar", "custom"])
def test_public_functions_match_the_jax_package(kind, axis, norm):
    n, route = _CASES[kind]
    shape = (n, 4, 32) if axis == 0 else (2, n, 128)
    assert api._route(kind, shape, axis, F32, "cuda") == route
    x = _real(shape, n + axis)
    family, t = kind[:3], int(kind[3])
    handler_cls = nd.DctHandler if family == "dct" else nd.DstHandler
    ref_cls = ref.DctHandler if family == "dct" else ref.DstHandler
    got = getattr(nd, f"nd{kind}")(torch.from_numpy(x),
                                   handler_cls(n).normalization(_norms(nd)[norm]), axis=axis)
    want = getattr(ref, f"nd{kind}")(jnp.asarray(x),
                                     ref_cls(n).normalization(_norms(ref)[norm]), axis=axis)
    assert got.dtype == F32 and got.shape == shape
    _close(got, want)


def _sines(modes, grid):
    """sum amp sin(a pi x) sin(b pi y) sin(c pi z) on the interior points
    x_j = (j + 1) / (n + 1) of each axis (float64)."""
    pts = [np.arange(1, m + 1) / (m + 1) for m in grid]
    out = np.zeros(grid)
    for a, b, c, amp in modes:
        out += (amp * np.sin(a * np.pi * pts[0])[:, None, None]
                * np.sin(b * np.pi * pts[1])[None, :, None]
                * np.sin(c * np.pi * pts[2])[None, None, :])
    return out


def test_dirichlet_solve_matches_jax_and_the_analytic_solution():
    """-lap_h u = f on the 255 x 255 x 127 interior of a 256 x 256 x 128
    grid (unit cube, h_i = 1/(n_i + 1)): u is a sum of DST-I modes, f its
    discrete Laplacian, so the spectral solve returns u to roundoff."""
    grid = (255, 255, 127)
    assert [api._route("dst1", grid, a, F32, "cuda") for a in range(3)] == \
        [api.R2C_PACKED_MID, api.R2C_PACKED, api.R2C_PACKED]
    modes = ((1, 2, 3, 1.0), (5, 3, 2, 0.5), (40, 7, 60, 0.25))

    def lam(k, m):
        return (2 - 2 * np.cos(np.pi * k / (m + 1))) * (m + 1) ** 2

    u = _sines(modes, grid)
    f = np.zeros(grid)
    for a, b, c, amp in modes:
        f += _sines(((a, b, c, amp * (lam(a, 255) + lam(b, 255) + lam(c, 127))),),
                    grid)
    f32 = f.astype(np.float32)
    k = [np.arange(1, m + 1) for m in grid]
    lam3 = (lam(k[0], 255)[:, None, None] + lam(k[1], 255)[None, :, None]
            + lam(k[2], 127)[None, None, :]).astype(np.float32)
    fh = nd.dstn(torch.from_numpy(f32), 1)
    got = nd.idstn(fh / torch.from_numpy(lam3), 1)
    want = ref_ndapi.idstn(ref_ndapi.dstn(jnp.asarray(f32), 1) / jnp.asarray(lam3), 1)
    _close(got, want)
    _close(got, u, 1e-5)
    # the forward spectrum is exactly sparse: (n_i + 1) per axis per mode
    spec = np.zeros(grid)
    for a, b, c, amp in modes:
        spec[a - 1, b - 1, c - 1] = (amp * (lam(a, 255) + lam(b, 255) + lam(c, 127))
                                     * 256 * 256 * 128)
    _close(fh, spec, 1e-5)


def test_neumann_solve_matches_jax_and_the_analytic_solution():
    """-lap_h u = f on the 1153 x 256 vertices of [0, 1]^2 with Neumann
    walls (h_i = 1/(n_i - 1)): u a sum of DCT-I modes with zero mean, the
    zero mode of the solution pinned to 0."""
    n0, n1 = 1153, 256
    assert api._route("dct1", (n0, n1), 0, F32, "cuda") == api.DCT1_MID
    x0, x1 = np.arange(n0) / (n0 - 1), np.arange(n1) / (n1 - 1)
    modes = ((3, 5, 1.0), (200, 17, 0.5))

    def lam(k, m):
        return (2 - 2 * np.cos(np.pi * k / (m - 1))) * (m - 1) ** 2

    u = sum(amp * np.cos(a * np.pi * x0)[:, None] * np.cos(b * np.pi * x1)[None, :]
            for a, b, amp in modes)
    f = sum(amp * (lam(a, n0) + lam(b, n1)) * np.cos(a * np.pi * x0)[:, None]
            * np.cos(b * np.pi * x1)[None, :] for a, b, amp in modes).astype(np.float32)
    lam2 = (lam(np.arange(n0), n0)[:, None] + lam(np.arange(n1), n1)[None, :])
    lam2[0, 0] = np.inf
    lam2 = lam2.astype(np.float32)
    got = nd.idctn(nd.dctn(torch.from_numpy(f), 1) / torch.from_numpy(lam2), 1)
    want = ref_ndapi.idctn(ref_ndapi.dctn(jnp.asarray(f), 1) / jnp.asarray(lam2), 1)
    _close(got, want)
    _close(got, u, 1e-5)


@pytest.mark.parametrize("kind,route,count", [
    ("dst1", api.R2C_PACKED_MID, 153), ("dct1", api.DCT1_MID, 146),
    ("dct4", api.DCT4_MID, 252), ("dst4", api.DCT4_MID, 252)])
def test_no_middle_axis_length_raises_k18_k19_or_k28(kind, route, count):
    """Over n = 2 ... 65536 along axis 0 of (n, 128) nothing raises: DST-I
    takes K18 at n = 128 F - 1 (F = 2 ... 160 with a plan), DCT-I K19 at
    n = 128 F + 1 (F = 9 ... 160 with a plan), DCT-IV and DST-IV K28 at
    n = 256 F (F = 5 ... 256; F > 160 is the long form, which raised
    dct4_long before it was ported)."""
    got, long_ = 0, []
    for n in range(2, 65537):
        r = api._route(kind, (n, 128), 0, F32, "cuda")
        got += r == route
        if r == api.DCT4_MID and n > 40960:
            long_.append(n)
    assert got == count
    assert long_ == ([256 * f for f in range(161, 257)] if kind in ("dct4", "dst4") else [])
