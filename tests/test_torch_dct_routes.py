"""ndrustfft_tpu_torch.api._route for the DCT and DST kinds: which kernel
each call takes on a CUDA tensor (none raises), and the gates against the
JAX package's own gate functions.
_route is pure, so no card and no memory is needed."""

import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu import plan as ref_plan
from ndrustfft_tpu.ops.pallas import dct as ref_pdct
from ndrustfft_tpu.ops.pallas import fft as ref_pfft
from ndrustfft_tpu.ops.pallas import rfft as ref_prfft

from ndrustfft_tpu_torch import api

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("kind,shape,axis,want", [
    # the reference's dct2d grid: DCT-I along axis 0 of n x n
    ("dct1", (129, 129), 0, api.DCT_DENSE_MID),
    ("dct1", (265, 265), 0, api.DCT_DENSE_MID),
    ("dct1", (513, 513), 0, api.DCT_DENSE_MID),
    ("dct1", (1025, 1025), 0, api.DCT_DENSE_MID),
    # the 1024^2 DCT-II/III and DST-II/III pairs, DCT-IV along axis 0
    ("dct2", (1024, 1024), 1, api.DCT2_NAT),
    ("dct2", (1024, 1024), 0, api.DCT_DENSE_MID),
    ("dct3", (1024, 1024), 0, api.DCT_DENSE_MID),
    ("dct3", (1024, 1024), -1, api.DCT3_NAT),
    ("dct4", (1024, 1024), 0, api.DCT_DENSE_MID),
    ("dst2", (1024, 1024), 1, api.DCT2_NAT),
    ("dst3", (1024, 1024), 0, api.DCT_DENSE_MID),
    ("dst4", (1024, 1024), 0, api.DCT_DENSE_MID),
    # every leg of the 512^3 Neumann solve
    ("dct2", (512, 512, 512), 2, api.DCT2_NAT),
    ("dct2", (512, 512, 512), 1, api.DCT_DENSE_MID),
    ("dct2", (512, 512, 512), 0, api.DCT_DENSE_MID),
    ("dct3", (512, 512, 512), 0, api.DCT_DENSE_MID),
    ("dct3", (512, 512, 512), 1, api.DCT_DENSE_MID),
    ("dct3", (512, 512, 512), 2, api.DCT3_NAT),
    # the kernels' other sizes: n = 2 and odd n dense, K23/K24 at 256 and 4096
    ("dct4", (2, 128), 0, api.DCT_DENSE_MID),
    ("dct1", (3, 1100, 128), 1, api.DCT_DENSE_MID),
    ("dct2", (128, 256), 1, api.DCT2_NAT),
    ("dst3", (200, 4096), 1, api.DCT3_NAT),
    # a middle axis with cols < 128 moves the axis last, as the JAX package does
    ("dct2", (200, 512, 64), 1, api.DCT2_NAT),
    # what the JAX package leaves to XLA runs the torch engine
    ("dct2", (100, 512), 1, api.ENGINE),          # batch < 128
    ("dct4", (60, 512), 1, api.ENGINE),            # 2 * 60 rows < 128
    ("dct1", (100, 5), 1, api.ENGINE),
    ("dct1", (4, 1), 1, api.ENGINE),               # n = 1: the lowering raises
    ("dct3", (300, 1), 1, api.ENGINE),
    ("dct2", (512, 100), 0, api.ENGINE),           # cols < 128 and batch < 128
    ("dst1", (100, 12), 1, api.ENGINE),
    # the lane lowerings on K15, K10 and K8
    ("dct1", (256, 513), 1, api.R2C_PACKED),                   # h = 512: the core, F = 4
    ("dst1", (256, 511), 1, api.R2C_PACKED),
    ("dct1", (256, 1025), 1, api.R2C_PACKED),                  # h = 1024
    ("dct1", (256, 130), 1, api.R2C_PACKED),                   # h = 129: the dense product
    ("dst1", (3, 129, 128), 1, api.R2C_PACKED),                # mid without K18: axis moves
    ("dct4", (64, 1024), 1, api.DCT_LANE),                 # K10 on 2 * 64 rows
    ("dct3", (256, 200), 1, api.DCT_LANE),                 # K8
    ("dct2", (256, 300), 1, api.R2C_PACKED),                   # r2c of even n
    ("dst2", (256, 129), 1, api.R2C_ROWPAIR),                  # odd: row pairs
    # the generic schedule: the DCT-IV composite on K6 (m = 600), K15 at
    # h = 264 and 600, K8 inside DCT-IV (2 * 64 rows) and the row pairs
    ("dst4", (1200, 128), 0, api.DCT4_HALF_MID),
    ("dct1", (256, 265), 1, api.R2C_PACKED),
    ("dct2", (256, 1200), 1, api.R2C_PACKED),
    ("dct4", (64, 1000), 1, api.DCT_LANE),
    ("dct2", (256, 301), 1, api.R2C_ROWPAIR),
    ("dct2", (1200, 1100), 0, api.R2C_PACKED),                 # mid, n > 1100: axis moves
    ("dct1", (256, 385), 1, api.R2C_PACKED),                   # h = 384: the wide core, F = 3
    # DCT-II/III (and DST-II/III) along a middle axis above K27's cap: K25/K26
    # on the fixed core (2048, 4096) and in the n-point form (1152)
    ("dct2", (2048, 128), 0, api.DCT2_MID),
    ("dst2", (1152, 200), 0, api.DCT2_MID),
    ("dct3", (4096, 128), 0, api.DCT3_MID),
    # K23/K24 beyond the fixed core's half lengths: the n-point form (384 and
    # 128, odd k) and the wide core's half length (8192: h = 4096, F = 32)
    ("dct2", (128, 384), 1, api.DCT2_NAT),
    ("dct3", (128, 128), 1, api.DCT3_NAT),
    ("dct2", (128, 8192), 1, api.DCT2_NAT),
    # along a middle axis above K27's cap: DCT-I on K19 (the wide core at
    # 1153, the fixed one at 2049), DST-I on K18 (h = 1024), DCT-IV on K28
    ("dct1", (1153, 128), 0, api.DCT1_MID),
    ("dct1", (2049, 256), 0, api.DCT1_MID),
    ("dst1", (1023, 128), 0, api.R2C_PACKED_MID),
    ("dct4", (2048, 128), 0, api.DCT4_MID),
])
def test_route_on_cuda(kind, shape, axis, want):
    assert api._route(kind, shape, axis, F32, "cuda") == want


@pytest.mark.parametrize("kind", [f"{f}{t}" for f in ("dct", "dst") for t in (1, 2, 3, 4)])
def test_float64_takes_the_engine(kind):
    assert api._route(kind, (1024, 1024), 0, F64, "cuda") == api.ENGINE
    assert api._route(kind, (1024, 1024), 1, F64, "cuda") == api.ENGINE


@pytest.mark.parametrize("kind,shape,axis,want", [
    # Bluestein lengths, which raised K12 and K11 before they were ported:
    # the chirp-z DCT-II/III along a middle axis (K12), the DCT-IV composite
    # at a prime half length (its C2C on K11), the lane's chirp-z (K10)
    ("dct2", (2053, 128), 0, api.DCT23_BLUE_MID),
    ("dct3", (1109, 128), 0, api.DCT23_BLUE_MID),
    # K28's long form, n = 256 * F with F > 160 (it raised dct4_long before
    # that form was ported)
    ("dct4", (256 * 161, 128), 0, api.DCT4_MID),
    ("dst4", (65536, 128), 0, api.DCT4_MID),
    ("dct4", (2 * 1031, 128), 0, api.DCT4_HALF_MID),                  # composite, m prime
    # the n-point form on the real tile: n = 128 * k, odd k > 160 (it raised
    # dct23_long before the long form was ported)
    ("dct2", (128, 128 * 161), 1, api.DCT2_NAT),
    ("dst3", (128, 128 * 255), 1, api.DCT3_NAT),
    ("dct3", (128 * 161, 128), 0, api.DCT3_MID),
    ("dct4", (256, 32768), 1, api.DCT_LANE),      # four-step (K7/K13, ported)
    ("dct3", (256, 263), 1, api.BLUESTEIN_LANE),                    # Bluestein n
])
def test_unported_route_raises_on_cuda(kind, shape, axis, want):
    """The routes that raised on a CUDA tensor while their kernels were not
    ported: each is now a route name, the same on both devices."""
    assert api._route(kind, shape, axis, F32, "cuda") == want
    assert api._route(kind, shape, axis, F32, "cpu") == want


def test_dct_routes_never_take_the_fft_kernels():
    """K1-K3 serve no DCT/DST route: every length whose DCT route would
    reach them takes K23-K26/K28 first (api._dct_lane, _route_r2r). The
    lane lowerings reach K15, K10 and K8, the DCT-IV composite K6 (K11 at a
    Bluestein half length), the middle-axis DST-I, DCT-I and DCT-IV K18, K19
    and K28, and a Bluestein length K12 or the lane's chirp-z, under their
    own route names."""
    for n in range(2, 5000, 3):
        for kind in ("dct1", "dct2", "dct3", "dct4", "dst1"):
            for shape, axis in (((n, 256), 0), ((256, n), 1)):
                route = api._route(kind, shape, axis, F32, "cuda")
                assert route in (api.DCT_DENSE_MID, api.DCT2_NAT, api.DCT3_NAT,
                                 api.DCT2_MID, api.DCT3_MID, api.DCT4_HALF_MID, api.R2C_PACKED, api.R2C_ROWPAIR,
                                 api.DCT_LANE, api.R2C_PACKED_MID, api.DCT1_MID,
                                 api.DCT4_MID, api.DCT23_BLUE_MID, api.BLUESTEIN_LANE,
                                 api.ENGINE), (kind, shape, axis, route)


@pytest.fixture
def _jax_gates():
    old = ref_config.pallas_interpret
    ref_config.pallas_interpret = True   # the gates' backend test passes on the CPU
    yield
    ref_config.pallas_interpret = old


def test_gates_match_the_jax_package(_jax_gates):
    f32 = jnp.float32
    for n in list(range(2, 1300)) + [2048, 2049, 2053, 4096, 4097, 8192, 16384, 32768,
                                     32770, 65536]:
        assert (n % 2 == 0 and api._ts_ok(n)) == ref_pdct.dct_pallas_supported(n, f32), n
        if n >= 4 and n % 2 == 0:
            assert api._ts_ok(n // 2) == ref_pdct.dct4_mid_supported(n, f32), n
        assert (2 <= n <= api._DENSE_DCT_MAX) == ref_pdct.dct_dense_mid_supported(n, f32)
        want_k19 = ref_prfft.dct1_mid_supported(n, f32)
        assert (n % 2 == 1 and n >= 5 and api._nat_f(2 * (n - 1)) is not None) == want_k19
        plan = ref_plan.get_c2c_plan(n, -1)
        if plan.kind == "bluestein":
            assert api._blue_mid_ok(n) == ref_pfft.blue_mid_supported(plan, f32), n
        else:
            assert api._kernel_ok(n) == ref_pfft.pallas_supported(plan, f32), n
