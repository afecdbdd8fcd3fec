"""ndrustfft_tpu_torch.api._route: which kernel each call takes on a CUDA
tensor. _route is pure, so no card and no memory is needed."""

import pytest
import torch

from ndrustfft_tpu_torch import api

torch.set_num_threads(1)

C64, F32 = torch.complex64, torch.float32


@pytest.mark.parametrize("kind,shape,axis,dtype,n,want", [
    # the flagship 512^2 and 1024^2 step
    ("r2c", (512, 512), 1, F32, None, api.R2C_NAT),
    ("fft", (512, 257), 0, C64, None, api.C2C_AXIS_MID),
    ("ifft", (512, 257), 0, C64, None, api.C2C_AXIS_MID),
    ("c2r", (512, 257), 1, C64, 512, api.C2R_NAT),
    ("r2c", (1024, 1024), -1, F32, None, api.R2C_NAT),
    ("ifft", (1024, 513), 0, C64, None, api.C2C_AXIS_MID),
    ("c2r", (1024, 513), -1, C64, 1024, api.C2R_NAT),
    # every leg of the 512^3 step
    ("r2c", (512, 512, 512), 2, F32, None, api.R2C_NAT),
    ("fft", (512, 512, 257), 1, C64, None, api.C2C_AXIS_MID),
    ("fft", (512, 512, 257), 0, C64, None, api.C2C_AXIS_MID),
    ("ifft", (512, 512, 257), 0, C64, None, api.C2C_AXIS_MID),
    ("ifft", (512, 512, 257), 1, C64, None, api.C2C_AXIS_MID),
    ("c2r", (512, 512, 257), 2, C64, 512, api.C2R_NAT),
    # n = 2048 (F = 16) and the R2C/C2R core at F = 16
    ("fft", (2048, 130), 0, C64, None, api.C2C_AXIS_MID),
    ("r2c", (200, 4096), 1, F32, None, api.R2C_NAT),
    # what the JAX package leaves to XLA runs the torch engine
    ("fft", (512, 257), 0, torch.complex128, None, api.ENGINE),
    ("r2c", (512, 512), 1, torch.float64, None, api.ENGINE),
    ("fft", (512, 100), 0, C64, None, api.ENGINE),       # cols < 128
    ("r2c", (100, 512), 1, F32, None, api.ENGINE),        # batch < 128
    ("c2r", (100, 257), 1, C64, 512, api.ENGINE),
    ("fft", (64, 1024), 1, C64, None, api.ENGINE),        # lane-last, batch < 128
    ("c2r", (200, 1), 1, C64, 1, api.ENGINE),
    # the complex n-D transform: the reference's fft2d rows (K4), lane-last
    # C2C on rows (K10 with F = 4, 8, 16; K8 for n <= 256)
    ("fft", (128, 128), 0, C64, None, api.C2C_DENSE_MID),
    ("ifft", (264, 264), 0, C64, None, api.C2C_DENSE_MID),
    ("fft", (256, 1024), 1, C64, None, api.C2C_ROWS),
    ("fft", (256, 256), 1, C64, None, api.C2C_DENSE_ROWS),
    ("ifft", (1024, 1024), 1, C64, None, api.C2C_ROWS),
    ("fft", (512, 512, 512), 2, C64, None, api.C2C_ROWS),
    ("ifft", (130, 2048), -1, C64, None, api.C2C_ROWS),
    ("ifft", (66, 2048), -1, C64, None, api.ENGINE),            # batch < 128
    ("fft", (256, 256, 256), 2, C64, None, api.C2C_DENSE_ROWS),
    ("fft", (256, 256, 256), 1, C64, None, api.C2C_DENSE_MID),
    ("ifft", (256, 256, 256), 0, C64, None, api.C2C_DENSE_MID),
    ("fft", (130, 2), 1, C64, None, api.C2C_DENSE_ROWS),
    ("fft", (3, 500, 130), 1, C64, None, api.C2C_DENSE_MID),   # no split, n <= 512
    ("fft", (512, 256, 64), 1, C64, None, api.C2C_DENSE_ROWS),  # cols < 128: axis moves
    # n > 256 without a split: K8's generic schedule on rows (the reference's
    # 264, 600), K6 along a middle axis (n > 512)
    ("fft", (600, 256), 0, C64, None, api.C2C_GENERIC_MID),
    ("fft", (256, 264), 1, C64, None, api.C2C_GENERIC_ROWS),
    ("ifft", (128, 600), 1, C64, None, api.C2C_GENERIC_ROWS),
    # R2C/C2R along a middle axis: the reference's rfft2d protocol along
    # axis 0 (K20/K21 at 128 and 264, K16/K17 at 512 and 1024), the R2C and
    # C2R legs of the 512^3 and 256^3 steps with the real axis first, axis 1
    # of 512^3, F = 16 and odd n
    ("r2c", (128, 128), 0, F32, None, api.R2C_DENSE_MID),
    ("c2r", (65, 128), 0, C64, 128, api.C2R_DENSE_MID),
    ("r2c", (264, 264), 0, F32, None, api.R2C_DENSE_MID),
    ("c2r", (133, 264), 0, C64, 264, api.C2R_DENSE_MID),
    ("r2c", (512, 512), 0, F32, None, api.R2C_MID),
    ("c2r", (257, 512), 0, C64, 512, api.C2R_MID),
    ("r2c", (1024, 1024), 0, F32, None, api.R2C_MID),
    ("c2r", (513, 1024), 0, C64, 1024, api.C2R_MID),
    ("r2c", (512, 512, 512), 0, F32, None, api.R2C_MID),
    ("c2r", (257, 512, 512), 0, C64, 512, api.C2R_MID),
    ("r2c", (256, 256, 256), 0, F32, None, api.R2C_DENSE_MID),
    ("c2r", (129, 256, 256), 0, C64, 256, api.C2R_DENSE_MID),
    ("r2c", (512, 512, 512), 1, F32, None, api.R2C_MID),
    ("r2c", (3, 4096, 130), 1, F32, None, api.R2C_MID),
    ("c2r", (2, 101, 130), 1, C64, 201, api.C2R_DENSE_MID),
    ("r2c", (131, 130), 0, F32, None, api.R2C_DENSE_MID),     # a Bluestein length
    ("r2c", (512, 512, 100), 1, F32, None, api.R2C_NAT),       # cols < 128: axis moves
    # butterfly factors outside {4, 8, 16}: K10 and K1 on the wide core
    # (F = 3 at n = 384, F = 32 at n = 4096), K2 at h = 4096 (F = 32)
    ("fft", (256, 384), 1, C64, None, api.C2C_ROWS),
    ("ifft", (128, 4096), 1, C64, None, api.C2C_ROWS),
    ("fft", (384, 256), 0, C64, None, api.C2C_AXIS_MID),
    ("fft", (4096, 128), 0, C64, None, api.C2C_AXIS_MID),
    ("r2c", (256, 8192), 1, F32, None, api.R2C_NAT),
    # a middle axis whose half length has a factor outside the fixed core's
    # {2, 4, 8, 16}: F = 3 (n = 768) and F = 32 (n = 8192), on the wide core
    ("r2c", (768, 256), 0, F32, None, api.R2C_MID),
    ("r2c", (8192, 128), 0, F32, None, api.R2C_MID),
    ("c2r", (385, 256), 0, C64, 768, api.C2R_MID),
    ("c2r", (4097, 128), 0, C64, 8192, api.C2R_MID),
])
def test_route_on_cuda(kind, shape, axis, dtype, n, want):
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want


@pytest.mark.parametrize("kind,shape,axis,n,want", [
    # a four-step length (K7 and K13, which raised before they were ported)
    ("fft", (2, 1 << 17), 1, None, api.C2C_FOURSTEP),
    # Bluestein lengths, which raised K11 before it was ported: the fused
    # chirp-z along a middle axis (K11), and for a middle-axis R2C/C2R beyond
    # K20/K21's cap the lane's chirp-z after a moveaxis (sub-FFTs on K10)
    ("fft", (509, 256), 0, None, api.C2C_BLUE_MID),
    ("r2c", (2 * 1031, 128), 0, None, api.BLUESTEIN_LANE),
    ("c2r", (1032, 128), 0, 2 * 1031, api.BLUESTEIN_LANE),
    ("r2c", (1153, 256), 0, None, api.BLUESTEIN_LANE),
    ("c2r", (1154, 128), 0, 2 * 1153, api.BLUESTEIN_LANE),
])
def test_unported_route_raises_on_cuda(kind, shape, axis, n, want):
    """The routes that raised on a CUDA tensor while their kernels were not
    ported: each is now a route name, the same on both devices."""
    dtype = F32 if kind == "r2c" else C64
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want
    assert api._route(kind, shape, axis, dtype, "cpu", n=n) == want


# The other kinds' lane lowerings, one route name each: the packed R2C
# (K15), the row pairs (odd n), the Hermitian extension (C2R) and the
# DCT-III/IV lowerings, whose C2C is K10 or K8; the motivating calls (the
# 256^3 and 128^3 steps' real legs along the last axis, odd grids, the
# Chebyshev DCT-I/DST-I and the DCT-IV lanes) among them
@pytest.mark.parametrize("kind,shape,axis,n,want", [
    ("r2c", (256, 201), 1, None, api.R2C_ROWPAIR),               # odd n: row pairs
    ("r2c", (256, 255), -1, None, api.R2C_ROWPAIR),
    ("c2r", (256, 101), 1, 200, api.C2R_LANE),                   # no natural factor: K8
    ("dct3", (256, 200), 1, None, api.DCT_LANE),                 # K8
    ("dct4", (128, 256), 1, None, api.DCT_LANE),                 # K8
    ("dct4", (256, 1024), 1, None, api.DCT_LANE),                # K10
    ("dst4", (128, 256), 1, None, api.DCT_LANE),
    ("r2c", (256, 256), 1, None, api.R2C_PACKED),                # h = 128: the core, F = 1
    ("r2c", (256, 256, 256), 2, None, api.R2C_PACKED),
    ("c2r", (256, 256, 129), 2, 256, api.C2R_LANE),
    ("r2c", (128, 128, 128), 2, None, api.R2C_PACKED),           # h = 64: the dense product
    ("c2r", (128, 128, 65), 2, 128, api.C2R_LANE),
    ("r2c", (129, 129, 129), 2, None, api.R2C_ROWPAIR),
    ("c2r", (129, 129, 65), 2, 129, api.C2R_LANE),
    ("r2c", (255, 255), 1, None, api.R2C_ROWPAIR),
    ("dct1", (129, 129), 1, None, api.R2C_PACKED),
    ("dct1", (129, 129, 129), 2, None, api.R2C_PACKED),
    ("dct1", (1025, 1025), 1, None, api.R2C_PACKED),             # h = 1024: the core, F = 8
    ("dst1", (256, 511), 1, None, api.R2C_PACKED),
    ("dct4", (1024, 1024), 1, None, api.DCT_LANE),
    ("dst4", (512, 512, 512), 2, None, api.DCT_LANE),
    ("dct2", (256, 200), 1, None, api.R2C_PACKED),               # no K23 split
    ("dct2", (256, 201), 1, None, api.R2C_ROWPAIR),
    # the generic schedule inside the lowerings: K15 at h = 300, the row
    # pairs (265, 301), the Hermitian extension (300) and DCT-IV (1000) on K8
    ("r2c", (256, 600), 1, None, api.R2C_PACKED),
    ("r2c", (256, 265), 1, None, api.R2C_ROWPAIR),
    ("c2r", (256, 151), 1, 300, api.C2R_LANE),
    ("dct4", (256, 1000), 1, None, api.DCT_LANE),
    ("dct2", (256, 301), 1, None, api.R2C_ROWPAIR),
    # the Hermitian extension's C2C at n = 640 on K10's wide core (F = 5)
    ("c2r", (128, 321), 1, 640, api.C2R_LANE),
])
def test_lane_lowerings_run_on_cuda(kind, shape, axis, n, want):
    dtype = C64 if kind == "c2r" else F32
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want
    assert api._route(kind, shape, axis, dtype, "cpu", n=n) == want


# A lane lowering whose inner C2C is a four-step length (it raised on a CUDA
# tensor before K7 and K13 were ported) takes the lowering's own route name
# on both devices: its C2C runs the four-step
@pytest.mark.parametrize("kind,shape,axis,n,want", [
    ("dct4", (256, 32768), 1, None, api.DCT_LANE),  # four-step
])
def test_other_kinds_inner_c2c_still_raises_on_cuda(kind, shape, axis, n, want):
    dtype = C64 if kind == "c2r" else F32
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want
    assert api._route(kind, shape, axis, dtype, "cpu", n=n) == want


def test_c2c_kernel_routes_serve_fft_and_ifft_only():
    """The C2C route names stay the complex transform's: another kind's
    lowering that reaches K10/K8 takes a route named for that lowering."""
    for kind in ("r2c", "c2r", "dct1", "dct2", "dct3", "dct4", "dst1", "dst2", "dst3",
                 "dst4"):
        for n in (2, 3, 128, 200, 201, 256, 264, 512, 640, 1000, 1024, 2048):
            for shape, axis in (((n, 256), 0), ((256, n), 1), ((130, n), 1)):
                dtype = C64 if kind == "c2r" else F32
                route = api._route(kind, shape, axis, dtype, "cuda")
                assert route not in (api.C2C_ROWS, api.C2C_DENSE_ROWS, api.C2C_DENSE_MID,
                                     api.C2C_GENERIC_ROWS, api.C2C_GENERIC_MID), \
                    (kind, shape, axis)


def test_kernel_routes_stand_on_cpu_and_other_devices_take_the_engine():
    assert api._route("fft", (512, 257), 0, C64, "cpu") == api.C2C_AXIS_MID
    assert api._route("fft", (512, 257), 0, C64, "meta") == api.ENGINE
    assert api._route("fft", (128, 128), 0, C64, "meta") == api.ENGINE
    assert api._route("fft", (128, 128), 0, C64, "cpu") == api.C2C_DENSE_MID
    assert api._route("fft", (128, 1024), 1, C64, "cpu") == api.C2C_ROWS
    assert api._route("fft", (128, 100), 1, C64, "cpu") == api.C2C_DENSE_ROWS


def test_route_rejects_unknown_kind_and_axis():
    with pytest.raises(ValueError):
        api._route("dct5", (512, 512), 0, F32, "cuda")
    with pytest.raises(ValueError, match="out of bounds"):
        api._route("fft", (512, 512), 2, C64, "cuda")


def test_mid_dims():
    assert api._mid_dims((4, 512, 3, 100), 1) == (4, 300)
    assert api._mid_dims((512, 100), 0) is None
    assert api._mid_dims((512, 512), 1) is None
