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
])
def test_route_on_cuda(kind, shape, axis, dtype, n, want):
    assert api._route(kind, shape, axis, dtype, "cuda", n=n) == want


@pytest.mark.parametrize("kind,shape,axis,n,kernel,item", [
    ("fft", (128, 128), 0, None, "_kernel_axis_mid_dense", "K4"),
    ("ifft", (264, 264), 0, None, "_kernel_axis_mid_dense", "K4"),
    ("fft", (384, 256), 0, None, "_kernel_axis_mid_bts2", "K1b"),
    ("fft", (4096, 128), 0, None, "_kernel_axis_mid_bts2", "K1b"),
    ("fft", (600, 256), 0, None, "_kernel_axis_mid", "K6"),
    ("fft", (256, 1024), 1, None, "_kernel_twostep", "K10"),
    ("fft", (256, 256), 1, None, "_kernel_lane_last", "K8"),
    ("fft", (2, 1 << 17), 1, None, "_kernel_exit_mul", "K7"),
    ("fft", (509, 256), 0, None, "_kernel_axis_mid_blue", "K11"),
    ("r2c", (512, 512), 0, None, "_r2c_kernel_mid", "K16"),
    ("r2c", (256, 256), 1, None, "_r2c_kernel", "K15"),
    ("r2c", (129, 256), 0, None, "_r2c_dense_kernel", "K20"),
    ("c2r", (257, 512), 0, 512, "_c2r_kernel_mid", "K17"),
    ("c2r", (65, 512), 0, 128, "_c2r_dense_kernel", "K21"),
    ("r2c", (256, 8192), 1, None, "_r2c_kernel_nat", "K1b"),
])
def test_unported_route_raises_on_cuda(kind, shape, axis, n, kernel, item):
    dtype = F32 if kind == "r2c" else C64
    with pytest.raises(NotImplementedError, match=kernel) as exc:
        api._route(kind, shape, axis, dtype, "cuda", n=n)
    assert f"ROADMAP.md item {item})" in str(exc.value)
    if kind == "fft" and shape[axis] == 509:
        return   # Bluestein has no plan on any device
    assert api._route(kind, shape, axis, dtype, "cpu", n=n) == api.ENGINE


def test_kernel_routes_stand_on_cpu_and_other_devices_take_the_engine():
    assert api._route("fft", (512, 257), 0, C64, "cpu") == api.C2C_AXIS_MID
    assert api._route("fft", (512, 257), 0, C64, "meta") == api.ENGINE
    assert api._route("fft", (128, 128), 0, C64, "meta") == api.ENGINE


def test_route_rejects_unknown_kind_and_axis():
    with pytest.raises(ValueError):
        api._route("dct5", (512, 512), 0, F32, "cuda")
    with pytest.raises(ValueError, match="out of bounds"):
        api._route("fft", (512, 512), 2, C64, "cuda")


def test_mid_dims():
    assert api._mid_dims((4, 512, 3, 100), 1) == (4, 300)
    assert api._mid_dims((512, 100), 0) is None
    assert api._mid_dims((512, 512), 1) is None
