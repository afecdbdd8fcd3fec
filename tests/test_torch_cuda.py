"""ndrustfft_tpu_torch's CUDA kernels on the card (marker ``cuda``).

Every test skips where ``torch.cuda.is_available()`` is false. This file
imports neither jax nor the JAX package, so on a machine with a card and no
JAX it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 5e-6 of max |plain| (kernel and plain version are both float32);
2e-6 for kernel 15 on the core and its dense product.
"""

import pytest
import torch

import ndrustfft_tpu_torch as nd
from ndrustfft_tpu_torch.ops import engine
from ndrustfft_tpu_torch.ops.hopper import dct as kdct
from ndrustfft_tpu_torch.ops.hopper import fft as kfft
from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

torch.set_num_threads(1)

TOL = 5e-6

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _dst1_oracle(x):
    """scipy's DST-I along dim 0 through torch.fft: -Im of the FFT of the
    odd extension [0, x, 0, -flip(x)] at bins 1 .. n (an oracle only)."""
    z = torch.zeros_like(x[:1])
    ext = torch.cat([z, x, z, -x.flip(0)], dim=0)
    return -torch.fft.rfft(ext, dim=0).imag[1:x.shape[0] + 1]


def test_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.view_as_complex(torch.randn(2, 1024, 257, 2, generator=g, device=dev))
    for sign, scale in ((-1, None), (+1, 1 / 1024)):
        assert _rel(kfft.c2c_axis_mid(x, sign, scale),
                    kfft.c2c_axis_mid_plain(x, sign, scale)) <= TOL
    r = torch.randn(130, 512, generator=g, device=dev)
    assert _rel(krfft.r2c_nat(r), krfft.r2c_nat_plain(r)) <= TOL
    s = krfft.r2c_nat_plain(r)
    assert _rel(krfft.c2r_nat(s, 512, 0.5), krfft.c2r_nat_plain(s, 512, 0.5)) <= TOL


def test_step_runs_on_the_kernels(dev):
    x = torch.randn(512, 512, device=dev)
    hr, hc = nd.R2cFftHandler(512), nd.FftHandler(512)
    before = (kfft.c2c_axis_mid.launches, krfft.r2c_nat.launches,
              krfft.c2r_nat.launches)
    back = nd.ndifft_r2c(nd.ndifft(nd.ndfft(nd.ndfft_r2c(x, hr, axis=1), hc, axis=0),
                                   hc, axis=0), hr, axis=1)
    after = (kfft.c2c_axis_mid.launches, krfft.r2c_nat.launches,
             krfft.c2r_nat.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 1, 1]
    assert _rel(back, x) <= 1e-5


def test_unported_route_and_grad_raise(dev):
    # n = 384 (F = 3) runs on kernel 10's radix core; DCT-II at n = 768
    # (h = 384, once the wide form) and n = 128 * 161 (odd k > 160, which
    # raised before the long forms were ported) on kernel 23's radix row
    # core
    x = torch.view_as_complex(torch.randn(256, 384, 2, device=dev))
    before = kfft.c2c_rows.radix_launches
    y = nd.ndfft(x, axis=1)
    assert kfft.c2c_rows.radix_launches - before == 1
    assert _rel(y.to(torch.complex128), torch.fft.fft(x.to(torch.complex128), dim=1)) <= 1e-5
    r = torch.randn(256, 768, device=dev)
    before = kdct.dct2_nat.radix_launches
    y = nd.nddct2(r, axis=1)
    assert kdct.dct2_nat.radix_launches - before == 1
    assert _rel(y, kdct.dct2_nat_plain(r, 2.0)) <= TOL
    r = torch.randn(128, 128 * 161, device=dev)
    before = kdct.dct2_nat.radix_launches
    y = nd.nddct2(r, axis=1)
    assert kdct.dct2_nat.radix_launches - before == 1
    assert _rel(y, kdct.dct2_nat_plain(r, 2.0)) <= TOL
    # DST-I along axis 0 at 1023 runs kernel 18 (it raised before the kernel
    # was ported); DCT-IV past n = 40960 runs kernel 28's four-step (it
    # raised before the long form was ported)
    r = torch.randn(1023, 128, device=dev)
    before = krfft.r2c_packed_mid.launches
    y = nd.nddst1(r, axis=0)
    assert krfft.r2c_packed_mid.launches - before == 1
    assert _rel(y.double(), _dst1_oracle(r.double())) <= 1e-5
    r = torch.randn(256 * 161, 128, device=dev)
    before = kdct.dct4_mid.fourstep_launches
    y = nd.nddct4(r, axis=0)
    assert kdct.dct4_mid.fourstep_launches - before == 1
    assert _rel(y, kdct.dct4_mid_plain(r[None], 2.0)[0]) <= TOL
    with pytest.raises(NotImplementedError, match="autograd"):
        nd.ndfft_r2c(torch.zeros(512, 512, device=dev, requires_grad=True), axis=1)
    y = nd.ndfft(torch.ones(4, 8, dtype=torch.complex128, device=dev), axis=1)
    assert abs(complex(y[0, 0]) - 8.0) < 1e-12      # complex128: the engine


def test_dct_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(2, 265, 130, generator=g, device=dev)
    for t in (1, 2, 3, 4):     # DCT-I at n - 1 = 264 on the radix column tile
        plain = kdct.dct_radix_plain if kdct.dct_radix_len(265, t) else kdct.dct_dense_mid_plain
        assert _rel(kdct.dct_dense_mid(x, t, 2.0), plain(x, t, 2.0)) <= TOL
    r = torch.randn(130, 1024, generator=g, device=dev)
    assert _rel(kdct.dct2_nat(r, 2.0), kdct.dct2_nat_plain(r, 2.0)) <= TOL
    assert _rel(kdct.dct3_nat(r, 0.5), kdct.dct3_nat_plain(r, 0.5)) <= TOL
    r = torch.randn(7, 256, generator=g, device=dev)
    assert _rel(kdct.dct2_nat(r), kdct.dct2_nat_plain(r)) <= TOL
    assert _rel(kdct.dct3_nat(r), kdct.dct3_nat_plain(r)) <= TOL


def test_dct_pair_runs_on_the_kernels(dev):
    x = torch.randn(1024, 1024, device=dev)
    h = nd.DctHandler(1024)
    hi = h.normalization(nd.Normalization.scalar(1 / 1024))
    fns = (kdct.dct_dense_mid, kdct.dct2_nat, kdct.dct3_nat)
    before = [f.launches for f in fns]
    y = nd.nddct2(nd.nddct2(x, h, axis=1), h, axis=0)
    back = nd.nddct3(nd.nddct3(y, hi, axis=0), hi, axis=1)
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 1, 1]
    assert _rel(back, x) <= 1e-5


def test_unported_dct_route_raises(dev):
    # DCT-II along axis 0 at 2048 runs kernel 25 on the radix column tile (it
    # raised before the kernel was ported); the odd k past 20480 runs there
    # too (it raised before the long forms were ported, then ran the n-point
    # form), and the prime k = 163 keeps the n-point form
    x = torch.randn(2048, 128, device=dev)
    before = kdct.dct2_mid.launches
    y = nd.nddct2(x, axis=0)
    assert kdct.dct2_mid.launches - before == 1
    assert _rel(y, kdct.dct2_mid_plain(x[None], 2.0)[0]) <= TOL
    for k, form in ((161, "radix_launches"), (163, "npoint_launches")):
        x2 = torch.randn(128 * k, 128, device=dev)
        before = getattr(kdct.dct2_mid, form)
        y = nd.nddct2(x2, axis=0)
        assert getattr(kdct.dct2_mid, form) - before == 1
        assert _rel(y, kdct.dct2_mid_plain(x2[None], 2.0)[0]) <= TOL
    assert nd.nddct2([1.0, 2.0, 3.0]).device.type == "cuda"   # non-tensor input
    # DCT-I at 2049 and DCT-IV at 2048 along axis 0 run kernels 19 and 28
    # (they raised before the kernels were ported), and so does DST-IV at
    # 65536 (the four-step, F = 256; it raised before the long form was
    # ported)
    x1 = torch.randn(2049, 128, device=dev)
    before = (krfft.dct1_mid.launches, kdct.dct4_mid.launches)
    y1 = nd.nddct1(x1, axis=0)
    y4 = nd.nddct4(x, axis=0)
    assert (krfft.dct1_mid.launches - before[0], kdct.dct4_mid.launches - before[1]) == (1, 1)
    assert _rel(y1, krfft.dct1_mid_plain(x1[None], 1.0)[0]) <= TOL
    assert _rel(y4, kdct.dct4_mid_plain(x[None], 2.0)[0]) <= TOL
    x4 = torch.randn(65536, 128, device=dev)
    before = kdct.dct4_mid.fourstep_launches
    y4 = nd.nddst4(x4, axis=0)
    assert kdct.dct4_mid.fourstep_launches - before == 1
    alt = torch.ones(65536, 1, device=dev)
    alt[1::2] = -1
    assert _rel(y4, kdct.dct4_mid_plain(x4.flip(0)[None], 2.0)[0] * alt) <= TOL


def test_c2c_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(2)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    for t, n in ((130, 512), (128, 1024), (66, 2048)):
        x = crandn(t, n)
        for sign, scale in ((-1, None), (+1, 1 / n)):
            assert _rel(kfft.c2c_rows(x, sign, scale),
                        kfft.c2c_rows_plain(x, sign, scale)) <= TOL
    for t, n in ((130, 128), (200, 200), (131, 256)):
        x = crandn(t, n)
        for sign, scale in ((-1, None), (+1, 1 / n)):
            before = kfft.c2c_dense_rows.radix_launches
            assert _rel(kfft.c2c_dense_rows(x, sign, scale),
                        kfft.c2c_radix_rows_plain(x, sign, scale)) <= TOL
            assert kfft.c2c_dense_rows.radix_launches - before == 1
    for shape in ((1, 128, 128), (1, 264, 264), (3, 200, 257), (2, 500, 130)):
        x = crandn(*shape)
        for sign, scale in ((-1, None), (+1, 1 / shape[1])):
            assert _rel(kfft.c2c_dense_mid(x, sign, scale),
                        kfft.c2c_dense_mid_plain(x, sign, scale)) <= TOL


def test_complex_transform_runs_on_the_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.view_as_complex(torch.randn(1024, 1024, 2, generator=g, device=dev))
    h = nd.FftHandler(1024)
    fns = (kfft.c2c_rows, kfft.c2c_axis_mid, kfft.c2c_dense_rows, kfft.c2c_dense_mid)
    before = [f.launches for f in fns]
    y = nd.ndfft(nd.ndfft(x, h, axis=1), h, axis=0)
    back = nd.ndifft(nd.ndifft(y, h, axis=0), h, axis=1)
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 2, 0, 0]
    ref = torch.fft.fftn(x.to(torch.complex128))
    assert _rel(y.to(torch.complex128), ref) <= 1e-5
    assert _rel(back, x) <= 1e-5
    z = torch.view_as_complex(torch.randn(128, 256, 2, generator=g, device=dev))
    before = [f.launches for f in fns]
    w = nd.ndfft(nd.ndfft(z, axis=1), axis=0)       # K8, then K4
    assert [f.launches - b for f, b in zip(fns, before)] == [0, 0, 1, 1]
    assert _rel(w.to(torch.complex128), torch.fft.fftn(z.to(torch.complex128))) <= 1e-5
    # the C2R's Hermitian extension at n = 640 runs its C2C on kernel 10's
    # radix core (F = 5)
    s = torch.fft.rfft(torch.randn(128, 640, generator=g, device=dev, dtype=torch.float64))
    before = kfft.c2c_rows.radix_launches
    r = nd.ndifft_r2c(s.to(torch.complex64), axis=1, n=640)
    assert kfft.c2c_rows.radix_launches - before == 1
    assert _rel(r.double(), torch.fft.irfft(s, n=640, dim=1)) <= 1e-5


def test_mid_rfft_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    for shape in ((2, 512, 130), (1, 1024, 257), (3, 2048, 200), (2, 4096, 130)):
        nb, n, cols = shape
        x = torch.randn(*shape, generator=g, device=dev)
        assert _rel(krfft.r2c_mid(x), krfft.r2c_mid_plain(x)) <= TOL
        s = torch.view_as_complex(torch.randn(nb, n // 2 + 1, cols, 2, generator=g, device=dev))
        for scale in (None, 1 / n):
            assert _rel(krfft.c2r_mid(s, n, scale), krfft.c2r_mid_plain(s, n, scale)) <= TOL
    for shape in ((1, 128, 128), (2, 201, 130), (1, 264, 264), (1, 1100, 130), (2, 262, 130)):
        nb, n, cols = shape
        x = torch.randn(*shape, generator=g, device=dev)
        plain = krfft._R2C_DENSE_PLAIN[krfft.r2c_dense_form(n)]
        assert _rel(krfft.r2c_dense_mid(x), plain(x)) <= TOL
        s = torch.view_as_complex(torch.randn(nb, n // 2 + 1, cols, 2, generator=g, device=dev))
        plain = krfft._C2R_DENSE_PLAIN[krfft.c2r_dense_form(n)]
        for scale in (None, 1 / n):
            assert _rel(krfft.c2r_dense_mid(s, n, scale), plain(s, n, scale)) <= TOL


def test_rfft2d_runs_on_the_mid_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    fns = (krfft.r2c_mid, krfft.c2r_mid, krfft.r2c_dense_mid, krfft.c2r_dense_mid)
    for n, want in ((128, [0, 0, 1, 1]), (264, [0, 0, 1, 1]), (512, [1, 1, 0, 0]),
                    (1024, [1, 1, 0, 0])):
        x = torch.randn(n, n, generator=g, device=dev)
        h = nd.R2cFftHandler(n)
        before = [f.launches for f in fns]
        y = nd.ndfft_r2c(x, h, axis=0)
        back = nd.ndifft_r2c(y, h, axis=0)
        assert [f.launches - b for f, b in zip(fns, before)] == want
        assert _rel(y.to(torch.complex128), torch.fft.rfft(x.double(), dim=0)) <= 1e-5
        assert _rel(back, x) <= 1e-5
    # n = 768 (h = 384, F = 3): kernels 16 and 17 on the radix column tile
    x = torch.randn(768, 256, generator=g, device=dev)
    h = nd.R2cFftHandler(768)
    before = [krfft.r2c_mid.radix_launches, krfft.c2r_mid.radix_launches]
    y = nd.ndfft_r2c(x, h, axis=0)
    back = nd.ndifft_r2c(y, h, axis=0)
    assert [krfft.r2c_mid.radix_launches - before[0],
            krfft.c2r_mid.radix_launches - before[1]] == [1, 1]
    assert _rel(y, krfft.r2c_mid_plain(x[None])[0]) <= TOL
    assert _rel(back, x) <= 1e-5


def test_packed_r2c_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(6)
    for t, h in ((130, 64), (7, 128), (16641, 128), (131, 129), (3, 100), (10, 512),
                 (129, 1024)):
        x = torch.randn(t, 2 * h, generator=g, device=dev)
        if krfft.packed_core(h):
            got, want = krfft.r2c_packed(x), krfft.r2c_packed_plain(x)
        else:
            got = krfft.r2c_packed_dense(x)
            want = krfft._PACKED_DENSE_PLAIN[krfft.packed_dense_form(h)](x)
        assert got.shape == (t, h + 1)
        assert _rel(got, want) <= 2e-6


def test_real_step_128_cubed_runs_on_the_kernels(dev):
    """The 128^3 real step with the real axis last: K15's dense rows on the
    radix row core (h = 64), K8 on the moved axis 1 (65 < 128 columns), K4
    along axis 0, and K8 after the C2R's Hermitian extension."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(128, 128, 128, generator=g, device=dev)
    hr, hc = nd.R2cFftHandler(128), nd.FftHandler(128)
    fns = (krfft.r2c_packed_dense, kfft.c2c_dense_rows, kfft.c2c_dense_mid)
    before = [f.launches for f in fns]
    radix = krfft.r2c_packed_dense.radix_launches
    v = nd.ndfft(nd.ndfft(nd.ndfft_r2c(x, hr, axis=2), hc, axis=1), hc, axis=0)
    back = nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=0), hc, axis=1), hr, axis=2)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 3, 2]
    assert krfft.r2c_packed_dense.radix_launches - radix == 1
    assert _rel(v.to(torch.complex128), torch.fft.rfftn(x.double())) <= 1e-5
    assert _rel(back, x) <= 1e-5


def test_generic_kernels_match_plain(dev):
    """Kernel 8 above n = 256, kernel 6 and kernel 15's generic form on the
    radix core: odd and even h, ragged rows and column tiles, two prime
    stages (11352 = 8 * 3 * 11 * 43), 19272 and the longest length (20480,
    40 elements a thread)."""
    g = torch.Generator(device=dev).manual_seed(8)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    for t, n in ((130, 264), (7, 600), (129, 1200), (3, 11352), (2, 19272), (2, 20480)):
        x = crandn(t, n)
        for sign, scale in ((-1, None), (+1, 1 / n)):
            assert _rel(kfft.c2c_generic_rows(x, sign, scale),
                        kfft.c2c_generic_rows_plain(x, sign, scale)) <= TOL
    for shape in ((1, 600, 130), (2, 520, 129), (3, 600, 301), (1, 11352, 5), (1, 19272, 3),
                  (1, 20480, 3)):
        x = crandn(*shape)
        for sign, scale in ((-1, None), (+1, 1 / shape[1])):
            before = kfft.c2c_generic_mid.radix_launches
            assert _rel(kfft.c2c_generic_mid(x, sign, scale),
                        kfft.c2c_generic_mid_plain(x, sign, scale)) <= TOL
            assert kfft.c2c_generic_mid.radix_launches - before == 1
    for t, n in ((130, 530), (7, 600), (2, 2 * 11352)):
        x = torch.randn(t, n, generator=g, device=dev)
        got = krfft.r2c_packed_generic(x)
        assert got.shape == (t, n // 2 + 1)
        assert _rel(got, krfft.r2c_packed_generic_plain(x)) <= TOL


def test_real_step_600_runs_on_the_generic_kernels(dev):
    """The 600^2 real step with the real axis last: kernel 15 at h = 300,
    kernel 6 along axis 0 and back, kernel 8 at n = 600 after the C2R's
    Hermitian extension."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(600, 600, generator=g, device=dev)
    hr, hc = nd.R2cFftHandler(600), nd.FftHandler(600)
    fns = (krfft.r2c_packed_generic, kfft.c2c_generic_mid, kfft.c2c_generic_rows)
    before = [f.launches for f in fns]
    v = nd.ndfft(nd.ndfft_r2c(x, hr, axis=1), hc, axis=0)
    back = nd.ndifft_r2c(nd.ndifft(v, hc, axis=0), hr, axis=1)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 2, 1]
    assert _rel(v.to(torch.complex128), torch.fft.rfftn(x.double())) <= 1e-5
    assert _rel(back, x) <= 1e-5


def test_wide_kernels_match_plain(dev):
    """The lengths the wide core took: kernel 1 at F outside the fixed
    core's on the radix column tile and kernels 10, 2, 3 and 15 on the radix
    row core: odd, even and prime
    F (3, 5, 6, 9, 32, 127, 160), ragged column and row tiles, and one
    column or row per block at n = 16256 and 20480."""
    g = torch.Generator(device=dev).manual_seed(10)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    fns = (kfft.c2c_axis_mid, kfft.c2c_rows, krfft.r2c_nat, krfft.c2r_nat, krfft.r2c_packed)
    forms = ("radix_launches",) * 5
    before = [getattr(f, a) for f, a in zip(fns, forms)]
    for shape in ((2, 768, 130), (1, 640, 129), (3, 384, 385), (1, 4096, 33), (1, 16256, 3),
                  (1, 20480, 2)):
        x = crandn(*shape)
        for sign, scale in ((-1, None), (+1, 1 / shape[1])):
            assert _rel(kfft.c2c_axis_mid(x, sign, scale),
                        kfft.c2c_axis_mid_plain(x, sign, scale)) <= TOL
    for t, n in ((130, 384), (7, 1152), (33, 4096), (3, 16256), (2, 20480)):
        x = crandn(t, n)
        for sign, scale in ((-1, None), (+1, 1 / n)):
            assert _rel(kfft.c2c_rows(x, sign, scale),
                        kfft.c2c_rows_plain(x, sign, scale)) <= TOL
    for t, n in ((130, 768), (7, 1536), (5, 2 * 16256), (2, 40960)):
        x = torch.randn(t, n, generator=g, device=dev)
        got = krfft.r2c_nat(x)
        assert got.shape == (t, n // 2 + 1)
        assert _rel(got, krfft.r2c_nat_plain(x)) <= TOL
        assert _rel(krfft.r2c_packed(x), krfft.r2c_packed_plain(x)) <= TOL
        s = crandn(t, n // 2 + 1)
        s[:, 0] += 100j      # DC and Nyquist imaginary parts that must be ignored
        s[:, -1] += 100j
        for scale in (None, 1 / n):
            assert _rel(krfft.c2r_nat(s, n, scale), krfft.c2r_nat_plain(s, n, scale)) <= TOL
    assert [getattr(f, a) - b for f, a, b in zip(fns, forms, before)] == [12, 10, 4, 8, 4]


def _all_launches():
    """{wrapper: launches} of every kernel wrapper of the port."""
    return {f"{m.__name__}.{name}": fn.launches for m in (kfft, krfft, kdct)
            for name, fn in vars(m).items() if callable(fn) and hasattr(fn, "launches")}


def test_radix_kernel_matches_plain(dev):
    """The mixed-radix row core behind kernel 10 at F = 3, 5, 9, 32, 127 and
    160 and behind kernel 8 at n = 264, 600, 11352 and 20448 (the plans
    (8, 3, 11), (8, 3, 5, 5), (8, 3, 11, 43), (16, 2, 9, 71)), with ragged
    rows (row counts that do not divide into the tiles), both signs, with
    and without 1/n; no other kernel runs."""
    g = torch.Generator(device=dev).manual_seed(19)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    before = _all_launches()
    radix = kfft.c2c_rows.radix_launches
    for fn, plain, shapes in (
            (kfft.c2c_rows, kfft.c2c_rows_plain,
             ((131, 384), (7, 640), (1000, 1152), (33, 4096), (3, 16256), (5, 20480))),
            (kfft.c2c_generic_rows, kfft.c2c_generic_rows_plain,
             ((1001, 264), (7, 600), (3, 11352), (2, 20448)))):
        for t, n in shapes:
            x = crandn(t, n)
            for sign, scale in ((-1, None), (+1, None), (-1, 1 / n), (+1, 1 / n)):
                assert _rel(fn(x, sign, scale), plain(x, sign, scale)) <= TOL, (n, sign, scale)
    after = _all_launches()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"ndrustfft_tpu_torch.ops.hopper.fft.c2c_rows": 24,
                     "ndrustfft_tpu_torch.ops.hopper.fft.c2c_generic_rows": 16}
    assert kfft.c2c_rows.radix_launches - radix == 24


def test_kernel10_and_kernel2_run_the_radix_row_core(dev):
    """Kernel 10 at n = 512, 1024, 2048 (the bts2 core's lengths before)
    and kernels 2 and 15 at h = 128, 256, 384 and 16384 on the radix row
    core: ragged row counts, both signs, with and without 1/n, an input
    that is not 16-byte aligned, and no rows; every launch counted in
    ``radix_launches``, no other kernel runs."""
    g = torch.Generator(device=dev).manual_seed(26)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    before = _all_launches()
    radix = [f.radix_launches for f in (kfft.c2c_rows, krfft.r2c_nat, krfft.r2c_packed)]
    for t, n in ((130, 512), (129, 1024), (66, 2048), (1, 2048)):
        x = crandn(t, n)
        for sign, scale in ((-1, None), (+1, None), (-1, 1 / n), (+1, 1 / n)):
            assert _rel(kfft.c2c_rows(x, sign, scale),
                        kfft.c2c_rows_plain(x, sign, scale)) <= TOL, (t, n, sign, scale)
    assert kfft.c2c_rows(crandn(0, 1024), -1).shape == (0, 1024)
    for t, h in ((130, 128), (7, 256), (131, 384), (3, 16384)):
        x = torch.randn(t, 2 * h, generator=g, device=dev)
        for fn in ((krfft.r2c_packed,) if h == 128 else (krfft.r2c_nat, krfft.r2c_packed)):
            got = fn(x)
            assert got.shape == (t, h + 1)
            assert _rel(got, krfft.r2c_radix_plain(x)) <= TOL, (fn.__name__, t, h)
    x = torch.randn(5 * 1024 + 2, generator=g, device=dev)[2:].reshape(5, 1024)
    assert x.data_ptr() % 16
    assert _rel(krfft.r2c_nat(x), krfft.r2c_radix_plain(x)) <= TOL
    assert _rel(krfft.r2c_packed(x), krfft.r2c_radix_plain(x)) <= TOL
    assert krfft.r2c_nat(torch.zeros(0, 1024, device=dev)).shape == (0, 513)
    after = _all_launches()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {"ndrustfft_tpu_torch.ops.hopper.fft.c2c_rows": 16,
                     "ndrustfft_tpu_torch.ops.hopper.rfft.r2c_nat": 4,
                     "ndrustfft_tpu_torch.ops.hopper.rfft.r2c_packed": 5}
    assert [f.radix_launches - b for f, b in
            zip((kfft.c2c_rows, krfft.r2c_nat, krfft.r2c_packed), radix)] == [16, 4, 5]


def test_real_step_768_runs_on_the_wide_kernels(dev):
    """The 768^2 real step with the real axis last: kernels 2 and 3 at
    h = 384 (F = 3) on the radix row core and kernel 1 at (1, 768, 385)
    (F = 6) forward and back on the radix column tile."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(768, 768, generator=g, device=dev)
    hr, hc = nd.R2cFftHandler(768), nd.FftHandler(768)
    fns = ((kfft.c2c_axis_mid, "radix_launches"), (krfft.c2r_nat, "radix_launches"))
    before = [(f.launches, getattr(f, a)) for f, a in fns]
    r2c = krfft.r2c_nat.launches, krfft.r2c_nat.radix_launches
    v = nd.ndfft(nd.ndfft_r2c(x, hr, axis=1), hc, axis=0)
    back = nd.ndifft_r2c(nd.ndifft(v, hc, axis=0), hr, axis=1)
    assert [(f.launches - b0, getattr(f, a) - b1) for (f, a), (b0, b1) in zip(fns, before)] == \
        [(2, 2), (1, 1)]
    assert (krfft.r2c_nat.launches - r2c[0], krfft.r2c_nat.radix_launches - r2c[1]) == (1, 1)
    assert _rel(v.to(torch.complex128), torch.fft.rfftn(x.double())) <= 1e-5
    assert _rel(back, x) <= 1e-5


def test_dct23_kernels_match_plain_in_every_form(dev):
    """Kernels 23 to 26 in their forms (kernels 23 and 24 on the radix row
    core and kernels 25 and 26 on the radix column tile where n/2 has a
    plan, else the wide core's half length or the n-point form) and kernels
    16/17: ragged row and column tiles, prime F = 131 (the n-point form at
    k = 131 and the half length at k = 262, where n/2 has no plan), the
    largest tiles (n-point F = 159, half length F = 128: one transform per
    tile)."""
    g = torch.Generator(device=dev).manual_seed(12)
    forms = {"wide": 0, "npoint": 0, "radix": 0}

    def counts(wrapper):
        return (wrapper.launches, wrapper.wide_launches, wrapper.npoint_launches,
                getattr(wrapper, "radix_launches", 0))

    def check(wrapper, plain, x, scale):
        before = counts(wrapper)
        got = wrapper(x, scale)
        assert _rel(got, plain(x, scale)) <= TOL, (wrapper.__name__, tuple(x.shape))
        d = [a - b for a, b in zip(counts(wrapper), before)]
        assert d[0] == 1 and d[1] + d[2] + d[3] == 1
        forms["wide" if d[1] else "npoint" if d[2] else "radix"] += 1

    for t, n in ((130, 128), (7, 384), (130, 768), (33, 1536), (3, 1152), (2, 128 * 159),
                 (2, 128 * 131), (3, 32768), (130, 1024), (2, 128 * 262)):
        x = torch.randn(t, n, generator=g, device=dev)
        check(kdct.dct2_nat, kdct.dct2_nat_plain, x, 2.0)
        check(kdct.dct3_nat, kdct.dct3_nat_plain, x, 0.5)
    for shape in ((1, 512, 130), (2, 2048, 130), (1, 4096, 33), (2, 1280, 130), (1, 1536, 129),
                  (2, 1152, 130), (1, 128 * 159, 3), (1, 32768, 2), (3, 384, 385),
                  (1, 128 * 262, 3)):
        x = torch.randn(*shape, generator=g, device=dev)
        check(kdct.dct2_mid, kdct.dct2_mid_plain, x, 2.0)
        check(kdct.dct3_mid, kdct.dct3_mid_plain, x, None)
    # kernels 23 to 26 on the radix cores but at n = 128 * 131 and 128 * 262
    # (no plan of 64 * 131)
    assert forms == {"wide": 4, "npoint": 2, "radix": 34}
    before = [krfft.r2c_mid.radix_launches, krfft.c2r_mid.radix_launches]
    for shape in ((2, 768, 130), (1, 1280, 129), (1, 40960, 2)):
        x = torch.randn(*shape, generator=g, device=dev)
        assert _rel(krfft.r2c_mid(x), krfft.r2c_mid_plain(x)) <= TOL
        s = torch.view_as_complex(torch.randn(shape[0], shape[1] // 2 + 1, shape[2], 2,
                                              generator=g, device=dev))
        s[:, 0] += 100j      # DC and Nyquist imaginary parts that must be ignored
        s[:, -1] += 100j
        for scale in (None, 1 / shape[1]):
            assert _rel(krfft.c2r_mid(s, shape[1], scale),
                        krfft.c2r_mid_plain(s, shape[1], scale)) <= TOL
    assert [krfft.r2c_mid.radix_launches - before[0],
            krfft.c2r_mid.radix_launches - before[1]] == [3, 6]


def test_neumann_2d_runs_on_the_dct_kernels(dev):
    """A 2-D Neumann solve at 1280 x 768 (K25 and K26 on the radix column
    tile, K23 and K24 on the radix row core) against its analytic
    solution."""
    n0, n1 = 1280, 768
    x0 = (torch.arange(n0, device=dev, dtype=torch.float64) + 0.5) / n0
    x1 = (torch.arange(n1, device=dev, dtype=torch.float64) + 0.5) / n1
    u = torch.cos(3 * torch.pi * x0)[:, None] * torch.cos(5 * torch.pi * x1)[None, :]
    f = (torch.pi ** 2 * (9 + 25) * u).float()
    h0, h1 = nd.DctHandler(n0), nd.DctHandler(n1)
    h0i = h0.normalization(nd.Normalization.scalar(1 / n0))
    h1i = h1.normalization(nd.Normalization.scalar(1 / n1))
    fns = ((kdct.dct2_mid, "radix_launches"), (kdct.dct3_mid, "radix_launches"),
           (kdct.dct2_nat, "radix_launches"), (kdct.dct3_nat, "radix_launches"))
    before = [getattr(f, a) for f, a in fns]
    fh = nd.nddct2(nd.nddct2(f, h1, axis=1), h0, axis=0)
    k0 = (torch.arange(n0, device=dev, dtype=torch.float32) * torch.pi) ** 2
    k1 = (torch.arange(n1, device=dev, dtype=torch.float32) * torch.pi) ** 2
    lam = k0[:, None] + k1[None, :]
    lam[0, 0] = float("inf")             # the zero mode is pinned to 0
    got = nd.nddct3(nd.nddct3(fh / lam, h0i, axis=0), h1i, axis=1)
    assert [getattr(f, a) - b for (f, a), b in zip(fns, before)] == [1, 1, 1, 1]
    assert _rel(got.double(), u) <= 1e-5


def test_packed_mid_kernels_match_plain_in_both_forms(dev):
    """Kernels 18, 19 and 28's single pass on the radix column tile at the
    same h: ragged column tiles, the largest tiles (h = 20480: one column
    per tile, read-only loads), and K28's wide core at the prime F = 131."""
    g = torch.Generator(device=dev).manual_seed(13)
    fns = ((krfft.r2c_packed_mid, "radix_launches"), (krfft.dct1_mid, "radix_launches"),
           (kdct.dct4_mid, "radix_launches"), (kdct.dct4_mid, "wide_launches"))
    before = [(f.launches, getattr(f, a)) for f, a in fns]
    for shape in ((2, 256, 130), (1, 1024, 257), (3, 2048, 33), (1, 384, 385), (2, 1152, 130),
                  (1, 20480, 3)):
        xe = torch.randn(*shape, generator=g, device=dev)
        xo = torch.randn(*shape, generator=g, device=dev)
        for scale in (None, -1.0):
            assert _rel(krfft.r2c_packed_mid(xe, xo, scale),
                        krfft.r2c_packed_mid_plain(xe, xo, scale)) <= TOL, shape
    for shape in ((2, 2049, 130), (1, 1025, 257), (2, 1153, 130), (1, 1537, 129),
                  (1, 20481, 3)):
        x = torch.randn(*shape, generator=g, device=dev)
        for scale in (1.0, 0.25):
            assert _rel(krfft.dct1_mid(x, scale), krfft.dct1_mid_plain(x, scale)) <= TOL, shape
    shapes4 = ((2, 2048, 130), (1, 4096, 33), (1, 1024, 257), (2, 1280, 130),
               (1, 1536, 129), (1, 256 * 131, 3), (1, 40960, 2))
    for shape in shapes4:
        x = torch.randn(*shape, generator=g, device=dev)
        for scale in (2.0, None):
            assert _rel(kdct.dct4_mid(x, scale), kdct.dct4_mid_plain(x, scale)) <= TOL, shape
    radix4 = 2 * sum(kdct.dct4_form(shape[1]) == "radix" for shape in shapes4)
    assert [(f.launches - b0, getattr(f, a) - b1) for (f, a), (b0, b1) in zip(fns, before)] == \
        [(12, 12), (10, 10), (14, radix4), (14, 2)]


def test_dct4_fourstep_matches_plain(dev):
    """Kernel 28's four-step at forced splits of short lengths (hl = 1024 =
    32 * 32, 1280 = 10 * 128, ragged column tiles) against its plain version
    and the single pass, and at G2's length in place of the single pass's
    reach."""
    g = torch.Generator(device=dev).manual_seed(14)
    for shape, h2 in (((2, 2048, 130), 32), ((1, 2560, 33), 128), ((1, 65536, 40), 128)):
        x = torch.randn(*shape, generator=g, device=dev)
        y = torch.empty_like(x)
        hl = shape[1] // 2
        c1 = kdct.dct4_fourstep_cols(hl // h2, shape[0] * h2, shape[2], 132)
        c2 = kdct.dct4_fourstep_cols(h2, shape[0] * (hl // h2), shape[2], 132)
        kdct.dct4_fourstep_launch(x, y, 2.0, c1, c2, h2)
        assert _rel(y, kdct.dct4_fourstep_plain(x, 2.0, h2)) <= TOL, shape
        if hl <= kdct.DCT4_RADIX_MAX_HL:
            assert _rel(y, kdct.dct4_radix_plain(x, 2.0)) <= TOL, shape


def test_dirichlet_pair_runs_on_the_kernels(dev):
    """The 1023 x 1023 DST-I pair: kernel 18 at (1, 1024, 1023) along axis
    0 and kernel 15 at h = 1024 along axis 1, forward and back."""
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn(1023, 1023, generator=g, device=dev)
    fns = (krfft.r2c_packed_mid, krfft.r2c_packed)
    before = [f.launches for f in fns]
    y = nd.dstn(x, 1)
    back = nd.idstn(y, 1)
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 2]
    ref = _dst1_oracle(_dst1_oracle(x.double()).T).T
    assert _rel(y.double(), ref) <= 1e-5
    assert _rel(back, x) <= 1e-5


def test_blue_kernels_match_plain_in_both_forms(dev):
    """Kernel 11 at F = 8, 16, 3, 17, 33 and the routes' largest, 106, every
    launch on the radix core's column tile (counted in ``radix_launches``);
    kernel 12 on kernel 11's column kernel at M = chirp_m(n) = 2048, 2560,
    4608 (n = 1021, 1153, 2049; every launch counted in ``radix_launches``);
    ragged column tiles, both signs and the scale 1/n."""
    g = torch.Generator(device=dev).manual_seed(15)
    fns = (kfft.c2c_blue_mid, kdct.dct23_blue_mid)
    forms = ("radix_launches", "radix_launches")
    before = [(f.launches, getattr(f, a)) for f, a in zip(fns, forms)]
    for shape in ((2, 509, 130), (1, 1021, 257), (2, 131, 130), (1, 1031, 129),
                  (1, 2049, 33), (1, 6781, 3)):
        x = torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))
        for sign, scale in ((-1, None), (+1, 1.0 / shape[1])):
            assert _rel(kfft.c2c_blue_mid(x, sign, scale),
                        kfft.c2c_blue_mid_plain(x, sign, scale)) <= TOL, (shape, sign)
    for shape in ((2, 1021, 130), (1, 1153, 257), (1, 2049, 130)):
        x = torch.randn(*shape, generator=g, device=dev)
        for t, scale in ((2, 2.0), (3, None)):
            assert _rel(kdct.dct23_blue_mid(x, t, scale),
                        kdct.dct23_blue_mid_plain(x, t, scale)) <= TOL, (shape, t)
    assert [(f.launches - a, getattr(f, form) - b)
            for f, form, (a, b) in zip(fns, forms, before)] == [(12, 12), (6, 6)]


def test_dct2_rows_radix_matches_plain(dev):
    """Kernel 23 on the radix row core: odd and even k, h = 64 ... 16384
    (16, 32 and 40 elements a thread), ragged row tiles at each count of
    rows a block that fits, a row view off a 16-byte boundary (the wrapper
    copies it), every launch counted in ``radix_launches``; the 29 lengths
    without a plan keep the old forms (n = 128 * 131: the n-point form)."""
    g = torch.Generator(device=dev).manual_seed(25)
    before = (kdct.dct2_nat.launches, kdct.dct2_nat.radix_launches)
    for t, n in ((7, 128), (130, 384), (33, 640), (5, 1536), (3, 8192), (2, 128 * 159),
                 (3, 32768), (2, 40960)):
        x = torch.randn(t, n, generator=g, device=dev)
        for scale in (2.0, None):
            assert _rel(kdct.dct2_nat(x, scale), kdct.dct2_rows_radix_plain(x, scale)) <= TOL, n
        h = n // 2
        tr = -(-h // 16)        # threads a row in the 16-element form (h <= 4096)
        for rows in (1, 2, 3) if h <= kfft.RADIX_WIDE_N and 3 * tr <= 256 else (1,):
            y = torch.empty_like(x)
            kdct.dct2_rows_radix_launch(x, y, 2.0, rows)
            assert _rel(y, kdct.dct2_rows_radix_plain(x, 2.0)) <= TOL, (n, rows)
    flat = torch.randn(3 * 384 + 1, generator=g, device=dev)
    x = flat[1:].view(3, 384)
    assert x.data_ptr() % 16
    assert _rel(kdct.dct2_nat(x, 2.0), kdct.dct2_rows_radix_plain(x, 2.0)) <= TOL
    assert (kdct.dct2_nat.launches - before[0], kdct.dct2_nat.radix_launches - before[1]) == \
        (17, 17)
    x = torch.randn(2, 128 * 131, generator=g, device=dev)
    before = (kdct.dct2_nat.radix_launches, kdct.dct2_nat.npoint_launches)
    assert _rel(kdct.dct2_nat(x, 2.0), kdct.dct2_nat_plain(x, 2.0)) <= TOL
    assert (kdct.dct2_nat.radix_launches - before[0],
            kdct.dct2_nat.npoint_launches - before[1]) == (0, 1)


def test_dct3_rows_radix_matches_plain(dev):
    """Kernel 24 on the radix row core: odd and even k, h = 64 ... 16384
    (16, 32 and 40 elements a thread), ragged row tiles at each count of
    rows a block that fits, a row view off a 16-byte boundary (the wrapper
    copies it), every launch counted in ``radix_launches``; the 29 lengths
    without a plan keep the old forms (n = 128 * 131: the n-point form)."""
    g = torch.Generator(device=dev).manual_seed(27)
    before = (kdct.dct3_nat.launches, kdct.dct3_nat.radix_launches)
    for t, n in ((7, 128), (130, 384), (33, 640), (5, 1536), (3, 8192), (2, 128 * 159),
                 (3, 32768), (2, 40960)):
        x = torch.randn(t, n, generator=g, device=dev)
        for scale in (2.0, None, 1.0 / n):
            assert _rel(kdct.dct3_nat(x, scale), kdct.dct3_rows_radix_plain(x, scale)) <= TOL, n
        h = n // 2
        tr = -(-h // 16)        # threads a row in the 16-element form (h <= 4096)
        for rows in (1, 2, 3) if h <= kfft.RADIX_WIDE_N and 3 * tr <= 256 else (1,):
            y = torch.empty_like(x)
            kdct.dct3_rows_radix_launch(x, y, 2.0, rows)
            assert _rel(y, kdct.dct3_rows_radix_plain(x, 2.0)) <= TOL, (n, rows)
    flat = torch.randn(3 * 384 + 1, generator=g, device=dev)
    x = flat[1:].view(3, 384)
    assert x.data_ptr() % 16
    assert _rel(kdct.dct3_nat(x, 2.0), kdct.dct3_rows_radix_plain(x, 2.0)) <= TOL
    assert (kdct.dct3_nat.launches - before[0], kdct.dct3_nat.radix_launches - before[1]) == \
        (25, 25)
    x = torch.randn(2, 128 * 131, generator=g, device=dev)
    before = (kdct.dct3_nat.radix_launches, kdct.dct3_nat.npoint_launches)
    assert _rel(kdct.dct3_nat(x, 2.0), kdct.dct3_nat_plain(x, 2.0)) <= TOL
    assert (kdct.dct3_nat.radix_launches - before[0],
            kdct.dct3_nat.npoint_launches - before[1]) == (0, 1)


def test_dct2_mid_radix_matches_plain(dev):
    """Kernel 25 on the radix column tile: odd and even k, h = 64 ... 16384
    (16, 32 and 40 elements a thread), every column count C that fits a
    tile (at C <= 2 with both loads) with ragged L (5 and 130 columns),
    B = 1 and 2, every launch
    counted in ``radix_launches``; the lengths without a plan keep the old
    forms (n = 128 * 131: the n-point form)."""
    g = torch.Generator(device=dev).manual_seed(28)
    before = (kdct.dct2_mid.launches, kdct.dct2_mid.radix_launches)
    for nb, n, cols in ((2, 128, 130), (1, 384, 5), (2, 1152, 130), (1, 1536, 130),
                        (1, 8192, 5), (1, 128 * 159, 3), (1, 32768, 2), (1, 31104, 3)):
        x = torch.randn(nb, n, cols, generator=g, device=dev)
        for scale in (2.0, None):
            assert _rel(kdct.dct2_mid(x, scale), kdct.dct_radix_plain(x, 2, scale)) <= TOL, n
        h = n // 2
        for c, ldg in ((1, False), (1, True), (2, False), (2, True), (4, False), (8, False),
                       (16, False)):
            if h * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(h, c) > 512:
                continue
            y = torch.empty_like(x)
            kdct.dct_radix_launch(x, y, 2, 2.0, c, ldg)
            assert _rel(y, kdct.dct_radix_plain(x, 2, 2.0)) <= TOL, (n, c, ldg)
    assert (kdct.dct2_mid.launches - before[0], kdct.dct2_mid.radix_launches - before[1]) == \
        (16, 16)
    x = torch.randn(1, 128 * 131, 3, generator=g, device=dev)
    before = (kdct.dct2_mid.radix_launches, kdct.dct2_mid.npoint_launches)
    assert _rel(kdct.dct2_mid(x, 2.0), kdct.dct2_mid_plain(x, 2.0)) <= TOL
    assert (kdct.dct2_mid.radix_launches - before[0],
            kdct.dct2_mid.npoint_launches - before[1]) == (0, 1)


# (B, n, L) shapes of kernels 26 and 29 on the radix column tile: odd and
# even k, h = 64 ... 16384 (16, 32 and 40 elements a thread), ragged L,
# B = 1 and 2
_MID_RADIX_SHAPES = ((2, 128, 130), (1, 384, 5), (2, 1152, 130), (1, 1536, 130), (1, 2048, 33),
                     (1, 8192, 5), (1, 128 * 159, 3), (1, 32768, 2), (1, 31104, 3))
_MID_RADIX_COLS = ((1, False), (1, True), (2, False), (2, True), (4, False), (8, False),
                   (16, False))


def test_dct3_mid_radix_matches_plain(dev):
    """Kernel 26 on the radix column tile (kernel 27's Makhoul C2R): every
    column count C that fits a tile (at C <= 2 with both loads), every launch
    counted in ``radix_launches``; the lengths without a plan keep the old
    forms (n = 128 * 131: the n-point form, 128 * 262: the wide core)."""
    g = torch.Generator(device=dev).manual_seed(29)
    before = (kdct.dct3_mid.launches, kdct.dct3_mid.radix_launches)
    for nb, n, cols in _MID_RADIX_SHAPES:
        x = torch.randn(nb, n, cols, generator=g, device=dev)
        for scale in (1.0 / n, None):
            assert _rel(kdct.dct3_mid(x, scale), kdct.dct_radix_plain(x, 3, scale)) <= TOL, n
        h = n // 2
        for c, ldg in _MID_RADIX_COLS:
            if h * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(h, c) > 512:
                continue
            y = torch.empty_like(x)
            kdct.dct_radix_launch(x, y, 3, 0.5, c, ldg)
            assert _rel(y, kdct.dct_radix_plain(x, 3, 0.5)) <= TOL, (n, c, ldg)
    assert (kdct.dct3_mid.launches - before[0], kdct.dct3_mid.radix_launches - before[1]) == \
        (18, 18)
    before = (kdct.dct3_mid.radix_launches, kdct.dct3_mid.npoint_launches,
              kdct.dct3_mid.wide_launches)
    for n in (128 * 131, 128 * 262):
        x = torch.randn(1, n, 3, generator=g, device=dev)
        assert _rel(kdct.dct3_mid(x, 2.0), kdct.dct3_mid_plain(x, 2.0)) <= TOL
    assert (kdct.dct3_mid.radix_launches - before[0], kdct.dct3_mid.npoint_launches - before[1],
            kdct.dct3_mid.wide_launches - before[2]) == (0, 1, 1)


def test_spectral_dct_radix_matches_plain(dev):
    """Kernel 29 on the radix column tile: the forward Makhoul R2C, the pair
    pass and the inverse on one tile, at every column count C that fits (at
    C <= 2 with both loads), broadcast and lane-varying H, every launch
    through the wrapper counted in ``radix_launches``."""
    g = torch.Generator(device=dev).manual_seed(30)
    before = (kdct.spectral_dct_mid.launches, kdct.spectral_dct_mid.radix_launches)
    for nb, n, cols in _MID_RADIX_SHAPES:
        x = torch.randn(nb, n, cols, generator=g, device=dev)
        for hv, s2, s3 in ((torch.randn(n, 1, generator=g, device=dev), 2.0, 1.0 / n),
                           (torch.randn(n, cols, generator=g, device=dev), None, 0.37)):
            want = kdct.spectral_dct_mid_plain(x, hv, s2, s3)
            assert _rel(kdct.spectral_dct_mid(x, hv, s2, s3), want) <= TOL, n
            h = n // 2
            for c, ldg in _MID_RADIX_COLS:
                if h * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(h, c) > 512:
                    continue
                y = torch.empty_like(x)
                kdct.spectral_dct_radix_launch(x, y, hv, s2, s3, c, ldg)
                assert _rel(y, want) <= TOL, (n, c, ldg)
    assert (kdct.spectral_dct_mid.launches - before[0],
            kdct.spectral_dct_mid.radix_launches - before[1]) == (18, 18)


def test_spectral_c2c_r2c_radix_match_plain(dev):
    """Kernels 14 and 22 on the radix column tile: the forward transform,
    the multiply (K22: the pair pass) and the inverse on one tile, at every
    column count C that fits (at C <= 2 with both loads), broadcast and
    lane-varying H, real and complex, at n = 128 ... 20480 (K14) and
    h = 128 ... 20480 (K22, n = 2h); every launch through a wrapper counted
    in ``launches``."""
    g = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    before = (kfft.spectral_c2c_mid.launches, krfft.spectral_r2c_mid.launches)
    for nb, n, cols in ((2, 128, 33), (1, 384, 130), (2, 1024, 17), (1, 1280, 9),
                        (1, 16256, 3), (1, 20480, 2)):
        x = torch.complex(randn(nb, n, cols), randn(nb, n, cols))
        for h, s in ((randn(n, 1), None), (torch.complex(randn(n, cols), randn(n, cols)), 1 / n)):
            want = kfft.spectral_c2c_mid_plain(x, h, s)
            assert _rel(kfft.spectral_c2c_mid(x, h, s), want) <= TOL, n
            hr, hi = (h.real.contiguous(), h.imag.contiguous()) if h.is_complex() else (h, None)
            for c, ldg in _MID_RADIX_COLS:
                if n * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(n, c) > 512:
                    continue
                y = torch.empty_like(x)
                kfft.spectral_c2c_launch(x, y, hr, hi, 1.0 if s is None else s, c, ldg)
                assert _rel(y, want) <= TOL, (n, c, ldg)
    for nb, n, cols in ((2, 256, 33), (1, 512, 130), (2, 768, 17), (1, 2048, 9),
                        (1, 40960, 2)):
        x = randn(nb, n, cols)
        m = n // 2 + 1
        for hr, hi, s in ((randn(m, 1), None, None), (randn(m, cols), randn(m, cols), 0.5)):
            want = krfft.spectral_r2c_mid_plain(x, hr, hi, n, s)
            assert _rel(krfft.spectral_r2c_mid(x, hr, hi, n, s), want) <= TOL, n
            for c, ldg in _MID_RADIX_COLS:
                if n // 2 * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(n // 2, c) > 512:
                    continue
                y = torch.empty_like(x)
                krfft.spectral_r2c_launch(x, y, hr, hi, n, s, c, ldg)
                assert _rel(y, want) <= TOL, (n, c, ldg)
    assert (kfft.spectral_c2c_mid.launches - before[0],
            krfft.spectral_r2c_mid.launches - before[1]) == (12, 10)


def test_dct23_blue_radix_matches_plain(dev):
    """Kernel 12 on kernel 11's column kernel at every column count C that
    fits a tile, ragged L (5 and 130 columns): M = 288, 2304, 4608 and
    14336 (n = 131, 1103, 2049, 6781; 16, 32 and 40 elements a thread),
    DCT-II with scale 2 and DCT-III unscaled; the wrapper's launches are
    all in ``radix_launches``."""
    g = torch.Generator(device=dev).manual_seed(26)
    before = (kdct.dct23_blue_mid.launches, kdct.dct23_blue_mid.radix_launches)
    calls = 0
    for nb, n, cols in ((2, 131, 130), (1, 1103, 5), (1, 2049, 130), (1, 6781, 5)):
        x = torch.randn(nb, n, cols, generator=g, device=dev)
        mk = kfft.chirp_m(n)
        for t, scale in ((2, 2.0), (3, None)):
            want = kdct.dct23_blue_mid_plain(x, t, scale)
            assert _rel(kdct.dct23_blue_mid(x, t, scale), want) <= TOL, (n, t)
            calls += 1
            for c in (1, 2, 4, 8, 16):
                if _tile_fits(mk, c):
                    y = torch.empty_like(x)
                    kdct.dct23_blue_launch(x, y, t, scale, c)
                    assert _rel(y, want) <= TOL, (n, t, c)
    assert (kdct.dct23_blue_mid.launches - before[0],
            kdct.dct23_blue_mid.radix_launches - before[1]) == (calls, calls)


def test_blue_radix_kernel_matches_plain(dev):
    """Kernel 11's radix column tile at every column count C = 1, 2, 4, 8
    the tile allows (its launcher), with a ragged last tile (L = 13, 130),
    F = 3, 11, 17, 33, 53, 106, both signs and the scale 1/n; the wrapper's
    launch counted as the radix form."""
    g = torch.Generator(device=dev).manual_seed(21)
    for nb, n, cols in ((2, 131, 13), (1, 647, 130), (1, 1031, 13), (1, 2049, 130),
                        (1, 3331, 5), (1, 6781, 3)):
        x = torch.view_as_complex(torch.randn(nb, n, cols, 2, generator=g, device=dev))
        mk = kfft.blue_kernel_M(n)
        for sign, scale in ((-1, None), (+1, 1.0 / n)):
            want = kfft.c2c_blue_mid_plain(x, sign, scale)
            a, h = kfft._device_blue(n, sign, dev)
            for c in (1, 2, 4, 8):
                if mk * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(mk, c) > 512:
                    continue
                got = torch.empty_like(x)
                kfft.blue_radix_launch(x, got, a, h, 1.0 if scale is None else scale, c)
                assert _rel(got, want) <= TOL, (n, c, sign)
        launches = kfft.c2c_blue_mid.radix_launches
        assert _rel(kfft.c2c_blue_mid(x, -1), kfft.c2c_blue_mid_plain(x, -1)) <= TOL
        assert kfft.c2c_blue_mid.radix_launches - launches == 1


def _blue_fits(mk, c):
    """A chirp-z tile of kernels 21 and 15 (their 16-element form only)."""
    return mk * c <= kfft.RADIX_WIDE_N and kfft.radix_cols_threads(mk, c) <= kfft.RADIX_MAX_THREADS


def test_c2r_chirp_kernel_matches_plain(dev):
    """Kernel 21's chirp-z C2R on kernel 11's column kernel: even n (kernel
    17's load and inverse unpack as the prologue, chirp length n/2) and odd
    n (the Hermitian extension, chirp length n), at each column count C that
    fits, ragged L, scales None and 1/n, with DC and Nyquist imaginary parts
    to be ignored; through the wrapper where rfft.py::c2r_dense_form names
    it, each launch counted in chirp_launches."""
    g = torch.Generator(device=dev).manual_seed(33)
    for nb, n, cols in ((2, 262, 130), (1, 263, 257), (1, 449, 65), (1, 1094, 33),
                        (1, 1099, 17), (3, 5, 129), (2, 4, 65)):
        s = torch.view_as_complex(torch.randn(nb, n // 2 + 1, cols, 2, generator=g, device=dev))
        s[:, 0] += 100j
        s[:, -1] += 100j if n % 2 == 0 else 0
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        for scale in (None, 1 / n):
            want = krfft.c2r_blue_plain(s, n, scale)
            for c in (1, 2, 4, 8, 16):
                if not _blue_fits(mk, c):
                    continue
                got = torch.full((nb, n, cols), float("nan"), device=dev)
                krfft.c2r_blue_launch(s, got, n, scale, c)
                assert _rel(got, want) <= TOL, (n, c, scale)
        ref = torch.fft.irfft(s.to(torch.complex128), n=n, dim=1)
        assert _rel(krfft.c2r_blue_plain(s, n, 1 / n).double(), ref) <= 2e-6
    chirp = [n for n in range(4, 1101) if krfft.c2r_dense_form(n) == "chirp"]
    before = (krfft.c2r_dense_mid.launches, krfft.c2r_dense_mid.chirp_launches)
    for n in chirp[::40]:
        s = torch.view_as_complex(torch.randn(2, n // 2 + 1, 130, 2, generator=g, device=dev))
        assert _rel(krfft.c2r_dense_mid(s, n, 1 / n), krfft.c2r_blue_plain(s, n, 1 / n)) <= TOL, n
    calls = len(chirp[::40])
    assert (krfft.c2r_dense_mid.launches - before[0],
            krfft.c2r_dense_mid.chirp_launches - before[1]) == (calls, calls)


def test_dense_rows_chirp_kernel_matches_plain(dev):
    """Kernel 15's rows at a prime half length h on the chirp-z (kernel
    20's even form with row-addressed policies) at each count of rows a tile
    that fits, ragged row counts; through the wrapper at every h that
    rfft.py::packed_dense_form names "chirp", counted in chirp_launches."""
    g = torch.Generator(device=dev).manual_seed(34)
    for t, h in ((300, 131), (16384, 131), (129, 173), (65, 251), (7, 211)):
        x = torch.randn(t, 2 * h, generator=g, device=dev)
        want = krfft.r2c_packed_blue_plain(x)
        mk = kfft.chirp_m(h)
        for c in (1, 2, 4, 8, 16, 32):
            if not _blue_fits(mk, c):
                continue
            got = torch.full((t, h + 1), float("nan"), dtype=torch.complex64, device=dev)
            krfft.r2c_blue_rows_launch(x, got, c)
            assert _rel(got, want) <= 2e-6, (h, c)
        assert _rel(want.to(torch.complex128), torch.fft.rfft(x.double(), dim=1)) <= 2e-6
    chirp = [h for h in range(1, 257) if krfft.packed_dense_form(h) == "chirp"]
    before = (krfft.r2c_packed_dense.launches, krfft.r2c_packed_dense.chirp_launches)
    for h in chirp:
        x = torch.randn(130, 2 * h, generator=g, device=dev)
        assert _rel(krfft.r2c_packed_dense(x), krfft.r2c_packed_blue_plain(x)) <= 2e-6, h
    assert (krfft.r2c_packed_dense.launches - before[0],
            krfft.r2c_packed_dense.chirp_launches - before[1]) == (len(chirp), len(chirp))


def test_dense_rows_radix_kernel_matches_plain(dev):
    """Kernel 8 at n <= 256 on the radix row core: one row of n < 16 a
    thread (up to 256 rows a block at n = 2), odd n at odd row offsets
    (17, 129), and ragged row counts, both signs and the scale 1/n; every
    launch counted as the radix form."""
    g = torch.Generator(device=dev).manual_seed(23)
    before = (kfft.c2c_dense_rows.launches, kfft.c2c_dense_rows.radix_launches)
    calls = 0
    for n in (2, 17, 129, 200, 256):
        for t in (1, 7, 1001):
            x = torch.view_as_complex(torch.randn(t, n, 2, generator=g, device=dev))
            for sign, scale in ((-1, None), (+1, 1.0 / n)):
                got = kfft.c2c_dense_rows(x, sign, scale)
                assert _rel(got, kfft.c2c_radix_rows_plain(x, sign, scale)) <= TOL, (t, n)
                calls += 1
    assert (kfft.c2c_dense_rows.launches - before[0],
            kfft.c2c_dense_rows.radix_launches - before[1]) == (calls, calls)


def test_mid_radix_kernel_matches_plain(dev):
    """Kernel 6's column tile at every column count C = 1, 2, 4, 8 that the
    tile allows (its launcher): the 600^3 step's ragged L = 301, a few
    columns at 1200, and the longest length 20480 (one column a tile, 40
    elements a thread), both signs and the scale 1/n; the wrapper's launch
    counted as the radix form."""
    g = torch.Generator(device=dev).manual_seed(24)
    for shape in ((600, 600, 301), (3, 1200, 7), (1, 20480, 5)):
        x = torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))
        n = shape[1]
        for sign, scale in ((-1, None), (+1, 1.0 / n)):
            want = kfft.c2c_generic_mid_plain(x, sign, scale)
            for c in (1, 2, 4, 8):
                if n * c > kfft.RADIX_MAX_ELEMS:
                    continue
                got = torch.full_like(x, float("nan"))
                kfft.mid_radix_launch(x, got, sign, 1.0 if scale is None else scale, c)
                assert _rel(got, want) <= TOL, (shape, c, sign)
        before = (kfft.c2c_generic_mid.launches, kfft.c2c_generic_mid.radix_launches)
        assert _rel(kfft.c2c_generic_mid(x, -1), kfft.c2c_generic_mid_plain(x, -1)) <= TOL
        assert (kfft.c2c_generic_mid.launches - before[0],
                kfft.c2c_generic_mid.radix_launches - before[1]) == (1, 1)


def test_dense_mid_radix_kernel_matches_plain(dev, monkeypatch):
    """Kernel 4 on the radix column tile at every column count C = 1 ... 64
    of the 16-element form (its launcher): n < 16 (one thread a column),
    odd n, the dense route's longest n (511), ragged column counts (L = 129,
    257, and the 256^3 paths' (256, 256, 129) and (1, 256, 33024)), both
    signs and the scale 1/n; every launch of the wrapper counted as the
    radix form, none through the dense product (kernel 7's dense remnant)."""

    def dense_product(*args):
        raise AssertionError("kernel 4 ran the dense product")

    monkeypatch.setattr(kfft, "_dense_launch", dense_product)
    g = torch.Generator(device=dev).manual_seed(26)
    before = (kfft.c2c_dense_mid.launches, kfft.c2c_dense_mid.radix_launches,
              kfft.fourstep_mid.dense_launches)
    calls = 0
    for shape in ((3, 2, 129), (2, 3, 257), (1, 15, 129), (2, 17, 257), (1, 129, 129),
                  (1, 200, 257), (1, 264, 129), (1, 511, 257), (256, 256, 129),
                  (1, 256, 33024)):
        x = torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))
        n = shape[1]
        for sign, scale in ((-1, None), (+1, 1.0 / n)):
            want = kfft.c2c_dense_mid_plain(x, sign, scale)
            for c in (1, 2, 4, 8, 16, 32, 64):
                if n * c > kfft.RADIX_WIDE_N:
                    continue
                got = torch.full_like(x, float("nan"))
                kfft.mid_radix_launch(x, got, sign, 1.0 if scale is None else scale, c)
                assert _rel(got, want) <= TOL, (shape, c, sign)
            assert _rel(kfft.c2c_dense_mid(x, sign, scale), want) <= TOL, (shape, sign)
            calls += 1
    assert (kfft.c2c_dense_mid.launches - before[0], kfft.c2c_dense_mid.radix_launches - before[1],
            kfft.fourstep_mid.dense_launches - before[2]) == (calls, calls, 0)


def test_blue_fixed_factors_run_on_the_radix_column_tile(dev):
    """Kernel 11 at M = 512, 1024, 2048 (n = 193, 509, 1021: F = 4, 8, 16,
    which ran on the bts2 core before) at every column count C = 1, 2, 4, 8
    (its launcher), ragged column tiles, both signs and the scale 1/n; the
    wrapper's launches all on the radix column tile."""
    g = torch.Generator(device=dev).manual_seed(27)
    before = (kfft.c2c_blue_mid.launches, kfft.c2c_blue_mid.radix_launches)
    calls = 0
    for nb, n, cols in ((2, 193, 130), (1, 509, 13), (1, 1021, 129)):
        x = torch.view_as_complex(torch.randn(nb, n, cols, 2, generator=g, device=dev))
        mk = kfft.blue_kernel_M(n)
        for sign, scale in ((-1, None), (+1, 1.0 / n)):
            want = kfft.c2c_blue_mid_plain(x, sign, scale)
            a, h = kfft._device_blue(n, sign, dev)
            for c in (1, 2, 4, 8):
                got = torch.full_like(x, float("nan"))
                kfft.blue_radix_launch(x, got, a, h, 1.0 if scale is None else scale, c)
                assert _rel(got, want) <= TOL, (n, c, sign)
            assert _rel(kfft.c2c_blue_mid(x, sign, scale), want) <= TOL, (n, sign)
            calls += 1
    assert (kfft.c2c_blue_mid.launches - before[0],
            kfft.c2c_blue_mid.radix_launches - before[1]) == (calls, calls)


def _table_uploads():
    """The device-table cache's size and the misses of every table cache of
    the kernel wrappers: a call that uploads a table raises one of them."""
    misses = 0
    for mod in (kfft, krfft, kdct):
        for fn in vars(mod).values():
            if hasattr(fn, "cache_info") and fn.__name__.startswith(("device_", "_device")):
                misses += fn.cache_info().misses
    return len(kfft._WQ_CACHE), misses


@pytest.mark.parametrize("run", [True, False])
def test_warmup_uploads_the_tables_before_the_first_call(dev, run):
    """After warmup on the card, in either mode, the first real calls of
    every kind of the four handlers upload no table: the 600^3 real step's
    kernels 15, 6 and 8, kernel 8 at n = 256, kernel 10 at n = 1024 and
    kernels 2 and 3 at n = 512 (the radix row core's tables, and kernel 3's
    bts2 table), and the DCT/DST kinds of a 256-point handler. ``run=False``
    launches nothing and counts nothing."""
    g = torch.Generator(device=dev).manual_seed(25 + run)
    kfft._WQ_CACHE.clear()
    cases = ((nd.FftHandler(600), (3, 600, 301), 1), (nd.FftHandler(256), (130, 256), 1),
             (nd.R2cFftHandler(600), (130, 600), 1), (nd.DctHandler(256), (256, 130), 0),
             (nd.DstHandler(256), (130, 256), 1), (nd.FftHandler(1024), (130, 1024), 1),
             (nd.R2cFftHandler(512), (130, 512), 1))
    for h, shape, axis in cases:
        launches = _all_launches()
        assert h.warmup(shape, axis=axis, run=run, device=dev) is h
        if not run:
            assert _all_launches() == launches
    uploads = _table_uploads()
    for h, shape, axis in cases:
        for name, cplx in h._kinds:
            s = list(shape)
            if name == "ndifft_r2c":
                s[axis] = h.m
            x = torch.randn(*s, 2 if cplx else 1, generator=g, device=dev)
            x = torch.view_as_complex(x) if cplx else x[..., 0]
            getattr(nd, name)(x, h, axis=axis)
    torch.cuda.synchronize()
    assert _table_uploads() == uploads


def test_r2c_radix_kernel_matches_plain(dev):
    """Kernel 15's generic form on the radix row core: odd h (265), the
    600^3 step's h = 300 at a ragged multi-row tile (601 rows, 8 a tile),
    two prime stages (11352), one row a tile with 32 and 40 elements a
    thread (11352, 20448), and an input that is not 16-byte aligned."""
    g = torch.Generator(device=dev).manual_seed(22)
    before = krfft.r2c_packed_generic.launches
    for t, n in ((7, 530), (601, 600), (130, 1000), (3, 2 * 11352), (2, 2 * 20448)):
        x = torch.randn(t, n, generator=g, device=dev)
        got = krfft.r2c_packed_generic(x)
        assert got.shape == (t, n // 2 + 1)
        assert _rel(got, krfft.r2c_packed_generic_plain(x)) <= TOL, (t, n)
    x = torch.randn(5 * 600 + 2, generator=g, device=dev)[2:].reshape(5, 600)
    assert _rel(krfft.r2c_packed_generic(x), krfft.r2c_packed_generic_plain(x)) <= TOL
    assert krfft.r2c_packed_generic.launches - before == 6


def test_r2c_mid_radix_kernel_matches_plain(dev):
    """Kernels 16 and 20 on the radix column tile, both forms (the half
    length with the unpack epilogue at even n, the C2C of (x, 0) with half
    its bins stored at odd n) at every column count C that the tile allows
    (the launcher): n = 4 and 5 (one thread a column), odd n with a prime
    stage (129, 1095), 256 and 264, K16's h = 256, 384 (F = 3), 640 and
    20480 (one column a tile, 40 elements a thread), ragged L and B > 1;
    then through the wrappers, with their counters, an input whose rows do
    not start on an 8-byte boundary, zero sizes, and kernel 20 at a length
    without a plan (262 = 2 * 131, the kernel rfft.py::r2c_dense_form
    names)."""
    g = torch.Generator(device=dev).manual_seed(30)
    shapes = ((3, 4, 129), (2, 5, 257), (1, 129, 130), (2, 256, 200), (1, 264, 264),
              (1, 1095, 33), (2, 512, 130), (1, 768, 257), (1, 1280, 129), (1, 40960, 3))
    for shape in shapes:
        nb, n, cols = shape
        x = torch.randn(*shape, generator=g, device=dev)
        want = krfft.r2c_mid_radix_plain(x)
        length = krfft.r2c_mid_len(n)
        for c in (1, 2, 4, 8, 16, 32, 64):
            if length * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(length, c) > (
                    kfft.RADIX_MAX_THREADS if length * c <= kfft.RADIX_WIDE_N else 512):
                continue
            got = torch.full((nb, n // 2 + 1, cols), float("nan"), dtype=torch.complex64,
                             device=dev)
            krfft.r2c_mid_radix_launch(x, got, c)
            assert _rel(got, want) <= TOL, (shape, c)
    before = [(f.launches, f.radix_launches) for f in (krfft.r2c_mid, krfft.r2c_dense_mid)]
    dense = krfft.r2c_dense_mid.launches - krfft.r2c_dense_mid.radix_launches
    calls = [0, 0]
    for shape in shapes:
        x = torch.randn(*shape, generator=g, device=dev)
        k16 = shape[1] >= 512 and shape[1] % 256 == 0
        fn = krfft.r2c_mid if k16 else krfft.r2c_dense_mid
        assert _rel(fn(x), krfft.r2c_mid_radix_plain(x)) <= TOL, shape
        calls[not k16] += 1
    # rows that start 4 bytes past an 8-byte boundary
    for n, fn in ((512, krfft.r2c_mid), (200, krfft.r2c_dense_mid), (129, krfft.r2c_dense_mid)):
        x = torch.randn(2 * n * 130 + 1, generator=g, device=dev)[1:].reshape(2, n, 130)
        assert x.data_ptr() % 8 == 4
        assert _rel(fn(x), krfft.r2c_mid_radix_plain(x)) <= TOL, n
        calls[fn is krfft.r2c_dense_mid] += 1
    for shape, fn in (((0, 512, 130), krfft.r2c_mid), ((2, 512, 0), krfft.r2c_mid),
                      ((0, 200, 130), krfft.r2c_dense_mid), ((3, 129, 0), krfft.r2c_dense_mid)):
        got = fn(torch.empty(*shape, device=dev))
        assert got.shape == (shape[0], shape[1] // 2 + 1, shape[2])
        assert got.dtype == torch.complex64
    assert [(f.launches - a, f.radix_launches - b) for f, (a, b) in
            zip((krfft.r2c_mid, krfft.r2c_dense_mid), before)] == [(c, c) for c in calls]
    x = torch.randn(2, 262, 130, generator=g, device=dev)
    assert not krfft.r2c_mid_radix(262)
    plain = krfft._R2C_DENSE_PLAIN[krfft.r2c_dense_form(262)]
    assert _rel(krfft.r2c_dense_mid(x), plain(x)) <= TOL
    assert (krfft.r2c_dense_mid.launches - krfft.r2c_dense_mid.radix_launches) - dense == 1


def test_r2c_chirp_kernel_matches_plain(dev):
    """Kernel 20's real-input chirp-z on kernel 11's column tile: even n
    (the chirp length n/2 and the unpack) and odd n (the chirp length n and
    the first (n + 1)/2 bins), at each column count C that fits, ragged L;
    through the wrapper where rfft.py::r2c_dense_form names it, each launch
    counted in chirp_launches."""
    g = torch.Generator(device=dev).manual_seed(31)
    for shape in ((2, 262, 130), (1, 131, 257), (1, 1094, 33), (1, 1097, 17), (3, 5, 129),
                  (2, 4, 65)):
        nb, n, cols = shape
        x = torch.randn(*shape, generator=g, device=dev)
        want = krfft.r2c_blue_plain(x)
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        for c in (1, 2, 4, 8, 16):
            if mk * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(mk, c) > (
                    kfft.RADIX_MAX_THREADS if mk * c <= kfft.RADIX_WIDE_N else 512):
                continue
            got = torch.full((nb, n // 2 + 1, cols), float("nan"), dtype=torch.complex64,
                             device=dev)
            krfft.r2c_blue_launch(x, got, c)
            assert _rel(got, want) <= TOL, (shape, c)
        assert _rel(want.to(torch.complex128), torch.fft.rfft(x.double(), dim=1)) <= 2e-6
    chirp = [n for n in range(4, 1101) if krfft.r2c_dense_form(n) == "chirp"]
    before = (krfft.r2c_dense_mid.launches, krfft.r2c_dense_mid.chirp_launches)
    for n in chirp[::40]:
        x = torch.randn(2, n, 130, generator=g, device=dev)
        assert _rel(krfft.r2c_dense_mid(x), krfft.r2c_blue_plain(x)) <= TOL, n
    calls = len(chirp[::40])
    assert (krfft.r2c_dense_mid.launches - before[0],
            krfft.r2c_dense_mid.chirp_launches - before[1]) == (calls, calls)


def test_dense_rows_radix_kernel_matches_plain(dev):
    """Kernel 15's dense rows on the radix row core (the unpack epilogue),
    many rows a block at h = 2, 3 and 5, odd h; the form that
    rfft.py::packed_dense_form names at h = 1, 31 and the prime 131;
    launches on the core counted in radix_launches."""
    g = torch.Generator(device=dev).manual_seed(32)
    before = (krfft.r2c_packed_dense.launches, krfft.r2c_packed_dense.radix_launches)
    calls = [0, 0]
    for t, h in ((1001, 2), (777, 3), (4097, 5), (16384, 64), (131, 97), (200, 100),
                 (65, 250), (129, 1), (300, 131), (129, 31)):
        x = torch.randn(t, 2 * h, generator=g, device=dev)
        radix = krfft.packed_dense_radix(h)
        want = krfft._PACKED_DENSE_PLAIN[krfft.packed_dense_form(h)](x)
        assert _rel(krfft.r2c_packed_dense(x), want) <= 2e-6, h
        for rows in (1, 3) if radix else ():
            assert _rel(krfft.r2c_radix_launch(x, "rows", rows), want) <= 2e-6, (h, rows)
        calls[0] += 1
        calls[1] += radix
    assert (krfft.r2c_packed_dense.launches - before[0],
            krfft.r2c_packed_dense.radix_launches - before[1]) == tuple(calls)


def test_bluestein_axis1_runs_on_the_radix_column_tile(dev):
    """ndfft/ndifft along axis 1 of (2, 1031, 130) (F = 17) take kernel 11's
    radix form, K12 at 2049 along axis 0 its chirp-z on the same column
    kernel; no engine call."""
    g = torch.Generator(device=dev).manual_seed(23)
    x = torch.view_as_complex(torch.randn(2, 1031, 130, 2, generator=g, device=dev))
    r = torch.randn(2049, 130, generator=g, device=dev)
    counts = (kfft.c2c_blue_mid.launches, kfft.c2c_blue_mid.radix_launches,
              kdct.dct23_blue_mid.radix_launches)
    calls = engine.c2c.calls
    y = nd.ndfft(x, axis=1)
    back = nd.ndifft(y, axis=1)
    d = nd.nddct2(r, axis=0)
    assert (kfft.c2c_blue_mid.launches - counts[0], kfft.c2c_blue_mid.radix_launches - counts[1],
            kdct.dct23_blue_mid.radix_launches - counts[2]) == (2, 2, 1)
    assert engine.c2c.calls == calls
    assert _rel(y.to(torch.complex128), torch.fft.fft(x.to(torch.complex128), dim=1)) <= 1e-5
    assert _rel(back, x) <= 1e-5
    assert d.shape == r.shape and bool(torch.isfinite(d).all())


def test_prime_lengths_run_on_the_blue_kernels(dev):
    """ndfft/ndifft at 509 along axis 0 (kernel 11) and along the last axis
    (the engine's chirp-z, its sub-FFTs on kernel 10 at M = 1024), against
    torch.fft in complex128; the 2049 x 256 DCT-II/III pair along axis 0
    (kernel 12, M = 4608 on kernel 11's column kernel) back to x."""
    g = torch.Generator(device=dev).manual_seed(16)
    x = torch.view_as_complex(torch.randn(509, 256, 2, generator=g, device=dev))
    ref = torch.fft.fft(x.to(torch.complex128), dim=0)
    fns = (kfft.c2c_blue_mid, kfft.c2c_rows, kdct.dct23_blue_mid)
    before = [f.launches for f in fns]
    calls = engine.c2c.calls
    y = nd.ndfft(x, axis=0)
    back = nd.ndifft(y, axis=0)
    assert _rel(y.to(torch.complex128), ref) <= 1e-5 and _rel(back, x) <= 1e-5
    xt = x.T.contiguous()
    y = nd.ndfft(xt, axis=1)
    back = nd.ndifft(y, axis=1)
    assert _rel(y.to(torch.complex128), ref.T) <= 1e-5 and _rel(back, xt) <= 1e-5
    r = torch.randn(2049, 256, generator=g, device=dev)
    h = nd.DctHandler(2049)
    hi = h.normalization(nd.Normalization.scalar(1 / 2049))
    back = nd.nddct3(nd.nddct2(r, h, axis=0), hi, axis=0)
    assert _rel(back, r) <= 1e-5
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 4, 2]
    assert engine.c2c.calls == calls


def _fourstep_forms():
    return (kfft.fourstep_mid.launches, kfft.fourstep_mid.radix_launches,
            kfft.fourstep_mid.dense_launches, kfft.rows_store_t.launches,
            kfft.rows_store_t.radix_launches)


def test_fourstep_kernels_match_plain_in_each_form(dev):
    """Kernel 7 on the radix column tile (n1 = 144, 512, 1024, 384, 2176
    with n2 = 17: ragged and one-column tiles) and on the dense product at
    the prime n1 = 131, and kernel 13 on the radix row core (n2 = 1024 and
    128, over rows that cross a batch boundary inside a block: n1 = 144 and
    3), both signs, against their plain versions."""
    g = torch.Generator(device=dev).manual_seed(17)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    before = _fourstep_forms()
    for shape in ((2, 144, 160), (2, 131, 160), (3, 512, 130), (1, 1024, 1024), (2, 384, 384),
                  (2, 2176, 17)):
        x = crandn(*shape)
        for sign in (-1, +1):
            assert _rel(kfft.fourstep_mid(x, sign), kfft.fourstep_mid_plain(x, sign)) <= TOL, \
                (shape, sign)
    for shape in ((3, 144, 1024), (3, 144, 128), (5, 3, 128)):
        x = crandn(*shape)
        for sign, scale in ((-1, None), (+1, 1 / (shape[1] * shape[2]))):
            y = kfft.rows_store_t(x, sign, scale)
            assert y.shape == (shape[0], shape[2], shape[1])
            assert _rel(y, kfft.rows_store_t_plain(x, sign, scale)) <= TOL, (shape, sign)
    assert [a - b for a, b in zip(_fourstep_forms(), before)] == [12, 10, 2, 6, 6]


def test_fourstep_launchers_at_every_tile(dev):
    """Kernel 7's radix launcher at every column count C that fits (at
    C <= 2 with both loads) and kernel 13's at every row count the
    row skeleton holds (its pitch from fft.py::store_t_pitch), against the
    plain versions, on ragged shapes and rows that cross batch
    boundaries."""
    g = torch.Generator(device=dev).manual_seed(29)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    for shape in ((3, 144, 130), (2, 1024, 33), (1, 4096, 17)):
        x = crandn(*shape)
        n1 = shape[1]
        tw = kfft.device_fourstep_tw(n1, shape[2], -1, dev)
        want = kfft.fourstep_mid_plain(x, -1)
        for c in (1, 2, 4, 8, 16, 32):
            if n1 * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(n1, c) > 512:
                continue
            for ldg in (False, True):
                if ldg and c > 2:
                    continue
                y = torch.full_like(x, float("nan"))
                kfft.fourstep_launch(x, y, -1, tw, c, ldg)
                assert _rel(y, want) <= TOL, (shape, c, ldg)
    for shape in ((3, 5, 128), (2, 144, 1024), (1, 3, 8192)):
        x = crandn(*shape)
        n2 = shape[2]
        want = kfft.rows_store_t_plain(x, +1, 0.5)
        most = 1 if n2 > kfft.RADIX_WIDE_N else min(32, kfft.RADIX_MAX_THREADS // -(-n2 // 16))
        for rows in range(1, most + 1):
            y = torch.full((shape[0], n2, shape[1]), float("nan"), dtype=x.dtype, device=dev)
            kfft.rows_store_t_launch(x, y, +1, 0.5, rows)
            assert _rel(y, want) <= TOL, (shape, rows)


def test_long_lengths_run_on_the_fourstep_kernels(dev):
    """One row of 2^20 (K7 and K13 on the radix core, (1024, 1024)) and
    40960 along axis 0 of (40960, 128) (K7 on the radix tile at n1 = 256,
    K8's rows of 160 and the swap) round trip
    against torch.fft in complex128; ndfft at the prime 10007 runs the
    lane's chirp-z with its sub-FFTs on the four-step (it raised before K7
    was ported). The engine never runs."""
    g = torch.Generator(device=dev).manual_seed(18)
    calls = engine.c2c.calls
    before = _fourstep_forms()
    for shape, axis in (((1, 1 << 20), 1), ((40960, 128), 0), ((128, 10007), 1)):
        x = torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))
        y = nd.ndfft(x, axis=axis)
        back = nd.ndifft(y, axis=axis)
        ref = torch.fft.fft(x.to(torch.complex128), dim=axis)
        assert _rel(y.to(torch.complex128), ref) <= 1e-5 and _rel(back, x) <= 1e-5, shape
    assert [a - b for a, b in zip(_fourstep_forms(), before)] == [2 + 2 + 4, 2 + 2 + 4, 0, 2, 2]
    assert engine.c2c.calls == calls


def _spectral_forms():
    return (kfft.spectral_c2c_mid.launches, krfft.spectral_r2c_mid.launches,
            kdct.spectral_dct_mid.launches, kdct.spectral_dct_mid.wide_launches,
            kdct.spectral_dct_mid.npoint_launches, kdct.spectral_dct_mid.radix_launches)


def test_spectral_kernels_match_plain_in_each_form(dev):
    """Kernels 14 and 22 on the radix column tile (at the lengths of their
    old fixed and wide forms: n = 384 ... 20480, h = 256 ... 20480), K29 on
    the radix column tile (at the lengths of its old fixed, wide and n-point
    forms: h = 64 ... 16384, the odd k included) and at the remnant's
    n-point k = 131 and wide k = 262, ragged column tiles (L = 130, 17, 3),
    the largest tiles (F = 160 for K14/K22), broadcast and lane-varying H,
    real and complex (K14, K22), against their plain versions; neither K14
    nor K22 keeps a wide counter."""
    g = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    before = _spectral_forms()
    for nb, n, cols in ((2, 512, 130), (1, 1024, 257), (2, 384, 130), (1, 640, 17),
                        (1, 20480, 3)):
        x = torch.complex(randn(nb, n, cols), randn(nb, n, cols))
        for h, s in ((randn(n, 1), None), (torch.complex(randn(n, cols), randn(n, cols)), 1 / n)):
            assert _rel(kfft.spectral_c2c_mid(x, h, s),
                        kfft.spectral_c2c_mid_plain(x, h, s)) <= TOL, (n, cols)
    for nb, n, cols in ((2, 512, 130), (1, 1024, 257), (2, 768, 130), (1, 40960, 2)):
        x = randn(nb, n, cols)
        m = n // 2 + 1
        for hr, hi, s in ((randn(m, 1), None, 1 / n), (randn(m, cols), randn(m, cols), 0.5)):
            assert _rel(krfft.spectral_r2c_mid(x, hr, hi, n, s),
                        krfft.spectral_r2c_mid_plain(x, hr, hi, n, s)) <= TOL, (n, cols)
    for nb, n, cols in ((2, 512, 130), (1, 2048, 64), (2, 256, 130), (1, 1280, 130),
                        (1, 32768, 2), (2, 128, 130), (2, 384, 130), (1, 20352, 3),
                        (1, 128 * 131, 3), (1, 128 * 262, 2)):
        x = randn(nb, n, cols)
        for hv, s2, s3 in ((randn(n, 1), 2.0, 2.0), (randn(n, cols), None, 0.37)):
            assert _rel(kdct.spectral_dct_mid(x, hv, s2, s3),
                        kdct.spectral_dct_mid_plain(x, hv, s2, s3)) <= TOL, (n, cols)
    assert [a - b for a, b in zip(_spectral_forms(), before)] == [10, 8, 20, 2, 2, 16]
    assert not hasattr(kfft.spectral_c2c_mid, "wide_launches")
    assert not hasattr(krfft.spectral_r2c_mid, "wide_launches")


def test_spectral_functions_run_on_the_fused_kernels(dev):
    """ndspectral_c2c / r2c / dct / dst along axis 0 take one fused launch
    each and agree with the composition of the public transforms; along the
    last axis they compose. The
    engine never runs; n = 128 * 161 takes one launch on the radix column
    tile (it raised before the long forms were ported, and took the n-point
    form before kernel 29 moved to the radix column tile)."""
    g = torch.Generator(device=dev).manual_seed(20)
    calls = engine.c2c.calls
    before = _spectral_forms()
    xc = torch.view_as_complex(torch.randn(1024, 130, 2, generator=g, device=dev))
    hc = torch.randn(1024, 130, generator=g, device=dev)
    y = nd.ndspectral_c2c(xc, hc, axis=0)
    want = nd.ndifft(hc * nd.ndfft(xc, axis=0), axis=0)
    assert _rel(y, want) <= 1e-5
    xr = torch.randn(1024, 130, generator=g, device=dev)
    hr = torch.complex(torch.randn(513, generator=g, device=dev),
                       torch.randn(513, generator=g, device=dev))
    y = nd.ndspectral_r2c(xr, hr, axis=0)
    want = nd.ndifft_r2c(hr[:, None] * nd.ndfft_r2c(xr, axis=0), axis=0)
    assert _rel(y, want) <= 1e-5
    hd = torch.rand(1024, generator=g, device=dev)
    inv = nd.DctHandler(1024).normalization(nd.Normalization.scalar(1 / 2048))
    y = nd.ndspectral_dct(xr, hd, None, inv, axis=0)
    want = nd.nddct3(hd[:, None] * nd.nddct2(xr, axis=0), inv, axis=0)
    assert _rel(y, want) <= 1e-5
    invs = nd.DstHandler(1024).normalization(nd.Normalization.scalar(1 / 2048))
    y = nd.ndspectral_dst(xr, hd, None, invs, axis=0)
    want = nd.nddst3(hd[:, None] * nd.nddst2(xr, axis=0), invs, axis=0)
    assert _rel(y, want) <= 1e-5
    assert [a - b for a, b in zip(_spectral_forms(), before)] == [1, 1, 2, 0, 0, 2]
    nd.ndspectral_r2c(xr.T.contiguous(), torch.ones(513, device=dev), axis=1)   # last axis
    assert krfft.spectral_r2c_mid.launches - before[1] == 1
    xl = torch.randn(128 * 161, 128, generator=g, device=dev)
    hl = torch.rand(128 * 161, generator=g, device=dev)
    before = kdct.spectral_dct_mid.radix_launches
    y = nd.ndspectral_dct(xl, hl, axis=0)
    assert kdct.spectral_dct_mid.radix_launches - before == 1
    assert _rel(y, kdct.spectral_dct_mid_plain(xl[None], hl[:, None], 2.0, 2.0)[0]) <= TOL
    assert engine.c2c.calls == calls


def test_long_forms_match_plain(dev):
    """Kernels 23 to 26 and 29 in the n-point form on the real tile at odd
    k > 160 (n = 20864 with the prime k = 163; at n = 20608 and
    32640 = 128 * 255 the radix cores), and kernel
    28 past the complex tile at F = 161, 163 and 256 (n = 41216, 41728,
    65536: the four-step, the long form at the prime, the four-step): one
    call each, against the plain versions, with ragged column tiles and a
    broadcast and a lane-varying H."""
    g = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    before = [(f.launches, f.npoint_launches) for f in
              (kdct.dct2_nat, kdct.dct3_nat, kdct.dct2_mid, kdct.dct3_mid,
               kdct.spectral_dct_mid)]
    for n in (20608, 20864, 32640):
        x = randn(2, n, 130)
        r = randn(3, n)
        for scale in (2.0, None):
            assert _rel(kdct.dct2_mid(x, scale), kdct.dct2_mid_plain(x, scale)) <= TOL, n
            assert _rel(kdct.dct3_mid(x, scale), kdct.dct3_mid_plain(x, scale)) <= TOL, n
            assert _rel(kdct.dct2_nat(r, scale), kdct.dct2_nat_plain(r, scale)) <= TOL, n
            assert _rel(kdct.dct3_nat(r, scale), kdct.dct3_nat_plain(r, scale)) <= TOL, n
        for hv, s2, s3 in ((randn(n, 1), 2.0, 1.0 / n), (randn(n, 130), None, 0.37)):
            assert _rel(kdct.spectral_dct_mid(x, hv, s2, s3),
                        kdct.spectral_dct_mid_plain(x, hv, s2, s3)) <= TOL, n
    after = [(f.launches, f.npoint_launches) for f in
             (kdct.dct2_nat, kdct.dct3_nat, kdct.dct2_mid, kdct.dct3_mid,
              kdct.spectral_dct_mid)]
    assert [(a - c, b - d) for (a, b), (c, d) in zip(after, before)] == [(6, 2)] * 5
    counts = ("launches", "long_launches", "fourstep_launches", "wide_launches")
    before = [getattr(kdct.dct4_mid, c) for c in counts]
    for n in (41216, 41728, 65536):
        x = randn(2, n, 130)
        for scale in (2.0, None):
            assert _rel(kdct.dct4_mid(x, scale), kdct.dct4_mid_plain(x, scale)) <= TOL, n
    after = [getattr(kdct.dct4_mid, c) for c in counts]
    assert [a - b for a, b in zip(after, before)] == [6, 2, 4, 0]


def _tile_fits(n, c):
    """A radix column tile of c columns of length n that a block takes."""
    return n * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(n, c) <= (
        kfft.RADIX_MAX_THREADS if n * c <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS)


def test_axis_mid_radix_kernel_matches_plain(dev):
    """Kernel 1 on the radix column tile: each column count C = 1 ... 16 that
    the tile allows, both loads (evict-first and read-only) at C <= 2, at
    F = 3, 4, 5, 32, 160 with ragged L, both signs and the scale 1/n; the
    wrapper at its main shapes (1, 512, 131584), (768, 768, 385) (the plain
    version on the first 64 planes) and (1, 4096, 4096), every launch
    counted as the radix form."""
    g = torch.Generator(device=dev).manual_seed(40)

    def crandn(*shape):
        return torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))

    for shape in ((3, 384, 130), (2, 512, 257), (1, 640, 129), (1, 4096, 33), (1, 20480, 5)):
        x = crandn(*shape)
        n = shape[1]
        for sign, scale in ((-1, None), (+1, 1.0 / n)):
            want = kfft.c2c_axis_mid_plain(x, sign, scale)
            for c in (1, 2, 4, 8, 16):
                if not _tile_fits(n, c):
                    continue
                for ldg in (False, True) if c <= 2 else (False,):
                    got = torch.full_like(x, float("nan"))
                    kfft.mid_radix_launch(x, got, sign, 1.0 if scale is None else scale, c, ldg)
                    assert _rel(got, want) <= TOL, (shape, c, ldg, sign)
    before = (kfft.c2c_axis_mid.launches, kfft.c2c_axis_mid.radix_launches)
    for shape, cut in (((1, 512, 512 * 257), 1), ((768, 768, 385), 64), ((1, 4096, 4096), 1)):
        x = crandn(*shape)
        got = kfft.c2c_axis_mid(x, +1, 1.0 / shape[1])
        assert _rel(got[:cut], kfft.c2c_axis_mid_plain(x[:cut], +1, 1.0 / shape[1])) <= TOL, shape
        del x, got
    assert (kfft.c2c_axis_mid.launches - before[0],
            kfft.c2c_axis_mid.radix_launches - before[1]) == (3, 3)


def test_packed_mid_radix_kernel_matches_plain(dev):
    """Kernel 18 on the radix column tile: each column count C = 1 ... 32
    that the tile allows at h = 256, 384, 1024, 1536 and 10240 (DST-I at
    n = 20479) with ragged L, the scales None and -0.5; the wrapper at its
    main shapes (1023, 1024, 1023) (the plain version on the first 16
    planes) and (1, 1536, 1535), every launch counted as the radix form."""
    g = torch.Generator(device=dev).manual_seed(41)
    for shape in ((2, 256, 130), (1, 384, 383), (1, 1024, 257), (1, 1536, 129),
                  (1, 10240, 130)):
        xe = torch.randn(*shape, generator=g, device=dev)
        xo = torch.randn(*shape, generator=g, device=dev)
        h = shape[1]
        out = torch.empty((shape[0], h + 1, shape[2]), dtype=torch.complex64, device=dev)
        for scale in (None, -0.5):
            want = krfft.r2c_packed_mid_plain(xe, xo, scale)
            for c in (1, 2, 4, 8, 16, 32):
                if not _tile_fits(h, c):
                    continue
                out.fill_(float("nan"))
                krfft.r2c_packed_mid_launch(xe, xo, out, 1.0 if scale is None else scale, c)
                assert _rel(out, want) <= TOL, (shape, c, scale)
    before = (krfft.r2c_packed_mid.launches, krfft.r2c_packed_mid.radix_launches)
    for shape, cut in (((1023, 1024, 1023), 16), ((1, 1536, 1535), 1)):
        xe = torch.randn(*shape, generator=g, device=dev)
        xo = torch.randn(*shape, generator=g, device=dev)
        got = krfft.r2c_packed_mid(xe, xo, -0.5)
        assert _rel(got[:cut], krfft.r2c_packed_mid_plain(xe[:cut], xo[:cut], -0.5)) <= TOL
        del xe, xo, got
    assert (krfft.r2c_packed_mid.launches - before[0],
            krfft.r2c_packed_mid.radix_launches - before[1]) == (2, 2)


def test_c2r_radix_kernels_match_plain(dev):
    """Kernel 3 on the radix row core at every count of rows a block that
    fits (h = 256, 384, 640, 1280, 4608, 16384, 20480; ragged row counts;
    odd h + 1 bins a row, so every other row starts off a 16-byte boundary)
    and kernel 17 on the radix column tile at every column count C that the
    tile allows, at h = 256, 384, 1024, 1536, 10240 and 20480 with ragged
    L; the DC and
    Nyquist imaginary parts that must be ignored, the scales None, 1/n and
    -0.5; then the wrappers at their main shapes, zero sizes and a spectrum
    that is not 16-byte aligned, every launch counted in radix_launches."""
    g = torch.Generator(device=dev).manual_seed(42)

    def crandn(*shape):
        """A spectrum whose DC and Nyquist bins (dim 1) carry imaginary parts
        that must be ignored."""
        s = torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))
        s[:, 0] += 100j
        s[:, -1] += 100j
        return s

    for t, h in ((131, 256), (7, 384), (33, 640), (5, 1280), (3, 4608), (2, 16384), (2, 20480)):
        n = 2 * h
        s = crandn(t, h + 1)
        per = 16 if h <= kfft.RADIX_WIDE_N else 32 if h <= 16384 else 40
        most = (kfft.RADIX_MAX_THREADS if h <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS)
        for scale in (None, 1 / n, -0.5):
            want = krfft.c2r_nat_plain(s, n, scale)
            for rows in range(1, most // -(-h // per) + 1):
                if rows * h > kfft.RADIX_MAX_ELEMS:
                    break
                got = krfft.c2r_radix_launch(s, n, scale, rows)
                assert _rel(got, want) <= TOL, (t, h, rows, scale)
    for shape in ((2, 256, 130), (1, 384, 383), (1, 1024, 257), (1, 1536, 129),
                  (1, 10240, 130), (1, 20480, 3)):
        nb, h, cols = shape
        n = 2 * h
        s = crandn(nb, h + 1, cols)
        out = torch.empty((nb, n, cols), device=dev)
        for scale in (None, 1 / n, -0.5):
            want = krfft.c2r_mid_plain(s, n, scale)
            for c in (1, 2, 4, 8, 16, 32):
                if not _tile_fits(h, c):
                    continue
                out.fill_(float("nan"))
                krfft.c2r_mid_radix_launch(s, out, n, scale, c)
                assert _rel(out, want) <= TOL, (shape, c, scale)
    before = [(f.launches, f.radix_launches) for f in (krfft.c2r_nat, krfft.c2r_mid)]
    for t, n in ((262144, 512), (589824, 768), (32768, 32768)):
        s = crandn(t, n // 2 + 1)
        got = krfft.c2r_nat(s, n, 1 / n)
        cut = max(1, t // 64)
        assert _rel(got[:cut], krfft.c2r_nat_plain(s[:cut], n, 1 / n)) <= TOL, (t, n)
        del s, got
    for shape in ((1, 512, 262144), (512, 512, 512), (1, 1280, 1280)):
        nb, n, cols = shape
        s = crandn(nb, n // 2 + 1, cols)
        got = krfft.c2r_mid(s, n, 1 / n)
        cut = min(nb, 16)
        assert _rel(got[:cut], krfft.c2r_mid_plain(s[:cut], n, 1 / n)) <= TOL, shape
        del s, got
    s = torch.view_as_complex(torch.randn(5 * 513 + 1, 2, generator=g, device=dev))[1:]
    s = s.reshape(5, 513)
    assert s.data_ptr() % 16
    assert _rel(krfft.c2r_nat(s, 1024), krfft.c2r_nat_plain(s, 1024)) <= TOL
    assert krfft.c2r_nat(torch.zeros(0, 513, dtype=torch.complex64, device=dev), 1024).shape \
        == (0, 1024)
    assert krfft.c2r_mid(torch.zeros(2, 257, 0, dtype=torch.complex64, device=dev),
                         512).shape == (2, 512, 0)
    assert [(f.launches - a, f.radix_launches - b) for f, (a, b) in
            zip((krfft.c2r_nat, krfft.c2r_mid), before)] == [(4, 4), (3, 3)]


def test_dense_radix_kernels_match_plain(dev):
    """Kernel 21 on the radix column tile at even n (kernel 17's kernel at
    any h = n/2 with a plan: n = 4, 6, 130, 256, 264, 1100) and at odd n
    (the length-n inverse of the Hermitian extension, its mirrored half
    filled in the prologue: n = 5, 129, 1095), and kernel
    27's DCT-I (n = 3, 129, 265, 1025) and DCT-II/III (n = 4, 130, 512,
    1024, 1100) on it, at every column count C that the tile allows, with
    ragged L and two scales; the spectra carry DC and Nyquist imaginary
    parts that must be ignored. Then the wrappers at their main shapes (the
    plain version on a slice), every launch at a length with a plan counted
    in radix_launches, and the dense product at the remnant types and
    lengths (DCT-IV, odd n for DCT-II/III, n = 262 and 1099 without a
    plan, kernel 21 at n = 129 and DCT-I at n = 130, where
    fft.dense_beats_radix gives it the dense product)."""
    g = torch.Generator(device=dev).manual_seed(22)

    def crandn(*shape):
        s = torch.view_as_complex(torch.randn(*shape, 2, generator=g, device=dev))
        s[:, 0] += 100j
        s[:, -1] += 100j
        return s

    for nb, n, cols in ((2, 4, 130), (2, 5, 130), (1, 6, 33), (2, 129, 257), (1, 130, 130),
                        (1, 256, 383), (2, 264, 129), (1, 1095, 130), (1, 1100, 65)):
        s = crandn(nb, n // 2 + 1, cols)
        out = torch.empty((nb, n, cols), device=dev)
        length = krfft.r2c_mid_len(n)
        for scale in (None, 1 / n):
            want = krfft.c2r_dense_radix_plain(s, n, scale)
            for c in (1, 2, 4, 8, 16, 32):
                if not _tile_fits(length, c):
                    continue
                out.fill_(float("nan"))
                krfft.c2r_dense_radix_launch(s, out, n, scale, c)
                assert _rel(out, want) <= TOL, (n, cols, c, scale)
    for nb, n, cols in ((2, 3, 130), (1, 4, 129), (2, 129, 130), (1, 130, 257), (1, 265, 130),
                        (1, 512, 129), (2, 1024, 33), (1, 1025, 65), (1, 1100, 130)):
        x = torch.randn(nb, n, cols, generator=g, device=dev)
        y = torch.empty_like(x)
        for t in (1, 2, 3):
            h = kdct.dct_radix_len(n, t)
            if h is None:
                continue
            for scale in (None, 2.0):
                want = kdct.dct_radix_plain(x, t, scale)
                for c in (1, 2, 4, 8, 16, 32):
                    if not _tile_fits(h, c):
                        continue
                    y.fill_(float("nan"))
                    kdct.dct_radix_launch(x, y, t, scale, c)
                    assert _rel(y, want) <= TOL, (n, cols, t, c, scale)
    before = [(f.launches, f.radix_launches) for f in (krfft.c2r_dense_mid, kdct.dct_dense_mid)]
    for nb, n, cols in ((1, 256, 65536), (1, 129, 65536), (1, 255, 32768), (1, 262, 130),
                        (1, 1099, 130)):
        s = crandn(nb, n // 2 + 1, cols)
        plain = krfft._C2R_DENSE_PLAIN[krfft.c2r_dense_form(n)]
        assert _rel(krfft.c2r_dense_mid(s, n, 1 / n), plain(s, n, 1 / n)) <= TOL, n
    for shape, types in (((1, 512, 262144), (2, 3)), ((1024, 1024, 1024), (2, 3)),
                         ((1, 129, 16641), (1,)), ((2, 130, 130), (1,)), ((2, 1024, 130), (4,)),
                         ((2, 265, 130), (2, 3)),
                         ((1, 1099, 130), (2, 3))):
        x = torch.randn(*shape, generator=g, device=dev)
        cut = min(shape[0], 16)
        for t in types:
            plain = kdct.dct_radix_plain if kdct.dct_radix_len(shape[1], t) else \
                kdct.dct_dense_mid_plain
            got = kdct.dct_dense_mid(x, t, 2.0)
            assert _rel(got[:cut], plain(x[:cut], t, 2.0)) <= TOL, (shape, t)
            del got
        del x
    assert [(f.launches - a, f.radix_launches - b) for f, (a, b) in
            zip((krfft.c2r_dense_mid, kdct.dct_dense_mid), before)] == [(5, 2), (11, 5)]
