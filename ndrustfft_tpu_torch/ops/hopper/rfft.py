"""The R2C and C2R kernels.

* Kernels 2 and 3, :func:`r2c_nat` and :func:`c2r_nat`: R2C of contiguous
  (T, n) rows, even n, h = n/2 = 128 * F, and its C2R, at every F on the
  mixed-radix row core, the unpack as the R2C's epilogue and the inverse
  unpack as the C2R's prologue, both in shared memory
  (``csrc/rfft_radix.cu`` on ``csrc/fft_radix.cuh``; replace the JAX
  package's ``ops/pallas/rfft.py::_r2c_kernel_nat`` and
  ``_c2r_kernel_nat``).
* Kernels 16 and 17, :func:`r2c_mid` and :func:`c2r_mid`: the same two along
  the middle axis of (B, n, L), replacing ``rfft.py::_r2c_kernel_mid`` and
  ``_c2r_kernel_mid``: the half-length C2C on the mixed-radix core's column
  tile, with the unpack as kernel 16's epilogue and the inverse unpack as
  kernel 17's prologue, in shared memory (``csrc/rfft_mid_radix.cu`` on
  ``csrc/fft_radix.cuh``).
* Kernels 20 and 21, :func:`r2c_dense_mid` and :func:`c2r_dense_mid`: R2C and
  C2R along the middle axis, 4 <= n <= 1100, odd n included, replacing
  ``rfft.py::_r2c_dense_kernel`` and ``_c2r_dense_kernel``. Where
  :func:`~.fft.radix_plan` has the transform length (h = n/2 for even n, n
  for odd n), kernel 20 runs kernel 16's column kernel (at odd n the
  length-n C2C of (x, 0), half of its bins stored) and kernel 21 kernel
  17's (at odd n the length-n inverse of the column's Hermitian extension,
  its mirrored half filled in a prologue, the real part stored). At the
  other lengths (a prime factor above 127) kernel 20 runs a real-input
  chirp-z on kernel 11's column kernel (``csrc/fft_blue_radix.cu``:
  the chirp length n/2 with the unpack at even n, n at odd n, the
  convolution length the 7-smooth M >= 2 len - 1 of least modelled time,
  :func:`~.fft.chirp_m`) where :func:`r2c_dense_form` names it, and kernel
  21 the same chirp-z backwards where :func:`c2r_dense_form` names it (the
  column's inverse as conj(FFT(conj V)): kernel 17's inverse unpack or the
  Hermitian extension as the load's prologue, a real store;
  ``csrc/rfft_blue_radix.cu``); else one real
  product with a host table, which kernel 21 also keeps at the 61 odd n
  where :func:`~.fft.dense_beats_radix` holds (a large prime stage, such as
  129 = 3 * 43) (``csrc/rfft_dense.cu`` on the dense loop
  ``csrc/dense_real.cuh``).
* Kernels 18 and 19, :func:`r2c_packed_mid` and :func:`dct1_mid`: the R2C
  of a column built otherwise, along the middle axis, times a scale
  (replace ``rfft.py::_r2c_kernel_packed_mid`` and ``_dct1_kernel_mid``).
  Kernel 18, the packed R2C of two (B, h, L) streams, z = xe + i xo
  (DST-I's odd extension), is kernel 16's column kernel with a two-stream
  load and the scale in its store (``csrc/rfft_mid_radix.cu``); kernel 19,
  DCT-I of (B, h + 1, L) on its even extension, runs kernel 27's DCT-I on
  the same column tile (``csrc/dct_mid_radix.cu``: the extension's pairs
  in the load, the unpack's real rows in the epilogue) at every F <= 160
  of its routes, each with a plan.
* Kernel 15, the packed R2C of contiguous (T, n) rows (replaces
  ``rfft.py::_r2c_kernel``), in three wrappers by half length h = n/2:
  :func:`r2c_packed` for h = 128 * F (kernel 2's code, with F = 1 added),
  :func:`r2c_packed_generic` for h > 256 without a split and
  :func:`r2c_packed_dense` for every other h <= 256 with a plan (many rows
  a block at small h) run the half-length C2C on the mixed-radix row core
  with the unpack as its epilogue in shared memory (``csrc/rfft_radix.cu``
  on ``csrc/fft_radix.cuh``); :func:`r2c_packed_dense` runs kernel 20's
  even chirp-z with row-addressed policies at h = 1, 31 and the primes
  131 ... 251 (``csrc/rfft_blue_radix.cu``), as :func:`packed_dense_form`
  names.
* Kernel 22, :func:`spectral_r2c_mid`: the fused pipeline C2R(H * R2C(x))
  along the middle axis of (B, n, L), kernel 16's load and half-length
  transform, the pair pass (unpack, multiply, inverse unpack) and kernel
  17's half-length inverse and store on one radix column tile, the inverse
  on the sign +1 table (``csrc/spectral_r2c_radix.cu``; replaces
  ``rfft.py::_spectral_kernel_mid``).

This module holds their host-built constants, their plain PyTorch versions
and their wrappers, whose ``launches`` attributes count kernel launches
(kernel 22 has one form, counted in ``launches``; kernels 2, 3 and 15 at
h = 128 * F and kernels 16,
17, 18 and 19 count every launch in ``radix_launches`` as well,
kernels 20 and 21 their launches on the radix column tile and kernel 15's
dense rows theirs on the radix row core; kernels 20 and 21 and kernel
15's dense rows count their chirp-z's in ``chirp_launches``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ...plan import _cis, blue_h, chirp
from . import _build
from .fft import (GENERIC_MAX_N, M, RADIX_CODELETS, RADIX_MAX_ELEMS, RADIX_MAX_P,
                  RADIX_MAX_STAGES, RADIX_MAX_THREADS, RADIX_SMALL_TILE, bts2_plain,
                  c2c_radix_mid_plain, c2c_radix_rows_plain, check_cuda, check_mult, chirp_m,
                  chirp_z_radix_plain, core_f, dense_beats_radix, dense_tile,
                  device_radix, device_wq, generic_split, idle_lanes, mult_planes,
                  num_sms, pair_tensor, radix_block, radix_cols_threads, radix_mid_cols,
                  radix_plan, spread_rows)

# lengths kernels 20 and 21 take: the JAX package's rfft_dense_mid_supported
# (its _DENSE_RFFT_MAX), which the routes mirror
DENSE_MIN_N, DENSE_MAX_N = 4, 1100
# the dense lane DFT's h <= 256 (the JAX package's _half_fft_consts)
PACKED_DENSE_MAX_H = 256


def packed_core(h: int) -> bool:
    """Kernel 15 takes half length h = 128 * F (:func:`r2c_packed`)."""
    return core_f(h) is not None


def unpack_twiddle(n: int):
    """(re, im) float32 of W_n^k, k = 0..n/2-1: the forward unpack twiddle,
    as the JAX package builds it for ``_r2c_kernel_nat``."""
    k = np.arange(n // 2, dtype=np.int64)
    ur, ui = _cis(2 * k, n, -1)
    return np.asarray(ur, np.float32), np.asarray(ui, np.float32)


def c2r_unpack_consts(n: int, scale: float = 1.0) -> np.ndarray:
    """(h, 4) float32 rows (A.re, A.im, B.re, B.im) of the inverse unpack
    G[k] = A[k] S[k] + B[k] conj S[h-k], with A = s (1 + i u), B = s (1 - i u),
    u = W_n^{-k}. The 1/2 of the unpack and the 2 of the half-length inverse
    cancel, and the scale s rides both constants."""
    k = np.arange(n // 2, dtype=np.int64)
    ur, ui = _cis(2 * k, n, +1)
    ab = np.stack([1.0 - ui, ur, 1.0 + ui, -ur], axis=1) * scale
    return ab.astype(np.float32)


@lru_cache(maxsize=64)
def _device_tw(n: int, device: torch.device) -> torch.Tensor:
    re, im = unpack_twiddle(n)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


@lru_cache(maxsize=64)
def _device_ab(n: int, scale: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(c2r_unpack_consts(n, scale)).to(device)


def _mirror(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """z[(h - k) % h] along ``dim`` for k = 0..h-1."""
    return torch.roll(z.flip(dim), 1, dims=dim)


def _unpack(zz: torch.Tensor, tw: torch.Tensor, dim: int) -> torch.Tensor:
    """The R2C unpack of the half-length spectrum Z along ``dim`` (its last
    axis or dim 1 of (B, h, L)): X[k] = Fe + W_n^k Fo, then X[h]."""
    zm = _mirror(zz, dim).conj()
    fe = 0.5 * (zz + zm)
    fo = -0.5j * (zz - zm)
    spec = fe + (tw if dim == -1 else tw[:, None]) * fo
    z0 = zz.narrow(dim, 0, 1)
    return torch.cat([spec, (z0.real - z0.imag).to(spec.dtype)], dim=dim)


def r2c_radix_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the R2C on the radix row core (kernels 2 and 15):
    (T, n) float32 -> (T, n/2+1) complex64, the radix core's plain version
    on the row read as its complex pairs z[t] = x[2t] + i x[2t+1] (h = n / 2
    of them), then the unpack."""
    t, n = x.shape
    h = n // 2
    z = torch.view_as_complex(x.reshape(t, h, 2).contiguous())
    return _unpack(c2c_radix_rows_plain(z, -1), _device_tw(n, x.device), -1)


r2c_nat_plain = r2c_radix_plain     # kernel 2


def _mask_imag0(s: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """s with the imaginary part of its first entry along ``dim`` (the last
    axis, or dim 1 of a 3-D tensor) set to 0."""
    mask = torch.ones(s.shape[dim], dtype=s.real.dtype, device=s.device)
    mask[0] = 0.0
    if dim != -1:
        mask = mask[:, None]
    return torch.complex(s.real, s.imag * mask)


def _inverse_unpack(s: torch.Tensor, n: int, scale, dim: int) -> torch.Tensor:
    """G[k] = A[k] S[k] + B[k] conj S[h-k] along ``dim`` (the last axis, or
    dim 1 of (B, h+1, L)), with the DC and Nyquist imaginary parts ignored."""
    h = n // 2
    sc = 1.0 if scale is None else float(scale)
    ab = _device_ab(n, sc, s.device)
    if dim != -1:
        ab = ab[:, None, :]
    sk = _mask_imag0(s.narrow(dim, 0, h), dim)                # S[k], DC imag = 0
    sm = _mask_imag0(s.narrow(dim, 1, h).flip(dim), dim)      # S[h-k], Nyquist imag = 0
    return (torch.complex(ab[..., 0], ab[..., 1]) * sk
            + torch.complex(ab[..., 2], ab[..., 3]) * sm.conj())


def c2r_nat_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 3 on the radix row core: (T, n/2+1) complex64
    -> (T, n) float32, times ``scale``, with the DC and Nyquist imaginary
    parts ignored: the inverse unpack G (:func:`_inverse_unpack`), then the
    radix core's plain version with the sign +1 table on the kernel's plan
    (:func:`~.fft.c2c_radix_rows_plain`), z read as the real row's pairs."""
    t = s.shape[0]
    z = c2c_radix_rows_plain(_inverse_unpack(s, n, scale, -1), +1)
    return torch.view_as_real(z).reshape(t, n)


def _check_nat(n: int, what: str) -> int:
    """F of the half length h = n/2 = 128 * F that kernels 2, 3, 15, 16, 17
    and 22 take (:func:`~.fft.core_f`: the JAX package's twostep split and a
    plan; the radix core has radix_plan(h) at each), or raise."""
    f = None if n % 2 else core_f(n // 2)
    if f is None:
        raise ValueError(f"{what}: n={n} is not 2 h with h = 128 * F, a twostep split "
                         f"and a plan (128 <= h <= {GENERIC_MAX_N})")
    return f


def r2c_radix_launch(x: torch.Tensor, what: str, rows=None) -> torch.Tensor:
    """The R2C of the rows of a (T, n) float32 CUDA tensor at half length h
    = n/2 on the radix row core with the unpack epilogue (kernels 2 and 15),
    ``rows`` a block (by default :func:`radix_block`); counts nothing."""
    check_cuda(x, torch.float32, what)
    if x.data_ptr() % 8:       # the kernel reads rows as float2
        x = x.clone()
    t, n = x.shape
    h = n // 2
    plan = radix_plan(h)
    table = device_radix(h, -1, x.device)
    u = _device_tw(n, x.device)
    out = torch.empty((t, h + 1), dtype=torch.complex64, device=x.device)
    if t == 0:
        return out
    with torch.cuda.device(x.device):
        err = _build.lib().ndfft_r2c_radix(
            x.data_ptr(), out.data_ptr(), table.data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), u.data_ptr(), t, h,
            rows or radix_block(h, t, num_sms(x.device)),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, what)
    return out


def _r2c_rows(x: torch.Tensor, wrapper, rows=None) -> torch.Tensor:
    """``wrapper``'s (kernel 2's or 15's) launch on the radix row core,
    ``rows`` a block (by default :func:`radix_block`), counted in its
    ``launches`` and ``radix_launches``."""
    out = r2c_radix_launch(x, wrapper.__name__, rows)
    wrapper.launches += x.shape[0] > 0
    wrapper.radix_launches += x.shape[0] > 0
    return out


def r2c_nat(x: torch.Tensor) -> torch.Tensor:
    """R2C of the rows of a (T, n) float32 tensor -> (T, n/2+1) complex64,
    h = n/2 = 128 * F. A CPU tensor runs the plain version; a CUDA tensor
    launches kernel 2 on the radix row core or raises."""
    if x.dim() != 2:
        raise ValueError(f"r2c_nat: expected (T, n), got {tuple(x.shape)}")
    _check_nat(x.shape[1], "r2c_nat")
    if x.device.type == "cpu":
        return r2c_nat_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_nat: unsupported device {x.device}")
    return _r2c_rows(x, r2c_nat)


r2c_nat.launches = 0
r2c_nat.radix_launches = 0


def c2r_radix_launch(s: torch.Tensor, n: int, scale=None, rows=None) -> torch.Tensor:
    """Kernel 3 on the (T, n/2+1) complex64 rows of a CUDA tensor: the radix
    row core with the inverse unpack as its prologue, ``rows`` a block (by
    default :func:`~.fft.radix_block`); counts nothing."""
    check_cuda(s, torch.complex64, "c2r_nat")
    t = s.shape[0]
    h = n // 2
    out = torch.empty((t, n), dtype=torch.float32, device=s.device)
    if t == 0:
        return out
    plan = radix_plan(h)
    ab = _device_ab(n, 1.0 if scale is None else float(scale), s.device)
    with torch.cuda.device(s.device):
        err = _build.lib().ndfft_c2r_radix(
            s.data_ptr(), out.data_ptr(), device_radix(h, +1, s.device).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), ab.data_ptr(), t, h,
            rows or radix_block(h, t, num_sms(s.device)),
            torch.cuda.current_stream(s.device).cuda_stream)
    _build.check(err, "c2r_nat")
    return out


def c2r_nat(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """C2R of the rows of a (T, n/2+1) complex64 spectrum -> (T, n) float32,
    h = n/2 = 128 * F, times ``scale``; the DC and Nyquist imaginary parts
    are ignored. A CPU tensor runs the plain version; a CUDA tensor launches
    kernel 3 on the radix row core, counted in ``launches`` and
    ``radix_launches``, or raises."""
    _check_nat(n, "c2r_nat")
    h = n // 2
    if s.dim() != 2 or s.shape[1] != h + 1:
        raise ValueError(f"c2r_nat: expected (T, {h + 1}), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return c2r_nat_plain(s, n, scale)
    if s.device.type != "cuda":
        raise ValueError(f"c2r_nat: unsupported device {s.device}")
    out = c2r_radix_launch(s, n, scale)
    c2r_nat.launches += s.shape[0] > 0
    c2r_nat.radix_launches += s.shape[0] > 0
    return out


c2r_nat.launches = 0
c2r_nat.radix_launches = 0


# --------------------------------------------------------------------------
# Kernels 16, 17 and 20 on the radix column tile
# --------------------------------------------------------------------------


def r2c_mid_len(n: int) -> int:
    """The transform length of the R2C of n on the radix column tile: the
    half length h = n/2 for even n, n itself for odd n."""
    return n if n % 2 else n // 2


def r2c_mid_radix(n: int) -> bool:
    """The radix column tile takes the R2C of n (:func:`~.fft.radix_plan`
    has its transform length)."""
    return radix_plan(r2c_mid_len(n)) is not None


def r2c_mid_radix_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernels 16 and 20 on the radix column tile:
    (B, n, L) float32 -> (B, n//2+1, L) complex64 along dim 1. Even n: the
    radix core's plain version (:func:`~.fft.c2c_radix_mid_plain`) on the
    half-length columns x[:, 0::2] + i x[:, 1::2], then the unpack with the
    mirror row; odd n: the first (n + 1)/2 bins of its C2C of (x, 0)."""
    nb, n, cols = x.shape
    if n % 2:
        z = c2c_radix_mid_plain(torch.complex(x, torch.zeros_like(x)), -1)
        return z[:, :n // 2 + 1].contiguous()
    xv = x.reshape(nb, n // 2, 2, cols)
    zz = c2c_radix_mid_plain(torch.complex(xv[:, :, 0], xv[:, :, 1]), -1)
    return _unpack(zz, _device_tw(n, x.device), 1)


r2c_mid_plain = r2c_mid_radix_plain     # kernel 16


def r2c_mid_cols(n: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernels 16 and 20 at n: :func:`~.fft.radix_mid_cols`
    at the transform length. (On an H100 its count ran fastest, or within 1%
    of the fastest, at (1, 512, 262144), (512, 512, 512), (1, 1280, 1280),
    (1, 256, 65536) and (1, 129, 65536): chip_smoke.py phase 5 times each
    C at those shapes.)"""
    return radix_mid_cols(r2c_mid_len(n), groups, cols, sms)


def r2c_mid_radix_launch(x: torch.Tensor, out: torch.Tensor, c: int) -> None:
    """Launch the R2C on the radix column tile (kernels 16 and 20), ``c``
    columns a tile (:func:`r2c_mid_cols`), on a (B, n, L) float32 CUDA
    tensor x into the (B, n//2+1, L) complex64 out; counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    length = r2c_mid_len(n)
    plan = radix_plan(length)
    u = None if n % 2 else _device_tw(n, dev).data_ptr()
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_r2c_mid_radix(
            x.data_ptr(), out.data_ptr(), device_radix(length, -1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), u, nb, n, cols, c,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_r2c_mid_radix")


def _r2c_mid_radix(wrapper, x: torch.Tensor) -> torch.Tensor:
    """``wrapper``'s (kernel 16's or 20's) launch on the radix column tile,
    counted in its ``launches`` and ``radix_launches``."""
    nb, n, cols = x.shape
    out = torch.empty((nb, n // 2 + 1, cols), dtype=torch.complex64, device=x.device)
    if x.numel() == 0:
        return out
    r2c_mid_radix_launch(x, out, r2c_mid_cols(n, nb, cols, num_sms(x.device)))
    wrapper.launches += 1
    wrapper.radix_launches += 1
    return out


def c2r_mid_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 17 on the radix column tile: (B, n/2+1, L)
    complex64 -> (B, n, L) float32 along dim 1, times ``scale``, with the DC
    and Nyquist imaginary parts ignored: the inverse unpack G
    (:func:`_inverse_unpack`), then the radix core's plain version with the
    sign +1 table (:func:`~.fft.c2c_radix_mid_plain`), z[l] as real rows 2l
    and 2l + 1."""
    nb, _, cols = s.shape
    z = c2c_radix_mid_plain(_inverse_unpack(s, n, scale, 1), +1)
    return torch.stack([z.real, z.imag], dim=2).reshape(nb, n, cols)


def _bts2_col_c2r_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """The bts2 column C2R's plain version (kernel 26's remnant, whose
    inverse runs the bts2 core): (B, n/2+1, L) complex64 -> (B, n, L) float32, the
    inverse unpack G, then the core's plain version with the sign +1 Wq,
    z[l] as real rows 2l and 2l + 1."""
    nb, _, cols = s.shape
    h = n // 2
    g = _inverse_unpack(s, n, scale, 1)
    z = bts2_plain(g, device_wq(h, +1, 1.0, s.device), +1)
    return torch.stack([z.real, z.imag], dim=2).reshape(nb, n, cols)


def _check_mid(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """Rank and type, on every device: the plain versions take what the
    kernels take."""
    if t.dim() != 3:
        raise ValueError(f"{what}: expected (B, n, L), got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")


def c2r_mid_cols(h: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernel 17 at half length h: kernel 18's rule
    (:func:`packed_mid_cols`: kernel 16's below h = 1024, up to 16 columns
    in the 32- or 40-element form from h = 1024 on). (On an H100 its count
    ran fastest of every C that fits at (1, 257, 262144), (512, 257, 512),
    (1, 641, 1280), (1, 385, 295680), (1, 513, 131072), (1, 1025, 65536),
    (1, 2049, 32768), (1, 4097, 16384) and (1, 10241, 130):
    time_kernels.py --scan-c2r.)"""
    return packed_mid_cols(h, groups, cols, sms)


def c2r_mid_radix_launch(s: torch.Tensor, out: torch.Tensor, n: int, scale, c: int) -> None:
    """Launch kernel 17 on the radix column tile, ``c`` columns a tile
    (:func:`c2r_mid_cols`), on the (B, n/2+1, L) complex64 CUDA tensor s
    into the (B, n, L) float32 out; counts nothing."""
    nb, _, cols = s.shape
    dev = s.device
    h = n // 2
    plan = radix_plan(h)
    ab = _device_ab(n, 1.0 if scale is None else float(scale), dev)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_c2r_mid_radix(
            s.data_ptr(), out.data_ptr(), device_radix(h, +1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), ab.data_ptr(), nb, h, cols, c,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_c2r_mid_radix")


def r2c_mid(x: torch.Tensor) -> torch.Tensor:
    """R2C along dim 1 of a (B, n, L) float32 tensor -> (B, n/2+1, L)
    complex64, h = n/2 = 128 * F (:func:`_check_nat`). A CPU tensor runs the
    plain version; a CUDA tensor launches kernel 16 on the radix column tile
    or raises."""
    _check_mid(x, torch.float32, "r2c_mid")
    _check_nat(x.shape[1], "r2c_mid")
    if x.device.type == "cpu":
        return r2c_mid_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "r2c_mid")
    return _r2c_mid_radix(r2c_mid, x)


r2c_mid.launches = 0
r2c_mid.radix_launches = 0


def c2r_mid(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """C2R along dim 1 of a (B, n/2+1, L) complex64 spectrum -> (B, n, L)
    float32, times ``scale``; the DC and Nyquist imaginary parts are ignored.
    h = n/2 = 128 * F (:func:`_check_nat`). A CPU tensor runs the plain
    version; a CUDA tensor launches kernel 17 on the radix column tile,
    counted in ``launches`` and ``radix_launches``, or raises."""
    _check_mid(s, torch.complex64, "c2r_mid")
    _check_nat(n, "c2r_mid")
    nb, m, cols = s.shape
    if m != n // 2 + 1:
        raise ValueError(f"c2r_mid: expected (B, {n // 2 + 1}, L), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return c2r_mid_plain(s, n, scale)
    if s.device.type != "cuda":
        raise ValueError(f"c2r_mid: unsupported device {s.device}")
    check_cuda(s, torch.complex64, "c2r_mid")
    out = torch.empty((nb, n, cols), dtype=torch.float32, device=s.device)
    if s.numel() == 0:
        return out
    c2r_mid_radix_launch(s, out, n, scale, c2r_mid_cols(n // 2, nb, cols, num_sms(s.device)))
    c2r_mid.launches += 1
    c2r_mid.radix_launches += 1
    return out


c2r_mid.launches = 0
c2r_mid.radix_launches = 0


# --------------------------------------------------------------------------
# Kernel 22: the fused real spectral pipeline along a middle axis
# --------------------------------------------------------------------------


def spectral_r2c_mid_plain(x: torch.Tensor, hr: torch.Tensor, hi, n: int,
                           scale=None) -> torch.Tensor:
    """Plain version of kernel 22 on the radix column tile: the R2C on the
    radix column tile's plain version (:func:`r2c_mid_radix_plain`), the
    product with H = hr + i hi ((m, 1) or (m, L), m = n/2 + 1; hi None for
    a real H), then kernel 17's plain version (:func:`c2r_mid_plain`), which
    ignores the product's DC and Nyquist imaginary parts (the JAX kernel's
    mask and its Nyquist row Re(H[h]) X[h])."""
    spec = r2c_mid_radix_plain(x) * (hr if hi is None else torch.complex(hr, hi))
    return c2r_mid_plain(spec, n, scale)


SPECTRAL_WIDE_H = 640   # kernels 22 and 29's wide column tiles from this half length on
SPECTRAL_MAX_C = 8      # and at most this many columns in them


def spectral_cols(h: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernels 22 and 29 on the radix column tile at
    half length h (the same (h, C) tile and two transforms): kernel 18's
    rule (:func:`packed_mid_cols`) with wide tiles of at most
    SPECTRAL_MAX_C columns from h = SPECTRAL_WIDE_H on: below it
    :func:`~.fft.radix_mid_cols` (the 16-element form), from it the largest
    power of two up to 8 whose tile a block takes in the 32- or 40-element
    form, halved while the grid would leave SMs idle; the fastest at each
    shape timed. (On an NVIDIA H100 80GB HBM3 at 700 W, C = 1, 2, 4, 8, 16:
    kernel 29 by time_kernels.py --scan-dct-mid, at S3's (1, 1024,
    1048576) with a lane-varying H 56.4, 31.1, 21.1, 18.1, 18.2 ms (takes
    8); at (1, 2048, 4096) 0.363, 0.266, 0.234, 0.177, 0.177 (8); at
    (8, 1280, 8192) 3.81, 2.79, 2.21, 1.60, 1.81 (8, where kernel 25's rule
    took 4); at (1, 1152, 1152) 0.096, 0.072, 0.065, 0.081, 0.078 (h = 576:
    4); one column at (1, 31104, 31104), 54.3 ms with the read-only load
    that the wrapper takes at C <= 2, 57.7 evict-first. Kernel 22 by
    chip_smoke.py phase 5: at S2's (1, 1024, 1048576) 39.4, 22.8, 14.5,
    10.0, 11.8 ms (8); at (1024, 1024, 1024) 29.7, 17.6, 11.5, 9.81, 10.6
    (8); at (8, 768, 16384) 3.01, 1.96, 1.38, 1.03, 1.22 (8).)"""
    return packed_mid_cols(h, groups, cols, sms, wide_from=SPECTRAL_WIDE_H, most=SPECTRAL_MAX_C)


def spectral_r2c_launch(x: torch.Tensor, y: torch.Tensor, hr: torch.Tensor, hi, n: int, scale,
                        c: int, ldg: bool) -> None:
    """Launch kernel 22 on the radix column tile, ``c`` columns a tile
    (:func:`spectral_cols`), on the (B, n, L) float32 CUDA tensor x into
    y with the contiguous float32 multiplier planes hr, hi ((n/2 + 1, 1) or
    (n/2 + 1, L); hi None for a real H); x loaded through the read-only path
    if ``ldg``; the inverse on the sign +1 table. Counts nothing."""
    nb, _, cols = x.shape
    dev = x.device
    h = n // 2
    plan = radix_plan(h)
    ab = _device_ab(n, 1.0 if scale is None else float(scale), dev)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_spectral_r2c_radix(
            x.data_ptr(), y.data_ptr(), hr.data_ptr(), None if hi is None else hi.data_ptr(),
            hr.shape[1], device_radix(h, -1, dev).data_ptr(), device_radix(h, +1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), _device_tw(n, dev).data_ptr(),
            ab.data_ptr(), nb, n, cols, c, int(ldg), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_spectral_r2c_radix")


def spectral_r2c_mid(x: torch.Tensor, hr: torch.Tensor, hi, n: int, scale=None) -> torch.Tensor:
    """C2R(H * R2C(x)) along dim 1 of a (B, n, L) float32 tensor, times
    ``scale`` (the C2R's), h = n/2 = 128 * F (:func:`_check_nat`); H =
    hr + i hi, float32 planes of shape (n/2 + 1, 1) or (n/2 + 1, L), hi None
    for a real H. A CPU tensor runs the plain version; a CUDA tensor
    launches kernel 22 on the radix column tile (columns a tile
    :func:`spectral_cols`, the read-only load at C <= 2, the inverse on
    the sign +1 table) or raises."""
    _check_mid(x, torch.float32, "spectral_r2c_mid")
    nb, _, cols = x.shape
    _check_nat(n, "spectral_r2c_mid")
    if x.shape[1] != n:
        raise ValueError(f"spectral_r2c_mid: expected (B, {n}, L), got {tuple(x.shape)}")
    check_mult(hr, x, n // 2 + 1, "spectral_r2c_mid")
    if hi is not None and hi.shape != hr.shape:
        raise ValueError(f"spectral_r2c_mid: planes {tuple(hr.shape)} and {tuple(hi.shape)}")
    if x.device.type == "cpu":
        return spectral_r2c_mid_plain(x, hr, hi, n, scale)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_r2c_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "spectral_r2c_mid")
    hr, hi = mult_planes(hr, hi, "spectral_r2c_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    c = spectral_cols(n // 2, nb, cols, num_sms(x.device))
    spectral_r2c_launch(x, y, hr, hi, n, scale, c, c <= 2)
    spectral_r2c_mid.launches += 1
    return y


spectral_r2c_mid.launches = 0


# --------------------------------------------------------------------------
# Kernels 18 and 19 on the radix column tile
# --------------------------------------------------------------------------


def _bts2_col_r2c_plain(xe: torch.Tensor, xo: torch.Tensor) -> torch.Tensor:
    """The bts2 column R2C's plain version (kernel 25's remnant):
    the core's plain version on xe + i xo, (B, h, L) float32, then the
    unpack with the mirror row, (B, h+1, L) complex64."""
    h = xe.shape[1]
    zz = bts2_plain(torch.complex(xe, xo), device_wq(h, -1, 1.0, xe.device), -1)
    return _unpack(zz, _device_tw(2 * h, xe.device), 1)


def r2c_packed_mid_plain(xe: torch.Tensor, xo: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 18: (B, h, L) float32 streams -> scale * the
    R2C of length 2h of the column with even samples xe and odd samples xo,
    (B, h+1, L) complex64: the radix core's plain version
    (:func:`~.fft.c2c_radix_mid_plain`) on xe + i xo, then the unpack with
    the mirror row, times the scale."""
    h = xe.shape[1]
    zz = c2c_radix_mid_plain(torch.complex(xe, xo), -1)
    spec = _unpack(zz, _device_tw(2 * h, xe.device), 1)
    return spec if scale is None else spec * float(scale)


def dct1_mid_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 19: (B, n, L) float32 -> scale * Re of the R2C
    of length 2h of the even extension [x, x[h-1], .., x[1]] along dim 1,
    h = n - 1: kernel 27's DCT-I on the radix column tile (the R2C's plain
    version, :func:`r2c_mid_radix_plain`, of the extension), its real
    rows."""
    n = x.shape[1]
    re = r2c_mid_radix_plain(torch.cat([x, x[:, 1:n - 1].flip(1)], dim=1)).real
    return re.contiguous() if scale is None else re * float(scale)


def _check_half(h: int, what: str, name: str) -> int:
    """F of the half length h = 128 * F that kernels 18 and 19 take
    (:func:`~.fft.core_f`), or raise."""
    f = core_f(h)
    if f is None:
        raise ValueError(f"{what}: {name}={h} is not 128 * F with a plan "
                         f"(128 <= {name} <= {GENERIC_MAX_N})")
    return f


PACKED_MID_MAX_C = 16   # kernel 18's widest tile from h = 1024 on (64 bytes a stream row)


def packed_mid_cols(h: int, groups: int, cols: int, sms: int, wide_from: int = 1024,
                    most: int = PACKED_MID_MAX_C) -> int:
    """Columns per tile of kernel 18 at half length h: below h = ``wide_from``
    :func:`r2c_mid_cols` at n = 2h (:func:`~.fft.radix_mid_cols` at h, the
    16-element form); from there on the largest power of two up to ``most``
    whose tile a block takes in the 32- or 40-element form
    (16 at h = 1024 and 1280, 8 to 2048, 4 to 4096, 2 to 10240, 1 above),
    halved while the grid would leave SMs idle. (On an H100,
    time_kernels.py --scan-cols and chip_smoke.py phase 5: at the Dirichlet
    solve's (1, 1024, 1046529) 16 columns took 24% less time than
    radix_mid_cols's 4, and at h = 1536 ... 4096 its rule's count ran
    1.1-3.1x faster than the 16-element form's 1 or 2.)"""
    if h < wide_from:
        return r2c_mid_cols(2 * h, groups, cols, sms)
    c = most
    while c > 1 and (h * c > RADIX_MAX_ELEMS or radix_cols_threads(h, c) > 2 * RADIX_MAX_THREADS):
        c //= 2
    while c > 1 and groups * -(-cols // c) < sms:
        c //= 2
    return c


def r2c_packed_mid_launch(xe: torch.Tensor, xo: torch.Tensor, out: torch.Tensor, scale: float,
                          c: int) -> None:
    """Launch kernel 18 on the radix column tile, ``c`` columns a tile
    (:func:`packed_mid_cols`), on the (B, h, L) float32 CUDA streams xe, xo
    into the (B, h+1, L) complex64 out; counts nothing."""
    nb, h, cols = xe.shape
    dev = xe.device
    plan = radix_plan(h)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_r2c_packed_mid_radix(
            xe.data_ptr(), xo.data_ptr(), out.data_ptr(), device_radix(h, -1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), _device_tw(2 * h, dev).data_ptr(),
            scale, nb, h, cols, c, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_r2c_packed_mid_radix")


def r2c_packed_mid(xe: torch.Tensor, xo: torch.Tensor, scale=None) -> torch.Tensor:
    """scale * the R2C of length 2h along dim 1 of the column whose even
    samples are xe and whose odd samples are xo, two (B, h, L) float32
    tensors -> (B, h+1, L) complex64, h = 128 * F. A CPU tensor runs the
    plain version; a CUDA tensor launches kernel 18 on the radix column
    tile, counted in ``launches`` and ``radix_launches``, or raises."""
    _check_mid(xe, torch.float32, "r2c_packed_mid")
    _check_mid(xo, torch.float32, "r2c_packed_mid")
    if xe.shape != xo.shape or xe.device != xo.device:
        raise ValueError(f"r2c_packed_mid: streams {tuple(xe.shape)} on {xe.device} and "
                         f"{tuple(xo.shape)} on {xo.device} differ")
    nb, h, cols = xe.shape
    _check_half(h, "r2c_packed_mid", "h")
    if xe.device.type == "cpu":
        return r2c_packed_mid_plain(xe, xo, scale)
    if xe.device.type != "cuda":
        raise ValueError(f"r2c_packed_mid: unsupported device {xe.device}")
    check_cuda(xe, torch.float32, "r2c_packed_mid")
    check_cuda(xo, torch.float32, "r2c_packed_mid")
    out = torch.empty((nb, h + 1, cols), dtype=torch.complex64, device=xe.device)
    if xe.numel() == 0:
        return out
    r2c_packed_mid_launch(xe, xo, out, 1.0 if scale is None else float(scale),
                          packed_mid_cols(h, nb, cols, num_sms(xe.device)))
    r2c_packed_mid.launches += 1
    r2c_packed_mid.radix_launches += 1
    return out


r2c_packed_mid.launches = 0
r2c_packed_mid.radix_launches = 0


def dct1_mid_cols(h: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernel 19 at h = n - 1: kernel 18's
    :func:`packed_mid_cols` at h, the same R2C of length 2h on the same
    column tile. (On an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py
    phase 5, C = 1, 2, 4, 8: at (2049, 2049, 257) 36.78, 20.18, 13.84,
    13.63 ms (32.59 and 17.65 read-only at C = 1, 2), at (1, 2049, 526593)
    39.34, 23.02, 15.22, 14.12 and at (1, 1537, 1537) 0.127, 0.083, 0.089,
    0.079: the rule's 8 ran fastest at each.)"""
    return packed_mid_cols(h, groups, cols, sms)


def dct1_mid(x: torch.Tensor, scale=None) -> torch.Tensor:
    """scale * Re of the R2C of length 2h of the even extension along dim 1
    of a (B, n, L) float32 tensor (2 * scale * the rustdct DCT-I), odd
    n = h + 1, h = 128 * F. A CPU tensor runs the plain version; a CUDA
    tensor launches kernel 19, kernel 27's DCT-I on the radix column tile
    (``csrc/dct_mid_radix.cu``, columns a tile by :func:`dct1_mid_cols`, x
    through the read-only path at C <= 2), counted in ``launches`` and
    ``radix_launches``, or raises."""
    _check_mid(x, torch.float32, "dct1_mid")
    nb, n, cols = x.shape
    _check_half(n - 1, "dct1_mid", "n - 1")
    if x.device.type == "cpu":
        return dct1_mid_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dct1_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "dct1_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from .dct import dct_radix_launch    # dct.py imports this module

    c = dct1_mid_cols(n - 1, nb, cols, num_sms(x.device))
    # kernel 27 stores (s / 2) Re X: s = 2 scale gives scale Re X
    dct_radix_launch(x, y, 1, 2.0 * (1.0 if scale is None else float(scale)), c, ldg=c <= 2)
    dct1_mid.launches += 1
    dct1_mid.radix_launches += 1
    return y


dct1_mid.launches = 0
dct1_mid.radix_launches = 0


# --------------------------------------------------------------------------
# Kernels 20 and 21: along the middle axis, kernel 20 on the radix column
# tile where a plan exists, else (and kernel 21 always) as one real product
# --------------------------------------------------------------------------


def r2c_dense_consts(n: int) -> np.ndarray:
    """(n, 2m) float32 W = [cos(2 pi t k / n) | -sin(2 pi t k / n)],
    m = n//2 + 1, built in float64 and rounded once in C order: the JAX
    package's ``_r2c_dense_w`` table at its "highest" tier."""
    t = np.arange(n, dtype=np.int64)
    k = np.arange(n // 2 + 1, dtype=np.int64)
    cr, si = _cis(2 * np.outer(t, k), n, -1)
    return np.ascontiguousarray(np.concatenate([cr, si], axis=1), np.float32)


def c2r_dense_consts(n: int, scale: float = 1.0) -> np.ndarray:
    """(2m, n) float32 rows [A^T; B^T] with x = A Re S + B Im S: the
    Hermitian fold (x2 weights), the DC and, for even n, Nyquist masking
    (zero B columns) and ``scale``, built in float64 and rounded once in C
    order: the JAX package's ``_c2r_dense_w`` table."""
    h = n // 2
    t = np.arange(n, dtype=np.int64)
    k = np.arange(h + 1, dtype=np.int64)
    cr, sn = _cis(2 * np.outer(t, k), n, +1)
    a = 2.0 * cr
    b = -2.0 * sn
    a[:, 0] *= 0.5
    b[:, 0] = 0.0
    if n % 2 == 0:
        a[:, h] *= 0.5
        b[:, h] = 0.0
    w = np.concatenate([a.T, b.T], axis=0) * scale
    return np.ascontiguousarray(w, np.float32)


@lru_cache(maxsize=64)
def _device_dense(kind: str, n: int, scale: float, device: torch.device) -> torch.Tensor:
    w = r2c_dense_consts(n) if kind == "r2c" else c2r_dense_consts(n, scale)
    return torch.from_numpy(w).to(device)


def r2c_dense_mid_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 20's dense product (the lengths without a
    radix plan): Y[b, j, c] = sum_t W[t, j] x[b, t, c], rows j < m the real
    and j >= m the imaginary parts."""
    m = x.shape[1] // 2 + 1
    y = torch.einsum("tj,btc->bjc", _device_dense("r2c", x.shape[1], 1.0, x.device), x)
    return torch.complex(y[:, :m], y[:, m:])


def c2r_dense_mid_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 21: x[b, t, c] = sum_j W2[j, t] Z[b, j, c]
    with Z = [Re S; Im S] along dim 1."""
    sc = 1.0 if scale is None else float(scale)
    z = torch.cat([s.real, s.imag], dim=1)
    return torch.einsum("jt,bjc->btc", _device_dense("c2r", n, sc, s.device), z)


def _check_dense_n(n: int, what: str) -> None:
    if not DENSE_MIN_N <= n <= DENSE_MAX_N:
        raise ValueError(f"{what}: n={n} is outside {DENSE_MIN_N} ... {DENSE_MAX_N}")


def _launch_dense(entry: str, w, inp: torch.Tensor, out: torch.Tensor, n: int,
                  rows: int) -> None:
    nb, _, cols = inp.shape
    tm = dense_tile(rows, nb, cols, num_sms(inp.device))
    with torch.cuda.device(inp.device):
        err = getattr(_build.lib(), entry)(
            w.data_ptr(), inp.data_ptr(), out.data_ptr(), nb, n, cols, tm,
            torch.cuda.current_stream(inp.device).cuda_stream)
    _build.check(err, entry)


@lru_cache(maxsize=64)
def _device_r2c_blue(length: int, device: torch.device):
    """Kernel 20's chirp-z tables at chirp length ``length`` as complex64
    tensors on ``device``: the chirp exp(-i pi t^2 / length) (entry and
    exit) and H of :func:`~.fft.chirp_m` (length), each built in float64 and
    rounded once (``plan.chirp``, ``plan.blue_h``)."""
    return (pair_tensor(chirp(length, -1), device),
            pair_tensor(blue_h(length, -1, chirp_m(length)), device))


def r2c_blue_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 20's chirp-z: (B, n, L) float32 -> (B, n//2+1,
    L) complex64 along dim 1. Even n: :func:`~.fft.chirp_z_radix_plain` on
    the half-length columns z = x[:, 0::2] + i x[:, 1::2] (chirp length
    h = n/2) times the entry and exit chirps, then the unpack; odd n: the
    same on (x, 0) (chirp length n), its first (n + 1)/2 bins."""
    nb, n, cols = x.shape
    length = r2c_mid_len(n)
    a, hh = _device_r2c_blue(length, x.device)
    if n % 2:
        z = torch.complex(x, torch.zeros_like(x))
    else:
        xv = x.reshape(nb, length, 2, cols)
        z = torch.complex(xv[:, :, 0], xv[:, :, 1])
    zz = chirp_z_radix_plain(z * a[:, None], hh, 1.0) * a[:, None]
    return zz[:, :n // 2 + 1].contiguous() if n % 2 else _unpack(zz, _device_tw(n, x.device), 1)


def r2c_blue_launch(x: torch.Tensor, out: torch.Tensor, c: int) -> None:
    """Launch kernel 20's chirp-z on the radix column tile, ``c`` columns a
    tile, on a (B, n, L) float32 CUDA tensor x into the (B, n//2+1, L)
    complex64 out (``csrc/fft_blue_radix.cu``); counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    length = r2c_mid_len(n)
    mk = chirp_m(length)
    a, hh = _device_r2c_blue(length, dev)
    plan = radix_plan(mk)
    u = None if n % 2 else _device_tw(n, dev).data_ptr()
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_r2c_blue_radix(
            x.data_ptr(), out.data_ptr(), a.data_ptr(), hh.data_ptr(), u,
            device_radix(mk, -1, dev).data_ptr(), (ctypes.c_int * RADIX_MAX_STAGES)(*plan),
            len(plan), nb, n, mk, cols, c, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_r2c_blue_radix")


# the least odd n without a plan where the chirp-z (kernel 20's, kernel
# 21's) beats the dense product (its chirp length is n there, twice an even
# n's)
CHIRP_MIN_ODD = 449
# the least prime transform length whose one prime stage on the radix
# column tile loses to the chirp-z
CHIRP_MIN_P = 97


def _transform_p(t: int) -> int:
    """The largest prime stage of radix_plan(t), 0 where it has none."""
    return max((r for r in radix_plan(t) if r not in RADIX_CODELETS), default=0)


def chirp_beats_radix(n: int) -> bool:
    """Whether the real-input chirp-z on kernel 11's column kernel beats the
    radix column tile at n, where that tile has a plan of the transform
    length T (h = n/2, or n at odd n; kernels 20 and 21): the tile's prime
    stage p spends about p operations an element, the chirp-z about
    20 log2 M (M >= 4 T), so the chirp-z takes T = p >= CHIRP_MIN_P and
    T = 5 p, 7 p with p = 127, the largest stage."""
    t = r2c_mid_len(n)
    p = _transform_p(t)
    return (t == p and p >= CHIRP_MIN_P) or (p == RADIX_MAX_P and t >= 5 * p)


def _no_plan_form(n: int) -> str:
    """The chirp-z or the dense product at a length without a plan: the
    chirp-z at even n and odd n >= CHIRP_MIN_ODD (kernels 20 and 21)."""
    return "chirp" if n % 2 == 0 or n >= CHIRP_MIN_ODD else "dense"


def r2c_dense_form(n: int) -> str:
    """The kernel that kernel 20's wrapper runs at n: "radix" (the radix
    column tile), "chirp" (the real-input chirp-z on kernel 11's column
    kernel) or "dense" (the real product). The product, about n operations
    an element, takes odd n = p >= 31 and odd n = 3 p with p >= 67 (p the
    radix tile's prime stage), the chirp-z the lengths of
    :func:`chirp_beats_radix`, the radix tile every other length with a
    plan; without a plan :func:`_no_plan_form`. Fitted to
    ``time_kernels.py --route-dense`` on an H100: summed over n = 4 ...
    1100 within 0.1% of the fastest kernel at each length, and no length
    more than 5% slower than its fastest (PERF.md)."""
    if not r2c_mid_radix(n):
        return _no_plan_form(n)
    p = _transform_p(r2c_mid_len(n))
    if n % 2 and ((n == p and p >= 31) or (n == 3 * p and p >= 67)):
        return "dense"
    return "chirp" if chirp_beats_radix(n) else "radix"


_R2C_DENSE_PLAIN = {"radix": r2c_mid_radix_plain, "chirp": r2c_blue_plain,
                    "dense": r2c_dense_mid_plain}


def r2c_dense_mid(x: torch.Tensor) -> torch.Tensor:
    """R2C along dim 1 of a (B, n, L) float32 tensor -> (B, n//2+1, L)
    complex64, 4 <= n <= 1100, on the kernel :func:`r2c_dense_form` names at
    n. A CPU tensor runs that kernel's plain version; a CUDA tensor launches
    kernel 20 on the radix column tile (counted in ``radix_launches`` as
    well), its chirp-z (``chirp_launches``) or its dense product. Anything
    else raises."""
    _check_mid(x, torch.float32, "r2c_dense_mid")
    nb, n, cols = x.shape
    _check_dense_n(n, "r2c_dense_mid")
    form = r2c_dense_form(n)
    if x.device.type == "cpu":
        return _R2C_DENSE_PLAIN[form](x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_dense_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "r2c_dense_mid")
    if form == "radix":
        return _r2c_mid_radix(r2c_dense_mid, x)
    m = n // 2 + 1
    out = torch.empty((nb, m, cols), dtype=torch.complex64, device=x.device)
    if x.numel() == 0:
        return out
    if form == "chirp":
        # columns a tile: radix_mid_cols at M (8 at M = 288, 2 at 1280, 1 at
        # 2304); on an H100 no other count was 3% faster summed over an M's
        # lengths (time_kernels.py --route-dense times every C that fits)
        r2c_blue_launch(x, out, radix_mid_cols(chirp_m(r2c_mid_len(n)), nb, cols,
                                               num_sms(x.device)))
        r2c_dense_mid.chirp_launches += 1
    else:
        r2c_dense_launch(x, out)
    r2c_dense_mid.launches += 1
    return out


def r2c_dense_launch(x: torch.Tensor, out: torch.Tensor) -> None:
    """Launch kernel 20's dense product on a (B, n, L) float32 CUDA tensor x
    into the (B, n//2+1, L) complex64 out (``csrc/rfft_dense.cu``); counts
    nothing."""
    n = x.shape[1]
    _launch_dense("ndfft_r2c_dense_mid", _device_dense("r2c", n, 1.0, x.device), x, out, n,
                  2 * (n // 2 + 1))


r2c_dense_mid.launches = 0
r2c_dense_mid.radix_launches = 0
r2c_dense_mid.chirp_launches = 0


def c2r_dense_form(n: int) -> str:
    """The kernel that kernel 21's wrapper runs at n: "radix" (the radix
    column tile), "chirp" (the chirp-z C2R on kernel 11's column kernel) or
    "dense" (the real product). The product takes the 61 odd n with a plan
    where :func:`~.fft.dense_beats_radix` holds (e.g. 129 = 3 * 43), the
    chirp-z the lengths of :func:`chirp_beats_radix` (194 = 2 * 97 ...,
    5 * 127, 7 * 127), the radix tile every other length with a plan;
    without a plan :func:`_no_plan_form`, as for kernel 20. Fitted to
    ``time_kernels.py --route-dense`` on an H100: summed over n = 4 ...
    1100 within 0.03% of the fastest kernel at each length (PERF.md)."""
    if not r2c_mid_radix(n):
        return _no_plan_form(n)
    if n % 2 and dense_beats_radix(n):
        return "dense"
    return "chirp" if chirp_beats_radix(n) else "radix"


def c2r_odd_mid_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 21 at odd n on the radix column tile:
    (B, (n+1)/2, L) complex64 -> (B, n, L) float32, scale * the real part of
    the radix core's plain version with the sign +1 table
    (:func:`~.fft.c2c_radix_mid_plain`) on the Hermitian extension of each
    column: S[k] for k <= (n-1)/2 (the DC's imaginary part set to 0), then
    conj S[n-k]."""
    ext = torch.cat([_mask_imag0(s, 1), s[:, 1:].flip(1).conj()], dim=1)
    z = c2c_radix_mid_plain(ext, +1)
    return (z.real * (1.0 if scale is None else float(scale))).contiguous()


def c2r_dense_radix_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 21 on the radix column tile: at even n
    kernel 17's (:func:`c2r_mid_plain`, any h = n/2 with a plan), at odd n
    :func:`c2r_odd_mid_plain`."""
    return c2r_odd_mid_plain(s, n, scale) if n % 2 else c2r_mid_plain(s, n, scale)


def c2r_dense_cols(n: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernel 21 on the radix column tile: kernel 17's
    :func:`c2r_mid_cols` at h = n/2 for even n, :func:`r2c_mid_cols` at odd
    n (the transform length n)."""
    return r2c_mid_cols(n, groups, cols, sms) if n % 2 else c2r_mid_cols(n // 2, groups, cols, sms)


def c2r_dense_radix_launch(s: torch.Tensor, out: torch.Tensor, n: int, scale, c: int) -> None:
    """Launch kernel 21 on the radix column tile, ``c`` columns a tile
    (:func:`c2r_dense_cols`), on the (B, n//2+1, L) complex64 CUDA tensor s
    into the (B, n, L) float32 out: kernel 17's kernel at even n, at odd n
    the length-n inverse of the Hermitian extension (its mirrored half
    filled from the tile in the prologue); counts nothing."""
    if n % 2 == 0:
        c2r_mid_radix_launch(s, out, n, scale, c)
        return
    nb, _, cols = s.shape
    dev = s.device
    plan = radix_plan(n)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_c2r_odd_mid_radix(
            s.data_ptr(), out.data_ptr(), device_radix(n, +1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan),
            1.0 if scale is None else float(scale), nb, n, cols, c,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_c2r_odd_mid_radix")


def c2r_dense_launch(s: torch.Tensor, out: torch.Tensor, n: int, scale) -> None:
    """Launch kernel 21's dense product on the (B, n//2+1, L) complex64 CUDA
    tensor s into the (B, n, L) float32 out (``csrc/rfft_dense.cu``);
    counts nothing."""
    _launch_dense("ndfft_c2r_dense_mid",
                  _device_dense("c2r", n, 1.0 if scale is None else float(scale), s.device),
                  s, out, n, n)


def c2r_blue_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 21's chirp-z: (B, n//2+1, L) complex64 ->
    (B, n, L) float32 along dim 1, times ``scale``, the DC and (even n)
    Nyquist imaginary parts ignored. The column's inverse z = IFFT(V) as
    conj(FFT(conj V)), the forward by :func:`~.fft.chirp_z_radix_plain` on
    kernel 20's tables: at even n V is kernel 17's inverse unpack G
    (:func:`_inverse_unpack`, the scale in it; chirp length n/2) and z[l]
    gives real rows 2l and 2l + 1; at odd n V is the Hermitian extension
    (chirp length n) and scale * Re z the output."""
    nb, _, cols = s.shape
    a, hh = _device_r2c_blue(r2c_mid_len(n), s.device)
    if n % 2:
        v = torch.cat([_mask_imag0(s, 1), s[:, 1:].flip(1).conj()], dim=1)
    else:
        v = _inverse_unpack(s, n, scale, 1)
    z = (chirp_z_radix_plain(v.conj() * a[:, None], hh, 1.0) * a[:, None]).conj()
    if n % 2:
        return (z.real * (1.0 if scale is None else float(scale))).contiguous()
    return torch.stack([z.real, z.imag], dim=2).reshape(nb, n, cols)


def c2r_blue_launch(s: torch.Tensor, out: torch.Tensor, n: int, scale, c: int) -> None:
    """Launch kernel 21's chirp-z on kernel 11's column kernel, ``c``
    columns a tile, on the (B, n//2+1, L) complex64 CUDA tensor s into the
    (B, n, L) float32 out (``csrc/rfft_blue_radix.cu``); counts nothing."""
    nb, _, cols = s.shape
    dev = s.device
    length = r2c_mid_len(n)
    mk = chirp_m(length)
    a, hh = _device_r2c_blue(length, dev)
    plan = radix_plan(mk)
    sc = 1.0 if scale is None else float(scale)
    ab = None if n % 2 else _device_ab(n, sc, dev).data_ptr()
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_c2r_blue_radix(
            s.data_ptr(), out.data_ptr(), a.data_ptr(), hh.data_ptr(), ab,
            device_radix(mk, -1, dev).data_ptr(), (ctypes.c_int * RADIX_MAX_STAGES)(*plan),
            len(plan), sc, nb, n, mk, cols, c, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_c2r_blue_radix")


_C2R_DENSE_PLAIN = {"radix": c2r_dense_radix_plain, "chirp": c2r_blue_plain,
                    "dense": c2r_dense_mid_plain}


def c2r_dense_mid(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """C2R along dim 1 of a (B, n//2+1, L) complex64 spectrum -> (B, n, L)
    float32, times ``scale``, 4 <= n <= 1100; the DC and (even n) Nyquist
    imaginary parts are ignored; on the kernel :func:`c2r_dense_form` names
    at n. A CPU tensor runs that kernel's plain version; a CUDA tensor
    launches kernel 21 on the radix column tile (counted in
    ``radix_launches`` as well), its chirp-z (``chirp_launches``) or its
    dense product. Anything else raises."""
    _check_mid(s, torch.complex64, "c2r_dense_mid")
    _check_dense_n(n, "c2r_dense_mid")
    nb, m, cols = s.shape
    if m != n // 2 + 1:
        raise ValueError(f"c2r_dense_mid: expected (B, {n // 2 + 1}, L), got "
                         f"{tuple(s.shape)}")
    form = c2r_dense_form(n)
    if s.device.type == "cpu":
        return _C2R_DENSE_PLAIN[form](s, n, scale)
    if s.device.type != "cuda":
        raise ValueError(f"c2r_dense_mid: unsupported device {s.device}")
    check_cuda(s, torch.complex64, "c2r_dense_mid")
    out = torch.empty((nb, n, cols), dtype=torch.float32, device=s.device)
    if s.numel() == 0:
        return out
    sms = num_sms(s.device)
    if form == "radix":
        c2r_dense_radix_launch(s, out, n, scale, c2r_dense_cols(n, nb, cols, sms))
        c2r_dense_mid.radix_launches += 1
    elif form == "chirp":
        # columns a tile: radix_mid_cols at M, as kernel 20's chirp-z
        c2r_blue_launch(s, out, n, scale, radix_mid_cols(chirp_m(r2c_mid_len(n)), nb, cols, sms))
        c2r_dense_mid.chirp_launches += 1
    else:
        c2r_dense_launch(s, out, n, scale)
    c2r_dense_mid.launches += 1
    return out


c2r_dense_mid.launches = 0
c2r_dense_mid.radix_launches = 0
c2r_dense_mid.chirp_launches = 0


# --------------------------------------------------------------------------
# Kernel 15: the packed R2C of contiguous rows
# --------------------------------------------------------------------------


def _check_packed(x: torch.Tensor, what: str) -> None:
    """Rank and type, on every device: the plain versions take what the
    kernels take."""
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (T, n), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: expected torch.float32, got {x.dtype}")


r2c_packed_plain = r2c_radix_plain          # kernel 15 at h = 128 * F


def r2c_packed(x: torch.Tensor) -> torch.Tensor:
    """R2C of the rows of a (T, n) float32 tensor -> (T, h+1) complex64,
    h = n/2 = 128 * F (:func:`packed_core`). A CPU tensor runs the plain
    version; a CUDA tensor launches kernel 15 on the radix row core or
    raises."""
    _check_packed(x, "r2c_packed")
    _check_nat(x.shape[1], "r2c_packed")
    if x.device.type == "cpu":
        return r2c_packed_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_packed: unsupported device {x.device}")
    return _r2c_rows(x, r2c_packed)


r2c_packed.launches = 0
r2c_packed.radix_launches = 0


PACKED_IDLE_LANES = 16  # kernel 15's dense rows leave at most 1 lane in 16 idle


def packed_dense_rows(h: int, count: int, sms: int) -> int:
    """Rows a block of kernel 15's dense rows (h <= 256) on the radix row
    core: :func:`~.fft.radix_block`'s small-tile count (RADIX_SMALL_TILE
    elements, kernel 8's at n <= 256), raised to the fewest rows whose
    r ceil(h / 16) threads leave at most one lane in PACKED_IDLE_LANES of
    the block's warps idle (within RADIX_MAX_THREADS; else the small-tile
    count), halved while the grid would leave SMs idle. (On an H100 the
    small-tile count left up to 45% of the lanes idle at h = 37, 97, 100 and
    200 and ran 1.05-1.7x slower there than this count (``time_kernels.py
    --scan-rows``); summed over the 229 h it took 31.9 ms against this
    count's 29.9 at 2^23 reals a call (``--route-dense``).)"""
    tr = -(-h // 16)
    small = max(1, min(RADIX_SMALL_TILE // h, RADIX_MAX_THREADS // tr))
    rows = next((r for r in range(small, RADIX_MAX_THREADS // tr + 1)
                 if idle_lanes(r * tr) <= 1 / PACKED_IDLE_LANES), small)
    return spread_rows(rows, count, sms)


# the half length with a plan that kernel 15's radix row core does not
# take: at h = 31 the dense product beat it 1.18x (two scans), and the
# chirp-z (M = 64) beats both (time_kernels.py --route-dense on an H100)
PACKED_NOT_RADIX = (31,)


def packed_dense_radix(h: int) -> bool:
    """Kernel 15's wrapper :func:`r2c_packed_dense` runs the radix row core
    at half length h: :func:`~.fft.radix_plan` has h and h is not in
    PACKED_NOT_RADIX (229 of the 254 h <= 256 that are not 128 * F)."""
    return radix_plan(h) is not None and h not in PACKED_NOT_RADIX


def packed_dense_form(h: int) -> str:
    """The kernel that kernel 15's dense rows run at half length h: "radix"
    (the radix row core, :func:`packed_dense_radix`) or "chirp" (the
    real-input chirp-z of the rows on kernel 11's column kernel, at the 23
    primes 131 ... 251, which have no plan, and at h = 1 and 31, where it
    beat the dense product 3.2x and 1.13x; time_kernels.py --route-dense on
    an H100)."""
    return "radix" if packed_dense_radix(h) else "chirp"


def packed_blue_rows(mk: int, count: int, sms: int) -> int:
    """Rows a tile of kernel 15's chirp-z at convolution length mk: the
    fewest (a power of two) whose ceil(mk / 16) threads a row fill whole
    warps, at most :func:`~.fft.radix_mid_cols`'s count at mk (the
    16-element form, halved while SMs would idle). One row is one contiguous
    run, so fewer rows read fewer sectors a warp; the warps' idle lanes set
    the floor. (On an H100 this count ran fastest, or within 1.1%, of the
    counts 1 ... 32 at each of the 25 h that take the chirp-z;
    radix_mid_cols's own count ran 9-20% slower at M = 512 (8 rows against
    1) and 29% at h = 31 (M = 64, 32 rows against 8): time_kernels.py
    --route-dense.)"""
    most = radix_mid_cols(mk, 1, count, sms)
    tr = -(-mk // 16)
    c = 1
    while c < most and (c * tr) % 32:
        c *= 2
    return c


def r2c_packed_blue_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 15's rows on the chirp-z: (T, 2h) float32 ->
    (T, h+1) complex64, kernel 20's chirp-z plain version
    (:func:`r2c_blue_plain`) on the rows as the columns of a (1, 2h, T)
    view."""
    return r2c_blue_plain(x.t()[None])[0].t().contiguous()


def r2c_blue_rows_launch(x: torch.Tensor, out: torch.Tensor, c: int) -> None:
    """Launch kernel 15's rows on kernel 11's column kernel, ``c`` rows a
    tile, on the (T, 2h) float32 rows of a CUDA tensor x into the (T, h+1)
    complex64 out (``csrc/rfft_blue_radix.cu``: kernel 20's even chirp-z with
    row-addressed policies); counts nothing."""
    if x.data_ptr() % 8:       # the kernel reads rows as float2
        x = x.clone()
    t, n = x.shape
    h = n // 2
    dev = x.device
    mk = chirp_m(h)
    a, hh = _device_r2c_blue(h, dev)
    plan = radix_plan(mk)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_r2c_blue_rows(
            x.data_ptr(), out.data_ptr(), a.data_ptr(), hh.data_ptr(),
            _device_tw(n, dev).data_ptr(), device_radix(mk, -1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), t, h, mk, c,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_r2c_blue_rows")


_PACKED_DENSE_PLAIN = {"radix": r2c_radix_plain, "chirp": r2c_packed_blue_plain}


def r2c_packed_dense(x: torch.Tensor) -> torch.Tensor:
    """R2C of the rows of a (T, n) float32 tensor -> (T, n/2+1) complex64,
    n even, n <= 512, on the kernel :func:`packed_dense_form` names at
    h = n/2. A CPU tensor runs that kernel's plain version; a CUDA tensor
    launches kernel 15 on the radix row core with the unpack epilogue
    (counted in ``radix_launches`` as well) or its chirp-z
    (``chirp_launches``). Anything else raises."""
    _check_packed(x, "r2c_packed_dense")
    t, n = x.shape
    if n % 2 or not 2 <= n <= 2 * PACKED_DENSE_MAX_H:
        raise ValueError(f"r2c_packed_dense: n={n} is not even in 2 ... "
                         f"{2 * PACKED_DENSE_MAX_H}")
    form = packed_dense_form(n // 2)
    if x.device.type == "cpu":
        return _PACKED_DENSE_PLAIN[form](x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_packed_dense: unsupported device {x.device}")
    if form == "radix":
        return _r2c_rows(x, r2c_packed_dense, packed_dense_rows(n // 2, t, num_sms(x.device)))
    check_cuda(x, torch.float32, "r2c_packed_dense")
    out = torch.empty((t, n // 2 + 1), dtype=torch.complex64, device=x.device)
    if t == 0:
        return out
    r2c_blue_rows_launch(x, out, packed_blue_rows(chirp_m(n // 2), t, num_sms(x.device)))
    r2c_packed_dense.launches += 1
    r2c_packed_dense.chirp_launches += 1
    return out


r2c_packed_dense.launches = 0
r2c_packed_dense.radix_launches = 0
r2c_packed_dense.chirp_launches = 0


r2c_packed_generic_plain = r2c_radix_plain  # kernel 15 at a generic h


def r2c_packed_generic(x: torch.Tensor) -> torch.Tensor:
    """R2C of the rows of a (T, n) float32 tensor -> (T, h+1) complex64 at a
    half length h = n/2 the generic schedule takes (256 < h <= 20480, odd h
    included). A CPU tensor runs the plain version; a CUDA tensor launches
    kernel 15's generic form (the radix row core with the unpack epilogue)
    or raises."""
    _check_packed(x, "r2c_packed_generic")
    t, n = x.shape
    h = n // 2
    if n % 2 or generic_split(h) is None:
        raise ValueError(f"r2c_packed_generic: n={n} is not 2 h with a generic "
                         f"schedule of h (256 < h <= {GENERIC_MAX_N})")
    if x.device.type == "cpu":
        return r2c_packed_generic_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_packed_generic: unsupported device {x.device}")
    out = r2c_radix_launch(x, "r2c_packed_generic")
    r2c_packed_generic.launches += t > 0
    return out


r2c_packed_generic.launches = 0
