"""Kernels 2 and 3: R2C and C2R of contiguous rows, even n, h = n/2 = 128 * F.

The CUDA kernels are in ``csrc/rfft_nat.cu`` on the shared core
``csrc/bts2_core.cuh``; they replace the JAX package's
``ops/pallas/rfft.py::_r2c_kernel_nat`` and ``_c2r_kernel_nat``. This module
holds their host-built constants, their plain PyTorch versions and their
wrappers, whose ``launches`` attributes count kernel launches.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...plan import _cis
from . import _build
from .fft import CORE_F, M, block_rows, bts2_plain, check_cuda, device_wq, num_sms


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


def _mirror(z: torch.Tensor) -> torch.Tensor:
    """z[..., (h - k) % h] for k = 0..h-1."""
    return torch.roll(z.flip(-1), 1, dims=-1)


def r2c_nat_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 2: (T, n) float32 -> (T, n/2+1) complex64."""
    t, n = x.shape
    h = n // 2
    z = torch.view_as_complex(x.reshape(t, h, 2).contiguous())  # x[2t] + i x[2t+1]
    zz = bts2_plain(z.reshape(t, h, 1), device_wq(h, -1, 1.0, x.device),
                    -1).reshape(t, h)
    zm = _mirror(zz).conj()
    fe = 0.5 * (zz + zm)
    fo = -0.5j * (zz - zm)
    spec = fe + _device_tw(n, x.device) * fo
    nyq = (zz[:, :1].real - zz[:, :1].imag).to(spec.dtype)
    return torch.cat([spec, nyq], dim=1)


def _mask_imag0(s: torch.Tensor) -> torch.Tensor:
    """s with the imaginary part of its first column set to 0."""
    mask = torch.ones(s.shape[-1], dtype=s.real.dtype, device=s.device)
    mask[0] = 0.0
    return torch.complex(s.real, s.imag * mask)


def c2r_nat_plain(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 3: (T, n/2+1) complex64 -> (T, n) float32,
    times ``scale``, with the DC and Nyquist imaginary parts ignored."""
    t = s.shape[0]
    h = n // 2
    sc = 1.0 if scale is None else float(scale)
    ab = _device_ab(n, sc, s.device)
    sk = _mask_imag0(s[:, :h])                      # S[k], DC imag = 0
    sm = _mask_imag0(s[:, 1:h + 1].flip(-1))        # S[h-k], Nyquist imag = 0
    g = (torch.complex(ab[:, 0], ab[:, 1]) * sk
         + torch.complex(ab[:, 2], ab[:, 3]) * sm.conj())
    z = bts2_plain(g.reshape(t, h, 1), device_wq(h, +1, 1.0, s.device),
                   +1).reshape(t, h)
    return torch.view_as_real(z).reshape(t, n)


def _check_n(n: int, what: str) -> None:
    h = n // 2
    if n % 2 or h % M or h // M not in CORE_F:
        raise ValueError(f"{what}: n={n} is not 2 * 128 * F, F in {CORE_F}")


def r2c_nat(x: torch.Tensor) -> torch.Tensor:
    """R2C of the rows of a (T, n) float32 tensor -> (T, n/2+1) complex64.
    A CPU tensor runs the plain version; a CUDA tensor launches kernel 2 or
    raises."""
    if x.dim() != 2:
        raise ValueError(f"r2c_nat: expected (T, n), got {tuple(x.shape)}")
    t, n = x.shape
    _check_n(n, "r2c_nat")
    if x.device.type == "cpu":
        return r2c_nat_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_nat: unsupported device {x.device}")
    check_cuda(x, torch.float32, "r2c_nat")
    h = n // 2
    wq = device_wq(h, -1, 1.0, x.device)
    tw = _device_tw(n, x.device)
    out = torch.empty((t, h + 1), dtype=torch.complex64, device=x.device)
    if t == 0:
        return out
    r = block_rows(h, t, num_sms(x.device))
    with torch.cuda.device(x.device):
        err = _build.lib().ndfft_r2c_nat(
            x.data_ptr(), out.data_ptr(), wq.data_ptr(), tw.data_ptr(), t, n, r,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "r2c_nat")
    r2c_nat.launches += 1
    return out


r2c_nat.launches = 0


def c2r_nat(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """C2R of the rows of a (T, n/2+1) complex64 spectrum -> (T, n) float32,
    times ``scale``; the DC and Nyquist imaginary parts are ignored. A CPU
    tensor runs the plain version; a CUDA tensor launches kernel 3 or raises."""
    _check_n(n, "c2r_nat")
    h = n // 2
    if s.dim() != 2 or s.shape[1] != h + 1:
        raise ValueError(f"c2r_nat: expected (T, {h + 1}), got {tuple(s.shape)}")
    if s.device.type == "cpu":
        return c2r_nat_plain(s, n, scale)
    if s.device.type != "cuda":
        raise ValueError(f"c2r_nat: unsupported device {s.device}")
    check_cuda(s, torch.complex64, "c2r_nat")
    t = s.shape[0]
    sc = 1.0 if scale is None else float(scale)
    wq = device_wq(h, +1, 1.0, s.device)
    ab = _device_ab(n, sc, s.device)
    out = torch.empty((t, n), dtype=torch.float32, device=s.device)
    if t == 0:
        return out
    r = block_rows(h, t, num_sms(s.device))
    with torch.cuda.device(s.device):
        err = _build.lib().ndfft_c2r_nat(
            s.data_ptr(), out.data_ptr(), wq.data_ptr(), ab.data_ptr(), t, n, r,
            torch.cuda.current_stream(s.device).cuda_stream)
    _build.check(err, "c2r_nat")
    c2r_nat.launches += 1
    return out


c2r_nat.launches = 0
