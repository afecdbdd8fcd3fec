"""Kernels 23, 24 and 27: the DCT kernels.

* Kernel 27, :func:`dct_dense_mid`: any DCT type along the middle axis of a
  (B, n, L) float32 tensor as one dense product with the scaled type matrix
  (``csrc/dct_dense.cu``; replaces the JAX package's
  ``ops/pallas/dct.py::_dct_dense_kernel``).
* Kernels 23 and 24, :func:`dct2_nat` and :func:`dct3_nat`: DCT-II and
  DCT-III of contiguous float32 rows by the Makhoul lowering on the bts2
  core's half-length real FFT (``csrc/dct_nat.cu``; replace
  ``dct.py::_dct2_kernel`` and ``_dct3_kernel``).

This module holds their host-built constants, their plain PyTorch versions
and their wrappers, whose ``launches`` attributes count kernel launches. All
transforms are in the rustdct convention (scipy's unnormalized DCT / 2)
times ``scale``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...plan import _cis
from . import _build
from .fft import M, block_rows, check_cuda, dense_tile, device_wq, num_sms
from .rfft import _device_ab, _device_tw, c2r_nat_plain, r2c_nat_plain

DCT_F = (1, 2, 4, 8, 16)   # half-length factors F of kernels 23/24 (h = 128 F)


# --------------------------------------------------------------------------
# Kernel 27: the dense DCT matrix
# --------------------------------------------------------------------------


def dense_matrix(n: int, dct_type: int) -> np.ndarray:
    """Exact float64 (n, n) DCT matrix M[k, t] in the rustdct convention,
    with integer-exact angle reduction (the JAX package's
    ``_dct_dense_matrix``)."""
    t = np.arange(n, dtype=np.int64)
    k = np.arange(n, dtype=np.int64)
    if dct_type == 1:
        m_ = _cis(np.outer(k, t), n - 1, -1)[0]
        m_[:, 0] *= 0.5
        m_[:, n - 1] *= 0.5
    elif dct_type == 2:
        m_ = _cis(np.outer(k, 2 * t + 1), 2 * n, -1)[0]
    elif dct_type == 3:
        m_ = _cis(np.outer(2 * k + 1, t), 2 * n, -1)[0]
        m_[:, 0] = 0.5
    elif dct_type == 4:
        m_ = _cis(np.outer(2 * k + 1, 2 * t + 1), 4 * n, -1)[0]
    else:
        raise ValueError(f"bad dct type {dct_type}")
    return m_


def dense_consts(n: int, dct_type: int, scale: float = 1.0) -> np.ndarray:
    """(n, n) float32 W[t, k] = scale * M[k, t], rounded once from float64:
    the JAX kernel's table at its "highest" tier, in C order (the kernel
    reads W[t, k] at t * n + k)."""
    return np.ascontiguousarray((dense_matrix(n, dct_type) * scale).T, np.float32)


@lru_cache(maxsize=64)
def _device_dense(n: int, dct_type: int, scale: float,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dense_consts(n, dct_type, scale)).to(device)


def dct_dense_mid_plain(x: torch.Tensor, dct_type: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 27: scale * DCT along dim 1 of (B, n, L)."""
    s = 1.0 if scale is None else float(scale)
    w = _device_dense(x.shape[1], dct_type, s, x.device)
    return torch.einsum("tk,btc->bkc", w, x)


def dct_dense_mid(x: torch.Tensor, dct_type: int, scale=None) -> torch.Tensor:
    """scale * DCT-<dct_type> along dim 1 of a (B, n, L) float32 tensor. A
    CPU tensor runs the plain version; a CUDA tensor launches kernel 27 or
    raises."""
    if x.dim() != 3:
        raise ValueError(f"dct_dense_mid: expected (B, n, L), got {tuple(x.shape)}")
    nb, n, cols = x.shape
    if dct_type not in (1, 2, 3, 4) or n < 1 or (dct_type == 1 and n < 2):
        raise ValueError(f"dct_dense_mid: no DCT-{dct_type} of length {n}")
    if x.device.type == "cpu":
        return dct_dense_mid_plain(x, dct_type, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dct_dense_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "dct_dense_mid")
    s = 1.0 if scale is None else float(scale)
    w = _device_dense(n, dct_type, s, x.device)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    tm = dense_tile(n, nb, cols, num_sms(x.device))
    with torch.cuda.device(x.device):
        err = _build.lib().ndfft_dct_dense_mid(
            w.data_ptr(), x.data_ptr(), y.data_ptr(), nb, n, cols, tm,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dct_dense_mid")
    dct_dense_mid.launches += 1
    return y


dct_dense_mid.launches = 0


# --------------------------------------------------------------------------
# Kernels 23 and 24: the Makhoul lowering on the half-length real FFT
# --------------------------------------------------------------------------


def makhoul_perm(n: int) -> np.ndarray:
    """v = x[perm] = [x0, x2, .., x_odd descending] (ops/dct.py's
    ``_evenodd_perm``); DCT-III's output is y = u[argsort(perm)]."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)[::-1]])


def dct2_post(n: int, scale: float = 1.0):
    """(re, im) float32 of the DCT-II post twiddle scale * e^{-i pi k/(2n)},
    k = 0..n-1 (at scale 1 the JAX kernel's table, dct.py:237-240)."""
    wr, wi = _cis(np.arange(n, dtype=np.int64), 2 * n, -1)
    return np.asarray(wr * scale, np.float32), np.asarray(wi * scale, np.float32)


def dct3_pre(n: int, scale: float = 1.0):
    """(re, im) float32 of the DCT-III spectrum twiddle (scale/2) *
    e^{+i pi k/(2n)}, k = 0..n/2: the conjugate of the lowering's pre twiddle
    (ops/dct.py ``_dct3_consts``) with the x0 halving's 1/2 folded in."""
    qr, qi = _cis(np.arange(n // 2 + 1, dtype=np.int64), 2 * n, +1)
    return (np.asarray(qr * (0.5 * scale), np.float32),
            np.asarray(qi * (0.5 * scale), np.float32))


@lru_cache(maxsize=64)
def _device_twiddle(kind: str, n: int, scale: float,
                    device: torch.device) -> torch.Tensor:
    re, im = (dct2_post if kind == "post" else dct3_pre)(n, scale)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


@lru_cache(maxsize=64)
def _device_index(kind: str, n: int, device: torch.device) -> torch.Tensor:
    perm = makhoul_perm(n)
    idx = perm if kind == "perm" else np.argsort(perm)
    return torch.from_numpy(np.ascontiguousarray(idx)).to(device)


def dct2_nat_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 23: (T, n) float32 -> scale * DCT-II of each
    row: Makhoul permutation, kernel 2's R2C, Hermitian unfold, post twiddle."""
    n = x.shape[1]
    h = n // 2
    s = 1.0 if scale is None else float(scale)
    spec = r2c_nat_plain(x[:, _device_index("perm", n, x.device)])
    full = torch.cat([spec, spec[:, 1:h].flip(-1).conj()], dim=1)
    return (full * _device_twiddle("post", n, s, x.device)).real


def dct3_nat_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 24: (T, n) float32 -> scale * DCT-III of each
    row: S[k] = Q[k] (x[k] - i x[n-k]), kernel 3's C2R, un-permutation."""
    t, n = x.shape
    h = n // 2
    s = 1.0 if scale is None else float(scale)
    xz = torch.cat([x, x.new_zeros(t, 1)], dim=1)          # x[n] = 0
    k = torch.arange(h + 1, device=x.device)
    spec = _device_twiddle("pre", n, s, x.device) * torch.complex(xz[:, k], -xz[:, n - k])
    u = c2r_nat_plain(spec, n, None)
    return u[:, _device_index("unperm", n, x.device)]


def _check_nat(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (T, n), got {tuple(x.shape)}")
    n = x.shape[1]
    h = n // 2
    if n % 2 or h % M or h // M not in DCT_F:
        raise ValueError(f"{what}: n={n} is not 2 * 128 * F, F in {DCT_F}")


def _launch_nat(x: torch.Tensor, entry: str, wq, c1, c2) -> torch.Tensor:
    t, n = x.shape
    if x.data_ptr() % 8:       # the kernels read rows as float2
        x = x.clone()
    y = torch.empty_like(x)
    if t == 0:
        return y
    r = block_rows(n // 2, t, num_sms(x.device))
    with torch.cuda.device(x.device):
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), y.data_ptr(), wq.data_ptr(), c1.data_ptr(),
            c2.data_ptr(), t, n, r, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)
    return y


def dct2_nat(x: torch.Tensor, scale=None) -> torch.Tensor:
    """scale * DCT-II of the rows of a (T, n) float32 tensor, n = 256 ...
    4096 a power of two. A CPU tensor runs the plain version; a CUDA tensor
    launches kernel 23 or raises."""
    _check_nat(x, "dct2_nat")
    if x.device.type == "cpu":
        return dct2_nat_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dct2_nat: unsupported device {x.device}")
    check_cuda(x, torch.float32, "dct2_nat")
    n = x.shape[1]
    s = 1.0 if scale is None else float(scale)
    y = _launch_nat(x, "ndfft_dct2_nat", device_wq(n // 2, -1, 1.0, x.device),
                    _device_tw(n, x.device), _device_twiddle("post", n, s, x.device))
    dct2_nat.launches += 1
    return y


dct2_nat.launches = 0


def dct3_nat(x: torch.Tensor, scale=None) -> torch.Tensor:
    """scale * DCT-III of the rows of a (T, n) float32 tensor, n = 256 ...
    4096 a power of two. A CPU tensor runs the plain version; a CUDA tensor
    launches kernel 24 or raises."""
    _check_nat(x, "dct3_nat")
    if x.device.type == "cpu":
        return dct3_nat_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dct3_nat: unsupported device {x.device}")
    check_cuda(x, torch.float32, "dct3_nat")
    n = x.shape[1]
    s = 1.0 if scale is None else float(scale)
    y = _launch_nat(x, "ndfft_dct3_nat", device_wq(n // 2, +1, 1.0, x.device),
                    _device_ab(n, 1.0, x.device), _device_twiddle("pre", n, s, x.device))
    dct3_nat.launches += 1
    return y


dct3_nat.launches = 0
