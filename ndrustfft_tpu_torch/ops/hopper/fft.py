"""Kernel 1: C2C along the middle axis of (B, n, L) complex64, n = 128 * F.

The CUDA kernel is ``csrc/fft_axis_mid.cu`` on the shared core
``csrc/bts2_core.cuh``; it replaces the JAX package's
``ops/pallas/fft.py::_kernel_axis_mid_bts2``. This module holds its host-built
constants (:func:`bts2_consts`), its plain PyTorch version
(:func:`c2c_axis_mid_plain`) and its wrapper (:func:`c2c_axis_mid`), whose
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...plan import dft_matrix, stage_twiddle
from . import _build

M = 128                 # stage-2 DFT length of the core
CORE_F = (2, 4, 8, 16)  # butterfly factors the core instantiates
C2C_F = (4, 8, 16)      # factors kernel 1 takes (n = 512, 1024, 2048)
SMEM_ELEMS = 8192       # complex elements of one block's tile (64 KB)


def bts2_consts(n: int, sign: int, scale: float = 1.0):
    """(F, m, m) float32 (re, im) of the twiddle-folded stage-2 matrices
    Wq[q][b][p'] = W_n^{q b} * W_m^{b p'} * scale, m = 128, F = n / m.

    Built in float64 by the same expression as the JAX package's
    ``_bts2_consts`` (mode "highest") and rounded once, so the two tables are
    bit-identical."""
    f = n // M
    tw_r, tw_i = stage_twiddle(f, M, sign)         # [q, b]
    wm_r, wm_i = dft_matrix(M, sign)               # [b, p']
    re = np.empty((f, M, M), np.float32)
    im = np.empty((f, M, M), np.float32)
    for q in range(f):
        cr = tw_r[q][:, None] * wm_r - tw_i[q][:, None] * wm_i
        ci = tw_r[q][:, None] * wm_i + tw_i[q][:, None] * wm_r
        re[q] = np.asarray(cr * scale, np.float32)
        im[q] = np.asarray(ci * scale, np.float32)
    return re, im


@lru_cache(maxsize=64)
def device_wq(n: int, sign: int, scale: float, device: torch.device) -> torch.Tensor:
    """:func:`bts2_consts` as a (F, m, m) complex64 tensor on ``device``."""
    re, im = bts2_consts(n, sign, scale)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


@lru_cache(maxsize=64)
def _dft_f(f: int, sign: int, device: torch.device) -> torch.Tensor:
    re, im = dft_matrix(f, sign)
    return torch.complex(torch.from_numpy(re.astype(np.float32)),
                         torch.from_numpy(im.astype(np.float32))).to(device)


def bts2_plain(x: torch.Tensor, wq: torch.Tensor, sign: int) -> torch.Tensor:
    """Plain version of the core: the length-n transform along dim 1 of a
    (B, n, L) complex tensor, n = F * m, with stage-2 constants ``wq``.

    Stage 1 is the F-point DFT over the leading planes a (t = a*m + b),
    stage 2 the per-q product with Wq, and the (p', q) order of the result
    is k = q + F*p'."""
    nb, n, cols = x.shape
    f = wq.shape[0]
    y = torch.einsum("aq,bamc->bqmc", _dft_f(f, sign, x.device),
                     x.reshape(nb, f, M, cols))
    z = torch.einsum("qmp,bqmc->bpqc", wq, y)
    return z.reshape(nb, n, cols)


def c2c_axis_mid_plain(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 1 on any device."""
    s = 1.0 if scale is None else float(scale)
    return bts2_plain(x, device_wq(x.shape[1], sign, s, x.device), sign)


@lru_cache(maxsize=8)
def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def block_cols(n: int, groups: int, cols: int, sms: int) -> int:
    """Columns per block: the largest power of two whose n x C tile fits the
    shared-memory budget, halved while the grid of ``groups`` times the
    column tiles would leave SMs idle."""
    c = SMEM_ELEMS // n
    while c > 1 and groups * -(-cols // c) < sms:
        c //= 2
    return c


def check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.requires_grad:
        raise NotImplementedError(
            f"{what}: the CUDA kernels have no backward yet (ROADMAP.md, "
            "queue 1 item 8: autograd)")


def c2c_axis_mid(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C along dim 1 of a (B, n, L) complex64 tensor, n = 128 * F with F
    in {4, 8, 16}, times ``scale``. A CPU tensor runs the plain version; a
    CUDA tensor launches kernel 1 or raises."""
    if x.dim() != 3:
        raise ValueError(f"c2c_axis_mid: expected (B, n, L), got {tuple(x.shape)}")
    nb, n, cols = x.shape
    if n % M or n // M not in C2C_F:
        raise ValueError(f"c2c_axis_mid: n={n} is not 128 * F, F in {C2C_F}")
    if x.device.type == "cpu":
        return c2c_axis_mid_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_axis_mid: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "c2c_axis_mid")
    s = 1.0 if scale is None else float(scale)
    wq = device_wq(n, sign, s, x.device)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    c = block_cols(n, nb, cols, num_sms(x.device))
    with torch.cuda.device(x.device):
        err = _build.lib().ndfft_c2c_axis_mid(
            x.data_ptr(), y.data_ptr(), wq.data_ptr(), nb, n, cols, c, sign,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "c2c_axis_mid")
    c2c_axis_mid.launches += 1
    return y


c2c_axis_mid.launches = 0
