"""Kernels 23 to 29 and 12: the DCT kernels.

* Kernel 27, :func:`dct_dense_mid`: any DCT type along the middle axis of a
  (B, n, L) float32 tensor, 2 <= n <= 1100 (replaces the JAX package's
  ``ops/pallas/dct.py::_dct_dense_kernel``). DCT-I where n - 1 has a radix
  plan and DCT-II/III at even n where n/2 has one run the Makhoul passes
  on the radix column tile (``csrc/dct_mid_radix.cu``: DCT-I as the R2C of
  the even extension, DCT-II as kernel 16's R2C of the Makhoul order with
  the post twiddle in its epilogue, DCT-III as kernel 17's C2R with the pre
  twiddle in its load and the interleave in its epilogue); DCT-IV, DCT-II/
  III at odd n, the lengths without a plan and the DCT-I lengths where
  :func:`~.fft.dense_beats_radix` holds for n - 1 keep one dense product
  with the scaled type matrix (``csrc/dct_dense.cu``). DST-II/III reach
  both through their flip/sign conjugation.
* Kernels 23 and 24, :func:`dct2_nat` and :func:`dct3_nat`: DCT-II and
  DCT-III of contiguous float32 rows by the Makhoul lowering (replace
  ``dct.py::_dct2_kernel`` and ``_dct3_kernel``). At every length whose
  half length has a plan (:func:`dct2_nat_radix`) both run on the radix
  row core (``csrc/dct_rows_radix.cu``): kernel 23 as the Makhoul R2C,
  kernel 24 as the Makhoul C2R; at the 29 others, ``csrc/dct_nat.cu``.
* Kernels 25 and 26, :func:`dct2_mid` and :func:`dct3_mid`: the same two
  along the middle axis of (B, n, L) (replace ``dct.py::_dct2_kernel_mid``
  and ``_dct3_kernel_mid``). At the lengths of :func:`dct2_nat_radix`
  kernel 25 runs kernel 27's Makhoul R2C and kernel 26 its Makhoul C2R on
  the radix column tile (``csrc/dct_mid_radix.cu``), columns a tile by
  :func:`dct2_mid_cols`; at the 29 others, ``csrc/dct_mid.cu``.
* Kernel 28, :func:`dct4_mid`: DCT-IV along the middle axis of (B, n, L),
  n = 2 hl with hl = 128 * F, F <= 256, as one complex FFT of length hl
  per column between an entry and an exit chirp (replaces
  ``dct.py::_dct4_kernel_mid``), in the form :func:`dct4_form` names: on
  the radix column tile (``csrc/dct4_mid_radix.cu``) as one pass at every
  hl <= 10240 with a plan and as the two passes of a column four-step
  above it, parked in y; at the 23 prime F without a plan on the wide
  core (F <= 160) or in the long form, the FFTs of the two real streams in
  two passes of the wide core's real tile (``csrc/dct4_mid.cu``).
* Kernel 29, :func:`spectral_dct_mid`: the fused pipeline
  DCT-III(H * DCT-II(x)) along the middle axis of (B, n, L), kernel 25's
  forward, the multiply and kernel 26's inverse on one column tile
  (replaces ``dct.py::_spectral_dct_kernel_mid``): on the radix column tile
  at the lengths of :func:`dct2_nat_radix` (``csrc/spectral_dct_radix.cu``,
  columns a tile by :func:`~.rfft.spectral_cols`), in the bts2 forms of
  :func:`dct_form` at the 29 others (``csrc/spectral_dct_mid.cu``).
* Kernel 12, :func:`dct23_blue_mid`: the Makhoul DCT-II/III core along the
  middle axis of a real (B, n, L) tensor at a Bluestein length, the
  real-input chirp-z on kernel 11's column kernel at M = chirp_m(n) with
  Re(z b) out, the Makhoul twiddles (and DCT-III's c0/2) folded into the
  entry and exit tables (``csrc/dct_blue_radix.cu``; replaces
  ``fft.py::_kernel_axis_mid_blue_rr``).

Kernels 23 to 26 and 29 take every n = 128 * k that the JAX gate
``dct_pallas_supported`` sends to them (split (128, k), k <= 256). Off the
radix cores (at the 29 lengths without a plan of n/2), they run in the
form :func:`dct_form` names: the half length h = n/2 = 128 * F for even k
(the real FFT of kernels 2/3 or 16/17 on the wide core
``csrc/bts2_wide.cuh``), and the n-point FFT on the wide core's real tile
for odd k, where h = 64 k is no multiple of 128 (``csrc/dct_wide.cuh``; one
column fills a block at odd k > 160).

What bounds them, and what the designs do about it, is in the sources'
header comments: the bts2 core's dense DFT-128 on the FP32 cores, device
memory for the radix core; device memory read once and written once; every
constant built on the host.

This module holds their host-built constants, their plain PyTorch versions
and their wrappers, whose ``launches`` attributes count kernel launches
(kernels 23 to 26, 28 and 29 also count the wide core's (half-length)
launches apart, in ``wide_launches``, kernels 23 to 26 and 29 the n-point
ones in ``npoint_launches``, kernel 28 its long form's in
``long_launches`` and its four-step's in ``fourstep_launches``, kernel 27
its radix column tile's, kernels 23 to 26, 28 and 29 their radix cores'
and kernel 12 its chirp-z's (every one) in ``radix_launches``). All
transforms are in the rustdct convention (scipy's unnormalized DCT / 2)
times ``scale``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ...plan import _cis, blue_h, chirp
from . import _build
from .fft import (M, RADIX_MAX_STAGES, RADIX_WIDE_N, REAL_MAX_F, WIDE_MAX_F,
                  bts2_plain, c2c_radix_mid_plain, check_blue_n, check_cuda, check_mult,
                  chirp_m, chirp_z_radix_plain, dense_beats_radix, dense_tile,
                  device_radix, device_wide, device_wq, f32_pair, mult_planes, num_sms,
                  pair_tensor, radix_block, radix_mid_cols, radix_plan, wide_block,
                  wide_bytes, wide_real_bytes)
from .rfft import (_bts2_col_c2r_plain, _bts2_col_r2c_plain, _device_ab, _device_tw,
                   c2r_mid_cols, c2r_mid_plain, c2r_nat_plain, packed_mid_cols,
                   r2c_mid_cols, r2c_mid_radix_plain, r2c_radix_plain, spectral_cols)


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
    """Plain version of kernel 27's dense product: scale * DCT along dim 1
    of (B, n, L)."""
    s = 1.0 if scale is None else float(scale)
    w = _device_dense(x.shape[1], dct_type, s, x.device)
    return torch.einsum("tk,btc->bkc", w, x)


def dct_radix_len(n: int, dct_type: int):
    """The transform length h of kernel 27 on the radix column tile at
    (n, dct_type): n - 1 for DCT-I, n/2 for DCT-II/III at even n, where
    :func:`~.fft.radix_plan` has it and, for DCT-I, the dense product is not
    faster (:func:`~.fft.dense_beats_radix`: 101 of the 772 n with a plan,
    e.g. 128 = 127 + 1); else None (DCT-IV, odd n for DCT-II/III, those
    DCT-I lengths, no plan: the dense product)."""
    h = n - 1 if dct_type == 1 else n // 2 if dct_type in (2, 3) and n % 2 == 0 else 0
    if h < 2 or radix_plan(h) is None or (dct_type == 1 and dense_beats_radix(h)):
        return None
    return h


def dct_radix_plain(x: torch.Tensor, dct_type: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 27 on the radix column tile: scale * DCT-I,
    II or III along dim 1 of (B, n, L), as the kernel computes it. DCT-I: the
    half of the real part of the R2C of the even extension (kernel 16's plain
    version, :func:`~.rfft.r2c_mid_radix_plain`); DCT-II: that R2C of the
    Makhoul order, X[k] times the post twiddle P[k], y[k] = Re and
    y[n-k] = -Im for 0 < k < h; DCT-III: S[k] = Q[k] (x[k] - i x[n-k]) and
    kernel 17's plain version (:func:`~.rfft.c2r_mid_plain`), then the
    un-permutation."""
    n = x.shape[1]
    s = _scale(scale)
    if dct_type == 1:
        e = torch.cat([x, x[:, 1:n - 1].flip(1)], dim=1)
        return (r2c_mid_radix_plain(e).real * (0.5 * s)).contiguous()
    h = n // 2
    if dct_type == 2:
        w = (r2c_mid_radix_plain(x[:, _device_index("perm", n, x.device)])
             * _device_twiddle("post", n, s, x.device)[:h + 1, None])
        return torch.cat([w.real, -w.imag[:, 1:h].flip(1)], dim=1)
    return c2r_mid_plain(_dct3_spec(x, s), n, None)[:, _device_index("unperm", n, x.device)]


def dct_radix_cols(n: int, dct_type: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernel 27 on the radix column tile at the
    transform length h: kernel 16's :func:`~.rfft.r2c_mid_cols` of 2h
    (DCT-I, DCT-II), kernel 17's :func:`~.rfft.c2r_mid_cols` (DCT-III)."""
    h = dct_radix_len(n, dct_type)
    if dct_type == 3:
        return c2r_mid_cols(h, groups, cols, sms)
    return r2c_mid_cols(2 * h, groups, cols, sms)


def dct_radix_launch(x: torch.Tensor, y: torch.Tensor, dct_type: int, scale, c: int,
                     ldg: bool = False) -> None:
    """Launch kernel 27 (or kernels 25 and 26, DCT-II and DCT-III past
    n = 1100) on the radix column tile, ``c`` columns a tile
    (:func:`dct_radix_cols`, :func:`dct2_mid_cols`),
    on the (B, n, L) float32 CUDA tensor x into y
    (``csrc/dct_mid_radix.cu``), a DCT-II's or DCT-III's x loaded through
    the read-only path if ``ldg``, else evict-first; counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    h = dct_radix_len(n, dct_type)
    s = _scale(scale)
    plan = radix_plan(h)
    if dct_type == 1:
        c1, c2 = _device_tw(2 * h, dev).data_ptr(), None
    elif dct_type == 2:
        c1, c2 = _device_tw(n, dev).data_ptr(), _device_twiddle("post", n, s, dev).data_ptr()
    else:
        c1, c2 = _device_ab(n, 1.0, dev).data_ptr(), _device_twiddle("pre", n, s, dev).data_ptr()
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_dct_mid_radix(
            dct_type, x.data_ptr(), y.data_ptr(),
            device_radix(h, +1 if dct_type == 3 else -1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), c1, c2, 0.5 * s, nb, n, cols, c,
            int(ldg), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_dct_mid_radix")


def dct_dense_launch(x: torch.Tensor, y: torch.Tensor, dct_type: int, scale) -> None:
    """Launch kernel 27's dense product on the (B, n, L) float32 CUDA
    tensor x into y (``csrc/dct_dense.cu``); counts nothing."""
    nb, n, cols = x.shape
    w = _device_dense(n, dct_type, _scale(scale), x.device)
    tm = dense_tile(n, nb, cols, num_sms(x.device))
    with torch.cuda.device(x.device):
        err = _build.lib().ndfft_dct_dense_mid(
            w.data_ptr(), x.data_ptr(), y.data_ptr(), nb, n, cols, tm,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dct_dense_mid")


def dct_dense_mid(x: torch.Tensor, dct_type: int, scale=None) -> torch.Tensor:
    """scale * DCT-<dct_type> along dim 1 of a (B, n, L) float32 tensor.
    Where :func:`dct_radix_len` has a length (DCT-I, and DCT-II/III at even
    n), a CPU tensor runs :func:`dct_radix_plain` and a CUDA tensor launches
    kernel 27 on the radix column tile (counted in ``radix_launches`` as
    well); at the other types and lengths, :func:`dct_dense_mid_plain` and
    the dense product. Anything else raises."""
    if x.dim() != 3:
        raise ValueError(f"dct_dense_mid: expected (B, n, L), got {tuple(x.shape)}")
    nb, n, cols = x.shape
    if dct_type not in (1, 2, 3, 4) or n < 1 or (dct_type == 1 and n < 2):
        raise ValueError(f"dct_dense_mid: no DCT-{dct_type} of length {n}")
    radix = dct_radix_len(n, dct_type) is not None
    if x.device.type == "cpu":
        if radix:
            return dct_radix_plain(x, dct_type, scale)
        return dct_dense_mid_plain(x, dct_type, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dct_dense_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "dct_dense_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if radix:
        dct_radix_launch(x, y, dct_type, scale,
                         dct_radix_cols(n, dct_type, nb, cols, num_sms(x.device)))
        dct_dense_mid.radix_launches += 1
    else:
        dct_dense_launch(x, y, dct_type, scale)
    dct_dense_mid.launches += 1
    return y


dct_dense_mid.launches = 0
dct_dense_mid.radix_launches = 0


# --------------------------------------------------------------------------
# Kernels 23 to 26: the Makhoul lowering on the bts2 core
# --------------------------------------------------------------------------


def dct_form(n: int):
    """("half", F) where kernels 23 to 26 and 29 run the half-length real FFT,
    n = 2h with h = 128 * F (k = n / 128 even, F <= 160: the wide core's
    complex tile); ("npoint", F) where they run the n-point FFT on the real
    tile, n = 128 * F with odd F <= 255 (n <= 32640); None beyond, or where
    n is no multiple of 128. (Where :func:`dct2_nat_radix` holds they run on
    the radix cores instead; the form names the lengths they take.)"""
    if n <= 0 or n % M:
        return None
    k = n // M
    if k % 2 == 0:
        return ("half", k // 2) if k // 2 <= WIDE_MAX_F else None
    return ("npoint", k) if k <= REAL_MAX_F else None


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


def dct3_pre_npoint(n: int, scale: float = 1.0):
    """(re, im) float32 of the n-point DCT-III's input twiddle scale *
    e^{-i pi t/(2n)}, t = 0..n-1, entry 0 halved (the x0 halving): the JAX
    kernel's separable pre twiddle (dct.py:_build_dct3) as one table, with
    its h0 mask and the scale folded in."""
    wr, wi = _cis(np.arange(n, dtype=np.int64), 2 * n, -1)
    half = np.ones(n)
    half[0] = 0.5
    return (np.asarray(wr * half * scale, np.float32),
            np.asarray(wi * half * scale, np.float32))


def npoint_chirp(n: int, scale: float = 1.0):
    """(re, im) float32 of the n-point DCT-III's input twiddle in the
    kernels' separable form, F + 128 values (F = n / 128): e^{-i pi a/(2F)}
    for a < F, then scale * e^{-i pi b/(2n)} for b < 128, whose product at
    t = a * 128 + b is :func:`dct3_pre_npoint`'s e^{-i pi t/(2n)} (the x0
    halving is the kernels' load). Built by the JAX kernel's ``_cis``
    expressions (``dct.py::_build_dct3``: the b part at scale 1 is its
    ``b`` table's first 128 entries bit for bit) and rounded once."""
    f = n // M
    ar, ai = _cis(np.arange(f, dtype=np.int64), 2 * f, -1)
    br, bi = _cis(np.arange(M, dtype=np.int64), 2 * n, -1)
    return (np.concatenate([np.asarray(ar, np.float32), np.asarray(br * scale, np.float32)]),
            np.concatenate([np.asarray(ai, np.float32), np.asarray(bi * scale, np.float32)]))


_TWIDDLES = {"post": dct2_post, "pre": dct3_pre, "pre_npoint": dct3_pre_npoint,
             "chirp_npoint": npoint_chirp}


@lru_cache(maxsize=64)
def _device_twiddle(kind: str, n: int, scale: float,
                    device: torch.device) -> torch.Tensor:
    re, im = _TWIDDLES[kind](n, scale)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


@lru_cache(maxsize=64)
def _device_index(kind: str, n: int, device: torch.device) -> torch.Tensor:
    perm = makhoul_perm(n)
    idx = perm if kind == "perm" else np.argsort(perm)
    return torch.from_numpy(np.ascontiguousarray(idx)).to(device)


def _scale(scale) -> float:
    return 1.0 if scale is None else float(scale)


def _dct2_plain(x: torch.Tensor, scale) -> torch.Tensor:
    """scale * DCT-II along dim 1 of a (B, n, L) float32 tensor in the form
    the bts2 kernels take at n (:func:`dct_form`): the Makhoul permutation,
    then the half-length R2C on the bts2 core (the column R2C's plain
    version, :func:`~.rfft._bts2_col_r2c_plain`, which takes every h = 128 F,
    those without a radix plan included) with the Hermitian unfold, or the
    n-point FFT (the core's plain version); then the post twiddle."""
    n = x.shape[1]
    post = _device_twiddle("post", n, _scale(scale), x.device)[:, None]
    v = x[:, _device_index("perm", n, x.device)]
    if dct_form(n)[0] == "npoint":
        z = bts2_plain(v.to(torch.complex64), device_wq(n, -1, 1.0, x.device), -1)
        return (z * post).real
    h = n // 2
    spec = _bts2_col_r2c_plain(v[:, 0::2], v[:, 1::2])
    full = torch.cat([spec, spec[:, 1:h].flip(1).conj()], dim=1)
    return (full * post).real


def _dct3_spec(x: torch.Tensor, s: float) -> torch.Tensor:
    """The DCT-III's half spectrum S[k] = Q[k] (x[k] - i x[n-k]), k = 0..n/2,
    x[n] = 0, of (B, n, L) along dim 1 (Q = :func:`dct3_pre` at scale s)."""
    nb, n, cols = x.shape
    xz = torch.cat([x, x.new_zeros(nb, 1, cols)], dim=1)     # x[n] = 0
    k = torch.arange(n // 2 + 1, device=x.device)
    return (_device_twiddle("pre", n, s, x.device)[:, None]
            * torch.complex(xz[:, k], -xz[:, n - k]))


def _dct3_plain(x: torch.Tensor, scale) -> torch.Tensor:
    """scale * DCT-III along dim 1 of a (B, n, L) float32 tensor in the
    kernels' form at n: S[k] = Q[k] (x[k] - i x[n-k]) and the bts2 column
    C2R (half length, :func:`~.rfft._bts2_col_c2r_plain`, the arithmetic of
    the kernels' core), or the n-point FFT of the pre-twiddled column (its real
    part); then the un-permutation y[2t] = u[t], y[2t+1] = u[n-1-t]."""
    n = x.shape[1]
    s = _scale(scale)
    if dct_form(n)[0] == "npoint":
        w = x * _device_twiddle("pre_npoint", n, s, x.device)[:, None]
        u = bts2_plain(w, device_wq(n, -1, 1.0, x.device), -1).real
    else:
        u = _bts2_col_c2r_plain(_dct3_spec(x, s), n, None)
    return u[:, _device_index("unperm", n, x.device)]


def dct2_nat_radix(n: int) -> bool:
    """Kernels 23 to 26 and 29 run on the radix cores at n (kernel 23 the
    Makhoul R2C on rows, kernel 24 the Makhoul C2R on rows, kernels 25 and
    26 the Makhoul R2C and C2R on the column tile, kernel 29 both on one
    column tile): :func:`dct_form` takes n and
    :func:`~.fft.radix_plan` has h = n/2 = 64 k (259 of the 288 lengths, the
    odd k included; not k = 131 ... 251 prime, nor 2 k for k = 131, 137,
    139, 149, 151, 157, which keep the wide core's forms)."""
    return dct_form(n) is not None and radix_plan(n // 2) is not None


def dct2_rows_radix_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 23 on the radix row core: (T, n) float32 ->
    scale * DCT-II of each row, as the kernel computes it: the R2C of the
    Makhoul order at half length h = n/2 (kernel 2's plain version,
    :func:`~.rfft.r2c_radix_plain`), X[k] times the post twiddle P[k],
    y[k] = Re and y[n-k] = -Im for 0 < k < h."""
    n = x.shape[1]
    h = n // 2
    w = (r2c_radix_plain(x[:, _device_index("perm", n, x.device)])
         * _device_twiddle("post", n, _scale(scale), x.device)[:h + 1])
    return torch.cat([w.real, -w.imag[:, 1:h].flip(1)], dim=1)


def dct2_nat_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 23: (T, n) float32 -> scale * DCT-II of each
    row, in the form the kernel takes at n: :func:`dct2_rows_radix_plain`
    where :func:`dct2_nat_radix` holds, else :func:`_dct2_plain` on the rows
    as (T, n, 1)."""
    if dct2_nat_radix(x.shape[1]):
        return dct2_rows_radix_plain(x, scale)
    return _dct2_plain(x[:, :, None], scale)[:, :, 0]


def dct2_rows_radix_launch(x: torch.Tensor, y: torch.Tensor, scale, rows=None) -> None:
    """Launch kernel 23 on the radix row core on the (T, n) float32 CUDA
    tensor x (16-byte aligned) into y, ``rows`` a block (by default
    :func:`~.fft.radix_block` at h = n/2, as kernel 2); counts nothing."""
    t, n = x.shape
    h = n // 2
    dev = x.device
    plan = radix_plan(h)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_dct2_rows_radix(
            x.data_ptr(), y.data_ptr(), device_radix(h, -1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), _device_tw(n, dev).data_ptr(),
            _device_twiddle("post", n, _scale(scale), dev).data_ptr(), t, h,
            rows or radix_block(h, t, num_sms(dev)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_dct2_rows_radix")


def dct3_rows_radix_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 24 on the radix row core: (T, n) float32 ->
    scale * DCT-III of each row, as the kernel computes it: the half
    spectrum S[k] = Q[k] (x[k] - i x[n-k]), kernel 3's plain version
    (:func:`~.rfft.c2r_nat_plain`: the DC and Nyquist imaginary parts
    ignored, the inverse unpack, the radix plain with the sign +1 table),
    then the un-permutation y[2t] = u[t], y[2t+1] = u[n-1-t]."""
    n = x.shape[1]
    s = _dct3_spec(x[:, :, None], _scale(scale))[:, :, 0]
    return c2r_nat_plain(s, n, None)[:, _device_index("unperm", n, x.device)]


def dct3_rows_radix_launch(x: torch.Tensor, y: torch.Tensor, scale, rows=None) -> None:
    """Launch kernel 24 on the radix row core on the (T, n) float32 CUDA
    tensor x into y (both 16-byte aligned), ``rows`` a block (by default
    :func:`~.fft.radix_block` at h = n/2, as kernel 3); counts nothing."""
    t, n = x.shape
    h = n // 2
    dev = x.device
    plan = radix_plan(h)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_dct3_rows_radix(
            x.data_ptr(), y.data_ptr(), device_radix(h, +1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan),
            _device_ab(n, 1.0, dev).data_ptr(),
            _device_twiddle("pre", n, _scale(scale), dev).data_ptr(), t, h,
            rows or radix_block(h, t, num_sms(dev)), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_dct3_rows_radix")


def dct3_nat_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 24: (T, n) float32 -> scale * DCT-III of each
    row, in the form the kernel takes at n: :func:`dct3_rows_radix_plain`
    where :func:`dct2_nat_radix` holds, else :func:`_dct3_plain` on the rows
    as (T, n, 1)."""
    if dct2_nat_radix(x.shape[1]):
        return dct3_rows_radix_plain(x, scale)
    return _dct3_plain(x[:, :, None], scale)[:, :, 0]


def dct2_mid_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 25: scale * DCT-II along dim 1 of (B, n, L),
    in the form the kernel takes at n: kernel 27's Makhoul R2C on the radix
    column tile (:func:`dct_radix_plain`) where :func:`dct2_nat_radix`
    holds, else :func:`_dct2_plain`."""
    if dct2_nat_radix(x.shape[1]):
        return dct_radix_plain(x, 2, scale)
    return _dct2_plain(x, scale)


DCT2_MID_WIDE_H = 768   # kernel 25's wide column tiles from this half length on


def dct2_mid_cols(h: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernels 25 and 26 on the radix column tile at half
    length h: kernel 18's rule (:func:`~.rfft.packed_mid_cols`) with its wide
    tiles from h = DCT2_MID_WIDE_H on: below it :func:`~.fft.radix_mid_cols`
    (the 16-element form), from it the largest power of two up to 16 whose
    tile a block takes in the 32- or 40-element form (16 at h = 768 and
    1024, 1 above h = 10240), halved while the grid would leave SMs idle.
    (On an NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 5, C =
    1, 2, 4, 8, 16: at (1, 1536, 2359296) 144.8, 70.2, 37.6, 29.0, 28.1 ms
    and at (1536, 1536, 1536) 83.6, 60.6, 28.2, 28.3, 27.1, where
    radix_mid_cols took 4; at (1, 2048, 2048) 0.146, 0.087, 0.076, 0.059,
    0.059 (the grid rule takes 8); at (1, 1152, 1152) 0.070, 0.053, 0.047,
    0.056, 0.054 (h = 576: 4, the 16-element form); one column at
    (1, 31104, 31104), 30.6 ms. Kernel 26, time_kernels.py --scan-dct-mid,
    the fastest or within 7%: at (1, 1536, 2359296) 133.3, 76.3, 52.7,
    42.9, 40.5 and at (1536, 1536, 1536) 87.4, 61.8, 49.7, 40.4, 39.6; at
    (1, 2048, 2048) 0.147, 0.100, 0.091, 0.074, 0.068; at (1, 1152, 1152)
    0.069, 0.048, 0.038, 0.045, 0.052; at (1, 31104, 31104) 30.3 read-only,
    30.8 evict-first. The wrapper loads x through the read-only path at
    C <= 2, as kernel 1: a tile row of one or two floats leaves the rest of
    each 32-byte sector in L2 for the neighbouring tiles.)"""
    return packed_mid_cols(h, groups, cols, sms, wide_from=DCT2_MID_WIDE_H)


def dct3_mid_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 26: scale * DCT-III along dim 1 of (B, n, L),
    in the form the kernel takes at n: kernel 27's Makhoul C2R on the radix
    column tile (:func:`dct_radix_plain`) where :func:`dct2_nat_radix`
    holds, else :func:`_dct3_plain`."""
    if dct2_nat_radix(x.shape[1]):
        return dct_radix_plain(x, 3, scale)
    return _dct3_plain(x, scale)


def _check_form(x: torch.Tensor, rows: bool, what: str):
    """The rank the wrapper takes and the form of its length, or raise."""
    if x.dim() != (2 if rows else 3):
        want = "(T, n)" if rows else "(B, n, L)"
        raise ValueError(f"{what}: expected {want}, got {tuple(x.shape)}")
    n = x.shape[1]
    form = dct_form(n)
    if form is None:
        raise ValueError(f"{what}: n={n} is not 128 * k with k even (k <= {2 * WIDE_MAX_F}) "
                         f"or odd (k <= {REAL_MAX_F})")
    return form


def launch_form(n: int, type3: bool, rows: bool) -> str:
    """The kernel form kernels 23 to 26 launch at n (``rows``: kernel 23 or,
    ``type3``, 24; else 25 or 26), n in :func:`dct_form`: "radix" where
    :func:`dct2_nat_radix` holds, else "npoint" (odd k) or "wide"."""
    if dct2_nat_radix(n):
        return "radix"
    return "npoint" if dct_form(n)[0] == "npoint" else "wide"


def _launch(wrapper, x: torch.Tensor, scale, type3: bool, rows: bool) -> torch.Tensor:
    """Kernel 23/24 (``rows``: x is (T, n)) or 25/26 (x is (B, n, L)) on a
    CUDA tensor: on the radix cores where :func:`dct2_nat_radix` holds, else
    the wide core's half-length form or its n-point form, by
    :func:`dct_form`; adds one to the wrapper's counts."""
    what = wrapper.__name__
    check_cuda(x, torch.float32, what)
    n = x.shape[1]
    form = launch_form(n, type3, rows)
    radix, npoint = form == "radix", form == "npoint"
    if radix and rows and x.data_ptr() % 16:
        x = x.clone()          # the radix rows read 16-byte quads
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    if radix:
        if not rows:
            c = dct2_mid_cols(n // 2, x.shape[0], x.shape[2], num_sms(x.device))
            dct_radix_launch(x, y, 3 if type3 else 2, scale, c, ldg=c <= 2)
        elif type3:
            dct3_rows_radix_launch(x, y, scale)
        else:
            dct2_rows_radix_launch(x, y, scale)
        wrapper.radix_launches += 1
    else:
        bts2_launch(x, y, scale, type3, rows, form)
        wrapper.wide_launches += not npoint
        wrapper.npoint_launches += npoint
    wrapper.launches += 1
    return y


def bts2_launch(x: torch.Tensor, y: torch.Tensor, scale, type3: bool, rows: bool,
                form: str) -> None:
    """Launch kernels 23 to 26's bts2 ``form`` ("wide" or "npoint",
    :func:`launch_form`'s names) on the float32 CUDA tensor x ((T, n) if
    ``rows`` else (B, n, L)) into y, at any n that :func:`dct_form` takes in
    that form; counts nothing. (The wrappers launch it where
    :func:`dct2_nat_radix` fails; chip_smoke.py times the forms the radix
    cores replaced with it.)"""
    n = x.shape[1]
    npoint = form == "npoint"
    dev = x.device
    s = _scale(scale)
    core = n if npoint else n // 2          # the length of the core's transform
    sign = +1 if type3 and not npoint else -1
    wq = device_wq(core, sign, 1.0, dev)
    if npoint:
        c1 = None
        c2 = _device_twiddle("chirp_npoint" if type3 else "post", n, s, dev)
    else:
        c1 = _device_ab(n, 1.0, dev) if type3 else _device_tw(n, dev)
        c2 = _device_twiddle("pre" if type3 else "post", n, s, dev)
    nb, cols = (1, x.shape[0]) if rows else (x.shape[0], x.shape[2])
    wf = device_wide(core, sign, dev).data_ptr()
    c = wide_block(core, nb, cols, num_sms(dev), wide_real_bytes if npoint else wide_bytes)
    shape = (cols, n) if rows else (nb, n, cols)
    entry = f"ndfft_dct_{'nat' if rows else 'mid'}_{'npoint' if npoint else 'wide'}"
    consts = (c2.data_ptr(),) if npoint else (c1.data_ptr(), c2.data_ptr())
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), entry)(
            int(type3), x.data_ptr(), y.data_ptr(), wq.data_ptr(), wf, *consts, *shape, c,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)


def _dct_wrapper(name: str, plain, type3: bool, rows: bool, doc: str):
    def wrapper(x: torch.Tensor, scale=None) -> torch.Tensor:
        _check_form(x, rows, name)
        if x.device.type == "cpu":
            return plain(x, scale)
        if x.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {x.device}")
        return _launch(wrapper, x, scale, type3, rows)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc + (
        " A CPU tensor runs the plain version; a CUDA tensor launches the kernel "
        "(on the radix cores where dct2_nat_radix(n) holds; else the wide core's "
        "half-length form or the n-point form, by dct_form(n)) or raises.")
    wrapper.launches = wrapper.wide_launches = wrapper.npoint_launches = 0
    return wrapper


dct2_nat = _dct_wrapper(
    "dct2_nat", dct2_nat_plain, False, True,
    "scale * DCT-II of the rows of a (T, n) float32 tensor (kernel 23), n = 128 * k "
    "(dct_form); its radix row core's launches are counted in radix_launches as well.")
dct2_nat.radix_launches = 0
dct3_nat = _dct_wrapper(
    "dct3_nat", dct3_nat_plain, True, True,
    "scale * DCT-III of the rows of a (T, n) float32 tensor (kernel 24), n = 128 * k "
    "(dct_form); its radix row core's launches are counted in radix_launches as well.")
dct3_nat.radix_launches = 0
dct2_mid = _dct_wrapper(
    "dct2_mid", dct2_mid_plain, False, False,
    "scale * DCT-II along dim 1 of a (B, n, L) float32 tensor (kernel 25), n = 128 * k "
    "(dct_form); its radix column tile's launches are counted in radix_launches as well.")
dct2_mid.radix_launches = 0
dct3_mid = _dct_wrapper(
    "dct3_mid", dct3_mid_plain, True, False,
    "scale * DCT-III along dim 1 of a (B, n, L) float32 tensor (kernel 26), n = 128 * k "
    "(dct_form); its radix column tile's launches are counted in radix_launches as well.")
dct3_mid.radix_launches = 0


# --------------------------------------------------------------------------
# Kernel 28: DCT-IV along a middle axis
# --------------------------------------------------------------------------


def dct4_f(n: int):
    """F of the half length hl = n/2 = 128 * F where kernel 28 takes n
    (1 <= F <= 256: the JAX gate dct4_mid_supported's split (128, F);
    :func:`dct4_form` names the form), else None."""
    if n % 2 or (n // 2) % M:
        return None
    f = n // 2 // M
    return f if 1 <= f <= REAL_MAX_F else None


def dct4_chirp(n: int):
    """(re, im) float32 of kernel 28's entry chirp e^{-i pi (4s+1)/(4n)},
    s = 0..n/2-1: the JAX package's composite expression (its
    api.py:530-531) at scale 1, rounded once."""
    sv = np.arange(n // 2)
    w = np.exp(-1j * np.pi * (4 * sv + 1) / (4 * n))
    return np.asarray(w.real, np.float32), np.asarray(w.imag, np.float32)


def dct4_post(n: int, scale: float = 1.0):
    """(re, im) float32 of kernel 28's exit chirp scale * (cos, sin)(pi k/n),
    k = 0..n/2-1: the JAX kernel's table expressions (dct.py:_build_dct4_mid),
    rounded once."""
    kv = np.arange(n // 2)
    return (np.asarray(scale * np.cos(np.pi * kv / n), np.float32),
            np.asarray(scale * np.sin(np.pi * kv / n), np.float32))


def dct4_chirp_long(n: int):
    """(re, im) float32 of kernel 28's entry chirp in its long form's
    separable form, F + 128 values (hl = n/2 = 128 * F): e^{-i pi a 128/n}
    = e^{-i pi a/(2F)} for a < F, then e^{-i pi/(4n)} e^{-i pi b/n} for
    b < 128, whose product at s = a * 128 + b is :func:`dct4_chirp`'s
    e^{-i pi (4s+1)/(4n)}. Built by the JAX kernel's expressions
    (``dct.py::_build_dct4_mid``'s a and b; the b part is its b table's first
    128 entries bit for bit) and rounded once."""
    f = n // 2 // M
    a = np.exp(-1j * np.pi * np.arange(f, dtype=np.float64) * M / n)
    b = np.exp(-1j * np.pi / (4 * n)) * np.exp(-1j * np.pi * np.arange(M, dtype=np.float64) / n)
    w = np.concatenate([a, b])
    return np.asarray(w.real, np.float32), np.asarray(w.imag, np.float32)


def dct4_fourstep_tw(n: int):
    """(re, im) float32 of kernel 28's four-step twiddle W_hl^u = e^{-2 pi i
    u / hl}, u = 0..hl-1 (hl = n/2; pass 1 reads entry s2 k1), each part
    rounded once."""
    hl = n // 2
    return f32_pair(_cis(2 * np.arange(hl, dtype=np.int64), hl, -1))


_DCT4_TABLES = {"chirp": lambda n, scale: dct4_chirp(n),
                "chirp_long": lambda n, scale: dct4_chirp_long(n), "post": dct4_post,
                "fourstep_tw": lambda n, scale: dct4_fourstep_tw(n)}


@lru_cache(maxsize=64)
def _device_dct4(kind: str, n: int, scale: float, device: torch.device) -> torch.Tensor:
    re, im = _DCT4_TABLES[kind](n, scale)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def _dct4_entry(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """c_s = w_s (x[2s] + i x[n-1-2s]) along dim 1 of (B, n, L)."""
    return torch.complex(x[:, 0::2], x.flip(1)[:, 0::2]) * w[:, None]


def _dct4_exit(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """y[2k] = Re(D_k conj p_k) and y[n-1-2k] = -Im(D_k conj p_k) from the
    (B, hl, L) D and the exit chirp p."""
    nb, hl, cols = d.shape
    p = p[:, None]
    evens = d.real * p.real + d.imag * p.imag
    odds = (d.real * p.imag - d.imag * p.real).flip(1)
    return torch.stack([evens, odds], dim=2).reshape(nb, 2 * hl, cols)


def _dct4_bts2_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 28's remnant (the wide core and the long
    form): the entry chirp, the bts2 core's plain version, the exit chirp."""
    n = x.shape[1]
    d = bts2_plain(_dct4_entry(x, _device_dct4("chirp", n, 1.0, x.device)),
                   device_wq(n // 2, -1, 1.0, x.device), -1)
    return _dct4_exit(d, _device_dct4("post", n, _scale(scale), x.device))


def dct4_radix_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 28's single pass on the radix column tile:
    the entry chirp, the radix core's plain version of length hl
    (:func:`~.fft.c2c_radix_mid_plain`), the exit chirp."""
    n = x.shape[1]
    d = c2c_radix_mid_plain(_dct4_entry(x, _device_dct4("chirp", n, 1.0, x.device)), -1)
    return _dct4_exit(d, _device_dct4("post", n, _scale(scale), x.device))


def _dct4_park(a: torch.Tensor) -> torch.Tensor:
    """y with Re a[k'] at row 2k' and Im a[k'] at row n-1-2k' (pass 1's
    store), from the (B, hl, L) a."""
    nb, hl, cols = a.shape
    return torch.stack([a.real, a.imag.flip(1)], dim=2).reshape(nb, 2 * hl, cols)


def _dct4_fourstep(x: torch.Tensor, h2: int, w: torch.Tensor, tw: torch.Tensor,
                   p: torch.Tensor, fft) -> torch.Tensor:
    """Kernel 28's column four-step at hl = h1 h2 with the entry chirp w,
    the twiddle W_hl^u (tw), the exit chirp p and ``fft``, the transform of
    each column of a (B', len, L) tensor: pass 1, the length-h1 transforms
    over s1 of c[s1 h2 + s2] times W_hl^{s2 k1}, parked in y as the kernel
    parks them (Re at row 2k', Im at row n-1-2k', k' = k1 + h1 s2); pass 2
    reads those rows back, runs the length-h2 transforms over s2 and applies
    the exit chirp at k = k1 + h1 k2."""
    nb, n, cols = x.shape
    hl = n // 2
    h1 = hl // h2
    dev = x.device
    a = fft(_dct4_entry(x, w).reshape(nb, h1, h2, cols).transpose(1, 2)
            .reshape(nb * h2, h1, cols))
    u = torch.outer(torch.arange(h2, device=dev), torch.arange(h1, device=dev))
    y = _dct4_park((a.reshape(nb, h2, h1, cols) * tw[u][..., None]).reshape(nb, hl, cols))
    a = torch.complex(y[:, 0::2], y.flip(1)[:, 0::2])
    d = fft(a.reshape(nb, h2, h1, cols).transpose(1, 2).reshape(nb * h1, h2, cols))
    return _dct4_exit(d.reshape(nb, h1, h2, cols).transpose(1, 2).reshape(nb, hl, cols), p)


def dct4_fourstep_plain(x: torch.Tensor, scale=None, h2=None) -> torch.Tensor:
    """Plain version of kernel 28's column four-step (:func:`_dct4_fourstep`)
    at :func:`dct4_split` or, ``h2`` given, h1 = hl / h2, each pass on the
    radix core's plain version (:func:`~.fft.c2c_radix_mid_plain`)."""
    n = x.shape[1]
    h2 = dct4_split(n // 2)[1] if h2 is None else h2
    dev = x.device
    return _dct4_fourstep(x, h2, _device_dct4("chirp", n, 1.0, dev),
                          _device_dct4("fourstep_tw", n, 1.0, dev),
                          _device_dct4("post", n, _scale(scale), dev),
                          lambda v: c2c_radix_mid_plain(v, -1))


DCT4_RADIX_MAX_HL = 20480   # the single pass's longest tile (csrc/fft_radix.cuh)
DCT4_FOURSTEP_FROM = 10240  # the four-step above this half length
DCT4_H2 = (256, 128)        # the four-step's pass-2 lengths, the first that divides hl


def dct4_split(hl: int):
    """(h1, h2) of kernel 28's column four-step at half length hl = 128 F:
    h2 = 256 where it divides hl (even F), else 128, and h1 = hl / h2,
    where h1 has a radix plan; else None. (On an NVIDIA H100 80GB HBM3 at
    700 W, chip_smoke.py phase 5, the passes' best column counts summed:
    at (1, 65536, 8192) 5.76 ms at (128, 256), 5.75 at (256, 128), 6.22 at
    (512, 64) and 7.04 at (1024, 32); at (1, 40960, 8192) 3.92 at (80, 256)
    and 4.16 at (160, 128).)"""
    for h2 in DCT4_H2:
        if hl % h2 == 0:
            h1 = hl // h2
            return (h1, h2) if radix_plan(h1) is not None else None
    return None


def dct4_form(n: int) -> str:
    """The form kernel 28 takes at n = 2 hl (:func:`dct4_f`): "fourstep"
    above hl = DCT4_FOURSTEP_FROM where :func:`dct4_split` has a split,
    "radix" (the single pass) at hl <= DCT4_RADIX_MAX_HL with a plan, else
    "wide" (F <= 160) or "long": the 23 prime F above 127. Above
    hl = 10240 the single pass holds one column a tile (4-byte tile rows):
    on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 5) it took
    10.60 ms at (1, 40960, 8192) with the read-only load, 12.40 without,
    the four-step 3.90 ms at (80, 256)."""
    hl = n // 2
    if hl > DCT4_FOURSTEP_FROM and dct4_split(hl) is not None:
        return "fourstep"
    if hl <= DCT4_RADIX_MAX_HL and radix_plan(hl) is not None:
        return "radix"
    return "long" if dct4_f(n) > WIDE_MAX_F else "wide"


def dct4_mid_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 28: scale * DCT-IV along dim 1 of (B, n, L)
    in the form :func:`dct4_form` names: :func:`dct4_radix_plain`,
    :func:`dct4_fourstep_plain`, or the bts2 core's for the remnant."""
    form = dct4_form(x.shape[1])
    if form == "radix":
        return dct4_radix_plain(x, scale)
    if form == "fourstep":
        return dct4_fourstep_plain(x, scale)
    return _dct4_bts2_plain(x, scale)


def dct4_mid_cols(hl: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernel 28's single pass at half length hl:
    kernel 25's :func:`dct2_mid_cols`, the same complex tile of hl. (On an
    NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py phase 5, C = 1, 2, 4, 8,
    16: at (2048, 2048, 256) 23.83, 14.16, 9.98, 8.68, 8.44 ms (22.10 and
    13.10 read-only at C = 1, 2), at (1, 2048, 524288) 40.17, 19.05,
    11.96, 8.78, 8.79, where the rule takes 16; at (1, 1536, 1536) 0.102,
    0.068, 0.063, 0.069, 0.063, where it takes 8.)"""
    return dct2_mid_cols(hl, groups, cols, sms)


DCT4_FOURSTEP_MAX_C = 32    # the four-step's widest tile (128 bytes a tile row)


def dct4_fourstep_cols(length: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of a pass of kernel 28's four-step at its transform
    length: :func:`~.fft.radix_mid_cols` (the 16-element form: 16 columns
    at 256, 32 at 128 and below). (On an NVIDIA H100 80GB HBM3 at 700 W,
    chip_smoke.py phase 5, at (1, 65536, 8192), split (128, 256), C = 2 ...
    64: pass 1 6.09, 4.48, 3.41, 3.30, 3.25, 4.00 ms, pass 2 8.30, 4.13,
    2.59, 2.51, 2.66, 2.66; the rule's 32 and 16 ran fastest.)"""
    return radix_mid_cols(length, groups, cols, sms, most=DCT4_FOURSTEP_MAX_C)


def _dct4_pass(step: int, x: torch.Tensor, y: torch.Tensor, length: int, t: torch.Tensor,
               c: int, ldg: bool = False) -> None:
    """One launch of kernel 28 on the radix column tile
    (``csrc/dct4_mid_radix.cu``): pass ``step`` (0 the single pass, 1 and 2
    the four-step's) at transform length ``length``, t the exit chirp or
    (pass 1) W_hl^u; counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    plan = radix_plan(length)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_dct4_mid_radix(
            step, x.data_ptr(), y.data_ptr(), device_radix(length, -1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan),
            _device_dct4("chirp", n, 1.0, dev).data_ptr(), t.data_ptr(), nb, n, cols, length, c,
            int(ldg), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_dct4_mid_radix")


def dct4_radix_launch(x: torch.Tensor, y: torch.Tensor, scale, c: int,
                      ldg: bool = False) -> None:
    """Launch kernel 28's single pass, ``c`` columns a tile
    (:func:`dct4_mid_cols`), on the (B, n, L) float32 CUDA tensor x into y,
    x loaded through the read-only path if ``ldg``; counts nothing."""
    n = x.shape[1]
    _dct4_pass(0, x, y, n // 2, _device_dct4("post", n, _scale(scale), x.device), c, ldg)


def dct4_fourstep_launch(x: torch.Tensor, y: torch.Tensor, scale, c1: int, c2: int,
                         h2=None) -> None:
    """Launch kernel 28's two four-step passes on the (B, n, L) float32 CUDA
    tensor x into y (distinct), ``c1`` and ``c2`` columns a tile
    (:func:`dct4_fourstep_cols`), at :func:`dct4_split` or (h2 given)
    h1 = hl / h2; counts nothing."""
    n = x.shape[1]
    hl = n // 2
    h1, h2 = dct4_split(hl) if h2 is None else (hl // h2, h2)
    dev = x.device
    _dct4_pass(1, x, y, h1, _device_dct4("fourstep_tw", n, 1.0, dev), c1)
    _dct4_pass(2, x, y, h2, _device_dct4("post", n, _scale(scale), dev), c2)


def dct4_bts2_launch(x: torch.Tensor, y: torch.Tensor, scale, long_form: bool) -> None:
    """Launch kernel 28's remnant on the wide core or (``long_form``) in the
    long form (``csrc/dct4_mid.cu``); counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    hl = n // 2
    sms = num_sms(dev)
    if long_form:
        tile, entry = wide_block(hl, nb, cols, sms, wide_real_bytes), "ndfft_dct4_mid_long"
    else:
        tile, entry = wide_block(hl, nb, cols, sms), "ndfft_dct4_mid_wide"
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), entry)(
            x.data_ptr(), y.data_ptr(), device_wq(hl, -1, 1.0, dev).data_ptr(),
            device_wide(hl, -1, dev).data_ptr(),
            _device_dct4("chirp_long" if long_form else "chirp", n, 1.0, dev).data_ptr(),
            _device_dct4("post", n, _scale(scale), dev).data_ptr(), nb, n, cols, tile,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, entry)


def dct4_mid(x: torch.Tensor, scale=None) -> torch.Tensor:
    """scale * DCT-IV (the rustdct convention) along dim 1 of a (B, n, L)
    float32 tensor, n = 2 hl, hl = 128 * F, F <= 256 (:func:`dct4_f`). A CPU
    tensor runs the plain version; a CUDA tensor launches kernel 28 in the
    form :func:`dct4_form` names (one launch a call, two for the four-step),
    counted in ``launches`` and in ``radix_launches``,
    ``fourstep_launches``, ``wide_launches`` or ``long_launches``, or
    raises. The output is a new tensor (the four-step and the long form
    write y while x is still read).

    The forms: the single pass on the radix column tile at every hl <= 10240
    with a plan, columns a tile by :func:`dct4_mid_cols`, x through the
    read-only path at C <= 2; the two-pass column four-step above it
    (:func:`dct4_split`), each pass's columns by :func:`dct4_fourstep_cols`;
    the wide core and the long form at the 23 prime F without a plan."""
    if x.dim() != 3:
        raise ValueError(f"dct4_mid: expected (B, n, L), got {tuple(x.shape)}")
    nb, n, cols = x.shape
    f = dct4_f(n)
    if f is None:
        raise ValueError(f"dct4_mid: n={n} is not 2 * 128 * F with F <= {REAL_MAX_F}")
    if x.device.type == "cpu":
        return dct4_mid_plain(x, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dct4_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "dct4_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    form = dct4_form(n)
    hl = n // 2
    sms = num_sms(x.device)
    if form == "radix":
        c = dct4_mid_cols(hl, nb, cols, sms)
        dct4_radix_launch(x, y, scale, c, ldg=c <= 2)
    elif form == "fourstep":
        h1, h2 = dct4_split(hl)
        dct4_fourstep_launch(x, y, scale, dct4_fourstep_cols(h1, nb * h2, cols, sms),
                             dct4_fourstep_cols(h2, nb * h1, cols, sms))
    else:
        dct4_bts2_launch(x, y, scale, form == "long")
    dct4_mid.launches += 1
    setattr(dct4_mid, f"{form}_launches", getattr(dct4_mid, f"{form}_launches") + 1)
    return y


dct4_mid.launches = 0
dct4_mid.radix_launches = 0
dct4_mid.fourstep_launches = 0
dct4_mid.wide_launches = 0
dct4_mid.long_launches = 0


# --------------------------------------------------------------------------
# Kernel 12: the real-to-real chirp-z of the Makhoul DCT-II/III
# --------------------------------------------------------------------------


def _blue_rr_chirps(n: int, dct_type: int, scale: float):
    """Kernel 12's entry and exit constants (a, b), complex128: the chirp
    exp(-i pi t^2 / n), with w_t scale (w_t = e^{-i pi t/(2n)}) folded into b
    for DCT-II, into a for DCT-III with a[0] halved (the Makhoul c0/2): the
    JAX package's ``_blue_rr_consts_cached`` expressions."""
    car, cai = chirp(n, -1)
    a = car + 1j * cai
    b = a.copy()
    w = _cis(np.arange(n, dtype=np.int64), 2 * n, -1)
    tw = (w[0] + 1j * w[1]) * scale
    if dct_type == 2:
        b = b * tw
    else:
        a = a * tw
        a[0] *= 0.5
    return a, b


def blue_rr_consts(n: int, dct_type: int, scale: float = 1.0):
    """Kernel 12's tables at n, float32 (re, im) pairs: a, b
    (:func:`_blue_rr_chirps`; built by the JAX package's
    ``_blue_rr_consts_cached`` expressions in float64 and rounded once, so
    each is its table bit for bit) and H of the sign -1 chirp at the
    convolution length :func:`~.fft.chirp_m` (n) (the 7-smooth length of
    least modelled time that kernel 20's chirp-z runs: 4608 = 16 * 16 * 2 * 9
    at n = 2049, at most 14336 over the lengths the wrapper takes; the JAX
    kernel's 128 * ceil((2n - 1) / 128) is the TPU's lane width), built in
    float64 and rounded once (``plan.blue_h``)."""
    a, b = _blue_rr_chirps(n, dct_type, scale)
    return (f32_pair((a.real, a.imag)), f32_pair((b.real, b.imag)),
            f32_pair(blue_h(n, -1, chirp_m(n))))


@lru_cache(maxsize=64)
def _device_blue_rr(n: int, dct_type: int, scale: float, device: torch.device):
    """(a, b, H) of :func:`blue_rr_consts` as complex64 tensors on ``device``."""
    a, b = _blue_rr_chirps(n, dct_type, scale)
    return (pair_tensor((a.real, a.imag), device), pair_tensor((b.real, b.imag), device),
            pair_tensor(blue_h(n, -1, chirp_m(n)), device))


def dct23_blue_mid_plain(x: torch.Tensor, dct_type: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 12: Re(b . the chirp-z convolution of x a)
    along dim 1 of (B, n, L), the convolution on the radix core at
    M = :func:`~.fft.chirp_m` (n) (:func:`~.fft.chirp_z_radix_plain`)."""
    a, b, h = _device_blue_rr(x.shape[1], dct_type, _scale(scale), x.device)
    z = chirp_z_radix_plain(x * a[:, None], h, 1.0) * b[:, None]
    return z.real.contiguous()


def dct23_blue_cols(mk: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernel 12 at convolution length mk: one column
    above RADIX_WIDE_N (the 32-element form), :func:`~.fft.radix_mid_cols`
    below it. (On an H100 at M = 4608, chip_smoke.py's phase 5 scan in two
    runs: one column, 144 threads, 129.7-130.9 ms at (1, 2049, 524544) and
    126.2-126.4 at (2049, 2049, 256); two columns within 3% of it, either
    side; radix_mid_cols's C = 4, the 40-element form, 145.6-147.1.)"""
    return 1 if mk > RADIX_WIDE_N else radix_mid_cols(mk, groups, cols, sms)


def dct23_blue_launch(x: torch.Tensor, y: torch.Tensor, dct_type: int, scale, c: int) -> None:
    """Launch kernel 12 on kernel 11's column kernel, ``c`` columns a tile
    (:func:`dct23_blue_cols`), on the (B, n, L) float32 CUDA tensor x into y
    (``csrc/dct_blue_radix.cu``); counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    mk = chirp_m(n)
    a, b, h = _device_blue_rr(n, dct_type, _scale(scale), dev)
    plan = radix_plan(mk)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_dct23_blue_radix(
            x.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(), h.data_ptr(),
            device_radix(mk, -1, dev).data_ptr(), (ctypes.c_int * RADIX_MAX_STAGES)(*plan),
            len(plan), nb, n, mk, cols, c, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_dct23_blue_radix")


def dct23_blue_mid(x: torch.Tensor, dct_type: int, scale=None) -> torch.Tensor:
    """The Makhoul DCT-II/III core along dim 1 of a real (B, n, L) float32
    tensor at a Bluestein length n (ops/hopper/fft.py::blue_f): for
    DCT-II, scale Re(w_k FFT_n(v)[k]) of the even/odd-permuted v; for
    DCT-III, Re(FFT_n(c w scale)) of x with c0 halved, still to be
    un-permuted. The caller owns the permutation (ops/dct.py::
    dct23_blue_mid). A CPU tensor runs the plain version; a CUDA tensor
    launches kernel 12 on kernel 11's column kernel (counted in
    ``launches`` and ``radix_launches``) or raises."""
    if x.dim() != 3:
        raise ValueError(f"dct23_blue_mid: expected (B, n, L), got {tuple(x.shape)}")
    if dct_type not in (2, 3):
        raise ValueError(f"dct23_blue_mid: no chirp-z DCT-{dct_type}")
    nb, n, cols = x.shape
    check_blue_n(n, "dct23_blue_mid")
    if x.device.type == "cpu":
        return dct23_blue_mid_plain(x, dct_type, scale)
    if x.device.type != "cuda":
        raise ValueError(f"dct23_blue_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "dct23_blue_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    dct23_blue_launch(x, y, dct_type, scale,
                      dct23_blue_cols(chirp_m(n), nb, cols, num_sms(x.device)))
    dct23_blue_mid.launches += 1
    dct23_blue_mid.radix_launches += 1
    return y


dct23_blue_mid.launches = 0
dct23_blue_mid.radix_launches = 0


# --------------------------------------------------------------------------
# Kernel 29: the fused cosine-basis pipeline along a middle axis
# --------------------------------------------------------------------------


def spectral_dct_mid_plain(x: torch.Tensor, hv: torch.Tensor, s2=None, s3=None) -> torch.Tensor:
    """Plain version of kernel 29: s3 * DCT-III(H * s2 * DCT-II(x)) along
    dim 1 of (B, n, L), H real ((n, 1) or (n, L)), in the form the kernel
    takes at n: where :func:`dct2_nat_radix` holds the arithmetic of the two
    radix forms it fuses (:func:`dct_radix_plain` of type 2, the product,
    :func:`dct_radix_plain` of type 3), else the bts2 forms' (:func:`_dct2_plain`,
    :func:`_dct3_plain`)."""
    if dct2_nat_radix(x.shape[1]):
        return dct_radix_plain(dct_radix_plain(x, 2, s2) * hv, 3, s3)
    return _dct3_plain(_dct2_plain(x, s2) * hv, s3)


def spectral_dct_radix_launch(x: torch.Tensor, y: torch.Tensor, hv: torch.Tensor, s2, s3,
                              c: int, ldg: bool = False) -> None:
    """Launch kernel 29 on the radix column tile, ``c`` columns a tile
    (:func:`~.rfft.spectral_cols`), on the (B, n, L) float32 CUDA tensor x into
    y with the contiguous float32 multiplier hv ((n, 1) or (n, L);
    ``csrc/spectral_dct_radix.cu``), x loaded through the read-only path if
    ``ldg``, else evict-first; counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    h = n // 2
    plan = radix_plan(h)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_spectral_dct_radix(
            x.data_ptr(), y.data_ptr(), hv.data_ptr(), hv.shape[1],
            device_radix(h, -1, dev).data_ptr(), (ctypes.c_int * RADIX_MAX_STAGES)(*plan),
            len(plan), _device_tw(n, dev).data_ptr(),
            _device_twiddle("post", n, _scale(s2), dev).data_ptr(),
            _device_ab(n, 1.0, dev).data_ptr(),
            _device_twiddle("pre", n, _scale(s3), dev).data_ptr(), nb, n, cols, c, int(ldg),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_spectral_dct_radix")


def spectral_dct_mid(x: torch.Tensor, hv: torch.Tensor, s2=None, s3=None) -> torch.Tensor:
    """s3 * DCT-III(H * s2 * DCT-II(x)) (the rustdct convention) along dim 1
    of a (B, n, L) float32 tensor, n = 128 * k in a form of :func:`dct_form`;
    H is a float32 (n, 1) or (n, L) tensor. A CPU tensor runs the plain
    version; a CUDA tensor launches kernel 29 (on the radix column tile where
    :func:`dct2_nat_radix` holds, counted in ``radix_launches`` as well;
    else the wide core's half-length form at even k and the n-point form on
    the real tile at odd k <= 255) or raises."""
    _check_form(x, False, "spectral_dct_mid")
    nb, n, cols = x.shape
    check_mult(hv, x, n, "spectral_dct_mid")
    if x.device.type == "cpu":
        return spectral_dct_mid_plain(x, hv, s2, s3)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_dct_mid: unsupported device {x.device}")
    check_cuda(x, torch.float32, "spectral_dct_mid")
    hv, _ = mult_planes(hv, None, "spectral_dct_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    form = launch_form(n, False, False)
    if form == "radix":
        c = spectral_cols(n // 2, nb, cols, num_sms(x.device))
        spectral_dct_radix_launch(x, y, hv, s2, s3, c, ldg=c <= 2)
        spectral_dct_mid.radix_launches += 1
    else:
        spectral_dct_bts2_launch(x, y, hv, s2, s3, form)
        spectral_dct_mid.wide_launches += form == "wide"
        spectral_dct_mid.npoint_launches += form == "npoint"
    spectral_dct_mid.launches += 1
    return y


def spectral_dct_bts2_launch(x: torch.Tensor, y: torch.Tensor, hv: torch.Tensor, s2, s3,
                             form: str) -> None:
    """Launch kernel 29's bts2 ``form`` ("wide": the half length on the wide
    core, or "npoint": the n-point form on the real tile, :func:`launch_form`'s
    names) on the (B, n, L) float32 CUDA tensor x into y with the contiguous
    float32 multiplier hv, at any n that :func:`dct_form` takes in that form
    (``csrc/spectral_dct_mid.cu``); counts nothing. (The wrapper launches it
    where :func:`dct2_nat_radix` fails; chip_smoke.py times the forms the
    radix column tile replaced with it.)"""
    nb, n, cols = x.shape
    dev = x.device
    sms = num_sms(dev)
    post = _device_twiddle("post", n, _scale(s2), dev).data_ptr()
    args = (x.data_ptr(), y.data_ptr(), hv.data_ptr(), hv.shape[1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if form == "npoint":
            entry = "ndfft_spectral_dct_mid_npoint"
            err = _build.lib().ndfft_spectral_dct_mid_npoint(
                *args, device_wq(n, -1, 1.0, dev).data_ptr(), device_wide(n, -1, dev).data_ptr(),
                post, _device_twiddle("chirp_npoint", n, _scale(s3), dev).data_ptr(), nb, n,
                cols, wide_block(n, nb, cols, sms, wide_real_bytes), stream)
        else:
            h = n // 2
            entry = "ndfft_spectral_dct_mid_wide"
            err = _build.lib().ndfft_spectral_dct_mid_wide(
                *args, device_wq(h, -1, 1.0, dev).data_ptr(), device_wide(h, -1, dev).data_ptr(),
                _device_tw(n, dev).data_ptr(), post, device_wq(h, +1, 1.0, dev).data_ptr(),
                device_wide(h, +1, dev).data_ptr(), _device_ab(n, 1.0, dev).data_ptr(),
                _device_twiddle("pre", n, _scale(s3), dev).data_ptr(), nb, n, cols,
                wide_block(h, nb, cols, sms), stream)
    _build.check(err, entry)


spectral_dct_mid.launches = 0
spectral_dct_mid.wide_launches = 0
spectral_dct_mid.npoint_launches = 0
spectral_dct_mid.radix_launches = 0
