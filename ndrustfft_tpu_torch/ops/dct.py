"""DCT types 1-4 lowered to the torch engine's FFTs (the JAX package's
``ops/dct.py`` without its Pallas branches).

Each type is lowered with pre/post twiddles in the rustdct convention
(scipy's unnormalized dct / 2; the Default normalization's x2 gives scipy's
values):

  DCT-I   y[k] = (x0 + (-1)^k x_{n-1})/2 + sum_{t=1}^{n-2} x_t cos(pi t k/(n-1))
          == Re(FFT_{2n-2}(even extension))[k] / 2
  DCT-II  y[k] = sum_t x_t cos(pi k (2t+1) / (2n))
          == Re(e^{-i pi k/(2n)} FFT_n(Makhoul permutation of x)[k])
  DCT-III y[k] = x0/2 + sum_{t>=1} x_t cos(pi t (2k+1) / (2n))
          == unperm(Re(FFT_n(c e^{-i pi t/(2n)}))), c = x with x0 halved
  DCT-IV  y[k] = sum_t x_t cos(pi (2k+1)(2t+1) / (4n))
          == two n-point FFTs of pre-modulated copies, post-twiddled

All transforms run batched along the LAST axis of real tensors, in float32
or float64; ``scale`` multiplies the result and rides the constants. Their
inner transforms dispatch as the JAX package's do (``ops/engine.py``): DCT-I
and DST-I hand their extension rows to kernel 15, DCT-II its permuted rows
to the R2C (kernel 15, or the row pairs on kernel 8 for odd n), DCT-III and
DCT-IV their rows to kernel 10 or 8 (at a Bluestein length, the chirp-z's
sub-FFTs). The API sends DCT-II/III of the lengths kernels 23/24 take to
those kernels first (``api._route``), DCT-II/III along a middle axis at a
Bluestein length to :func:`dct23_blue_mid`, and DCT-IV along a middle axis
beyond the dense kernel's lengths to :func:`dct4_half_mid`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..plan import _cis, factorize, get_c2c_plan, get_r2c_plan
from .engine import c2c, const, r2c, r2c_packed
from .hopper.dct import dct23_blue_mid as _k12
from .hopper.fft import c2c_blue_mid, c2c_generic_mid


def _cplx(x: torch.Tensor) -> torch.dtype:
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


@lru_cache(maxsize=512)
def _half_twiddle(n: int):
    """e^{-i pi k/(2n)}, k = 0..n-1 (the DCT-II post and DCT-III pre twiddle)."""
    return _cis(np.arange(n, dtype=np.int64), 2 * n, -1)


def evenodd_perm(x: torch.Tensor) -> torch.Tensor:
    """Makhoul permutation [x0, x2, .., x_odd descending] along the last axis."""
    return torch.cat([x[..., 0::2], x[..., 1::2].flip(-1)], dim=-1)


def evenodd_unperm(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`evenodd_perm`: z[2t] = u[t], z[2t+1] = u[n-1-t]."""
    n = u.shape[-1]
    ceil = (n + 1) // 2
    evens = u[..., :ceil]
    odds = u[..., ceil:].flip(-1)
    if n % 2:
        odds = torch.cat([odds, odds[..., :1]], dim=-1)  # dummy slot
    z = torch.stack([evens, odds], dim=-1).reshape(u.shape[:-1] + (2 * ceil,))
    return z[..., :n]


def dct1(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DCT-I; requires n >= 2. The even extension
    [x, x[n-2], .., x[1]] is one row of length 2n - 2 for the packed R2C (its
    interleaved even/odd streams are the JAX package's xe and xo)."""
    n = x.shape[-1]
    if n < 2:
        raise ValueError(f"DCT-I requires length >= 2, got {n}")
    ext = torch.cat([x, x[..., 1:n - 1].flip(-1)], dim=-1)
    spec = r2c_packed(ext, get_r2c_plan(2 * n - 2))   # m = n bins exactly
    del ext     # freed before the output is made: each is twice the input
    return (0.5 if scale is None else 0.5 * scale) * spec.real


def dct2(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DCT-II (Makhoul, one n-point R2C)."""
    n = x.shape[-1]
    s = 1.0 if scale is None else scale
    if n == 1:
        return x * s if scale is not None else x
    m = n // 2 + 1
    v = r2c(evenodd_perm(x), get_r2c_plan(n))
    full = torch.cat([v, v[..., 1:n - m + 1].flip(-1).conj()], dim=-1)
    w = _half_twiddle(n)
    return (full * const((w[0] * s, w[1] * s), full.dtype, x.device)).real


def dct3(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DCT-III (x0 halved), the transpose of the
    Makhoul DCT-II: one n-point complex FFT."""
    n = x.shape[-1]
    s = 1.0 if scale is None else scale
    if n == 1:
        return (0.5 * s) * x
    pre = _half_twiddle(n)
    c = torch.cat([x[..., :1] * 0.5, x[..., 1:]], dim=-1)
    u = c * const((pre[0] * s, pre[1] * s), _cplx(x), x.device)
    return evenodd_unperm(c2c(u, get_c2c_plan(n, -1)).real)


@lru_cache(maxsize=512)
def _dct4_consts(n: int):
    t = np.arange(n, dtype=np.int64)
    pre_a = _cis(t, 2 * n, -1)                       # e^{-i pi t/(2n)}
    w = _cis(2 * t, 2 * n, -1)                       # e^{-i pi t/n}
    pre_b = (pre_a[0] * w[0] - pre_a[1] * w[1],      # pre * w
             pre_a[0] * w[1] + pre_a[1] * w[0])
    ne, no = (n + 1) // 2, n // 2
    post_e = _cis(4 * np.arange(ne, dtype=np.int64) + 1, 4 * n, -1)   # post[2j]
    post_o = _cis(4 * np.arange(no, dtype=np.int64) + 3, 4 * n, -1)   # post[2j+1]
    return pre_a, pre_b, post_e, post_o


def dct4(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DCT-IV: the 2n-point zero-padded lowering
    folded into two n-point FFTs (even and odd output bins) in one call."""
    n = x.shape[-1]
    s = 1.0 if scale is None else scale
    if n == 1:
        return x * (np.cos(np.pi / 4) * s)
    pre_a, pre_b, post_e, post_o = _dct4_consts(n)
    cd = _cplx(x)
    u = torch.stack([x * const(pre_a, cd, x.device),
                     x * const(pre_b, cd, x.device)], dim=-2)     # (..., 2, n)
    f = c2c(u, get_c2c_plan(n, -1))       # one C2C over 2 * batch rows
    del u       # 4x the input, as f is: freed before the exit passes
    ne, no = (n + 1) // 2, n // 2
    ye = (f[..., 0, :ne] * const((post_e[0] * s, post_e[1] * s), cd, x.device)).real
    yo = (f[..., 1, :no] * const((post_o[0] * s, post_o[1] * s), cd, x.device)).real
    if no < ne:
        yo = torch.cat([yo, yo[..., :1]], dim=-1)   # dummy slot
    y = torch.stack([ye, yo], dim=-1).reshape(x.shape[:-1] + (2 * ne,))
    return y[..., :n]


@lru_cache(maxsize=64)
def _dct4_half_consts(n: int, s: float):
    """The composite's entry chirp s e^{-i pi (4t+1)/(4n)} and exit chirp
    (cos, sin)(pi k/n), t, k < n/2, as (m, 1) float64 columns: the JAX
    package's expressions, rounded to float32 by the caller."""
    v = np.arange(n // 2).reshape(-1, 1)
    w = s * np.exp(-1j * np.pi * (4 * v + 1) / (4 * n))
    return w.real, w.imag, np.cos(np.pi * v / n), np.sin(np.pi * v / n)


def dct4_half_mid(x: torch.Tensor, scale=None) -> torch.Tensor:
    """scale * DCT-IV along dim 1 of a (B, n, L) float32 tensor, n even, by
    the JAX package's half-length composite (its api.py:512-546), m = n/2:
    c_t = s (x[2t] + i x[n-1-2t]) e^{-i pi (4t+1)/(4n)}, D = FFT_m(c) along
    dim 1 on kernel 6 (kernel 11 where m is a Bluestein length),
    y[2k] = Re(D_k e^{-i pi k/n}) and
    y[n-1-2k] = -Im(D_k e^{-i pi k/n}). The chirps are elementwise torch ops,
    as the JAX package leaves them to XLA."""
    nb, n, cols = x.shape
    s = 1.0 if scale is None else float(scale)
    wr, wi, pr, pq = (torch.as_tensor(np.asarray(a, np.float32), device=x.device)
                      for a in _dct4_half_consts(n, s))
    xe = x[:, 0::2, :]
    xon = x.flip(1)[:, 0::2, :]
    c = torch.complex(xe * wr - xon * wi, xe * wi + xon * wr)
    y = (c2c_generic_mid if factorize(n // 2) is not None else c2c_blue_mid)(c, -1)
    evens = y.real * pr + y.imag * pq
    odds = (y.real * pq - y.imag * pr).flip(1)
    return torch.stack([evens, odds], dim=2).reshape(nb, n, cols)


def makhoul_order(x: torch.Tensor) -> torch.Tensor:
    """The Makhoul order along dim 1 of (B, n, L): the evens, then the odds
    reversed (DCT-II's input to kernel 12)."""
    return torch.cat([x[:, 0::2], x[:, 1::2].flip(1)], dim=1)


def makhoul_interleave(u: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`makhoul_order` along dim 1: z[2t] = u[t],
    z[2t+1] = u[n-1-t] (DCT-III's output of kernel 12)."""
    half = (u.shape[1] + 1) // 2
    z = torch.empty_like(u)
    z[:, 0::2] = u[:, :half]
    z[:, 1::2] = u[:, half:].flip(1)
    return z


def dct23_blue_mid(x: torch.Tensor, dct_type: int, scale=None) -> torch.Tensor:
    """scale * DCT-II or DCT-III along dim 1 of a (B, n, L) float32 tensor at
    a Bluestein length, the JAX package's Makhoul lowering around kernel 12
    (its api.py:438-471): DCT-II permutes x (:func:`makhoul_order`) before
    the kernel; DCT-III un-permutes the kernel's output
    (:func:`makhoul_interleave`) after it. The permutations are torch ops,
    as the JAX package leaves them to XLA."""
    if dct_type == 2:
        return _k12(makhoul_order(x), 2, scale)
    return makhoul_interleave(_k12(x, 3, scale))


DCT_FNS = {1: dct1, 2: dct2, 3: dct3, 4: dct4}
