"""DST types 1-4 on the DCT and FFT lowerings (the JAX package's
``ops/dst.py``), in the rustdct convention (scipy's unnormalized dst / 2).

Types 2-4 are exact flip/sign conjugations of the same-type DCT, so they
ride every DCT route, kernels included (``api._dst_impl`` applies them along
the original axis; :func:`dst2`..:func:`dst4` are the same along the last
axis):

  DST-II  (x)[k] = DCT-II ((-1)^t x)[n-1-k]
  DST-III (x)[k] = (-1)^k DCT-III(flip(x))[k]
  DST-IV  (x)[k] = (-1)^k DCT-IV (flip(x))[k]

DST-I is the imaginary part of the FFT of the odd extension [0, x, 0,
-flip(x)] (length 2n+2), one row for the packed R2C (kernel 15 on the
card):

  DST-I   y[k] = sum_t x_t sin(pi (t+1)(k+1)/(n+1))
          == -Im(FFT_{2n+2}(odd extension))[k+1] / 2
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..plan import get_r2c_plan
from .dct import dct2, dct3, dct4
from .engine import r2c_packed


@lru_cache(maxsize=512)
def alt_signs(n: int) -> np.ndarray:
    """(+1, -1, +1, ...) of length n (float64; cast at use site)."""
    return np.where(np.arange(n) % 2, -1.0, 1.0)


@lru_cache(maxsize=256)
def alt_tensor(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """:func:`alt_signs` as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(alt_signs(n), dtype=dtype, device=device)


def _alt(x: torch.Tensor) -> torch.Tensor:
    return alt_tensor(x.shape[-1], x.dtype, x.device)


def dst1(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DST-I along the last axis."""
    n = x.shape[-1]
    z = torch.zeros_like(x[..., :1])
    ext = torch.cat([z, x, z, -x.flip(-1)], dim=-1)
    spec = r2c_packed(ext, get_r2c_plan(2 * n + 2))   # m = n + 2 bins
    del ext     # freed before the output is made: each is twice the input
    s = -0.5 if scale is None else -0.5 * scale
    return s * spec.imag[..., 1:n + 1]


def dst1_streams(x3: torch.Tensor):
    """The even and odd samples (xe, xo) of the odd extension
    [0, x, 0, -flip(x)] along dim 1 of (B, n, L), each (B, n + 1, L): kernel
    18's input for DST-I along a middle axis, assembled as the JAX package
    assembles it in XLA (its api.py:612-619), for odd or even n."""
    z = x3.new_zeros(x3.shape[0], 1, x3.shape[2])
    xe_, xo_ = x3[:, 1::2], x3[:, 0::2]
    if x3.shape[1] % 2 == 0:
        return (torch.cat([z, xe_, -xe_.flip(1)], dim=1),
                torch.cat([xo_, z, -xo_.flip(1)], dim=1))
    return (torch.cat([z, xe_, z, -xe_.flip(1)], dim=1),
            torch.cat([xo_, -xo_.flip(1)], dim=1))


def dst2(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DST-II == flip(DCT-II((-1)^t x))."""
    return dct2(x * _alt(x), scale).flip(-1)


def dst3(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DST-III == (-1)^k DCT-III(flip(x))."""
    return dct3(x.flip(-1), scale) * _alt(x)


def dst4(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(..., n) real -> scale * DST-IV == (-1)^k DCT-IV(flip(x))."""
    return dct4(x.flip(-1), scale) * _alt(x)


DST_FNS = {1: dst1, 2: dst2, 3: dst3, 4: dst4}
