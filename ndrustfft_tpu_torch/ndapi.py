"""Multi-axis functions over ``torch.Tensor``: ``fftn``, ``ifftn``,
``rfftn``, ``irfftn``, ``dctn``, ``idctn``, ``dstn`` and ``idstn`` (the JAX
package's ``ndapi.py``).

Each is the canonical composition of the per-axis functions of ``api.py``,
with a cached handler per axis length, in the JAX package's per-axis order:
the axes in the order given (all by default); ``rfftn`` takes its R2C along
the last of them first and ``irfftn`` its C2R last. Each call takes the
route ``api._route`` names for it, so along a middle axis the DCT/DST
kernels run in place.

The inverses scale as the JAX package's do: 1/n per axis for ``ifftn`` and
``irfftn``, 1/(2n) for ``idctn``/``idstn`` of types 2/3 and 4, 1/(2(n - 1))
for DCT-I and 1/(2(n + 1)) for DST-I. The JAX package divides after each
transform; here the factor is the handler's scalar normalization, which
the kernels fold into their constants, so no extra pass over the data runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .api import (
    _as_tensor, _auto_handler, nddct1, nddct2, nddct3, nddct4, nddst1, nddst2, nddst3,
    nddst4, ndfft, ndfft_r2c, ndifft, ndifft_r2c,
)
from .handlers import DctHandler, DstHandler, FftHandler, R2cFftHandler
from .normalization import Normalization

__all__ = ["fftn", "ifftn", "rfftn", "irfftn", "dctn", "idctn", "dstn", "idstn"]

_DCT = {1: nddct1, 2: nddct2, 3: nddct3, 4: nddct4}
_DST = {1: nddst1, 2: nddst2, 3: nddst3, 4: nddst4}
_INVERSE = {1: 1, 2: 3, 3: 2, 4: 4}


def _axes(x, axes):
    return list(range(x.ndim)) if axes is None else [a % x.ndim for a in axes]


def fftn(x, axes: Optional[Sequence[int]] = None):
    """C2C forward FFT over ``axes`` (all by default), unnormalized."""
    x = _as_tensor(x)
    for a in _axes(x, axes):
        x = ndfft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    return x


def ifftn(x, axes: Optional[Sequence[int]] = None):
    """C2C inverse FFT over ``axes``; Default normalization (1/n per axis)."""
    x = _as_tensor(x)
    for a in _axes(x, axes):
        x = ndifft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    return x


def rfftn(x, axes: Optional[Sequence[int]] = None):
    """Real n-D forward: R2C along the LAST of ``axes``, then C2C along the
    rest (numpy.fft.rfftn's axis convention)."""
    x = _as_tensor(x)
    axes = _axes(x, axes)
    r2c_axis = axes[-1]
    x = ndfft_r2c(x, _auto_handler(R2cFftHandler, x.shape[r2c_axis]), axis=r2c_axis)
    for a in axes[:-1]:
        x = ndfft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    return x


def irfftn(x, n_last: Optional[int] = None, axes: Optional[Sequence[int]] = None):
    """Inverse of :func:`rfftn`. ``n_last`` is the real length of the final
    axis (by default the even reconstruction 2 (m - 1), as numpy)."""
    x = _as_tensor(x)
    axes = _axes(x, axes)
    c2r_axis = axes[-1]
    for a in axes[:-1]:
        x = ndifft(x, _auto_handler(FftHandler, x.shape[a]), axis=a)
    m = x.shape[c2r_axis]
    n = n_last if n_last is not None else 2 * (m - 1)
    return ndifft_r2c(x, _auto_handler(R2cFftHandler, n), axis=c2r_axis)


def _r2r_n(fns, handler_cls, t: int, x, axes, inverse_shift: Optional[int] = None):
    """The type-t transform over ``axes``. An inverse (``inverse_shift`` not
    None) scales each axis by 1/(2 (n + inverse_shift)): the handler's scalar
    1/(n + inverse_shift) on the rustdct convention (scipy's / 2)."""
    x = _as_tensor(x)
    fn = fns[t]
    for a in _axes(x, axes):
        n = x.shape[a]
        h = _auto_handler(handler_cls, n)
        if inverse_shift is not None:
            h = h.normalization(Normalization.scalar(1.0 / (n + inverse_shift)))
        x = fn(x, h, axis=a)
    return x


def dctn(x, dct_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Real n-D DCT of the given type over ``axes`` (scipy.fft.dctn's values
    under the Default normalization)."""
    return _r2r_n(_DCT, DctHandler, dct_type, x, axes)


def idctn(x, dct_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Inverse n-D DCT: the type 2/3 duality (1 and 4 are their own inverse)
    with 1/(2n) per axis, 1/(2(n - 1)) for DCT-I."""
    t = _INVERSE[dct_type]
    return _r2r_n(_DCT, DctHandler, t, x, axes, -1 if t == 1 else 0)


def dstn(x, dst_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Real n-D DST of the given type over ``axes`` (scipy.fft.dstn's values
    under the Default normalization)."""
    return _r2r_n(_DST, DstHandler, dst_type, x, axes)


def idstn(x, dst_type: int = 2, axes: Optional[Sequence[int]] = None):
    """Inverse n-D DST: the type 2/3 duality (1 and 4 are their own inverse)
    with 1/(2n) per axis, 1/(2(n + 1)) for DST-I (scipy:
    dst(dst(x, 1), 1) == 2 (n + 1) x)."""
    t = _INVERSE[dst_type]
    return _r2r_n(_DST, DstHandler, t, x, axes, 1 if t == 1 else 0)
