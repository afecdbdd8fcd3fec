"""The scalar and complex dtype vocabulary of the JAX package
(``ndrustfft_tpu/__init__.py``), as torch dtypes."""

from __future__ import annotations

import numpy as np
import torch

float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128


def _as_torch(d) -> torch.dtype:
    """A torch dtype, or the torch dtype of a numpy dtype or scalar type."""
    if isinstance(d, torch.dtype):
        return d
    return torch.from_numpy(np.empty(0, np.dtype(d))).dtype


def complex_dtype(real) -> torch.dtype:
    """Complex dtype paired with a real dtype (f32 -> c64, f64 -> c128)."""
    return complex128 if _as_torch(real) == float64 else complex64


def real_dtype(cplx) -> torch.dtype:
    """Real dtype paired with a (possibly complex) dtype (c128 -> f64)."""
    d = _as_torch(cplx)
    return d.to_real() if d.is_complex else d
