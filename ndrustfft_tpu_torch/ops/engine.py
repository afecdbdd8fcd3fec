"""Mixed-radix FFT engine in plain PyTorch (the JAX package's ``ops/engine.py``).

Complex tensors throughout; the transformed axis is the LAST axis, and the
caller moves it there. Every stage is an einsum with a plan constant or an
elementwise twiddle, so the engine runs on any device and in float32 or
float64. It is the plain version of the whole slice, and the route for the
shapes the JAX package itself leaves to XLA (float64/complex128, and
batches or column counts below the kernels' gates). ``c2c``, ``r2c`` and
``c2r`` count their calls in a ``calls`` attribute, so that a run can show
that the engine stayed off a path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..plan import C2CPlan, R2CPlan, get_c2c_plan


def real_dtype(cplx_dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if cplx_dtype == torch.complex128 else torch.float32


def const(pair, dtype: torch.dtype, device) -> torch.Tensor:
    """A (re, im) numpy float64 pair as a complex tensor of ``dtype``: each
    part is rounded on its own, as the JAX package's split constants are."""
    rdt = real_dtype(dtype)
    re = torch.as_tensor(np.asarray(pair[0]), dtype=rdt, device=device)
    im = torch.as_tensor(np.asarray(pair[1]), dtype=rdt, device=device)
    return torch.complex(re, im)


@lru_cache(maxsize=256)
def _plan_consts(n: int, sign: int, dtype: torch.dtype, device: torch.device):
    plan = get_c2c_plan(n, sign)
    stages = [(f, m, const(wf, dtype, device), const(tw, dtype, device))
              for f, m, wf, tw in plan.stages]
    return stages, const(plan.base, dtype, device)


# einsum letters for trailing residue dims (excludes the t/p/j/q used by the
# contraction specs)
_TRAIL = "abcdeghiklmnorsuvwxyz"


def ct_valued(x: torch.Tensor, stages, base: torch.Tensor) -> torch.Tensor:
    """Recursive Cooley-Tukey over stage constants (DIT, k = q*m + p,
    t = f*t' + j):  X[q*m + p] = sum_j W_f^{jq} * (W_n^{jp} * FFT_m(x[j::f])[p]).

    Each level splits its axis in place and the residue dims accumulate as
    trailing batch dims, so all data movement is inside the einsums."""
    if len(stages) > len(_TRAIL):
        raise ValueError(
            f"plan with {len(stages)} stages exceeds the engine's "
            f"{len(_TRAIL)}-level recursion support")
    return _ct_at(x, stages, base, 0)


def _ct_at(x, stages, base, depth):
    trail = _TRAIL[:depth]
    if not stages:
        return torch.einsum(f"tp,...t{trail}->...p{trail}", base, x)
    f, m, wf, tw = stages[0]
    ax = x.ndim - 1 - depth
    shape = tuple(x.shape)
    split = shape[:ax] + (m, f) + shape[ax + 1:]
    y = _ct_at(x.reshape(split), stages[1:], base, depth + 1)  # (..., p, j, <trail>)
    y = y * tw.transpose(0, 1).reshape((m, f) + (1,) * depth)
    out = torch.einsum(f"jq,...pj{trail}->...qp{trail}", wf, y)
    return out.reshape(shape[:ax] + (f * m,) + shape[ax + 1:])


def c2c(x: torch.Tensor, plan: C2CPlan, scale=None) -> torch.Tensor:
    """Batched C2C FFT along the last axis, unnormalized; ``scale`` (a
    python float) multiplies the result."""
    c2c.calls += 1
    stages, base = _plan_consts(plan.n, plan.sign, x.dtype, x.device)
    y = ct_valued(x, stages, base)
    if scale is not None:
        y = y * scale
    return y


c2c.calls = 0


def r2c(x: torch.Tensor, plan: R2CPlan) -> torch.Tensor:
    """Real (..., n) -> half-spectrum (..., m), m = n//2 + 1, unnormalized.

    Even n packs z[t] = x[2t] + i*x[2t+1] into one half-size C2C and
    unpacks; odd n runs a full C2C of the complexified input and truncates.
    """
    r2c.calls += 1
    if not plan.half:
        z = torch.complex(x, torch.zeros_like(x))
        return c2c(z, plan.sub)[..., :plan.m]
    return r2c_packed(x[..., 0::2], x[..., 1::2], plan)


r2c.calls = 0


def r2c_packed(xe: torch.Tensor, xo: torch.Tensor, plan: R2CPlan) -> torch.Tensor:
    """Half-spectrum from pre-split even/odd sample streams (..., h)."""
    z = c2c(torch.complex(xe, xo), plan.sub)              # FFT_h of xe + i*xo
    first = z[..., :1]
    zk = torch.cat([z, first], dim=-1)                      # Z[k], k = 0..h
    zm = torch.cat([first, z[..., 1:].flip(-1), first], dim=-1)  # Z[(h-k) % h]
    fe = 0.5 * (zk + zm.conj())
    fo = -0.5j * (zk - zm.conj())
    tw = const(plan.unpack_tw, z.dtype, z.device)
    return fe + tw * fo


def c2r(s: torch.Tensor, n: int, scale=None, mask_dc_nyq=True) -> torch.Tensor:
    """Half-spectrum (..., m) -> real (..., n) by Hermitian extension + C2C.

    The order is the reference's: ``scale`` on the spectrum first, then the
    DC (and, for even n, Nyquist) imaginary parts set to zero, then the
    unnormalized inverse."""
    c2r.calls += 1
    m = n // 2 + 1
    rdt = real_dtype(s.dtype)
    if n == 1:
        y = s[..., :1].real
        return y * scale if scale is not None else y
    if scale is not None:
        s = s * scale
    if mask_dc_nyq:
        mask = torch.ones(m, dtype=rdt, device=s.device)
        mask[0] = 0.0
        if n % 2 == 0:
            mask[m - 1] = 0.0
        s = torch.complex(s.real, s.imag * mask)
    # bins m..n-1 are conj(X[n-k]): indices n-m..1 == flip of bins 1..n-m
    e = torch.cat([s, s[..., 1:n - m + 1].flip(-1).conj()], dim=-1)
    return c2c(e, get_c2c_plan(n, +1)).real


c2r.calls = 0
