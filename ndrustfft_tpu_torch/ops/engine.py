"""The lane lowerings (the JAX package's ``ops/engine.py``): C2C, R2C and
C2R along the LAST axis, which the caller moves there.

Each entry point dispatches on its route function in ``gates.py``, the one
that ``api._route`` names a call's route by: :func:`c2c` to kernel 10 or 8
(dense or generic) of contiguous rows, beyond 20480 to the four-step
:func:`_fourstep` (kernels 7 and 13), or for a Bluestein plan to the
chirp-z :func:`_bluestein`, whose two sub-FFTs are again :func:`c2c`;
:func:`r2c` to kernel 2, kernel 15 or the row pairs of an odd length;
:func:`c2r` to kernel 3 or the Hermitian extension and :func:`c2c`. Where
the JAX package runs XLA (float64/complex128, batches below the kernels'
gates, lengths past the four-step), the mixed-radix engine runs: every
stage an einsum with a plan constant or an elementwise twiddle, on any
device and in float32 or float64. Every lowering reaches the engine
through :func:`c2c`.

``c2c.calls`` counts the engine's runs, so that a run can show that the
engine stayed off a path; ``r2c.calls`` and ``c2r.calls`` count entries to
those lowerings, so that a run can show that a call stayed off them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import gates
from ..dtypes import real_dtype
from ..plan import C2CPlan, R2CPlan, get_c2c_plan
from .hopper import fft as _kfft
from .hopper import rfft as _krfft


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


def _kernel_device(x: torch.Tensor) -> bool:
    """The devices whose tensors the kernel routes take (a CPU tensor runs
    the kernels' plain versions); any other device runs the engine."""
    return x.device.type in ("cuda", "cpu")


def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1] if x.shape[-1] else 0


# the C2C kernels of contiguous rows, by route
_ROW_KERNELS = {gates.C2C_ROWS: _kfft.c2c_rows, gates.C2C_DENSE_ROWS: _kfft.c2c_dense_rows,
                gates.C2C_GENERIC_ROWS: _kfft.c2c_generic_rows}


def c2c(x: torch.Tensor, plan: C2CPlan, scale=None) -> torch.Tensor:
    """Batched C2C FFT along the last axis, unnormalized; ``scale`` (a
    python float) multiplies the result, folded into the kernel constants.
    complex64 over >= 128 rows takes kernel 10 (256 < n = 128 * F <= 20480)
    or kernel 8 (its dense lane DFT at
    n <= 256, the generic schedule at 256 < n <= 20480 without a split);
    complex64 at 20480 < n <= 2^22 with a four-step split takes
    :func:`_fourstep` over any number of rows. A Bluestein plan runs
    :func:`_bluestein` first, on any dtype and device."""
    n = plan.n
    if plan.kind == "bluestein":
        return _bluestein(x, plan, scale)
    if x.dtype == torch.complex64 and _kernel_device(x):
        route = gates.lane_c2c_route(n, _rows(x))
        if route == gates.C2C_FOURSTEP:
            return _fourstep(x, plan, scale)
        fn = _ROW_KERNELS.get(route)
        if fn is not None:
            return fn(x.reshape(-1, n).contiguous(), plan.sign, scale).reshape(x.shape)
    c2c.calls += 1
    stages, base = _plan_consts(plan.n, plan.sign, x.dtype, x.device)
    y = ct_valued(x, stages, base)
    if scale is not None:
        y = y * scale
    return y


c2c.calls = 0


def _fourstep(x: torch.Tensor, plan: C2CPlan, scale=None) -> torch.Tensor:
    """Four-step (Bailey) C2C of length n = n1 n2 (the JAX package's
    ``engine._fourstep``), t = t1 n2 + t2 and k = k1 + n1 k2:
    X[k1 + n1 k2] = sum_t2 W_n2^{t2 k2} W_n^{t2 k1} sum_t1 W_n1^{t1 k1} x[t1 n2 + t2].
    Step 1+2 is kernel 7 on the (B, n1, n2) view, unscaled, the twiddle in
    its epilogue; step 3+4 is kernel 13 (n2 = 128 * F: the row FFT with the
    scale, stored transposed as (B, n2, n1)), or, where n2 has no twostep
    split (n2 <= 256), :func:`c2c` over the B n1 rows of n2 (kernel 8's
    dense product, or the chirp-z at a prime n2; n1 >= 128 at every such
    split) with the scale and the transpose as its own pass, as the JAX
    package leaves it to XLA."""
    n, sign = plan.n, plan.sign
    n1, n2 = gates._fourstep_split(n)
    b = _rows(x)
    y = _kfft.fourstep_mid(x.reshape(b, n1, n2).contiguous(), sign)
    if gates._twostep_split(n2) is not None:
        y = _kfft.rows_store_t(y, sign, scale)
    else:
        y = c2c(y.reshape(b * n1, n2), get_c2c_plan(n2, sign), scale)
        y = y.reshape(b, n1, n2).transpose(1, 2)
    return y.reshape(x.shape)


@lru_cache(maxsize=64)
def _blue_consts(n: int, sign: int, dtype: torch.dtype, device: torch.device):
    plan = get_c2c_plan(n, sign)
    return (const(plan.chirp_a, dtype, device), const(plan.H, dtype, device),
            const(plan.chirp_b, dtype, device))


def _bluestein(x: torch.Tensor, plan: C2CPlan, scale=None) -> torch.Tensor:
    """Chirp-z (the JAX package's ``engine._bluestein``):
    X[k] = b[k] IFFT_M(FFT_M(x a, zero-padded to M) H)[k], k < n. The
    chirps, the pad, the H product and the slice are torch ops, as the JAX
    package leaves them to XLA; both length-M sub-FFTs are :func:`c2c` over
    the same rows (K10 or K8 where ``gates.lane_c2c_route`` takes M, M =
    128 * s with s 3-smooth, the four-step beyond 20480), the user scale
    folded into the inverse's as scale / M."""
    n, M = plan.n, plan.M
    a, h, b = _blue_consts(n, plan.sign, x.dtype, x.device)
    xa = x.new_zeros(x.shape[:-1] + (M,))
    torch.mul(x, a, out=xa[..., :n])
    f = c2c(xa, plan.sub_fwd)
    del xa
    f.mul_(h)
    s = 1.0 / M if scale is None else float(scale) / M
    return c2c(f, plan.sub_inv, s)[..., :n] * b


def r2c(x: torch.Tensor, plan: R2CPlan) -> torch.Tensor:
    """Real (..., n) -> half-spectrum (..., m), m = n//2 + 1, unnormalized.

    Even n: float32 over >= 128 rows takes kernel 2 at a natural-layout
    half length (h = 128 * F >= 256), else :func:`r2c_packed`. Odd n pairs
    the rows into one complex C2C (:func:`_r2c_rowpair`); a single row runs
    the C2C of the complexified input and truncates."""
    r2c.calls += 1
    n = plan.n
    if not plan.half:
        if _rows(x) >= 2:
            return _r2c_rowpair(x, plan)
        z = torch.complex(x, torch.zeros_like(x))
        return c2c(z, plan.sub)[..., :plan.m]
    if x.dtype == torch.float32 and _kernel_device(x) \
            and gates.r2c_lane_route(n, _rows(x)) == gates.R2C_NAT:
        y = _krfft.r2c_nat(x.reshape(-1, n).contiguous())
        return y.reshape(x.shape[:-1] + (plan.m,))
    return r2c_packed(x, plan)


r2c.calls = 0


def _r2c_rowpair(x: torch.Tensor, plan: R2CPlan) -> torch.Tensor:
    """Odd-n R2C of >= 2 rows: rows a and b ride one complex C2C of
    z = a + i b, and A = (Z + conj ZM) / 2, B = -i (Z - conj ZM) / 2 with
    ZM[k] = Z[(n - k) % n]; half the C2C work of complexifying each row."""
    n, m = plan.n, plan.m
    lead = x.shape[:-1]
    xf = x.reshape(-1, n)
    if xf.shape[0] % 2:
        xf = torch.cat([xf, torch.zeros_like(xf[:1])], dim=0)
    z = c2c(torch.complex(xf[0::2], xf[1::2]), plan.sub)
    zk = z[:, :m]
    zm = torch.cat([z[:, :1], z[:, n - m + 1:].flip(-1)], dim=-1).conj()  # conj Z[(n-k) % n]
    a = 0.5 * (zk + zm)
    b = -0.5j * (zk - zm)
    return torch.stack([a, b], dim=1).reshape(-1, m)[:_rows(x)].reshape(lead + (m,))


def r2c_packed(x: torch.Tensor, plan: R2CPlan) -> torch.Tensor:
    """Half-spectrum of real rows (..., n), n even, by the half-length C2C of
    z[t] = x[2t] + i x[2t+1] and the unpack: kernel 15 for float32 over
    >= 128 rows (the rows go to it whole: a contiguous float32 row of length
    2h is the complex row z; the radix row core at h = 128 * F, a generic h
    or every other h <= 256 with a plan, the dense product at the other
    h <= 256), else :func:`c2c` and the unpack."""
    n, m = plan.n, plan.m
    h = n // 2
    if x.dtype == torch.float32 and _kernel_device(x) \
            and gates.packed_kernel(h, _rows(x)):
        fn = (_krfft.r2c_packed if _krfft.packed_core(h) else
              _krfft.r2c_packed_dense if h <= _krfft.PACKED_DENSE_MAX_H else
              _krfft.r2c_packed_generic)
        return fn(x.reshape(-1, n).contiguous()).reshape(x.shape[:-1] + (m,))
    z = c2c(torch.complex(x[..., 0::2], x[..., 1::2]), plan.sub)   # FFT_h of xe + i*xo
    first = z[..., :1]
    zk = torch.cat([z, first], dim=-1)                      # Z[k], k = 0..h
    zm = torch.cat([first, z[..., 1:].flip(-1), first], dim=-1)  # Z[(h-k) % h]
    fe = 0.5 * (zk + zm.conj())
    fo = -0.5j * (zk - zm.conj())
    tw = const(plan.unpack_tw, z.dtype, z.device)
    return fe + tw * fo


def hermitian_extension(s: torch.Tensor, n: int) -> torch.Tensor:
    """The full spectrum (..., n) of a half-spectrum (..., m), m = n//2 + 1,
    with the DC (and, for even n, Nyquist) imaginary parts set to zero."""
    m = n // 2 + 1
    mask = torch.ones(m, dtype=real_dtype(s.dtype), device=s.device)
    mask[0] = 0.0
    if n % 2 == 0:
        mask[m - 1] = 0.0
    s = torch.complex(s.real, s.imag * mask)
    # bins m..n-1 are conj(X[n-k]): indices n-m..1 == flip of bins 1..n-m
    return torch.cat([s, s[..., 1:n - m + 1].flip(-1).conj()], dim=-1)


def c2r(s: torch.Tensor, n: int, scale=None) -> torch.Tensor:
    """Half-spectrum (..., m) -> real (..., n): kernel 3 for complex64 over
    >= 128 rows at a natural-layout half length, else
    :func:`hermitian_extension` and :func:`c2c`.

    The order is the reference's: ``scale`` on the spectrum first, then the
    DC (and, for even n, Nyquist) imaginary parts set to zero, then the
    unnormalized inverse. The scale is a real scalar, so it commutes with
    the mask and rides the inverse C2C's constants."""
    c2r.calls += 1
    m = n // 2 + 1
    if n == 1:
        y = s[..., :1].real
        return y * scale if scale is not None else y
    if s.dtype == torch.complex64 and _kernel_device(s) \
            and gates.c2r_lane_route(n, _rows(s)) == gates.C2R_NAT:
        y = _krfft.c2r_nat(s.reshape(-1, m).contiguous(), n, scale)
        return y.reshape(s.shape[:-1] + (n,))
    return c2c(hermitian_extension(s, n), get_c2c_plan(n, +1), scale).real


c2r.calls = 0
