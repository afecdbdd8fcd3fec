"""Public functions over ``torch.Tensor``: ``ndfft``, ``ndifft``,
``ndfft_r2c``, ``ndifft_r2c``, ``nddct1``..``nddct4`` and
``nddst1``..``nddst4``, with the JAX package's signatures and error strings.

Every call picks its route in one pure function, :func:`_route`. Its gates
mirror the JAX package's TPU gates (``cols >= 128``, ``batch >= 128``, the
twostep split with m <= 128), so that every route has a JAX counterpart:

* a route whose JAX counterpart is a Pallas kernel runs that kernel's
  ported wrapper (``ops/hopper``): the CUDA kernel on a CUDA tensor, its
  plain version on a CPU tensor; every Pallas kernel has its port, so no
  float32 route raises for want of a kernel;
* a route whose JAX counterpart is the XLA engine runs the torch engine.

The gates and the route names live in ``gates.py``. The other kinds' lane
lowerings take one route name each: R2C_PACKED (the packed R2C, K15, of R2C,
DCT-I, DST-I and DCT-II rows), R2C_ROWPAIR (odd-length R2C and DCT-II rows
paired into one C2C), C2R_LANE (the Hermitian extension and its C2C) and
DCT_LANE (the DCT-III/IV lowerings' C2C); each C2C is K10 or K8 (dense, or
the generic schedule above 256), or the four-step beyond 20480. The route
and the lowering in ``ops/engine.py`` are decided by the same function of
``gates.py``; the launch counters show which kernel ran. DCT4_HALF_MID is
the DCT-IV/DST-IV composite along a middle axis, its half-length C2C on K6
(K11 at a Bluestein half length); R2C_PACKED_MID
(DST-I's odd-extension streams on K18), DCT1_MID (K19) and DCT4_MID (the
fused DCT-IV/DST-IV, K28) run along a middle axis in place. A Bluestein
length (a prime factor above 128) takes C2C_BLUE_MID (the fused chirp-z,
K11) or DCT23_BLUE_MID (its real-to-real DCT-II/III form, K12) along a
middle axis where the JAX package runs those kernels, and elsewhere
BLUESTEIN_LANE: the engine's chirp-z, whose sub-FFTs run on K10, K8 or the
four-step. A C2C of length 20480 < n <= 2^22 with a four-step split takes
C2C_FOURSTEP on every axis (a middle axis moves last, as in the JAX
package): K7 along n1 with the exit twiddle, then K13 along n2 with the
transposed store (or K8's rows and a swap).
The ``_par`` names are the serial functions (the port has no sharded input).

The fused spectral pipelines ``ndspectral_r2c``, ``ndspectral_c2c``,
``ndspectral_dct`` and ``ndspectral_dst`` (a forward transform, a diagonal
multiply and the inverse along one axis) take their route from
:func:`_spectral_route`: along a middle axis, where the JAX package runs
its fused Pallas kernel, one launch of K22, K14 or K29 (SPECTRAL_R2C_MID,
SPECTRAL_C2C_MID, SPECTRAL_DCT_MID; the DST through K29 by the flip/sign
conjugation); everywhere else COMPOSE, the exact composition of the
public transforms on their own routes.

A non-tensor input (numpy array, list, scalar) goes to the CUDA device, as
the JAX package puts it on its default device; a CPU tensor is how a caller
asks for the CPU.
"""

from __future__ import annotations

import math
import sys
from functools import lru_cache

import torch

from .config import config
from .gates import (
    BLUESTEIN_LANE, C2C_AXIS_MID, C2C_BLUE_MID, C2C_DENSE_MID, C2C_DENSE_ROWS, C2C_FOURSTEP,
    C2C_GENERIC_MID, C2C_GENERIC_ROWS, C2C_ROWS,
    C2R_DENSE_MID, C2R_LANE, C2R_MID, C2R_NAT, COMPOSE, DCT1_MID, DCT2_MID, DCT2_NAT,
    DCT3_MID, DCT3_NAT, DCT4_HALF_MID, DCT4_MID, DCT23_BLUE_MID, DCT_DENSE_MID, DCT_LANE,
    ENGINE, MIN_BATCH,
    R2C_DENSE_MID, R2C_MID, R2C_NAT, R2C_PACKED, R2C_PACKED_MID, R2C_ROWPAIR,
    SPECTRAL_C2C_MID, SPECTRAL_DCT_MID, SPECTRAL_R2C_MID,
    _c2c_kernel_route,
    _kernel_ok, _lane_c2c, _nat_f, _twostep_split, c2r_lane_route, inner_c2c_route,
    lane_c2c_route, packed_lane, r2c_lane_route,
)
from .handlers import DctHandler, DstHandler, FftHandler, R2cFftHandler
from .normalization import Normalization
from .ops import dct as _dct
from .ops import dst as _dst
from .ops import engine as _engine
from .ops.hopper import dct as _kdct
from .ops.hopper import fft as _kfft
from .ops.hopper import rfft as _krfft
from .plan import MAX_BASE_RADIX, factorize, get_c2c_plan, get_r2c_plan

__all__ = ["ndfft", "ndifft", "ndfft_r2c", "ndifft_r2c",
           "nddct1", "nddct2", "nddct3", "nddct4",
           "nddst1", "nddst2", "nddst3", "nddst4",
           "ndfft_par", "ndifft_par", "ndfft_r2c_par", "ndifft_r2c_par",
           "nddct1_par", "nddct2_par", "nddct3_par", "nddct4_par",
           "nddst1_par", "nddst2_par", "nddst3_par", "nddst4_par",
           "ndspectral_r2c", "ndspectral_c2c", "ndspectral_dct", "ndspectral_dst"]

_C2C_KINDS = ("fft", "ifft")
_R2R_KINDS = tuple(f"{f}{t}" for f in ("dct", "dst") for t in (1, 2, 3, 4))

# the JAX package's TPU gates beyond those of gates.py
_MIN_COLS = 128          # api._mid_dims
_DENSE_DCT_MAX = 1100    # dct._DENSE_DCT_MAX
_BLUE_VMEM_M = int(0.8 * 100 * 1024 * 1024) // (12 * 128 * 4)   # fft.blue_mid_supported


def _check_size(got: int, expected: int, what: str = "fft"):
    if got != expected:
        raise ValueError(f"Size mismatch in {what}, got {got} expected {expected}")


def _norm_axis(axis: int, ndim: int) -> int:
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of bounds for {ndim}-d array")
    return axis % ndim


@lru_cache(maxsize=4096)
def _auto_handler(cls, n):
    return cls(n)


def _plan_log(kind, n, axis, route):
    if config.debug_plan_log:
        print(f"[ndrustfft_tpu_torch] {kind} n={n} axis={axis} -> {route}",
              file=sys.stderr)


# --------------------------------------------------------------------------
# The JAX package's kernel gates that only the API takes
# --------------------------------------------------------------------------


def _ts_ok(n: int) -> bool:
    """A {128, 256} twostep split of n with m <= 128 (dct_pallas_supported's
    and dct4_mid_supported's split test)."""
    ts = _twostep_split(n)
    return ts is not None and ts[0] <= MAX_BASE_RADIX


def _blue_mid_ok(n: int) -> bool:
    """fft.blue_mid_supported for a Bluestein length n (blue_kernel_M and the
    kernel's VMEM bound: n <= 6784, M <= 13568)."""
    mk = _kfft.blue_kernel_M(n)
    return mk is not None and mk <= _BLUE_VMEM_M


def _mid_dims(shape, axis):
    """(nb, cols) for the axis-mid kernels, or None when ineligible."""
    if axis >= len(shape) - 1:
        return None
    cols = math.prod(shape[axis + 1:])
    if cols < _MIN_COLS:
        return None
    return math.prod(shape[:axis]), cols


def _route(kind: str, shape, axis: int, dtype: torch.dtype, device_type: str,
           n: int | None = None) -> str:
    """The route of one call: one of the ported kernels' routes (C2C_AXIS_MID,
    C2C_ROWS, C2C_DENSE_ROWS, C2C_DENSE_MID, C2C_GENERIC_ROWS,
    C2C_GENERIC_MID, R2C_NAT, C2R_NAT, R2C_MID, C2R_MID, R2C_DENSE_MID,
    C2R_DENSE_MID, DCT_DENSE_MID, DCT2_NAT, DCT3_NAT, DCT2_MID, DCT3_MID, the
    DCT-IV composite DCT4_HALF_MID, R2C_PACKED_MID, DCT1_MID, DCT4_MID, the
    chirp-z C2C_BLUE_MID and DCT23_BLUE_MID, the four-step C2C_FOURSTEP
    (K7 and K13, on any axis after a moveaxis), and the lane lowerings'
    R2C_PACKED, R2C_ROWPAIR, C2R_LANE, DCT_LANE, BLUESTEIN_LANE) or ENGINE.

    ``kind`` is "fft", "ifft", "r2c", "c2r", "dct1".."dct4" or
    "dst1".."dst4"; ``shape``, ``axis`` and ``dtype`` are the input's; ``n``
    is the real length of a "c2r" (default 2 * (m - 1)). "cuda" and "cpu"
    take the same route (one of ``gates.ROUTES``); other devices always
    take ENGINE."""
    shape = tuple(shape)
    axis = _norm_axis(axis, len(shape))
    if kind in _R2R_KINDS:
        n = shape[axis]
        route = ENGINE if dtype != torch.float32 else _route_r2r(kind, shape, axis, n)
    else:
        if n is None:
            n = shape[axis] if kind != "c2r" else 2 * (shape[axis] - 1)
        if dtype not in (torch.float32, torch.complex64):
            route = ENGINE      # the JAX package's XLA, Bluestein lengths included
        else:
            route = _route_f32(kind, shape, axis, n)
            if kind in _C2C_KINDS:
                route = _c2c_kernel_route(route, n)
    return route if device_type in ("cuda", "cpu") else ENGINE


def _rfft_mid(kind: str, n: int):
    """Route of a float32 R2C/C2R along a middle axis with >= 128 columns
    (the JAX package's rfft_nat_supported, then rfft_dense_mid_supported):
    K16/K17 for a natural-layout half length (both on the radix column
    tile); K20/K21 for 4 <= n <= 1100 (any n, Bluestein lengths included:
    both run the radix column tile where the transform length, n/2 at even
    n and n at odd n, has a plan, K21 not at the odd n where
    ops/hopper/fft.py::dense_beats_radix holds, and the dense product, which
    needs none, elsewhere); else None."""
    if _nat_f(n) is not None:
        return R2C_MID if kind == "r2c" else C2R_MID
    if _krfft.DENSE_MIN_N <= n <= _krfft.DENSE_MAX_N:
        return R2C_DENSE_MID if kind == "r2c" else C2R_DENSE_MID
    return None


def _route_f32(kind, shape, axis, n):
    dims = _mid_dims(shape, axis)
    batch = math.prod(shape) // max(shape[axis], 1)
    if kind in ("r2c", "c2r") and dims is not None:
        route = _rfft_mid(kind, n)
        if route is not None:
            return route
    if kind in ("fft", "ifft"):
        if factorize(n) is None:
            # the JAX package's _c2c_impl: the fused chirp-z along a middle
            # axis (its api.py:172-190), else the lane lowering after a moveaxis
            mid = dims is not None and _blue_mid_ok(n)
            return C2C_BLUE_MID if mid else lane_c2c_route(n, batch)
        if dims is not None and _kernel_ok(n):
            ts = _twostep_split(n)
            use_ts = n > 256 and ts is not None and ts[0] <= MAX_BASE_RADIX
            if n <= 256 or (not use_ts and n <= 512):
                return "dense_mid"
            return C2C_AXIS_MID if use_ts else C2C_GENERIC_MID
        return _lane_c2c(n, batch)
    if kind == "r2c":
        return r2c_lane_route(n, batch)
    if kind == "c2r":
        return c2r_lane_route(n, batch)
    raise ValueError(f"unknown transform kind {kind!r}")


def _dct_lane(t: int, n: int, batch: int) -> str:
    """Route of the DCT-<t> lowering along the last axis of (batch, n)
    (ops/dct.py of the JAX package): kernels 23/24 for DCT-II/III at
    batch >= 128 and dct_pallas_supported(n), else the inner FFT's route:
    the R2C's for DCT-I and DCT-II, the C2C's over batch (DCT-III) or
    2 * batch (DCT-IV) rows."""
    if t == 1:
        return packed_lane(n - 1, batch) if n >= 2 else ENGINE
    if n == 1:
        return ENGINE
    if t in (2, 3) and batch >= MIN_BATCH and n % 2 == 0 and _ts_ok(n):
        return DCT2_NAT if t == 2 else DCT3_NAT
    if t == 2:
        # kernel 2 never serves here: every n whose half length it takes
        # passed the kernel-23 gate above
        return r2c_lane_route(n, batch)
    return inner_c2c_route(n, 2 * batch if t == 4 else batch, DCT_LANE)


def _route_r2r(kind, shape, axis, n):
    """Route of a float32 DCT or DST (the gates of the JAX package's
    _dct_impl and _dst_impl, in their order). DST-2/3/4 take the same-type
    DCT's route; DST-1 has its own."""
    t = int(kind[3])
    dims = _mid_dims(shape, axis)
    batch = math.prod(shape) // max(n, 1)
    if kind == "dst1":
        if dims is not None and _nat_f(2 * n + 2) is not None:
            return R2C_PACKED_MID
        return packed_lane(n + 1, batch)
    if dims is not None:
        if 2 <= n <= _DENSE_DCT_MAX:
            return DCT_DENSE_MID
        if t == 1:
            # the JAX package's packed DCT-I branch (its api.py:393-409) has
            # no route here: its half length n - 1 = 128 * F means an odd n,
            # which K19 takes
            if n % 2 and n >= 5 and _nat_f(2 * (n - 1)) is not None:
                return DCT1_MID
        elif t in (2, 3):
            if n % 2 == 0 and _ts_ok(n):
                return DCT2_MID if t == 2 else DCT3_MID
            if factorize(n) is None and _blue_mid_ok(n):
                return DCT23_BLUE_MID
        elif n % 2 == 0:
            if _ts_ok(n // 2):
                return DCT4_MID
            m = n // 2
            if factorize(m) is not None and _kernel_ok(m) or \
                    factorize(m) is None and _blue_mid_ok(m):
                # the JAX package's half-length C2C composite (its
                # api.py:512-546); m > 550 has no split here (those n take
                # K28), so the C2C is K6's generic schedule, or K11 at a
                # Bluestein m
                return DCT4_HALF_MID
    return _dct_lane(t, n, batch)


_SPECTRAL = {"r2c": SPECTRAL_R2C_MID, "c2c": SPECTRAL_C2C_MID, "dct": SPECTRAL_DCT_MID}


def _spectral_route(kind: str, shape, axis: int, dtype: torch.dtype, device_type: str,
                    fusable: bool = True) -> str:
    """The route of a fused spectral call: SPECTRAL_R2C_MID (K22),
    SPECTRAL_C2C_MID (K14) or SPECTRAL_DCT_MID (K29) where the JAX package
    runs its fused kernel, else COMPOSE.

    ``kind`` is "r2c", "c2c" or "dct"; ``shape``, ``axis`` and ``dtype`` are
    the input's (n = shape[axis]); ``fusable``: no handler has a custom
    norm and :func:`_spectral_mult_cols` takes the multiplier. The JAX gates
    (its api.py:1141-1410): float32 (complex64 for "c2c"), a middle axis
    with >= 128 columns, and the kernel's length gate: the natural-layout
    R2C's ``rfft_nat_supported`` (:func:`gates._nat_f`), the twostep C2C's
    ``spectral_c2c_mid_supported`` (n > 256 with the split (128, F), K1's
    gate), the DCT's ``dct_pallas_supported`` (even n with the split
    (128, k), k <= 256); other devices always compose. Pure: it launches
    nothing."""
    shape = tuple(shape)
    axis = _norm_axis(axis, len(shape))
    n = shape[axis]
    want = torch.complex64 if kind == "c2c" else torch.float32
    if (not fusable or dtype != want or _mid_dims(shape, axis) is None
            or device_type not in ("cuda", "cpu")):
        return COMPOSE
    if kind == "r2c":
        ok = _nat_f(n) is not None
    elif kind == "c2c":
        ts = _twostep_split(n)
        ok = n > 256 and _kernel_ok(n) and ts is not None and ts[0] <= MAX_BASE_RADIX
    else:
        ok = n % 2 == 0 and _ts_ok(n)
    return _SPECTRAL[kind] if ok else COMPOSE


# --------------------------------------------------------------------------
# Implementations
# --------------------------------------------------------------------------


def _c2c_norm_scale(handler, sign):
    """Fusable scalar for the transform's normalization, or None: the
    forward is never normalized; Default (1/n) and scalar policies ride the
    kernel constants of the inverse. Custom callables cannot fuse."""
    if sign != +1:
        return None
    norm = handler.norm
    if norm.kind == "default":
        return 1.0 / handler.n
    if norm.kind == "scalar":
        return norm.value
    return None


def _apply_custom(fn, y, axis):
    """Apply a ``Normalization.custom`` callable with the transform axis last."""
    if axis == y.ndim - 1:
        return fn(y)
    return fn(y.movedim(axis, -1)).movedim(-1, axis)


def _unnormalized(handler):
    return handler.normalization(Normalization.NONE)


def _check_grad(x):
    if x.requires_grad and x.device.type == "cuda":
        raise NotImplementedError(
            "the CUDA kernels have no backward yet (ROADMAP.md §1, "
            "autograd)")


# the C2C kernels along a middle axis, by route
_MID_KERNELS = {C2C_AXIS_MID: _kfft.c2c_axis_mid, C2C_DENSE_MID: _kfft.c2c_dense_mid,
                C2C_GENERIC_MID: _kfft.c2c_generic_mid, C2C_BLUE_MID: _kfft.c2c_blue_mid}


def _c2c_impl(x, handler, axis, sign):
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n)
    if sign == +1 and handler.norm.kind == "custom":
        y = _c2c_impl(x, _unnormalized(handler), axis, sign)
        return _apply_custom(handler.norm.fn, y, axis)
    _check_grad(x)
    n = handler.n
    kind = "fft" if sign < 0 else "ifft"
    route = _route(kind, x.shape, axis, x.dtype, x.device.type)
    _plan_log(kind, n, axis, route)
    scale = _c2c_norm_scale(handler, sign)
    if route in _MID_KERNELS:
        nb, cols = _mid_dims(x.shape, axis)
        y = _MID_KERNELS[route](x.reshape(nb, n, cols).contiguous(), sign, scale)
        return y.reshape(x.shape)
    # the row routes (K10, K8), the lane Bluestein and the engine take the
    # axis last (a no-op for the last axis; a middle axis with < 128 columns
    # moves, as the JAX package does); engine.c2c dispatches on the same
    # gates.lane_c2c_route
    y = _engine.c2c(x.movedim(axis, -1), get_c2c_plan(n, sign), scale)
    return y.movedim(-1, axis)


def _r2c_impl(x, handler, axis):
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n)
    if x.is_complex():
        raise TypeError("ndfft_r2c expects a real input array")
    _check_grad(x)
    n, m = handler.n, handler.m
    route = _route("r2c", x.shape, axis, x.dtype, x.device.type)
    _plan_log("r2c", n, axis, route)
    if route in (R2C_MID, R2C_DENSE_MID):
        # along a middle axis in place: no moveaxis, as the JAX package does
        nb, cols = _mid_dims(x.shape, axis)
        fn = _krfft.r2c_mid if route == R2C_MID else _krfft.r2c_dense_mid
        y = fn(x.reshape(nb, n, cols).contiguous())
        return y.reshape(x.shape[:axis] + (m,) + x.shape[axis + 1:])
    # the lane lowering: K2, K15 or the row pairs on K8 (engine.r2c)
    return _engine.r2c(x.movedim(axis, -1), get_r2c_plan(n)).movedim(-1, axis)


def _c2r_impl(xhat, handler, axis):
    axis = _norm_axis(axis, xhat.ndim)
    n, m = handler.n, handler.m
    _check_size(xhat.shape[axis], m)
    if handler.norm.kind == "custom":
        # the reference's order: normalize the spectrum, then zero the
        # DC/Nyquist imaginary parts, then invert
        xh = _apply_custom(handler.norm.fn, xhat, axis)
        return _c2r_impl(xh, _unnormalized(handler), axis)
    _check_grad(xhat)
    norm = handler.norm
    scale = None
    if norm.kind == "default":
        scale = 1.0 / n
    elif norm.kind == "scalar":
        scale = norm.value
    route = _route("c2r", xhat.shape, axis, xhat.dtype, xhat.device.type, n=n)
    _plan_log("c2r", n, axis, route)
    if route in (C2R_MID, C2R_DENSE_MID):
        nb, cols = _mid_dims(xhat.shape, axis)
        fn = _krfft.c2r_mid if route == C2R_MID else _krfft.c2r_dense_mid
        y = fn(xhat.reshape(nb, m, cols).contiguous(), n, scale)
        return y.reshape(xhat.shape[:axis] + (n,) + xhat.shape[axis + 1:])
    # the lane lowering: K3, or the Hermitian extension on K10/K8 (engine.c2r)
    y = _engine.c2r(xhat.movedim(axis, -1), n, scale=scale)
    return y.movedim(-1, axis)


def _dct_scale(norm):
    """The policy's scalar, applied to the input before a DCT or DST and
    folded into the constants: Default x2 (scipy's values), scalar v, NONE
    None (the rustdct convention)."""
    if norm.kind == "default":
        return 2.0
    if norm.kind == "scalar":
        return norm.value
    return None


# the DCT routes along a middle axis: fn(x3, dct_type, scale) on (B, n, L);
# kernel 19 takes 0.5 * the policy's scalar (1 for NONE), as the JAX package
# passes it
_MID_DCT = {DCT_DENSE_MID: _kdct.dct_dense_mid,
            DCT4_HALF_MID: lambda x3, t, scale: _dct.dct4_half_mid(x3, scale),
            DCT2_MID: lambda x3, t, scale: _kdct.dct2_mid(x3, scale),
            DCT3_MID: lambda x3, t, scale: _kdct.dct3_mid(x3, scale),
            DCT1_MID: lambda x3, t, scale: _krfft.dct1_mid(
                x3, 0.5 * (1.0 if scale is None else scale)),
            DCT4_MID: lambda x3, t, scale: _kdct.dct4_mid(x3, scale),
            DCT23_BLUE_MID: _dct.dct23_blue_mid}


def _dct_impl(x, handler, axis, dct_type):
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n, what="dct")
    if x.is_complex():
        raise TypeError("nddct expects a real input array")
    if handler.norm.kind == "custom":
        # the policy applies to the input before the transform
        x2 = _apply_custom(handler.norm.fn, x, axis)
        return _dct_impl(x2, _unnormalized(handler), axis, dct_type)
    _check_grad(x)
    n = handler.n
    kind = f"dct{dct_type}"
    route = _route(kind, x.shape, axis, x.dtype, x.device.type)
    _plan_log(kind, n, axis, route)
    scale = _dct_scale(handler.norm)
    if route in _MID_DCT:
        # along a middle axis in place: no moveaxis, as the JAX package does
        nb, cols = _mid_dims(x.shape, axis)
        y = _MID_DCT[route](x.reshape(nb, n, cols).contiguous(), dct_type, scale)
        return y.reshape(x.shape)
    xm = x.movedim(axis, -1)
    if route in (DCT2_NAT, DCT3_NAT):
        fn = _kdct.dct2_nat if route == DCT2_NAT else _kdct.dct3_nat
        y = fn(xm.reshape(-1, n).contiguous(), scale).reshape(xm.shape)
    else:
        y = _dct.DCT_FNS[dct_type](xm, scale)
    return y.movedim(-1, axis)


def _dst_impl(x, handler, axis, dst_type):
    """DST-1..4 along ``axis``. Types 2-4 are flip/sign conjugations of the
    same-type DCT along the original axis, so they take its routes and
    kernels; DST-1 runs the packed odd-extension lowering."""
    axis = _norm_axis(axis, x.ndim)
    n = handler.n
    _check_size(x.shape[axis], n, what="dst")
    if x.is_complex():
        raise TypeError("nddst expects a real input array")
    norm = handler.norm
    if norm.kind == "custom":
        # on the original input, before the conjugation
        x2 = _apply_custom(norm.fn, x, axis)
        return _dst_impl(x2, _unnormalized(handler), axis, dst_type)
    if dst_type == 1:
        _check_grad(x)
        route = _route("dst1", x.shape, axis, x.dtype, x.device.type)
        _plan_log("dst1", n, axis, route)
        if route == R2C_PACKED_MID:
            # along a middle axis in place, as the JAX package does (its
            # api.py:600-621): the odd extension's streams, kernel 18 with
            # -0.5 * the policy's scalar, and the imaginary rows 1 .. n
            nb, cols = _mid_dims(x.shape, axis)
            xe, xo = _dst.dst1_streams(x.reshape(nb, n, cols))
            s = _dct_scale(norm)
            spec = _krfft.r2c_packed_mid(xe, xo, -0.5 * (1.0 if s is None else s))
            del xe, xo
            return spec.imag[:, 1:n + 1].reshape(x.shape)
        return _dst.dst1(x.movedim(axis, -1), _dct_scale(norm)).movedim(-1, axis)
    shape = [1] * x.ndim
    shape[axis] = n
    alt = _dst.alt_tensor(n, x.dtype, x.device).reshape(shape)
    dh = DctHandler(n).normalization(norm)
    if dst_type == 2:
        return _dct_impl(x * alt, dh, axis, 2).flip(axis)
    return _dct_impl(x.flip(axis), dh, axis, dst_type) * alt


def _spectral_mult_cols(x, mult, axis, rows):
    """The fused kernels' multiplier layout, or None: 1 for a (rows,)
    multiplier (broadcast over the other axes), the product of
    x.shape[axis + 1:] for a lane-varying one of shape (rows,) +
    x.shape[axis + 1:]; any other shape takes the exact composition (the
    JAX package's api.py:1126-1138)."""
    if mult.dim() == 1 and mult.shape[0] == rows:
        return 1
    if tuple(mult.shape) == (rows,) + tuple(x.shape[axis + 1:]):
        return math.prod(x.shape[axis + 1:])
    return None


def _along(mult, axis, ndim):
    """A 1-D multiplier reshaped to broadcast along ``axis``; any other as
    it is (plain broadcasting)."""
    if mult.dim() != 1:
        return mult
    shape = [1] * ndim
    shape[axis] = mult.shape[0]
    return mult.reshape(shape)


def _spectral_fused(kind, x, mult, rows, axis, custom):
    """The route of a spectral call and its multiplier's (rows, hc) view,
    or (COMPOSE, None)."""
    hc = _spectral_mult_cols(x, mult, axis, rows)
    route = _spectral_route(kind, x.shape, axis, x.dtype, x.device.type,
                            not custom and hc is not None)
    if route == COMPOSE:
        return route, None
    _check_grad(x)
    _check_grad(mult)
    return route, mult.reshape(rows, hc)


def _spectral_impl(x, mult, handler, axis):
    """``c2r(mult * r2c(x))``: kernel 22 along a middle axis where the JAX
    package fuses, else the exact composition."""
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n)
    n, m = handler.n, handler.m
    norm = handler.norm
    route, hm = _spectral_fused("r2c", x, mult, m, axis, norm.kind == "custom")
    _plan_log("spectral", n, axis, route)
    if route == COMPOSE:
        return _c2r_impl(_along(mult, axis, x.ndim) * _r2c_impl(x, handler, axis), handler,
                         axis)
    nb, cols = _mid_dims(x.shape, axis)
    hr = (hm.real if hm.is_complex() else hm).to(x.dtype)
    hi = hm.imag.to(x.dtype) if hm.is_complex() else None
    y = _krfft.spectral_r2c_mid(x.reshape(nb, n, cols).contiguous(), hr, hi, n,
                                _c2c_norm_scale(handler, +1))
    return y.reshape(x.shape)


def _spectral_c2c_impl(x, mult, handler, axis):
    """``ifft(mult * fft(x))``, the forward unnormalized: kernel 14 along a
    middle axis where the JAX package fuses, else the exact composition."""
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], handler.n)
    n = handler.n
    norm = handler.norm
    route, hm = _spectral_fused("c2c", x, mult, n, axis, norm.kind == "custom")
    _plan_log("spectral_c2c", n, axis, route)
    if route == COMPOSE:
        fwd = _c2c_impl(x, handler, axis, -1)
        return _c2c_impl(_along(mult, axis, x.ndim) * fwd, handler, axis, +1)
    nb, cols = _mid_dims(x.shape, axis)
    hm = hm.to(torch.complex64) if hm.is_complex() else hm.to(torch.float32)
    y = _kfft.spectral_c2c_mid(x.reshape(nb, n, cols).contiguous(), hm,
                               _c2c_norm_scale(handler, +1))
    return y.reshape(x.shape)


def _spectral_dct_impl(x, mult, h2, h3, axis):
    """``dct3(mult * dct2(x, h2), h3)``: kernel 29 along a middle axis where
    the JAX package fuses, else the exact composition."""
    axis = _norm_axis(axis, x.ndim)
    _check_size(x.shape[axis], h2.n, what="dct")
    n = h2.n
    custom = "custom" in (h2.norm.kind, h3.norm.kind)
    route, hm = _spectral_fused("dct", x, mult, n, axis, custom)
    _plan_log("spectral_dct", n, axis, route)
    if route == COMPOSE:
        return _dct_impl(_along(mult, axis, x.ndim) * _dct_impl(x, h2, axis, 2), h3, axis, 3)
    nb, cols = _mid_dims(x.shape, axis)
    y = _kdct.spectral_dct_mid(x.reshape(nb, n, cols).contiguous(), hm.to(x.dtype),
                               _dct_scale(h2.norm), _dct_scale(h3.norm))
    return y.reshape(x.shape)


# --------------------------------------------------------------------------
# Public functions
# --------------------------------------------------------------------------


def _as_tensor(x) -> torch.Tensor:
    """A tensor keeps its device; anything else goes to the CUDA device."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ndrustfft_tpu_torch: a non-tensor input goes to the CUDA device "
            "(torch.device('cuda')), and there is none; pass a torch.Tensor "
            "on the CPU to run there")
    return torch.as_tensor(x, device="cuda")


def _prep_complex(x):
    x = _as_tensor(x)
    if not x.is_complex():
        x = x.to(torch.complex128 if x.dtype == torch.float64 else torch.complex64)
    return x


def _prep_real(x):
    x = _as_tensor(x)
    if x.is_complex():
        return x  # rejected with a clear error by _r2c_impl
    if x.dtype not in (torch.float32, torch.float64):
        x = x.to(torch.float32)
    return x


def ndfft(x, handler: FftHandler | None = None, axis: int = -1):
    """n-D complex-to-complex forward FFT along ``axis`` (unnormalized);
    ``handler=None`` plans for ``x.shape[axis]``."""
    x = _prep_complex(x)
    h = handler or _auto_handler(FftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _c2c_impl(x, h, axis, -1)


def ndifft(x, handler: FftHandler | None = None, axis: int = -1):
    """n-D C2C inverse FFT along ``axis``; the handler's normalization is
    applied after the transform (Default = 1/n)."""
    x = _prep_complex(x)
    h = handler or _auto_handler(FftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _c2c_impl(x, h, axis, +1)


def ndfft_r2c(x, handler: R2cFftHandler | None = None, axis: int = -1):
    """Real-to-complex FFT along ``axis``: real length n -> m = n//2 + 1 bins."""
    x = _prep_real(x)
    h = handler or _auto_handler(R2cFftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _r2c_impl(x, h, axis)


def ndifft_r2c(x, handler: R2cFftHandler | None = None, axis: int = -1,
               n: int | None = None):
    """Complex-to-real inverse FFT along ``axis``: m bins -> n reals. The
    normalization is applied to the spectrum first, then the DC (and, for
    even n, Nyquist) imaginary parts are zeroed, then the transform runs.
    Without a handler, ``n`` defaults to 2*(m-1)."""
    x = _prep_complex(x)
    if handler is None:
        m = x.shape[_norm_axis(axis, x.ndim)]
        handler = _auto_handler(R2cFftHandler, n if n is not None else 2 * (m - 1))
    return _c2r_impl(x, handler, axis)


def _make_r2r(family: str, t: int, impl, handler_cls):
    def f(x, handler=None, axis: int = -1):
        x = _prep_real(x)
        h = handler or _auto_handler(handler_cls, x.shape[_norm_axis(axis, x.ndim)])
        return impl(x, h, axis, t)

    roman = ("I", "II", "III", "IV")[t - 1]
    f.__name__ = f.__qualname__ = f"nd{family}{t}"
    f.__doc__ = (
        f"Real-to-real {family.upper()}-{roman} along ``axis``. With the Default "
        f"normalization (applied to the input, x2) the output equals "
        f"scipy.fft.{family}(x, type={t}); with Normalization.NONE it is the "
        f"rustdct convention (scipy / 2). ``handler=None`` plans for "
        f"``x.shape[axis]``.")
    return f


nddct1, nddct2, nddct3, nddct4 = (_make_r2r("dct", t, _dct_impl, DctHandler)
                                  for t in (1, 2, 3, 4))
nddst1, nddst2, nddst3, nddst4 = (_make_r2r("dst", t, _dst_impl, DstHandler)
                                  for t in (1, 2, 3, 4))

def _as_mult(multiplier, x) -> torch.Tensor:
    """The multiplier as a tensor on x's device (a tensor keeps its dtype)."""
    if isinstance(multiplier, torch.Tensor):
        return multiplier.to(x.device)
    return torch.as_tensor(multiplier, device=x.device)


def ndspectral_r2c(x, multiplier, handler: R2cFftHandler | None = None, axis: int = -1):
    """The real spectral pipeline along ``axis``, exactly
    ``ndifft_r2c(multiplier * ndfft_r2c(x, handler, axis), handler, axis)``:
    the forward R2C, the diagonal multiply, the normalized inverse C2R (the
    product's DC and Nyquist imaginary parts ignored). ``multiplier`` is
    real or complex, of shape (m,) (broadcast over the other axes) or
    (m,) + x.shape[axis + 1:] (lane-varying), m = n//2 + 1; along a middle
    axis that is one pass of kernel 22, anything else broadcastable
    composes. float64 always composes."""
    x = _prep_real(x)
    h = handler or _auto_handler(R2cFftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _spectral_impl(x, _as_mult(multiplier, x), h, axis)


def ndspectral_c2c(x, multiplier, handler: FftHandler | None = None, axis: int = -1):
    """The complex spectral pipeline along ``axis``, exactly
    ``ndifft(multiplier * ndfft(x, handler, axis), handler, axis)`` (the
    forward unnormalized, the handler's norm at the inverse).
    ``multiplier``: real or complex, (n,) or (n,) + x.shape[axis + 1:]; along
    a middle axis that is one pass of kernel 14, anything else broadcastable
    composes. complex128 always composes."""
    x = _prep_complex(x)
    h = handler or _auto_handler(FftHandler, x.shape[_norm_axis(axis, x.ndim)])
    return _spectral_c2c_impl(x, _as_mult(multiplier, x), h, axis)


def _spectral_r2r_prep(family, x, multiplier, handler, inv_handler, axis, cls):
    """(x, axis, h2, h3, mult) of ndspectral_dct/dst, with the JAX package's
    checks in its order: the handlers' sizes, then a complex multiplier."""
    x = _prep_real(x)
    axn = _norm_axis(axis, x.ndim)
    h2 = handler or _auto_handler(cls, x.shape[axn])
    h3 = inv_handler or h2
    if h3.n != h2.n:
        raise ValueError(f"Size mismatch in {family}, got {h3.n} expected {h2.n}")
    mult = _as_mult(multiplier, x)
    if mult.is_complex():
        raise TypeError(f"ndspectral_{family} expects a real multiplier (the "
                        f"{family.upper()} basis is real)")
    return x, axn, h2, h3, mult


def ndspectral_dct(x, multiplier, handler: DctHandler | None = None,
                   inv_handler: DctHandler | None = None, axis: int = -1):
    """The cosine-basis pipeline along ``axis``, exactly
    ``nddct3(multiplier * nddct2(x, handler, axis), inv_handler, axis)``
    (``inv_handler`` defaults to ``handler``; each handler's norm applies
    before its transform). The real ``multiplier`` is (n,) or (n,) +
    x.shape[axis + 1:]; along a middle axis that is one pass of kernel 29,
    any other shape, odd n, the last axis or a custom norm composes.
    float64 always composes."""
    x, _, h2, h3, mult = _spectral_r2r_prep("dct", x, multiplier, handler, inv_handler, axis,
                                            DctHandler)
    return _spectral_dct_impl(x, mult, h2, h3, axis)


def ndspectral_dst(x, multiplier, handler: DstHandler | None = None,
                   inv_handler: DstHandler | None = None, axis: int = -1):
    """The sine-basis pipeline along ``axis``, exactly
    ``nddst3(multiplier * nddst2(x, handler, axis), inv_handler, axis)``,
    through the DCT pipeline by the flip/sign conjugation (a = (-1)^t):
    dst3(H dst2(x)) = a dct3(flip(H) dct2(a x)), flip along the frequency
    axis (axis 0 of the multiplier). A custom norm or a multiplier of
    another shape composes (the callable must see the true DST values), as
    does float64."""
    x, axn, h2, h3, mult = _spectral_r2r_prep("dst", x, multiplier, handler, inv_handler,
                                              axis, DstHandler)
    n = h2.n
    _check_size(x.shape[axn], n, what="dst")
    route, _ = _spectral_fused("dct", x, mult, n, axn, "custom" in (h2.norm.kind, h3.norm.kind))
    if route == COMPOSE:
        return _dst_impl(_along(mult, axn, x.ndim) * _dst_impl(x, h2, axn, 2), h3, axn, 3)
    alt = _along(_dst.alt_tensor(n, x.dtype, x.device), axn, x.ndim)
    d2 = DctHandler(n).normalization(h2.norm)
    d3 = DctHandler(n).normalization(h3.norm)
    return alt * _spectral_dct_impl(alt * x, mult.flip(0), d2, d3, axn)


# The JAX package's ``_par`` twins (its api.py:1720-1731) run its sharded
# pencil path on a mesh-sharded input and are the serial functions on any
# other. The port has no sharded input (ROADMAP.md, "Distributed"), so each
# is its serial function.
ndfft_par, ndifft_par, ndfft_r2c_par, ndifft_r2c_par = ndfft, ndifft, ndfft_r2c, ndifft_r2c
nddct1_par, nddct2_par, nddct3_par, nddct4_par = nddct1, nddct2, nddct3, nddct4
nddst1_par, nddst2_par, nddst3_par, nddst4_par = nddst1, nddst2, nddst3, nddst4
