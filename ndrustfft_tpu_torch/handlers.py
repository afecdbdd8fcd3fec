"""Plan-caching handlers: ``FftHandler``, ``R2cFftHandler``, ``DctHandler``
and ``DstHandler``.

Construction of an FFT handler builds its plans for length ``n`` eagerly
(Bluestein's chirp-z plan where n has a prime factor above 128). The DCT
and DST handlers plan their FFT schedules at first use.
``.normalization(...)`` returns a new handler with another policy. Handlers
are immutable and hash by (type, n, normalization), as in the JAX package.
``.warmup(shape, axis)`` prepares every transform a handler serves before
its first call.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from .normalization import Normalization
from .plan import get_c2c_plan, get_r2c_plan


class _HandlerBase:
    __slots__ = ("n", "norm")

    def __init__(self, n: int):
        if not isinstance(n, int) or n <= 0:
            raise ValueError(f"transform length must be a positive int, got {n!r}")
        self.n = n
        self.norm = Normalization.DEFAULT

    def normalization(self, norm: Normalization) -> "_HandlerBase":
        """Builder: returns a new handler with the given normalization policy."""
        if not isinstance(norm, Normalization):
            raise TypeError(f"expected Normalization, got {type(norm).__name__}")
        new = copy.copy(self)
        new.norm = norm
        return new

    @classmethod
    def from_reference(cls, h) -> "_HandlerBase":
        """This package's handler for a JAX-package handler ``h``.

        Reads ``h.n`` and ``h.norm`` (its ``kind``, ``value`` and ``fn``)
        by attribute, so the JAX package need not be imported here. A
        custom policy keeps the same callable, which must then accept a
        ``torch.Tensor``.
        """
        norm = h.norm
        kind = norm.kind
        if kind == "custom":
            new_norm = Normalization.custom(norm.fn)
        elif kind == "scalar":
            new_norm = Normalization.scalar(norm.value)
        else:
            new_norm = Normalization(kind)
        return cls(int(h.n)).normalization(new_norm)

    def __hash__(self):
        return hash((type(self).__name__, self.n, self.norm))

    def __eq__(self, other):
        return (
            type(self) is type(other) and self.n == other.n and self.norm == other.norm
        )

    def __repr__(self):
        return f"{type(self).__name__}(n={self.n}, norm={self.norm!r})"

    # transform kinds this handler serves: (public function, input is complex)
    _kinds: tuple = ()

    def warmup(self, shape, axis: int = -1, float64: bool = False, run: bool = True,
               device=None):
        """Prepare this handler's transforms for a forward-input ``shape``.

        For every kind the handler serves, forward and inverse (the inverse
        of an R2C handler takes ``m`` bins on the axis), the call walks its
        route on ``device`` (CUDA by default): on a CUDA device it builds
        the kernel library and uploads the route's device tables (Wq, the
        radix tables, the chirps), so that the first real call finds them.
        With ``run=True`` each kind then runs once on zeros, and a CUDA
        device is synchronized. With ``run=False`` a CUDA device runs no
        kernel (the launches are skipped and not counted), and a CPU device
        does nothing more: its plain versions build their tables as they
        run. An unbuildable library raises, as a first call would.
        """
        from . import api
        from .ops.hopper import _build

        device = torch.device("cuda" if device is None else device)
        shape = tuple(shape)
        ax = axis % len(shape)
        cdt, rdt = ((torch.complex128, torch.float64) if float64
                    else (torch.complex64, torch.float32))
        if not (run or device.type == "cuda"):
            return self
        saved = None if run else _launch_counts()
        for name, is_cplx in self._kinds:
            s = list(shape)
            if name == "ndifft_r2c":
                s[ax] = self.m
            x = torch.zeros(s, dtype=cdt if is_cplx else rdt, device=device)
            with contextlib.nullcontext() if run else _build.no_launch():
                getattr(api, name)(x, self, axis=ax)
        if saved is not None:
            for (fn, attr), v in saved.items():
                setattr(fn, attr, v)
        elif device.type == "cuda":
            torch.cuda.synchronize(device)
        return self


def _launch_counts():
    """{(wrapper, attribute): count} of every launch counter of the kernel
    wrappers and every call counter of the torch engine."""
    from .ops import engine
    from .ops.hopper import dct, fft, rfft

    out = {}
    for mod in (engine, fft, rfft, dct):
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "__dict__"):
                for attr, v in vars(fn).items():
                    if attr.endswith(("launches", "calls")) and type(v) is int:
                        out[(fn, attr)] = v
    return out


class FftHandler(_HandlerBase):
    """C2C FFT plans for axis length n."""

    _kinds = (("ndfft", True), ("ndifft", True))

    def __init__(self, n: int):
        super().__init__(n)
        get_c2c_plan(n, -1)
        get_c2c_plan(n, +1)


class R2cFftHandler(_HandlerBase):
    """R2C/C2R plans for real axis length n; spectrum length m = n//2 + 1."""

    __slots__ = ("m",)
    _kinds = (("ndfft_r2c", False), ("ndifft_r2c", True))

    def __init__(self, n: int):
        super().__init__(n)
        self.m = n // 2 + 1
        get_r2c_plan(n)
        get_c2c_plan(n, +1)


class DctHandler(_HandlerBase):
    """DCT-1/2/3/4 for axis length n; one handler serves all four types.
    The policy applies to the input before the transform; Default (x2)
    gives scipy.fft.dct's values, Normalization.NONE the rustdct convention
    (scipy / 2)."""

    _kinds = (("nddct1", False), ("nddct2", False), ("nddct3", False), ("nddct4", False))


class DstHandler(_HandlerBase):
    """DST-1/2/3/4 for axis length n, with :class:`DctHandler`'s policy
    rules (Default gives scipy.fft.dst's values)."""

    _kinds = (("nddst1", False), ("nddst2", False), ("nddst3", False), ("nddst4", False))
