"""Plan-caching handlers: ``FftHandler``, ``R2cFftHandler``, ``DctHandler``
and ``DstHandler``.

Construction of an FFT handler builds its plans for length ``n`` eagerly
(Bluestein's chirp-z plan where n has a prime factor above 128). The DCT
and DST handlers plan their FFT schedules at first use.
``.normalization(...)`` returns a new handler with another policy. Handlers
are immutable and hash by (type, n, normalization), as in the JAX package.
"""

from __future__ import annotations

import copy

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


class FftHandler(_HandlerBase):
    """C2C FFT plans for axis length n."""

    def __init__(self, n: int):
        super().__init__(n)
        get_c2c_plan(n, -1)
        get_c2c_plan(n, +1)


class R2cFftHandler(_HandlerBase):
    """R2C/C2R plans for real axis length n; spectrum length m = n//2 + 1."""

    __slots__ = ("m",)

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


class DstHandler(_HandlerBase):
    """DST-1/2/3/4 for axis length n, with :class:`DctHandler`'s policy
    rules (Default gives scipy.fft.dst's values)."""
