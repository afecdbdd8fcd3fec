"""Normalization policy, the same enum as ``ndrustfft_tpu.Normalization``.

  * C2C: the forward transform is never normalized; the inverse applies the
    policy after the transform. Default = multiply by 1/n.
  * R2C: the forward applies nothing; C2R applies the policy to the
    half-spectrum before the inverse, with Default = 1/n over the full n.

``custom(fn)`` takes a callable that receives a tensor whose LAST axis is
the transform axis and returns a tensor of the same shape and dtype.
``scalar(v)`` multiplies by a constant; the library folds it into the kernel
constants, as it does the Default 1/n.
"""

from __future__ import annotations

from typing import Callable, Optional


class Normalization:
    """One of Normalization.NONE, Normalization.DEFAULT,
    Normalization.custom(fn) or Normalization.scalar(v)."""

    __slots__ = ("kind", "fn", "value")

    def __init__(self, kind: str, fn: Optional[Callable] = None,
                 value: Optional[float] = None):
        if kind not in ("none", "default", "custom", "scalar"):
            raise ValueError(f"unknown normalization kind: {kind}")
        if kind == "custom" and fn is None:
            raise ValueError("Normalization.custom requires a callable")
        if kind == "scalar":
            if value is None:
                raise ValueError("Normalization.scalar requires a value")
            value = float(value)
        self.kind = kind
        self.fn = fn
        self.value = value

    NONE: "Normalization"
    DEFAULT: "Normalization"

    @staticmethod
    def custom(fn: Callable) -> "Normalization":
        """Custom callable; policies compare by the identity of ``fn``."""
        return Normalization("custom", fn)

    @staticmethod
    def scalar(value: float) -> "Normalization":
        """Multiply by ``value``, folded into the kernel constants."""
        return Normalization("scalar", value=value)

    def __repr__(self):
        if self.kind == "custom":
            return f"Normalization.custom({self.fn!r})"
        if self.kind == "scalar":
            return f"Normalization.scalar({self.value!r})"
        return f"Normalization.{self.kind.upper()}"

    def __hash__(self):
        return hash((self.kind, id(self.fn), self.value))

    def __eq__(self, other):
        return (
            isinstance(other, Normalization)
            and self.kind == other.kind
            and self.fn is other.fn
            and self.value == other.value
        )


Normalization.NONE = Normalization("none")
Normalization.DEFAULT = Normalization("default")
