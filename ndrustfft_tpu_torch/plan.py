"""Plan layer: factorization and plan-time twiddle/DFT constants.

The PyTorch counterpart of ``ndrustfft_tpu/plan.py``. Constants stay numpy
float64 masters built with the same integer phase reduction, so every table
is bit-identical to the JAX package's; the kernel wrappers cast them to
float32 and move them to the input's device once (see ``ops/hopper``).

Every n plans: a length with a prime factor above ``MAX_BASE_RADIX`` takes
Bluestein's chirp-z plan, whose two sub-FFTs have the smooth length
:func:`blue_sub_len` (n). The JAX package's native planner is not carried:
its tables are these numpy expressions, bit for bit.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

# Largest factor the planner emits; the JAX package's default
# ``config.max_base_radix``. The kernel gates in ``api._route`` mirror it.
MAX_BASE_RADIX = 128


def prime_factors(n: int) -> list[int]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return fs


def _greedy_partition(primes: list[int], k: int,
                      max_base: int) -> Optional[list[int]]:
    """Group prime factors into k buckets of product <= max_base, balanced."""
    buckets = [1] * k
    for p in sorted(primes, reverse=True):
        order = sorted(range(k), key=lambda i: buckets[i])
        for i in order:
            if buckets[i] * p <= max_base:
                buckets[i] *= p
                break
        else:
            return None
    return [b for b in buckets if b > 1] or [1]


@lru_cache(maxsize=None)
def factorize(n: int, max_base: int = MAX_BASE_RADIX) -> Optional[tuple[int, ...]]:
    """Factor n into a few factors each <= max_base (largest first), or None
    when n has a prime factor > max_base (Bluestein territory)."""
    if n <= 0:
        raise ValueError(f"transform length must be positive, got {n}")
    if n == 1:
        return (1,)
    pf = prime_factors(n)
    if max(pf) > max_base:
        return None
    k = 1
    while max_base**k < n:
        k += 1
    while True:
        parts = _greedy_partition(pf, k, max_base)
        if parts is not None:
            return tuple(sorted(parts, reverse=True))
        k += 1


def next_smooth(n: int) -> int:
    """Smallest 3-smooth number (2^a * 3^b) >= n."""
    best = 1
    while best < n:
        best *= 2
    p3 = 1
    while True:
        p2 = 1
        while p2 * p3 < n:
            p2 *= 2
        best = min(best, p2 * p3)
        if p3 >= n:  # include the pure power of 3 >= n, then stop
            break
        p3 *= 3
    return best


def blue_sub_len(n: int) -> int:
    """Bluestein convolution length M >= 2n - 1 for transform size n: the
    3-smooth ``next_smooth`` (2n - 1) where it is at most 256 or a multiple
    of 128, else 128 * next_smooth(ceil((2n - 1) / 128)) while that factor
    is at most 512, so that both sub-FFTs have a {128, 256} split (the JAX
    package's ``plan.blue_sub_len``)."""
    need = 2 * n - 1
    M = next_smooth(need)
    if M <= 256 or M % 128 == 0:
        return M
    s = next_smooth(-(-need // 128))
    if s <= 512:
        return 128 * s
    return M


def _cis(num, den: int, sign: int):
    """exp(sign * 1j * pi * num / den) with integer phase reduction mod 2*den."""
    num = np.asarray(num, dtype=np.int64) % (2 * den)
    ang = (np.pi / den) * num.astype(np.float64)
    if sign < 0:
        ang = -ang
    return np.cos(ang), np.sin(ang)


def dft_matrix(f: int, sign: int):
    """(f, f) DFT matrix W[t, k] = exp(sign*2j*pi*t*k/f), split re/im."""
    tk = np.outer(np.arange(f, dtype=np.int64), np.arange(f, dtype=np.int64))
    return _cis(2 * tk, f, sign)


def stage_twiddle(f: int, m: int, sign: int):
    """(f, m) twiddle W_n^{j*p} for n = f*m, split re/im."""
    jp = np.outer(np.arange(f, dtype=np.int64), np.arange(m, dtype=np.int64))
    return _cis(2 * jp, f * m, sign)


def chirp(n: int, sign: int, length: Optional[int] = None):
    """exp(sign * 1j * pi * t^2 / n) for t in [0, length), split re/im."""
    t = np.arange(n if length is None else length, dtype=np.int64)
    return _cis(t * t, n, sign)


def blue_h(n: int, sign: int, M: int):
    """(re, im) float64 of H = FFT_M of the wrapped inverse chirp
    h[u] = exp(-sign * 1j * pi * u^2 / n), u < n, mirrored into the tail
    (h_pad[M - u] = h[u]), computed by numpy in float64 as the JAX
    package's plan and kernel tables compute it."""
    hr = np.zeros(M)
    hi = np.zeros(M)
    cr, ci = chirp(n, -sign)
    hr[:n], hi[:n] = cr, ci
    hr[M - n + 1:] = cr[1:][::-1]
    hi[M - n + 1:] = ci[1:][::-1]
    H = np.fft.fft(hr + 1j * hi)
    return H.real.copy(), H.imag.copy()


class C2CPlan:
    """Schedule for a length-n C2C FFT in one direction.

    kind "ct": ``stages`` is a list of (f, m, Wf(re, im), tw(re, im)) and
    ``base`` the (re, im) dense DFT matrix of the last factor.
    kind "bluestein" (n has a prime factor above ``MAX_BASE_RADIX``):
    ``chirp_a`` = ``chirp_b`` = chirp(n, sign), ``H`` (:func:`blue_h`) of
    length ``M`` = :func:`blue_sub_len` (n), and the sub-FFT plans
    ``sub_fwd``/``sub_inv`` of length M.
    """

    __slots__ = ("n", "sign", "kind", "stages", "base", "M",
                 "chirp_a", "chirp_b", "H", "sub_fwd", "sub_inv")

    def __init__(self, n: int, sign: int):
        assert sign in (-1, 1)
        self.n = n
        self.sign = sign
        factors = factorize(n)
        if factors is None:
            self.kind = "bluestein"
            self.M = M = blue_sub_len(n)
            self.chirp_a = chirp(n, sign)
            self.chirp_b = chirp(n, sign)
            self.H = blue_h(n, sign, M)
            self.sub_fwd = get_c2c_plan(M, -1)
            self.sub_inv = get_c2c_plan(M, +1)
            return
        self.kind = "ct"
        self.stages = []
        rem = n
        for f in factors[:-1]:
            m = rem // f
            self.stages.append((f, m, dft_matrix(f, sign),
                                stage_twiddle(f, m, sign)))
            rem = m
        self.base = dft_matrix(factors[-1], sign)

    def __repr__(self):
        if self.kind == "bluestein":
            return f"C2CPlan(n={self.n}, sign={self.sign}, bluestein M={self.M})"
        fs = [f for f, _, _, _ in self.stages] + [self.base[0].shape[0]]
        return f"C2CPlan(n={self.n}, sign={self.sign}, factors={fs})"


@lru_cache(maxsize=512)
def get_c2c_plan(n: int, sign: int) -> C2CPlan:
    return C2CPlan(n, sign)


class R2CPlan:
    """R2C forward schedule. Even n: half-size complex FFT plus the unpack
    twiddle W_n^k. Odd n: full C2C of the complexified input, truncated to
    m = n//2 + 1 bins."""

    __slots__ = ("n", "m", "half", "sub", "unpack_tw")

    def __init__(self, n: int):
        self.n = n
        self.m = n // 2 + 1
        self.half = n % 2 == 0 and n >= 2
        if self.half:
            self.sub = get_c2c_plan(n // 2, -1)
            k = np.arange(self.m, dtype=np.int64)
            self.unpack_tw = _cis(2 * k, n, -1)
        else:
            self.sub = get_c2c_plan(n, -1)
            self.unpack_tw = None


@lru_cache(maxsize=512)
def get_r2c_plan(n: int) -> R2CPlan:
    return R2CPlan(n)
