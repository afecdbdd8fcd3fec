"""The JAX package's TPU kernel gates as pure functions of the length and the
batch, and the names of the port's routes.

Each lane lowering has one route function here (:func:`lane_c2c_route`,
:func:`r2c_lane_route`, :func:`c2r_lane_route`, :func:`packed_lane`):
``api._route`` names a whole call's route from it, and the lowering in
``ops/engine.py`` dispatches on the same function, so both agree on which
kernel a call reaches. Beyond the single kernels' range (n > 20480) a C2C
takes the four-step, C2C_FOURSTEP (kernels 7 and 13), as does every
lowering whose inner C2C has such a length. Every Pallas kernel of the JAX
package has its CUDA port, so every route runs on a CUDA tensor.
"""

from __future__ import annotations

from functools import lru_cache

from .ops.hopper import fft as _kfft
from .plan import MAX_BASE_RADIX, blue_sub_len, factorize

# routes that run a ported kernel, and the engine
C2C_AXIS_MID = "c2c_axis_mid"
C2C_ROWS = "c2c_rows"
C2C_DENSE_ROWS = "c2c_dense_rows"
C2C_DENSE_MID = "c2c_dense_mid"
C2C_GENERIC_ROWS = "c2c_generic_rows"
C2C_GENERIC_MID = "c2c_generic_mid"
R2C_NAT = "r2c_nat"
C2R_NAT = "c2r_nat"
R2C_MID = "r2c_mid"
C2R_MID = "c2r_mid"
# the JAX package's dense gates along a middle axis (4 <= n <= 1100 for the
# R2C/C2R, 2 <= n <= 1100 for any DCT): K20 and K21 run the radix column
# tile where the transform length (n/2 at even n, n at odd n) has a plan,
# K27 for DCT-I at a plan of n - 1 and DCT-II/III at even n with a plan of
# n/2; each keeps its dense product at the other lengths and types, and K21
# at odd n and K27's DCT-I where ops/hopper/fft.py::dense_beats_radix holds
R2C_DENSE_MID = "r2c_dense_mid"
C2R_DENSE_MID = "c2r_dense_mid"
DCT_DENSE_MID = "dct_dense_mid"
DCT2_NAT = "dct2_nat"
DCT3_NAT = "dct3_nat"
DCT2_MID = "dct2_mid"
DCT3_MID = "dct3_mid"
# the lane lowerings of the other kinds: K15 (the packed R2C of even-length
# rows: R2C, DCT-I, DST-I, DCT-II), the row pairs' C2C (odd-length R2C and
# DCT-II), the Hermitian extension's C2C (C2R) and the DCT-III/IV lowerings'
# C2C; each C2C is K10 or K8 (on the radix row core at n <= 256, counted by
# c2c_dense_rows, and above, by c2c_generic_rows) or the four-step (K7, K13;
# also the packed R2C's half-length C2C beyond 20480), as lane_c2c_route
# picks, and the launch counters show which
R2C_PACKED = "r2c_packed"
R2C_ROWPAIR = "r2c_rowpair"
C2R_LANE = "c2r_lane"
DCT_LANE = "dct_lane"
# the DCT-IV/DST-IV composite along a middle axis: the half-length C2C on K6
# between two elementwise chirps
DCT4_HALF_MID = "dct4_half_mid"
# along a middle axis: DST-I's packed R2C of the odd-extension streams (K18),
# DCT-I on its even extension (K19) and the fused DCT-IV/DST-IV (K28)
R2C_PACKED_MID = "r2c_packed_mid"
DCT1_MID = "dct1_mid"
DCT4_MID = "dct4_mid"
# Bluestein lengths (a prime factor above 128): the fused chirp-z C2C along
# a middle axis (K11), its real-to-real DCT-II/III form (K12), and along the
# last axis the engine's chirp-z, whose two length-M sub-FFTs run on K10,
# K8 or the four-step (the route of every lane lowering at such a length)
C2C_BLUE_MID = "c2c_blue_mid"
DCT23_BLUE_MID = "dct23_blue_rr_mid"
BLUESTEIN_LANE = "bluestein_lane"
# the four-step long C2C (engine._fourstep), 20480 < n <= 2^22 with a split
# (n1, n2): K7 along n1 with the exit twiddle, then K13 along n2 with the
# transposed store, or, where n2 has no twostep split, K8's rows and a swap
C2C_FOURSTEP = "c2c_fourstep"
# the fused spectral pipelines along a middle axis: IFFT(H FFT(x)) (K14),
# C2R(H R2C(x)) (K22) and DCT-III(H DCT-II(x)) (K29); COMPOSE is a spectral
# call that runs the exact composition of the public transforms instead
SPECTRAL_C2C_MID = "spectral_c2c_mid"
SPECTRAL_R2C_MID = "spectral_r2c_mid"
SPECTRAL_DCT_MID = "spectral_dct_mid"
COMPOSE = "compose"
ENGINE = "engine"

# every route api._route returns (the spectral calls' are _spectral_route's)
ROUTES = (C2C_AXIS_MID, C2C_ROWS, C2C_DENSE_ROWS, C2C_DENSE_MID, C2C_GENERIC_ROWS,
          C2C_GENERIC_MID, R2C_NAT, C2R_NAT, R2C_MID, C2R_MID, R2C_DENSE_MID, C2R_DENSE_MID,
          DCT_DENSE_MID, DCT2_NAT, DCT3_NAT, DCT2_MID, DCT3_MID, DCT4_HALF_MID, R2C_PACKED_MID,
          DCT1_MID, DCT4_MID, R2C_PACKED, R2C_ROWPAIR, C2R_LANE, DCT_LANE, C2C_BLUE_MID,
          DCT23_BLUE_MID, BLUESTEIN_LANE, C2C_FOURSTEP, ENGINE)

# the JAX package's TPU gates
MIN_BATCH = 128          # engine.c2c / r2c / c2r
_MAX_N = 65536           # fft._MAX_N
_VMEM_MAX_N = int(0.8 * 100 * 1024 * 1024) // (8 * 128 * 4)  # fft._LIVE_COPIES bound
_FOURSTEP_MAX_N = 1 << 22


@lru_cache(maxsize=None)
def _twostep_split(n: int):
    """(m, f) with m in {128, 256} dividing n and f = n/m <= 256, minimal
    m + f; or None (fft._twostep_split)."""
    cands = [d for d in (128, 256) if n % d == 0 and n // d <= 256]
    if not cands:
        return None
    m = min(cands, key=lambda d: d + n // d)
    return m, n // m


def _kernel_ok(n: int) -> bool:
    """fft.pallas_supported for a float32 Cooley-Tukey plan (n <= 20480,
    its VMEM working-set bound)."""
    if factorize(n) is None or n < 2 or n > min(_MAX_N, _VMEM_MAX_N):
        return False
    f = _kfft.lane_factor(n)
    return f is not None and not (n > 1024 and f % 8)


def _mid_stage_ok(k: int) -> bool:
    ts = _twostep_split(k)
    return k <= 256 or (ts is not None and ts[0] <= MAX_BASE_RADIX)


@lru_cache(maxsize=None)
def _fourstep_split(n: int):
    """fft.fourstep_split: (n1, n2) with both stages kernel-bodied, or None."""
    best = None
    d = 1
    while d * d <= n:
        if n % d == 0:
            for n1, n2 in ((n // d, d), (d, n // d)):
                if (n1 <= 4096 and n2 <= 16384 and _mid_stage_ok(n1)
                        and _mid_stage_ok(n2) and _kfft.lane_factor(n2) is not None):
                    if best is None or n1 + n2 < best[0] + best[1]:
                        best = (n1, n2)
        d += 1
    return best


def _nat_f(n: int):
    """Butterfly factor of the half-length core of the natural-layout R2C/C2R
    kernels for even n (rfft.rfft_nat_supported / _nat_ts), or None."""
    h = n // 2
    if n % 2 or n < 2 or not _kernel_ok(h):
        return None
    ts = _twostep_split(h)
    if h >= 256 and ts is not None and ts[0] <= MAX_BASE_RADIX:
        return ts[1]
    return None


def _lane_c2c(n: int, batch: int) -> str:
    """Route of a float32 C2C along the last axis of (batch, n)
    (engine.c2c): four-step beyond the single kernel's range, lane-last
    kernels, or the engine."""
    if n > min(_MAX_N, _VMEM_MAX_N):
        ok = n <= _FOURSTEP_MAX_N and _fourstep_split(n) is not None
        return "fourstep" if ok else ENGINE
    if batch >= MIN_BATCH and _kernel_ok(n):
        return "twostep" if n > 256 and _twostep_split(n) else "lane_last"
    return ENGINE


def _c2c_kernel_route(route: str, n: int) -> str:
    """The port's route for the JAX package's C2C route at length n: kernel
    10 for the twostep split (n = 128 * F, the fixed or the wide core),
    kernel 8 for the lane schedule (its dense lane DFT at n <= 256, the
    generic schedule above), kernel 4 for the dense mid product, kernels 7
    and 13 for the four-step; else ``route``."""
    if route == "twostep":
        return C2C_ROWS
    if route == "lane_last":
        return C2C_DENSE_ROWS if n <= 256 else C2C_GENERIC_ROWS
    if route == "dense_mid":
        return C2C_DENSE_MID
    if route == "fourstep":
        return C2C_FOURSTEP
    return route


_ROW_ROUTES = (C2C_ROWS, C2C_DENSE_ROWS, C2C_GENERIC_ROWS, C2C_FOURSTEP)


def lane_c2c_route(n: int, batch: int) -> str:
    """C2C_ROWS, C2C_DENSE_ROWS, C2C_GENERIC_ROWS, C2C_FOURSTEP,
    BLUESTEIN_LANE or ENGINE of a float32 C2C of length n over ``batch``
    contiguous rows. The four-step has no batch gate (the JAX package's
    engine.c2c tests it first). A Bluestein length takes the route of its
    sub-FFTs of length M = blue_sub_len(n) over the same rows
    (engine._bluestein): BLUESTEIN_LANE where K10, K8 or the four-step
    takes M, else ENGINE (below 128 rows, or M past the four-step)."""
    if factorize(n) is None:
        route = lane_c2c_route(blue_sub_len(n), batch)
        return BLUESTEIN_LANE if route in _ROW_ROUTES else route
    return _c2c_kernel_route(_lane_c2c(n, batch), n)


def inner_c2c_route(n: int, batch: int, lowering: str) -> str:
    """The route of a lowering whose inner transform is a C2C of length n
    over ``batch`` rows: ``lowering`` where K10, K8 or the four-step takes
    it, else BLUESTEIN_LANE or ENGINE."""
    route = lane_c2c_route(n, batch)
    return lowering if route in _ROW_ROUTES else route


def packed_kernel(h: int, batch: int) -> bool:
    """Whether kernel 15 takes engine.r2c_packed with half length h over
    ``batch`` rows: batch >= 128, at every h the JAX kernel takes
    (rfft._half_fft_consts: the core at h = 128 * F, the dense lane DFT at
    other h <= 256, the generic schedule above)."""
    return batch >= MIN_BATCH and _kernel_ok(h)


def packed_lane(h: int, batch: int) -> str:
    """Route of engine.r2c_packed with half length h (R2C: h = n/2, DCT-I:
    h = n - 1, DST-I: h = n + 1): R2C_PACKED where kernel 15 takes it
    (:func:`packed_kernel`), else the inner C2C's route: R2C_PACKED where
    the four-step takes h (the half-length C2C and the unpack),
    BLUESTEIN_LANE or ENGINE."""
    if packed_kernel(h, batch):
        return R2C_PACKED
    return inner_c2c_route(h, batch, R2C_PACKED)


def r2c_lane_route(n: int, batch: int) -> str:
    """Route of engine.r2c of length n over ``batch`` float32 rows: the row
    pairs' C2C for odd n, kernel 2 at a natural-layout half length (h =
    128 * F, the fixed or the wide core), else kernel 15
    (:func:`packed_lane`)."""
    if n % 2:
        pairs = (batch + 1) // 2 if batch >= 2 else 1
        return inner_c2c_route(n, pairs, R2C_ROWPAIR)
    if batch >= MIN_BATCH and _nat_f(n) is not None:
        return R2C_NAT
    return packed_lane(n // 2, batch)


def c2r_lane_route(n: int, batch: int) -> str:
    """Route of engine.c2r to length n over ``batch`` complex64 rows: kernel
    3 at a natural-layout half length (the radix row core), else the
    Hermitian extension's C2C."""
    if n == 1:
        return ENGINE
    if batch >= MIN_BATCH and _nat_f(n) is not None:
        return C2R_NAT
    return inner_c2c_route(n, batch, C2R_LANE)
