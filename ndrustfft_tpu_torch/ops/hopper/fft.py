"""The C2C kernels on complex64.

* Kernel 1, :func:`c2c_axis_mid`: C2C along the middle axis of (B, n, L),
  n = 128 * F, on an (n, C) column tile of the mixed-radix core, kernel
  6's kernel (``csrc/fft_mid_radix.cu``; replaces the JAX package's
  ``ops/pallas/fft.py::_kernel_axis_mid_bts2``).
* Kernel 10, :func:`c2c_rows`: C2C of contiguous (T, n) rows, n = 128 * F,
  at every F on the mixed-radix Stockham row core (``csrc/fft_rows_radix.cu``
  and ``csrc/fft_radix.cuh``; replaces ``fft.py::_kernel_twostep``).
* Kernel 4, :func:`c2c_dense_mid`: C2C of length n <= 512 along the middle
  axis of (B, n, L) (the JAX package's dense DFT-n body), on kernel 6's
  column tile of the radix core with up to 32 columns a tile
  (``csrc/fft_mid_radix.cu``; replaces ``fft.py::_kernel_axis_mid_dense``).
* Kernel 8, :func:`c2c_dense_rows` (n <= 256, the JAX package's dense lane
  DFT) and :func:`c2c_generic_rows` (256 < n <= 20480, its generic
  schedule): C2C along contiguous (T, n) rows on the mixed-radix row core
  (``csrc/fft_rows_radix.cu``; replaces ``fft.py::_kernel_lane_last``).
  Kernel 6, :func:`c2c_generic_mid`: C2C along the middle axis of (B, n, L)
  at the lengths of the JAX package's generic two-factor schedule n = m * f
  (f = :func:`lane_factor` (n)), on an (n, C) column tile of the radix core
  (``csrc/fft_mid_radix.cu``; replaces ``fft.py::_kernel_axis_mid``).
* Kernel 11, :func:`c2c_blue_mid`: Bluestein's chirp-z C2C along the
  middle axis of (B, n, L) for a length n with a prime factor above 128,
  fused into one pass: the chirped column zero-padded to M = 128 * F, the
  FFT_M, the product with H, the inverse and the exit chirp, on an (M, C)
  column tile of the mixed-radix core at every F (``csrc/fft_blue_radix.cu``;
  replaces ``fft.py::_kernel_axis_mid_blue``).
* Kernels 7 and 13, :func:`fourstep_mid` and :func:`rows_store_t`: the two
  passes of the four-step long C2C (``ops/engine.py::_fourstep``). Kernel 7
  is the C2C of length n1 along dim 1 of the (B, n1, n2) view times the
  exit twiddle W_n^{k1 t2}: kernel 1's radix column tile with the twiddle
  in an epilogue wherever n1 has a radix plan, the dense product (the
  twiddle in its epilogue) at the primes 131 ... 251
  (``csrc/fft_fourstep.cu``, ``csrc/fft_dense.cu``; replaces
  ``fft.py::_kernel_exit_mul``). Kernel 13 is the row C2C of length
  n2 = 128 * F on the radix row core with the scale and a transposed store,
  (B, n2, n1), in an epilogue (``csrc/fft_fourstep.cu``; replaces
  ``fft.py::_kernel_lane_store_t``).
* Kernel 14, :func:`spectral_c2c_mid`: the fused pipeline IFFT(H * FFT(x))
  along the middle axis of (B, n, L), n = 128 * F: kernel 1's radix column
  tile with two transforms and the diagonal multiply in between, the
  inverse on the sign +1 table (``csrc/spectral_c2c_radix.cu``; replaces
  ``fft.py::_spectral_c2c_kernel_mid``).

This module holds their host-built constants, their plain PyTorch versions
and their wrappers, whose ``launches`` attributes count kernel launches
(kernel 7 its radix and dense launches, in ``radix_launches`` and
``dense_launches``; kernels 1, 10, 8, 6, 4, 11 and 13 count every launch
of ``c2c_axis_mid``, ``c2c_rows``, ``c2c_dense_rows``,
``c2c_generic_mid``, ``c2c_dense_mid``, ``c2c_blue_mid`` and
``rows_store_t`` in ``radix_launches`` beside ``launches``; kernel 14 has
one form, counted in ``launches``).
"""

from __future__ import annotations

import bisect
import ctypes
from collections import OrderedDict
from functools import lru_cache

import numpy as np
import torch

from ...plan import blue_h, chirp, dft_matrix, factorize, prime_factors, stage_twiddle
from . import _build

M = 128                 # stage-2 DFT length of the core
# the butterfly factors of the retired bts2 fixed core (of a real, of a
# complex tile): the censuses and tests still split the lengths by them
CORE_F = (2, 4, 8, 16)
C2C_F = (4, 8, 16)
DENSE_MAX_N = 512       # longest transform kernels 4 and 8 take
GENERIC_MAX_N = 20480   # the JAX package's kernel bound (fft._LIVE_COPIES)
GENERIC_MAX_M = 224     # longest DFT-m of the JAX package's generic schedule (its gate)
GENERIC_SMEM = 96 * 1024    # a wide-core block's tile when a transform fits (2 blocks/SM)
MAX_SMEM = 232448           # the most dynamic shared memory a block may use
WIDE_SLOTS = 4              # planes per group of the wide core (bts2_wide.cuh)
WIDE_MAX_C = 16             # transforms per tile of the wide core
WQ_CACHE_BYTES = 256 << 20  # device tables kept (Wq 32 MB at n = 32768, exit twiddle 32 MB at 2^22)
WIDE_MAX_F = GENERIC_MAX_N // M   # 160: the wide core's largest factor on a complex tile
REAL_MAX_F = 256            # ... and on a real tile (csrc/bts2_wide.cuh::kWideMaxF)


def core_f(n: int):
    """The butterfly factor F of n = 128 * F where the bts2 core (fixed or
    wide) takes n: 128 <= n <= 20480 with a plan (prime factors <= 128), as
    the JAX package's kernel gate and twostep split take it; else None."""
    if n % M or not M <= n <= GENERIC_MAX_N or factorize(n) is None:
        return None
    return n // M


def bts2_consts(n: int, sign: int, scale: float = 1.0):
    """(F, m, m) float32 (re, im) of the twiddle-folded stage-2 matrices
    Wq[q][b][p'] = W_n^{q b} * W_m^{b p'} * scale, m = 128, F = n / m.

    Built in float64 by the same expression as the JAX package's
    ``_bts2_consts`` (mode "highest") and rounded once, so the two tables are
    bit-identical."""
    f = n // M
    tw_r, tw_i = stage_twiddle(f, M, sign)         # [q, b]
    wm_r, wm_i = dft_matrix(M, sign)               # [b, p']
    re = np.empty((f, M, M), np.float32)
    im = np.empty((f, M, M), np.float32)
    for q in range(f):
        cr = tw_r[q][:, None] * wm_r - tw_i[q][:, None] * wm_i
        ci = tw_r[q][:, None] * wm_i + tw_i[q][:, None] * wm_r
        re[q] = np.asarray(cr * scale, np.float32)
        im[q] = np.asarray(ci * scale, np.float32)
    return re, im


def lru_table(cache: OrderedDict, key, build, limit: int) -> torch.Tensor:
    """``cache[key]``, built by ``build()`` if missing, from a cache of the
    most recently used tables that holds at most ``limit`` bytes (and
    always the newest table). A hit costs O(1); a miss counts the bytes
    held."""
    t = cache.pop(key, None)
    if t is not None:
        cache[key] = t
        return t
    t = cache[key] = build()
    held = sum(v.numel() * v.element_size() for v in cache.values())
    while held > limit and len(cache) > 1:
        _, old = cache.popitem(last=False)
        held -= old.numel() * old.element_size()
    return t


_WQ_CACHE: OrderedDict = OrderedDict()


def device_wq(n: int, sign: int, scale: float, device: torch.device) -> torch.Tensor:
    """:func:`bts2_consts` as a (F, m, m) complex64 tensor on ``device``,
    from a cache of at most WQ_CACHE_BYTES (:func:`lru_table`)."""
    return lru_table(_WQ_CACHE, (n, sign, scale, device),
                     lambda: pair_tensor(bts2_consts(n, sign, scale), device), WQ_CACHE_BYTES)


def wide_consts(n: int, sign: int):
    """(F, F) float32 (re, im) of the stage-1 DFT-F, F = n / 128, C-contiguous:
    the JAX package's ``_bts2_consts`` Wf, built in float64 by the same
    expression and rounded once (the stage-2 scale rides Wq, not Wf). Its
    phase is reduced mod F, so entry (a, q) is entry (1, (a q) mod F) bit
    for bit: the wide core reads row 1."""
    re, im = dft_matrix(n // M, sign)
    return np.ascontiguousarray(re, np.float32), np.ascontiguousarray(im, np.float32)


@lru_cache(maxsize=64)
def device_wide(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """:func:`wide_consts` as a (F, F) complex64 tensor on ``device``."""
    re, im = wide_consts(n, sign)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def bts2_plain(x: torch.Tensor, wq: torch.Tensor, sign: int) -> torch.Tensor:
    """Plain version of the core (fixed or wide): the length-n transform
    along dim 1 of a (B, n, L) complex tensor, n = F * m, with stage-2
    constants ``wq``.

    Stage 1 is the F-point DFT over the leading planes a (t = a*m + b),
    stage 2 the per-q product with Wq, and the (p', q) order of the result
    is k = q + F*p'."""
    nb, n, cols = x.shape
    f = wq.shape[0]
    y = torch.einsum("aq,bamc->bqmc", device_wide(n, sign, x.device),
                     x.reshape(nb, f, M, cols))
    z = torch.einsum("qmp,bqmc->bpqc", wq, y)
    return z.reshape(nb, n, cols)


@lru_cache(maxsize=8)
def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wide_bytes(n: int, c: int) -> int:
    """Dynamic shared memory of a wide-core tile of ``c`` transforms of
    length n (csrc/bts2_wide.cuh::wide_smem_bytes): the tile, the Y scratch
    of WIDE_SLOTS planes and the row W_F^k."""
    return 8 * (c * (n + WIDE_SLOTS * M) + n // M)


def wide_real_bytes(n: int, c: int) -> int:
    """Dynamic shared memory of a wide-core tile of ``c`` real transforms
    of length n (csrc/bts2_wide.cuh::wide_real_smem_bytes): the tile of
    floats, the Y scratch and two rows of F values (W_F^k and a chirp)."""
    return 4 * c * n + 8 * (c * WIDE_SLOTS * M + 2 * (n // M))


def wide_block(n: int, groups: int, count: int, sms: int, nbytes=wide_bytes) -> int:
    """Transforms per tile of the wide core: the largest power of two up to
    WIDE_MAX_C whose tile (``nbytes(n, c)``) fits GENERIC_SMEM (two blocks
    per SM; at least one transform, up to MAX_SMEM: a complex tile at
    n = 20480, a real one at n = 32768), halved
    while the grid of ``groups`` times the tiles would leave SMs idle. The
    kernels spread the ``count`` transforms evenly over the tiles."""
    c = WIDE_MAX_C
    while c > 1 and nbytes(n, c) > GENERIC_SMEM:
        c //= 2
    while c > 1 and groups * -(-count // c) < sms:
        c //= 2
    return c


def dense_tile(n: int, nb: int, cols: int, sms: int) -> int:
    """Micro-tile of the dense products (kernel 7's dense body, kernels 27,
    20 and 21): 8 (128 x 128 block tiles) when that grid gives every SM two
    blocks, else 4 (64 x 64)."""
    blocks = -(-n // 128) * -(-cols // 128) * nb
    return 8 if blocks >= 2 * sms else 4


def check_cuda(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.requires_grad:
        raise NotImplementedError(
            f"{what}: the CUDA kernels have no backward yet (ROADMAP.md §1, "
            "autograd)")


def check_core_n(n: int, what: str) -> int:
    """F of n = 128 * F where the bts2 core takes n (:func:`core_f`), or
    raise."""
    f = core_f(n)
    if f is None:
        raise ValueError(f"{what}: n={n} is not 128 * F with a twostep split and a "
                         f"plan (128 <= n <= {GENERIC_MAX_N}, prime factors <= 128)")
    return f


# --------------------------------------------------------------------------
# Kernel 10: C2C of contiguous rows of n = 128 * F
# --------------------------------------------------------------------------


def _bts2_rows_plain(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """The bts2 core's plain version on the rows of a (T, n) tensor, n = 128
    * F, on a (T, n, 1) view with the core's constants (the bts2 row tile's
    arithmetic, which tests hold the radix core against)."""
    t, n = x.shape
    s = 1.0 if scale is None else float(scale)
    return bts2_plain(x.reshape(t, n, 1), device_wq(n, sign, s, x.device),
                      sign).reshape(t, n)


def _check_rows(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what}: expected (T, n), got {tuple(x.shape)}")


def c2c_rows(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C of the rows of a (T, n) complex64 tensor, n = 128 * F
    (:func:`core_f`), times ``scale``. A CPU tensor runs the plain version
    (:func:`c2c_rows_plain`); a CUDA tensor launches kernel 10 on the
    mixed-radix row core, counted in ``launches`` and ``radix_launches``, or
    raises."""
    _check_rows(x, "c2c_rows")
    t, n = x.shape
    check_core_n(n, "c2c_rows")
    if x.device.type == "cpu":
        return c2c_rows_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_rows: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "c2c_rows")
    y = _radix_launch(x, sign, scale, "c2c_rows")
    c2c_rows.launches += t > 0
    c2c_rows.radix_launches += t > 0
    return y


c2c_rows.launches = 0
c2c_rows.radix_launches = 0


# --------------------------------------------------------------------------
# The mixed-radix Stockham core (rows: kernels 10 and 8, kernels 2 and 15;
# columns: kernels 11, 6 and 4)
# --------------------------------------------------------------------------

RADIX_CODELETS = (16, 8, 4, 2, 9, 3, 5, 7)  # radices the kernel runs in registers
RADIX_MAX_P = 127           # the largest prime stage (a generic odd-p codelet)
RADIX_MAX_STAGES = 8        # csrc/fft_radix.cuh::kRadixMaxStages
RADIX_SMALL_TILE = 512      # complex elements of a block's tile of rows of n <= 256
RADIX_IDLE_LANES = 8        # above n = 256, a block leaves idle at most 1 lane in 8
RADIX_WIDE_N = 4096         # above it, one row a block (csrc/fft_radix.cuh)
RADIX_MAX_THREADS = 256     # threads of a block up to RADIX_WIDE_N, 16 elements each
RADIX_MAX_ELEMS = 20480     # elements of a block's tile: 512 threads of 40 (csrc/fft_radix.cuh)


@lru_cache(maxsize=None)
def radix_plan(n: int):
    """The stages of the radix core at n, in the order the kernel runs them:
    16 while 16 divides the power of two, then one 8, 4 or 2 for the rest of
    it; a 9 for each pair of 3s and a 3 for the last odd one; each 5 and 7;
    then each prime 11 <= p <= 127 as a stage of its own, ascending. None
    where n has a prime factor above 127 or needs more than
    RADIX_MAX_STAGES stages (no length that the two routes send)."""
    if n < 2:
        return None
    pf = prime_factors(n)
    if max(pf) > RADIX_MAX_P:
        return None
    e2, c3 = pf.count(2), pf.count(3)
    plan = [16] * (e2 // 4) + ([1 << (e2 % 4)] if e2 % 4 else [])
    plan += [9] * (c3 // 2) + [3] * (c3 % 2)
    plan += [p for p in pf if p in (5, 7)] + [p for p in pf if p > 7]
    return tuple(plan) if len(plan) <= RADIX_MAX_STAGES else None


def dense_beats_radix(n: int) -> bool:
    """Whether a dense product of the whole column is faster than the radix
    column tile at the transform length n, where a kernel offers both
    (kernel 21 at odd n, kernel 27's DCT-I at n - 1): n >= 23 with a prime
    stage p >= 11, and n < 128 or n <= 3 p. The radix core spends about p
    operations an element on a prime stage, the product about n; below 128
    the product's tile is the same for every n. Fitted to
    ``time_kernels.py --route-dense`` on an H100 at 2^23 reals a call:
    summed over every length with a plan, the routes it gives took within
    0.6% of the faster kernel's time, against 4-5% for the plan alone
    (n = 129 = 3 * 43: 0.233 ms radix, 0.207 dense; n = 215 = 5 * 43: 0.98x;
    n = 387 = 9 * 43: 0.54x)."""
    plan = radix_plan(n)
    p = max((r for r in plan if r not in RADIX_CODELETS), default=0) if plan else 0
    return n >= 23 and p >= 11 and (n < 128 or n <= 3 * p)


def radix_consts(n: int, sign: int):
    """float32 (re, im) of the radix core's table at (n, sign), each entry
    built in float64 and rounded once. Entries 0 ... n - 2 are the stage
    twiddles: the stage of radix r after the stages whose radices multiply
    to L holds W_{rL}^{j k} (1 <= j < r, 0 <= k < L) at L - 1 + (j - 1) L +
    k, so stage i starts at L - 1 and the stages fill n - 1 entries. Entry
    n - 1 is 1. After it, each prime stage p >= 11 holds its coefficient
    row W_p^u, 0 <= u < p."""
    plan = radix_plan(n)
    re, im = [], []
    lead = 1
    for r in plan:
        tr, ti = stage_twiddle(r, lead, sign)
        re.append(tr[1:].ravel())
        im.append(ti[1:].ravel())
        lead *= r
    re.append(np.ones(1))
    im.append(np.zeros(1))
    for p in plan:
        if p not in RADIX_CODELETS:
            wr, wi = dft_matrix(p, sign)
            re.append(wr[1])
            im.append(wi[1])
    return np.concatenate(re).astype(np.float32), np.concatenate(im).astype(np.float32)


def device_radix(n: int, sign: int, device: torch.device) -> torch.Tensor:
    """:func:`radix_consts` as a complex64 tensor on ``device``, kept in the
    one device-table cache (:func:`device_wq`)."""
    return lru_table(_WQ_CACHE, ("radix", n, sign, device),
                     lambda: pair_tensor(radix_consts(n, sign), device), WQ_CACHE_BYTES)


@lru_cache(maxsize=64)
def _radix_dft(r: int, sign: int, device: torch.device) -> torch.Tensor:
    """The (r, r) DFT-r matrix of a codelet, complex64, rounded once."""
    return pair_tensor(dft_matrix(r, sign), device)


def c2c_radix_rows_plain(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """Plain version of the radix core: the C2C of each row of a (T, n)
    tensor, times ``scale``, stage by stage as the kernel runs it, on the
    same plan and table. A stage of radix r after the stages whose radices
    multiply to L takes the row as (r, Q, L) [j, q, k] with Q = n / (r L),
    multiplies by its twiddles W_{rL}^{j k}, and writes
    y[q, m, k] = sum_j u[j, q, k] W_r^{j m} as the row (Stockham, natural
    order after the last stage). A prime stage's DFT-p is its coefficient
    row from the table (W_p^{(j m) mod p}); the codelets' DFT-r is the
    matrix rounded once."""
    t, n = x.shape
    table = device_radix(n, sign, x.device)
    plan = radix_plan(n)
    lead = 1
    primes = n
    for r in plan:
        tw = torch.cat([table.new_ones(1, lead),
                        table[lead - 1:lead - 1 + (r - 1) * lead].reshape(r - 1, lead)])
        if r not in RADIX_CODELETS:
            row = table[primes:primes + r]
            primes += r
            idx = torch.arange(r, device=x.device)
            dft = row[(idx[:, None] * idx[None, :]) % r]
        else:
            dft = _radix_dft(r, sign, x.device)
        u = x.reshape(t, r, n // (r * lead), lead) * tw[:, None, :]
        x = torch.einsum("jm,tjqk->tqmk", dft, u).reshape(t, n)
        lead *= r
    return x if scale is None else x * float(scale)


c2c_rows_plain = c2c_radix_rows_plain   # kernel 10 runs the radix core at every F


def radix_block(n: int, count: int, sms: int) -> int:
    """Rows per block of the radix core. A thread holds 16 elements up to
    RADIX_WIDE_N, so a row takes tr = ceil(n / 16) threads and a block at
    most RADIX_MAX_THREADS; above it a block holds one row. At n <= 256 a
    block takes as many rows as RADIX_SMALL_TILE elements hold; above, the
    fewest rows whose r * tr threads leave at most one lane in
    RADIX_IDLE_LANES of the block's warps idle (else the count that leaves
    the smallest share idle). Then the count is halved while the grid would
    leave SMs idle, and spread evenly over the tiles so that a ragged last
    tile is as full as the others.

    (Timed on an H100 over 2^27 elements with each count that fits,
    ``time_kernels.py --scan-rows``: a block of few warps ends its stages'
    barriers sooner, and idle lanes waste its warps' issue slots. The rule's
    count ran fastest, or within 5% of it, at n = 264 ... 2048 and
    h = 128 ... 1024, and up to 22% faster than the 2560-element tiles it
    replaced at n = 384, 512, 768; at n = 256, 2 rows a block ran 10%
    faster than 10.)"""
    tr = -(-n // 16)
    if n > RADIX_WIDE_N:
        rows = 1
    elif n <= 256:
        rows = max(1, min(RADIX_SMALL_TILE // n, RADIX_MAX_THREADS // tr))
    else:
        fits = range(1, RADIX_MAX_THREADS // tr + 1)
        idle = [idle_lanes(r * tr) for r in fits]
        rows = next((r for r, f in zip(fits, idle) if f <= 1 / RADIX_IDLE_LANES),
                    fits[idle.index(min(idle))])
    return spread_rows(rows, count, sms)


def idle_lanes(threads: int) -> float:
    """The share of a block's warp lanes that ``threads`` threads leave idle."""
    return (-threads % 32) / (32 * -(-threads // 32))


def spread_rows(rows: int, count: int, sms: int) -> int:
    """``rows`` a block, halved while the grid of ``count`` rows would leave
    SMs idle, then spread evenly over the tiles so that a ragged last tile
    is as full as the others."""
    while rows > 1 and -(-count // rows) < sms:
        rows //= 2
    return -(-count // -(-count // rows))


def _radix_launch(x: torch.Tensor, sign: int, scale, what: str, rows=None) -> torch.Tensor:
    """Launch the radix core on the (T, n) complex64 rows of x, ``rows`` a
    block (by default :func:`radix_block`)."""
    t, n = x.shape
    plan = radix_plan(n)
    table = device_radix(n, sign, x.device)
    y = torch.empty_like(x)
    if t == 0:
        return y
    rows = rows or radix_block(n, t, num_sms(x.device))
    stages = (ctypes.c_int * RADIX_MAX_STAGES)(*plan)
    with torch.cuda.device(x.device):
        err = _build.lib().ndfft_c2c_rows_radix(
            x.data_ptr(), y.data_ptr(), table.data_ptr(), stages, len(plan), t, n, rows,
            sign, 1.0 if scale is None else float(scale),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, what)
    return y


# --------------------------------------------------------------------------
# Kernel 7's dense body: the dense DFT product along a middle axis
# --------------------------------------------------------------------------


def dense_consts(n: int, sign: int, scale: float = 1.0) -> np.ndarray:
    """(n, n) complex64 W[t, k] = scale * exp(sign 2 pi i t k / n), each part
    built in float64 and rounded once (the JAX package's dense tables at the
    "highest" tier), in C order. W is symmetric; the kernel reads W[t, k] at
    t * n + k."""
    wr, wi = dft_matrix(n, sign)
    w = np.empty((n, n), np.complex64)
    w.real = wr * scale
    w.imag = wi * scale
    return np.ascontiguousarray(w)


@lru_cache(maxsize=64)
def _device_dense(n: int, sign: int, scale: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dense_consts(n, sign, scale)).to(device)


def dense_body_plain(x: torch.Tensor, sign: int) -> torch.Tensor:
    """Plain version of kernel 7's dense body without its twiddle:
    Y[b, k, c] = sum_t W[k, t] X[b, t, c] (the JAX package's dense body)."""
    return torch.einsum("kt,btc->bkc", _device_dense(x.shape[1], sign, 1.0, x.device), x)


def _dense_launch(x: torch.Tensor, sign: int, tw: torch.Tensor) -> torch.Tensor:
    """Launch kernel 7's dense body on the (B, n1, n2) tensor x, times its
    (n1, n2) exit twiddle ``tw`` in the epilogue."""
    nb, n, cols = x.shape
    w = _device_dense(n, sign, 1.0, x.device)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    tm = dense_tile(n, nb, cols, num_sms(x.device))
    with torch.cuda.device(x.device):
        err = _build.lib().ndfft_c2c_dense(
            w.data_ptr(), x.data_ptr(), y.data_ptr(), tw.data_ptr(), nb, n, cols, tm,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fourstep_mid")
    return y


# --------------------------------------------------------------------------
# Kernel 8 on the radix row core; kernels 6 (the lengths of the JAX
# package's generic two-factor schedule), 4 (n <= 512) and 1 (n = 128 * F)
# on the radix core's column tile
# --------------------------------------------------------------------------


def c2c_dense_rows(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C of the rows of a (T, n) complex64 tensor, n <= 512 with a
    :func:`radix_plan` (the routes send n <= 256, the JAX package's dense
    lane DFT), times ``scale``. A CPU tensor runs the plain version
    (:func:`c2c_radix_rows_plain`); a CUDA tensor launches kernel 8 on the
    radix row core, counted in ``launches`` and ``radix_launches``, or
    raises."""
    _check_rows(x, "c2c_dense_rows")
    t, n = x.shape
    if not n <= DENSE_MAX_N or radix_plan(n) is None:
        raise ValueError(f"c2c_dense_rows: n={n} is not 2 ... {DENSE_MAX_N} with a radix plan "
                         f"(prime factors <= {RADIX_MAX_P})")
    if x.device.type == "cpu":
        return c2c_radix_rows_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_dense_rows: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "c2c_dense_rows")
    y = _radix_launch(x, sign, scale, "c2c_dense_rows")
    c2c_dense_rows.launches += t > 0
    c2c_dense_rows.radix_launches += t > 0
    return y


c2c_dense_rows.launches = 0
c2c_dense_rows.radix_launches = 0


@lru_cache(maxsize=None)
def lane_factor(n: int):
    """The JAX package's ``fft._lane_factor``: the lane DFT factor f <= 256
    of the generic schedule (m = n / f must factor), or None."""
    if n <= 256:
        return n
    divs = [d for d in range(1, 257) if n % d == 0]
    preds = [lambda d: d % 128 == 0 and d >= 128]
    if n > 1024:
        preds.append(lambda d: d % 8 == 0 and d >= 64)
    preds += [lambda d: d >= 64, lambda d: d > 1]
    for pred in preds:
        for f in sorted((d for d in divs if pred(d)), reverse=True):
            if factorize(n // f) is not None:
                return f
    return None


def generic_split(n: int):
    """(m, f) of the generic schedule at n, or None where the generic
    kernels do not take n (n <= 256, n > 20480, no lane factor, m > 224)."""
    if not 256 < n <= GENERIC_MAX_N:
        return None
    f = lane_factor(n)
    if f is None or n // f > GENERIC_MAX_M:
        return None
    return n // f, f


c2c_generic_rows_plain = c2c_radix_rows_plain   # kernel 8 at n > 256 runs the radix core


def c2c_radix_mid_plain(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """Plain version of the radix core's column tile (kernels 6 and 4): each
    column of the (B, n, L) tensor as a row of :func:`c2c_radix_rows_plain`,
    the radix core's plain version on the kernel's plan and table."""
    nb, n, cols = x.shape
    rows = x.transpose(1, 2).reshape(nb * cols, n)
    y = c2c_radix_rows_plain(rows, sign, scale)
    return y.reshape(nb, cols, n).transpose(1, 2).contiguous()


c2c_generic_mid_plain = c2c_radix_mid_plain     # kernel 6
c2c_dense_mid_plain = c2c_radix_mid_plain       # kernel 4


def mid_radix_launch(x: torch.Tensor, y: torch.Tensor, sign: int, scale: float, c: int,
                     ldg: bool = False) -> None:
    """Launch the radix column tile of kernels 1, 6 and 4, ``c`` columns a
    tile (:func:`radix_mid_cols`), on (B, n, L) complex64 CUDA tensors x and
    y; x loaded through the read-only path if ``ldg``, else evict-first."""
    nb, n, cols = x.shape
    dev = x.device
    plan = radix_plan(n)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_c2c_mid_radix(
            x.data_ptr(), y.data_ptr(), device_radix(n, sign, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), nb, n, cols, c, sign, scale,
            int(ldg), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_c2c_mid_radix")


def _mid_radix(wrapper, x: torch.Tensor, sign: int, scale, tile=None) -> torch.Tensor:
    """``wrapper``'s kernel (1, 6 or 4) on the radix column tile of the
    (B, n, L) CUDA tensor x, counted in its ``launches`` and
    ``radix_launches``; ``tile(n, B, L, sms)`` gives the columns a tile and
    the load (default :func:`radix_mid_cols`, evict-first)."""
    nb, n, cols = x.shape
    check_cuda(x, torch.complex64, wrapper.__name__)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    sms = num_sms(x.device)
    c, ldg = tile(n, nb, cols, sms) if tile else (radix_mid_cols(n, nb, cols, sms), False)
    mid_radix_launch(x, y, sign, 1.0 if scale is None else float(scale), c, ldg)
    wrapper.launches += 1
    wrapper.radix_launches += 1
    return y


def _check_generic_n(n: int, what: str):
    mf = generic_split(n)
    if mf is None or radix_plan(n) is None:
        raise ValueError(f"{what}: n={n} has no generic schedule (256 < n <= "
                         f"{GENERIC_MAX_N}, a lane factor, m <= {GENERIC_MAX_M}) with a "
                         f"radix plan (prime factors <= {RADIX_MAX_P})")
    return mf


def c2c_generic_rows(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C of the rows of a (T, n) complex64 tensor, 256 < n <= 20480 with a
    generic schedule (the lengths the JAX package's lane kernel takes),
    times ``scale``. A CPU tensor runs the plain version; a CUDA tensor
    launches kernel 8 on the radix core or raises."""
    _check_rows(x, "c2c_generic_rows")
    t, n = x.shape
    _check_generic_n(n, "c2c_generic_rows")
    if x.device.type == "cpu":
        return c2c_generic_rows_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_generic_rows: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "c2c_generic_rows")
    y = _radix_launch(x, sign, scale, "c2c_generic_rows")
    c2c_generic_rows.launches += t > 0
    return y


c2c_generic_rows.launches = 0


def c2c_generic_mid(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C along dim 1 of a (B, n, L) complex64 tensor, 256 < n <= 20480 with
    a generic schedule (the lengths the JAX package's middle-axis kernel
    runs on it), times ``scale``. A CPU tensor runs the plain version; a
    CUDA tensor launches kernel 6 on the radix core's column tile, counted
    in ``launches`` and ``radix_launches``, or raises."""
    if x.dim() != 3:
        raise ValueError(f"c2c_generic_mid: expected (B, n, L), got {tuple(x.shape)}")
    _check_generic_n(x.shape[1], "c2c_generic_mid")
    if x.device.type == "cpu":
        return c2c_generic_mid_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_generic_mid: unsupported device {x.device}")
    return _mid_radix(c2c_generic_mid, x, sign, scale)


c2c_generic_mid.launches = 0
c2c_generic_mid.radix_launches = 0


def c2c_dense_mid(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C along dim 1 of a (B, n, L) complex64 tensor, n <= 512 with a
    :func:`radix_plan` (the routes send n <= 256, and n <= 512 without a
    {128, 256} split: the JAX package's dense body), times ``scale``. A CPU
    tensor runs the plain version (:func:`c2c_radix_mid_plain`); a CUDA
    tensor launches kernel 4 on the radix core's column tile, counted in
    ``launches`` and ``radix_launches``, or raises."""
    if x.dim() != 3:
        raise ValueError(f"c2c_dense_mid: expected (B, n, L), got {tuple(x.shape)}")
    n = x.shape[1]
    if not n <= DENSE_MAX_N or radix_plan(n) is None:
        raise ValueError(f"c2c_dense_mid: n={n} is not 2 ... {DENSE_MAX_N} with a radix plan "
                         f"(prime factors <= {RADIX_MAX_P})")
    if x.device.type == "cpu":
        return c2c_dense_mid_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_dense_mid: unsupported device {x.device}")
    return _mid_radix(c2c_dense_mid, x, sign, scale)


c2c_dense_mid.launches = 0
c2c_dense_mid.radix_launches = 0


c2c_axis_mid_plain = c2c_radix_mid_plain        # kernel 1


AXIS_MID_COLS = 4       # kernel 1's columns a tile above n = 1024, up to 5120


def axis_mid_tile(n: int, groups: int, cols: int, sms: int):
    """Kernel 1's columns a tile and load at n = 128 * F: up to n = 1024
    :func:`radix_mid_cols` (the 16-element form: 8 columns at n <= 512, 4
    to 1024); above it AXIS_MID_COLS columns in the 32- or 40-element form
    up to n = 5120, then 2 to n = 8192 and 1 above (no 40-element tile of
    two columns); halved while the grid would leave SMs idle; the read-only
    load at C <= 2, evict-first above. (On an H100, chip_smoke.py phase 5
    and time_kernels.py --scan-cols: at n = 2048 and 4096 four columns ran
    2.4x and 3.3x faster than radix_mid_cols's 2 and 1, the 16-element
    form; at n = 10240 one column 2-12% faster than two in the 40-element
    form; at C <= 2 the read-only load faster than evict-first in 66 of 71
    cases, by up to 28%: the neighbouring tiles re-read the rest of each
    32-byte sector.)"""
    if n <= RADIX_WIDE_N // 4:
        c = radix_mid_cols(n, groups, cols, sms)
    else:
        c = AXIS_MID_COLS if n * AXIS_MID_COLS <= RADIX_MAX_ELEMS else 2 if 2 * n <= 16384 else 1
        while c > 1 and groups * -(-cols // c) < sms:
            c //= 2
    return c, c <= 2


def c2c_axis_mid(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C along dim 1 of a (B, n, L) complex64 tensor, n = 128 * F
    (:func:`core_f`: the lengths with the JAX package's twostep split),
    times ``scale``. A CPU tensor runs the plain version
    (:func:`c2c_radix_mid_plain`); a CUDA tensor launches kernel 1 on the
    radix core's column tile, counted in ``launches`` and
    ``radix_launches``, or raises."""
    if x.dim() != 3:
        raise ValueError(f"c2c_axis_mid: expected (B, n, L), got {tuple(x.shape)}")
    check_core_n(x.shape[1], "c2c_axis_mid")
    if x.device.type == "cpu":
        return c2c_axis_mid_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_axis_mid: unsupported device {x.device}")
    return _mid_radix(c2c_axis_mid, x, sign, scale, axis_mid_tile)


c2c_axis_mid.launches = 0
c2c_axis_mid.radix_launches = 0


# --------------------------------------------------------------------------
# Kernel 11: Bluestein's chirp-z C2C along a middle axis
# --------------------------------------------------------------------------

BLUE_MAX_M = 16384      # the JAX package's fft._BLUE_MAX_M


def blue_kernel_M(n: int):
    """The JAX package's ``fft.blue_kernel_M``: the convolution length of the
    fused chirp-z at n, 2n - 1 where that is at most 256, else the smallest
    multiple of 128 >= 2n - 1 up to 16384; else None."""
    need = 2 * n - 1
    if need <= 256:
        return need
    mk = -(-need // M) * M
    return mk if mk <= BLUE_MAX_M else None


RADIX_SMOOTH = (2, 3, 5, 7)     # the prime factors of the codelet radices
# picoseconds a point and stage of kernel 20's chirp-z (both length-M
# transforms and the passes around them) by the stage's radix: a least-squares
# fit to time_kernels.py --route-dense on an H100 (every M >= 128 that
# the least 7-smooth rule gave, 2^23 reals a call; within 12% of the
# measured time on average). A radix-16 stage costs half of the others.
CHIRP_STAGE_PS = {16: 6.1, 8: 10.9, 4: 10.8, 2: 9.3, 9: 10.5, 3: 11.5, 5: 7.6, 7: 9.1}


@lru_cache(maxsize=None)
def chirp_m(length: int) -> int:
    """The convolution length of a chirp-z on the radix core at chirp length
    ``length`` (kernel 20's real-input chirp-z, kernel 21's, kernel 15's rows
    and kernel 12's): among the M from 2 length - 1
    to twice that (at most 4096, where a column's tile keeps the 16-element
    form) whose prime factors are all 2, 3, 5 or 7, so that every stage of
    :func:`radix_plan` (M) is a register codelet, the one of least modelled
    time M * sum(CHIRP_STAGE_PS over its stages), the smaller on a tie (131
    -> 288 = 16 * 2 * 9, 547 -> 1280 = 16 * 16 * 5, 1097 -> 2304 = 16 * 16
    * 9). The least such M (270, 1120, 2205 there) ran 1.6x slower summed
    over kernel 20's lengths on an H100: its plans have more and smaller
    stages. Kernel 11's 128 * ceil((2n - 1) / 128) (:func:`blue_kernel_M`)
    is the TPU's lane width."""
    lo = 2 * length - 1
    hi = 2 * lo if lo > 2048 else min(2 * lo, 4096)
    best = None
    top = max(lo, hi)
    smooth = _smooth_lengths(1 << top.bit_length())
    for mk in smooth[bisect.bisect_left(smooth, lo):bisect.bisect_right(smooth, top)]:
        plan = radix_plan(mk)
        if plan is not None:
            cost = mk * sum(CHIRP_STAGE_PS[r] for r in plan)
            if best is None or cost < best[0]:
                best = (cost, mk)
    return best[1]


@lru_cache(maxsize=None)
def _smooth_lengths(top: int):
    """The integers 1 ... top whose prime factors are all in RADIX_SMOOTH,
    ascending."""
    out = [1]
    for p in RADIX_SMOOTH:
        out = [v * p ** e for v in out for e in range(top.bit_length()) if v * p ** e <= top]
    return sorted(out)


# the largest convolution factor F = M / 128 of a length that kernels 11
# and 12 take: the JAX package's fused chirp-z tile of one column within a
# block's shared memory (the first Hopper form's wide tile, 8 (2 M + 512 +
# M / 128) bytes <= MAX_SMEM, held the same bound)
BLUE_MAX_F = 111


def blue_f(n: int):
    """F of the convolution length M = 128 * F where kernels 11 and 12 take
    n: a length above 128 whose blue_kernel_M is at most 128 * BLUE_MAX_F
    (n <= 7104; the routes send F <= 106), else None."""
    mk = blue_kernel_M(n)
    if n <= M or mk is None or mk > M * BLUE_MAX_F:
        return None
    return mk // M


def check_blue_n(n: int, what: str) -> int:
    f = blue_f(n)
    if f is None:
        raise ValueError(f"{what}: n={n} has no fused chirp-z tile (128 < n, "
                         f"M = 128 * ceil((2n - 1) / 128) <= {M * BLUE_MAX_F})")
    return f


def blue_consts(n: int, sign: int, scale: float = 1.0):
    """The JAX package's tables of the fused chirp-z at n, float32 (re, im)
    pairs: the entry and exit chirp exp(sign i pi t^2 / n) (t < n), H =
    FFT_M of the wrapped inverse chirp (M = blue_kernel_M(n)), the forward
    core's Wq (sign -1) and the inverse core's (sign +1, the user scale and
    1/M folded in). Built by the JAX package's ``_blue_consts`` expressions
    in float64 and rounded once, so each is its table bit for bit. Kernel
    11's radix column tile takes the chirp, H and the sign -1
    :func:`radix_consts` of M, which serves both of its transforms."""
    mk = blue_kernel_M(n)
    return (f32_pair(chirp(n, sign)), f32_pair(blue_h(n, sign, mk)),
            bts2_consts(mk, -1, 1.0), bts2_consts(mk, +1, scale / mk))


def f32_pair(pair):
    """A float64 (re, im) pair rounded once to float32."""
    return tuple(np.asarray(v, np.float32) for v in pair)


def pair_tensor(pair, device: torch.device) -> torch.Tensor:
    """A (re, im) pair, each part rounded once to float32, as a complex64
    tensor on ``device``."""
    re, im = f32_pair(pair)
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


@lru_cache(maxsize=64)
def _device_blue(n: int, sign: int, device: torch.device):
    """The chirp and H of :func:`blue_consts` as complex64 tensors on
    ``device``."""
    return (pair_tensor(chirp(n, sign), device),
            pair_tensor(blue_h(n, sign, blue_kernel_M(n)), device))


def chirp_z_radix_plain(xa: torch.Tensor, h: torch.Tensor, scale: float) -> torch.Tensor:
    """The fused chirp-z's convolution on the radix core (kernels 11, 12, 20
    and 21), on the chirped (B, n, L) column xa with M = len(h): each zero-padded
    column as a row, :func:`c2c_radix_rows_plain` forward, times H, the
    inverse with scale / M, rows k < n."""
    nb, n, cols = xa.shape
    mk = h.shape[0]
    pad = torch.cat([xa, xa.new_zeros(nb, mk - n, cols)], dim=1)
    rows = pad.transpose(1, 2).reshape(nb * cols, mk)
    f = c2c_radix_rows_plain(rows, -1) * h
    z = c2c_radix_rows_plain(f, +1, scale / mk)
    return z.reshape(nb, cols, mk)[:, :, :n].transpose(1, 2)


def c2c_blue_mid_plain(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 11 on any device: x a, the convolution on the
    radix core (:func:`chirp_z_radix_plain`), times the exit chirp b = a."""
    n = x.shape[1]
    check_blue_n(n, "c2c_blue_mid")
    a, h = _device_blue(n, sign, x.device)
    s = 1.0 if scale is None else float(scale)
    return chirp_z_radix_plain(x * a[:, None], h, s) * a[:, None]


def radix_cols_threads(mk: int, c: int) -> int:
    """Threads of a radix column tile of ``c`` columns of length mk
    (csrc/fft_blue_radix.cu, csrc/fft_mid_radix.cu): ceil(mk / e) a column,
    e = 16, 32 or 40 elements a thread by the tile's mk c elements, rounded
    up to warps."""
    e = 40 if mk * c > 16384 else 32 if mk * c > RADIX_WIDE_N else 16
    return -(-(c * -(-mk // e)) // 32) * 32


RADIX_MID_MAX_C = 32    # the widest column tile (chip_smoke.py phase 5's scan at n = 4 ... 256)
# kernel 11's columns a tile at the convolution lengths where another count
# than radix_mid_cols's ran fastest on an H100 (chip_smoke.py phase 5 times
# each C at M = 512, 1024, 2048 and 2176)
BLUE_RADIX_COLS = {512: 4, 1024: 2}


def radix_mid_cols(mk: int, groups: int, cols: int, sms: int, most: int = RADIX_MID_MAX_C) -> int:
    """Columns per tile of the radix core's column tiles (kernel 11 at
    convolution length mk, kernels 6 and 4 at n = mk): up to 4096 the
    largest power of two up to ``most`` whose tile stays in the 16-element
    form (at most RADIX_WIDE_N elements in RADIX_MAX_THREADS threads of 80
    registers, several blocks an SM: 8 columns or fewer from mk = 384 on,
    at least 16 at kernel 4's n <= 256, so that a tile row is a 128-byte
    line or more); above it the largest whose tile holds at most
    RADIX_MAX_ELEMS elements in 512 threads (32 or 40 elements a thread,
    one block an SM; one column above 10240); halved while the grid of
    ``groups`` times the tiles would leave SMs idle. (On an H100, at kernel
    11's M = 2176 one column a tile in the 16-element form ran faster than
    2, 4 or 8 columns in the 32- or 40-element form, whose 128 registers a
    thread leave one block an SM; at kernel 6's n = 600 four columns, a
    32-byte sector a tile row, ran fastest and one column 1.7x slower; at
    kernel 4's n <= 8 sixteen columns, blocks of a warp or less, ran up to
    1.8x slower than 32: chip_smoke.py's phase 5 times each C at the
    kernels' main shapes.)"""
    small = mk <= RADIX_WIDE_N
    limit = RADIX_WIDE_N if small else RADIX_MAX_ELEMS
    threads = RADIX_MAX_THREADS if small else 2 * RADIX_MAX_THREADS
    c = most
    while c > 1 and (mk * c > limit or radix_cols_threads(mk, c) > threads):
        c //= 2
    while c > 1 and groups * -(-cols // c) < sms:
        c //= 2
    return c


def blue_radix_cols(mk: int, groups: int, cols: int, sms: int) -> int:
    """Columns per tile of kernel 11 at convolution length mk:
    :func:`radix_mid_cols`, at most BLUE_RADIX_COLS[mk] where that holds
    one."""
    return radix_mid_cols(mk, groups, cols, sms, BLUE_RADIX_COLS.get(mk, RADIX_MID_MAX_C))


def blue_radix_launch(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                      scale: float, c: int) -> None:
    """Launch kernel 11's radix column tile, ``c`` columns a tile
    (:func:`blue_radix_cols`), on (B, n, L) complex64 CUDA tensors x and y
    with the chirp a and H (:func:`_device_blue`)."""
    nb, n, cols = x.shape
    dev = x.device
    mk = h.shape[0]
    plan = radix_plan(mk)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_c2c_blue_radix(
            x.data_ptr(), y.data_ptr(), a.data_ptr(), h.data_ptr(),
            device_radix(mk, -1, dev).data_ptr(), (ctypes.c_int * RADIX_MAX_STAGES)(*plan),
            len(plan), nb, n, mk, cols, c, scale / mk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_c2c_blue_radix")


def c2c_blue_mid(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """C2C of Bluestein length n along dim 1 of a (B, n, L) complex64 tensor
    (:func:`blue_f`), times ``scale``, as one fused chirp-z pass. A CPU
    tensor runs the plain version; a CUDA tensor launches kernel 11 on the
    radix core's column tile, counted in ``launches`` and
    ``radix_launches``, or raises."""
    if x.dim() != 3:
        raise ValueError(f"c2c_blue_mid: expected (B, n, L), got {tuple(x.shape)}")
    nb, n, cols = x.shape
    f = check_blue_n(n, "c2c_blue_mid")
    if x.device.type == "cpu":
        return c2c_blue_mid_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"c2c_blue_mid: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "c2c_blue_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    a, h = _device_blue(n, sign, x.device)
    blue_radix_launch(x, y, a, h, 1.0 if scale is None else float(scale),
                      blue_radix_cols(f * M, nb, cols, num_sms(x.device)))
    c2c_blue_mid.launches += 1
    c2c_blue_mid.radix_launches += 1
    return y


c2c_blue_mid.launches = 0
c2c_blue_mid.radix_launches = 0


# --------------------------------------------------------------------------
# Kernels 7 and 13: the four-step long C2C
# --------------------------------------------------------------------------

FOURSTEP_MAX_N1 = 4096      # the JAX package's fft._FOURSTEP_MAX_N1 (kernel 7's n1)
FOURSTEP_MAX_N2 = 16384     # fft._FOURSTEP_MAX_N2 (kernel 13's n2)


def fourstep_form(n1: int):
    """The form of kernel 7 at n1: "radix" (the radix column tile) wherever
    n1 has a :func:`radix_plan`, "dense" (the dense product, the JAX
    package's dense body) at the other n1 <= 256 (the primes 131 ... 251,
    and n1 = 1); None at the n1 that the four-step does not send (neither
    <= 256 nor 128 * F <= 4096 with a twostep split)."""
    if not 1 <= n1 <= FOURSTEP_MAX_N1 or n1 > 256 and core_f(n1) is None:
        return None
    return "radix" if radix_plan(n1) else "dense"


def fourstep_tw(n1: int, n2: int, sign: int):
    """(n1, n2) float32 (re, im) of the four-step's exit twiddle
    W_n^{k1 t2}, n = n1 n2: the JAX package's ``_add_exit_tw`` constants,
    ``stage_twiddle(n1, n2, sign)`` with each part rounded once."""
    return f32_pair(stage_twiddle(n1, n2, sign))


def device_fourstep_tw(n1: int, n2: int, sign: int, device: torch.device) -> torch.Tensor:
    """:func:`fourstep_tw` as a (n1, n2) complex64 tensor on ``device``, kept
    beside the Wq tables in the one device-table cache (:func:`device_wq`)."""
    return lru_table(_WQ_CACHE, ("tw", n1, n2, sign, device),
                     lambda: pair_tensor(fourstep_tw(n1, n2, sign), device), WQ_CACHE_BYTES)


def _check_fourstep_n1(n1: int, what: str) -> str:
    form = fourstep_form(n1)
    if form is None:
        raise ValueError(f"{what}: n1={n1} is neither <= 256 nor 128 * F <= "
                         f"{FOURSTEP_MAX_N1} with a plan")
    return form


def fourstep_mid_plain(x: torch.Tensor, sign: int) -> torch.Tensor:
    """Plain version of kernel 7: the radix core's plain version along dim 1
    (:func:`c2c_radix_mid_plain`, unscaled) where n1 has a plan, else the
    dense product's (:func:`dense_body_plain`), times the exit twiddle."""
    nb, n1, n2 = x.shape
    y = c2c_radix_mid_plain(x, sign) if radix_plan(n1) else dense_body_plain(x, sign)
    return y * device_fourstep_tw(n1, n2, sign, x.device)


def fourstep_launch(x: torch.Tensor, y: torch.Tensor, sign: int, tw: torch.Tensor, c: int,
                    ldg: bool) -> None:
    """Launch kernel 7's radix column tile, ``c`` columns a tile, on the
    (B, n1, n2) complex64 CUDA tensors x and y with the exit twiddle ``tw``;
    x loaded through the read-only path if ``ldg``."""
    nb, n1, n2 = x.shape
    dev = x.device
    plan = radix_plan(n1)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_fourstep_mid(
            x.data_ptr(), y.data_ptr(), device_radix(n1, sign, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), tw.data_ptr(), nb, n1, n2, c,
            sign, int(ldg), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fourstep_mid")


def fourstep_mid(x: torch.Tensor, sign: int) -> torch.Tensor:
    """Step 1+2 of the four-step: the unscaled C2C along dim 1 of a
    (B, n1, n2) complex64 tensor, times W_n^{k1 t2} with n = n1 n2. A CPU
    tensor runs the plain version; a CUDA tensor launches kernel 7 or
    raises: at every n1 with a plan the radix column tile with the twiddle
    in its epilogue, columns a tile and load by kernel 1's rule
    (:func:`axis_mid_tile`), counted in ``radix_launches``; at the primes
    131 ... 251 the dense product, counted in ``dense_launches``.
    ``launches`` counts both."""
    if x.dim() != 3:
        raise ValueError(f"fourstep_mid: expected (B, n1, n2), got {tuple(x.shape)}")
    nb, n1, n2 = x.shape
    form = _check_fourstep_n1(n1, "fourstep_mid")
    if x.device.type == "cpu":
        return fourstep_mid_plain(x, sign)
    if x.device.type != "cuda":
        raise ValueError(f"fourstep_mid: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "fourstep_mid")
    tw = device_fourstep_tw(n1, n2, sign, x.device)
    if form == "dense":
        y = _dense_launch(x, sign, tw)
    else:
        y = torch.empty_like(x)
        if x.numel() == 0:
            return y
        fourstep_launch(x, y, sign, tw, *axis_mid_tile(n1, nb, n2, num_sms(x.device)))
    if x.numel():
        fourstep_mid.launches += 1
        fourstep_mid.radix_launches += form == "radix"
        fourstep_mid.dense_launches += form == "dense"
    return y


fourstep_mid.launches = 0
fourstep_mid.radix_launches = 0
fourstep_mid.dense_launches = 0


def rows_store_t_plain(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """Plain version of kernel 13: the radix core's plain version on the
    rows (:func:`c2c_radix_rows_plain`, with the scale), then the
    transpose."""
    nb, n1, n2 = x.shape
    y = c2c_radix_rows_plain(x.reshape(nb * n1, n2), sign, scale)
    return y.reshape(nb, n1, n2).transpose(1, 2).contiguous()


STORE_T_ROWS = 4        # kernel 13's rows a block: a bin's run of 4 values fills a 32-byte sector


def store_t_rows(n2: int, count: int, sms: int) -> int:
    """Rows a block of kernel 13 over ``count`` rows of n2: STORE_T_ROWS,
    or as many as the row skeleton holds where fewer (RADIX_MAX_THREADS
    threads of 16 elements: 2 at n2 = 2048, 1 from 4096 on, runs of one
    value), halved while the grid would leave SMs idle. (On an H100,
    chip_smoke.py phase 5 over every count the skeleton holds: at
    (16385, 256, 128) R = 1, 2, 4, 8, 16, 32 ran 11.54, 8.58, 3.83, 3.91,
    3.89, 4.00 ms and the counts that are not powers of two 4.15-9.19; at
    (256, 1024, 1024) R = 1 ... 4 8.51, 6.52, 5.22, 2.47.)"""
    r = 1 if n2 > RADIX_WIDE_N else min(STORE_T_ROWS, RADIX_MAX_THREADS // -(-n2 // 16))
    r = 1 << (r.bit_length() - 1)
    while r > 1 and -(-count // r) < sms:
        r //= 2
    return r


def store_t_pitch(n2: int, rows: int) -> int:
    """The distance in elements of kernel 13's tile rows: n2 + 32 g, the
    least g >= 0 under which the epilogue's reads meet no bank conflict.
    Row c's bin k sits in slot c S + k + k // 32, S = 33 (n2 + 32 g) / 32
    (the row layout pads one slot after every 32 elements); a half-warp's
    sixteen 8-byte reads cover the 32 banks when their slots are distinct
    mod 16, and it reads h = min(R', 16) rows (R' = ``rows`` rounded up to
    a power of two) at 16 / h consecutive bins each, so the rows' starts
    c S mod 16 must be distinct multiples of 16 / h. (n2 = 1024 and
    R = 4: g = 4, S = 1188; n2 = 128 and R = 32: g = 1, S = 165.)"""
    h = min(1 << (rows - 1).bit_length(), 16)
    return next(n2 + 32 * g for g in range(16)   # 33 g runs over every residue mod 16
                if len({(c * 33 * (n2 + 32 * g) // 32 + j) % 16
                        for c in range(h) for j in range(16 // h)}) == 16)


def rows_store_t_launch(x: torch.Tensor, y: torch.Tensor, sign: int, scale, rows: int) -> None:
    """Launch kernel 13, ``rows`` rows a block, on the (B, n1, n2)
    complex64 CUDA tensor x into y, (B, n2, n1)."""
    nb, n1, n2 = x.shape
    dev = x.device
    plan = radix_plan(n2)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_rows_store_t(
            x.data_ptr(), y.data_ptr(), device_radix(n2, sign, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), nb * n1, n1, n2, rows,
            store_t_pitch(n2, rows), sign, 1.0 if scale is None else float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rows_store_t")


def rows_store_t(x: torch.Tensor, sign: int, scale=None) -> torch.Tensor:
    """Step 3+4 of the four-step: the C2C of length n2 = 128 * F <= 16384
    along dim 2 of a (B, n1, n2) complex64 tensor, times ``scale``, stored
    transposed as (B, n2, n1). A CPU tensor runs the plain version; a CUDA
    tensor launches kernel 13 on the radix row core with the transposed
    store in its epilogue, :func:`store_t_rows` rows a block, counted in
    ``launches`` and ``radix_launches``, or raises."""
    if x.dim() != 3:
        raise ValueError(f"rows_store_t: expected (B, n1, n2), got {tuple(x.shape)}")
    nb, n1, n2 = x.shape
    check_core_n(n2, "rows_store_t")
    if n2 > FOURSTEP_MAX_N2:
        raise ValueError(f"rows_store_t: n2={n2} > {FOURSTEP_MAX_N2}")
    if x.device.type == "cpu":
        return rows_store_t_plain(x, sign, scale)
    if x.device.type != "cuda":
        raise ValueError(f"rows_store_t: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "rows_store_t")
    y = x.new_empty((nb, n2, n1))
    if nb * n1 == 0:
        return y
    rows_store_t_launch(x, y, sign, scale, store_t_rows(n2, nb * n1, num_sms(x.device)))
    rows_store_t.launches += 1
    rows_store_t.radix_launches += 1
    return y


rows_store_t.launches = 0
rows_store_t.radix_launches = 0


# --------------------------------------------------------------------------
# Kernel 14: the fused complex spectral pipeline along a middle axis
# --------------------------------------------------------------------------


def check_mult(h: torch.Tensor, x: torch.Tensor, rows: int, what: str) -> int:
    """The multiplier's column count hc of a fused spectral kernel: 1 for a
    (rows, 1) multiplier broadcast over the columns of x (B, n, L), L for a
    lane-varying (rows, L) one; else raise."""
    cols = x.shape[2]
    if h.dim() != 2 or h.shape[0] != rows or h.shape[1] not in (1, cols):
        raise ValueError(f"{what}: expected a multiplier of shape ({rows}, 1) or ({rows}, "
                         f"{cols}), got {tuple(h.shape)}")
    if h.device != x.device:
        raise ValueError(f"{what}: the multiplier is on {h.device}, x on {x.device}")
    return h.shape[1]


def mult_planes(hr: torch.Tensor, hi, what: str):
    """The float32 planes of a multiplier as the kernels read them: hr and
    hi (or None for a real multiplier), each contiguous."""
    for p in (hr,) if hi is None else (hr, hi):
        if p.dtype != torch.float32:
            raise TypeError(f"{what}: expected a float32 multiplier plane, got {p.dtype}")
        if p.requires_grad:
            raise NotImplementedError(
                f"{what}: the CUDA kernels have no backward yet (ROADMAP.md §1, autograd)")
    return hr.contiguous(), None if hi is None else hi.contiguous()


def spectral_c2c_mid_plain(x: torch.Tensor, h: torch.Tensor, scale=None) -> torch.Tensor:
    """Plain version of kernel 14 on the radix column tile: the radix core's
    plain forward transform along dim 1 of (B, n, L)
    (:func:`c2c_radix_mid_plain`, sign -1), times H ((n, 1) or (n, L), real
    or complex), then its plain sign +1 transform times ``scale``."""
    return c2c_radix_mid_plain(c2c_radix_mid_plain(x, -1) * h, +1, scale)


def spectral_c2c_launch(x: torch.Tensor, y: torch.Tensor, hr: torch.Tensor, hi, scale: float,
                        c: int, ldg: bool) -> None:
    """Launch kernel 14 on the radix column tile, ``c`` columns a tile
    (:func:`axis_mid_tile`), on the (B, n, L) complex64 CUDA tensors x
    and y with the contiguous float32 multiplier planes hr, hi ((n, 1) or
    (n, L); hi None for a real H); x loaded through the read-only path if
    ``ldg``; the inverse on the sign +1 table. Counts nothing."""
    nb, n, cols = x.shape
    dev = x.device
    plan = radix_plan(n)
    with torch.cuda.device(dev):
        err = _build.lib().ndfft_spectral_c2c_radix(
            x.data_ptr(), y.data_ptr(), hr.data_ptr(), None if hi is None else hi.data_ptr(),
            hr.shape[1], device_radix(n, -1, dev).data_ptr(), device_radix(n, +1, dev).data_ptr(),
            (ctypes.c_int * RADIX_MAX_STAGES)(*plan), len(plan), nb, n, cols, c, scale, int(ldg),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ndfft_spectral_c2c_radix")


def spectral_c2c_mid(x: torch.Tensor, h: torch.Tensor, scale=None) -> torch.Tensor:
    """IFFT(H * FFT(x)) along dim 1 of a (B, n, L) complex64 tensor, n = 128
    * F (:func:`core_f`): the forward unnormalized, the inverse times
    ``scale``; H is (n, 1) or (n, L), float32 or complex64. A CPU tensor runs
    the plain version; a CUDA tensor launches kernel 14 on the radix column
    tile (columns a tile and load by kernel 1's rule, :func:`axis_mid_tile`,
    which ran fastest of C = 1 ... 16 at both of chip_smoke.py phase 5's
    shapes; the inverse on the sign +1 table) or raises."""
    if x.dim() != 3:
        raise ValueError(f"spectral_c2c_mid: expected (B, n, L), got {tuple(x.shape)}")
    nb, n, cols = x.shape
    check_core_n(n, "spectral_c2c_mid")
    check_mult(h, x, n, "spectral_c2c_mid")
    if x.device.type == "cpu":
        return spectral_c2c_mid_plain(x, h, scale)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_c2c_mid: unsupported device {x.device}")
    check_cuda(x, torch.complex64, "spectral_c2c_mid")
    hr, hi = mult_planes(*((h.real, h.imag) if h.is_complex() else (h, None)),
                         "spectral_c2c_mid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    spectral_c2c_launch(x, y, hr, hi, 1.0 if scale is None else float(scale),
                        *axis_mid_tile(n, nb, cols, num_sms(x.device)))
    spectral_c2c_mid.launches += 1
    return y


spectral_c2c_mid.launches = 0
