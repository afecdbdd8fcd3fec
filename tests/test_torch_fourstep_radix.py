"""Kernels 7 and 13 on the radix core (the four-step's column pass with the
exit twiddle in an epilogue, its row pass with the scale and the
transposed store in an epilogue), on the CPU, where the wrappers run their
plain versions:

* ``fourstep_mid``'s plain version (the radix column tile's, or at a prime
  n1 = 131 ... 251 the dense product's, times the exit twiddle) against
  ``_build_call_axis_mid(..., four_n=n1 n2)`` in interpret mode at n1 = 131
  (the dense remnant) and 144, n2 = 17 and 130, nb = 2, both signs;
* ``rows_store_t``'s plain version (the radix row core's with the scale,
  then the transpose) against ``_build_call_lane_store_t`` at n2 = 128 and
  384, n1 = 3 (a block's rows cross batch boundaries) and 144, with a
  scale;
* float64 numpy models of both epilogues as the kernels index them
  (``csrc/fft_fourstep.cu``): every output written exactly once, for the
  column counts and row counts the wrappers can choose, ragged tiles and
  blocks that cross a batch boundary; kernel 13's reads of one bin fall in
  distinct banks under ``store_t_pitch``; the two models in a row are the
  length-n DFT;
* ``fourstep_form`` over every n1 <= 4096 that the JAX package's
  ``_mid_stage_ok`` takes, and the four-step's census of forms.

Tolerance: max |port - JAX| <= 5e-6 * max |JAX| in float32 at the JAX
package's "highest" tier; 1e-12 of the peak for the float64 models.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndrustfft_tpu import config as ref_config
from ndrustfft_tpu.ops.pallas import fft as ref_pfft

from ndrustfft_tpu_torch import gates, plan
from ndrustfft_tpu_torch.ops.hopper import fft as kfft

torch.set_num_threads(1)

TOL = 5e-6
TOL64 = 1e-12
PRIMES_131_251 = [p for p in range(131, 252) if all(p % d for d in range(2, 16))]


@pytest.fixture(autouse=True)
def _jax_interpret():
    old = ref_config.pallas_interpret, ref_config.matmul_precision
    ref_config.pallas_interpret = True
    ref_config.matmul_precision = "highest"
    yield
    ref_config.pallas_interpret, ref_config.matmul_precision = old


def _crandn(shape, seed):
    g = np.random.default_rng(seed)
    return (g.standard_normal(shape) + 1j * g.standard_normal(shape)).astype(np.complex64)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _jax(run, x):
    yr, yi = run(jnp.asarray(x.real), jnp.asarray(x.imag))
    return np.asarray(yr) + 1j * np.asarray(yi)


# --------------------------------------------------------------------------
# The plain versions against the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n1", [131, 144])
@pytest.mark.parametrize("n2", [17, 130])
@pytest.mark.parametrize("sign", [-1, +1])
def test_fourstep_mid_radix_plain_matches_pallas(n1, n2, sign):
    x = _crandn((2, n1, n2), n1 * n2)
    run = ref_pfft._build_call_axis_mid(n1, sign, 2, n2, "float32", True,
                                        ref_pfft.dot_mode(), 1.0, four_n=n1 * n2)
    assert kfft.fourstep_form(n1) == ("dense" if n1 == 131 else "radix")
    _close(kfft.fourstep_mid(torch.from_numpy(x), sign), _jax(run, x), TOL)


@pytest.mark.parametrize("n2", [128, 384])
@pytest.mark.parametrize("n1", [3, 144])
@pytest.mark.parametrize("sign,scale", [(-1, 0.5), (+1, "inv_n")])
def test_rows_store_t_radix_plain_matches_pallas(n2, n1, sign, scale):
    s = 1.0 / (n1 * n2) if scale == "inv_n" else scale
    x = _crandn((2, n1, n2), n1 + n2)
    run = ref_pfft._build_call_lane_store_t(n2, sign, 2, n1, "float32", True,
                                            ref_pfft.dot_mode(), s)
    got = kfft.rows_store_t(torch.from_numpy(x), sign, s)
    assert got.shape == (2, n2, n1) and got.is_contiguous()
    _close(got, _jax(run, x), TOL)


# --------------------------------------------------------------------------
# float64 models of the two epilogues (csrc/fft_fourstep.cu)
# --------------------------------------------------------------------------


def _per_thread(elems: int) -> int:
    """Elements a thread holds (fft_radix.cuh::radix_per_thread)."""
    return 40 if elems > 16384 else 32 if elems > kfft.RADIX_WIDE_N else 16


def _rx_slot(q):
    return q + (q >> 5)


def k7_epilogue_model(z, tw, c):
    """Kernel 7's epilogue over the (B, n1, L) tile spectra z, ``c``
    columns a tile: block (b, tile), thread i = t c + cc writes column
    col0 + cc's bins k = t, t + tr, ... (cc < valid, t < tr) times
    tw[k, col]; returns y and the count of writes of each element."""
    nb, n1, cols = z.shape
    tiles = -(-cols // c)
    tr = -(-n1 // _per_thread(n1 * c))
    threads = kfft.radix_cols_threads(n1, c)
    y = np.zeros_like(z)
    writes = np.zeros(z.shape, np.int64)
    i = np.arange(threads)
    t, cc = i // c, i % c
    for b in range(nb):
        for tile in range(tiles):
            col0 = tile * cols // tiles
            valid = (tile + 1) * cols // tiles - col0
            for ti, ci in zip(t[(cc < valid) & (t < tr)], cc[(cc < valid) & (t < tr)]):
                ks = np.arange(ti, n1, tr)
                y[b, ks, col0 + ci] = z[b, ks, col0 + ci] * tw[ks, col0 + ci]
                writes[b, ks, col0 + ci] += 1
    return y, writes


def k13_epilogue_model(z, n1, rows, scale):
    """Kernel 13's epilogue over the (T, n2) tile spectra z, ``rows`` rows a
    block: block j's rows row0 ... row0 + valid - 1 (the skeleton's even
    spread); thread i keeps row c = i mod R' (R' = rows rounded up to a
    power of two) and bins k2 = i // R' + m (threads // R'), writing
    scale z[row0 + c, k2] to y[(b n2 + k2) n1 + k1]. Returns y (B, n2, n1),
    the writes of each output, and each read's shared-memory slot by
    (block, iteration m, lane), -1 where the lane reads nothing."""
    t_rows, n2 = z.shape
    rp2 = 1 << (rows - 1).bit_length()
    pitch = kfft.store_t_pitch(n2, rows)
    tr = -(-n2 // _per_thread(n2))
    threads = -(-rows * tr // 32) * 32
    step = threads // rp2
    iters = -(-n2 // step)
    tiles = -(-t_rows // rows)
    y = np.zeros((t_rows // n1, n2, n1), z.dtype)
    writes = np.zeros(y.shape, np.int64)
    slots = np.full((tiles, iters, threads), -1, np.int64)
    i = np.arange(threads)
    c = i % rp2
    for blk in range(tiles):
        row0 = blk * t_rows // tiles
        valid = (blk + 1) * t_rows // tiles - row0
        for m in range(iters):
            k2 = i // rp2 + m * step
            live = (c < valid) & (k2 < n2)
            r = row0 + c[live]
            b, k1 = r // n1, r % n1
            y[b, k2[live], k1] = scale * z[r, k2[live]]
            np.add.at(writes, (b, k2[live], k1), 1)
            slots[blk, m, live] = _rx_slot(c[live] * pitch + k2[live])
    return y, writes, slots


def _z64(shape, seed):
    g = np.random.default_rng(seed)
    return g.standard_normal(shape) + 1j * g.standard_normal(shape)


def _tw64(n1, n2, sign):
    return np.exp(sign * 2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / (n1 * n2))


@pytest.mark.parametrize("n1,n2,nb", [(144, 17, 2), (256, 130, 1), (1024, 33, 1),
                                      (2176, 17, 2)])
def test_fourstep_mid_epilogue_model(n1, n2, nb):
    """Every (b, k1, col) written once, ragged tiles included, at each
    column count the skeleton takes for n1 (fft.py::axis_mid_tile picks
    among them) and at the chosen one, with the exit twiddle's value."""
    z = _z64((nb, n1, n2), n1 + n2)
    tw = _tw64(n1, n2, -1)
    want = z * tw
    chosen = kfft.axis_mid_tile(n1, nb, n2, 132)[0]
    counts = {c for c in (1, 2, 4, 8, 16, 32)
              if n1 * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(n1, c) <= (
                  kfft.RADIX_MAX_THREADS if n1 * c <= kfft.RADIX_WIDE_N else 512)}
    assert chosen in counts
    for c in sorted(counts):
        y, writes = k7_epilogue_model(z, tw, c)
        assert (writes == 1).all(), c
        assert np.abs(y - want).max() <= TOL64 * np.abs(want).max(), c


@pytest.mark.parametrize("n2", [128, 1024, 16384])
@pytest.mark.parametrize("n1,nb", [(3, 3), (5, 2), (144, 1)])
def test_rows_store_t_epilogue_model(n2, n1, nb):
    """At every power-of-two row count the row skeleton holds at n2 (the
    counts store_t_rows can choose among them: 4 at most, halved for
    small grids), over T = nb n1 rows (n1 = 3 and 5: blocks whose rows
    cross batch boundaries, T = 9 and 10 with R = 4 a ragged spread of 3,
    3, 3 and 3, 3, 4): every (b, k2, k1) written exactly once with scale
    z[b n1 + k1, k2]; the reads of each half-warp in distinct banks (8-byte
    slots distinct mod 16)."""
    t_rows = nb * n1
    z = _z64((t_rows, n2), n2 + n1)
    want = 0.25 * z.reshape(nb, n1, n2).transpose(0, 2, 1)
    most = {128: 32, 1024: 4, 16384: 1}[n2]
    rows = [most >> s for s in range(most.bit_length())]
    assert kfft.store_t_rows(n2, 1 << 30, 1) == min(most, kfft.STORE_T_ROWS)
    assert kfft.store_t_rows(n2, t_rows, 132) in rows
    for r in rows:
        y, writes, slots = k13_epilogue_model(z, n1, r, 0.25)
        assert (writes == 1).all(), r
        assert np.abs(y - want).max() <= TOL64 * np.abs(want).max(), r
        half = slots.reshape(slots.shape[0], slots.shape[1], -1, 16)
        for lanes in half.reshape(-1, 16):
            live = lanes[lanes >= 0]
            assert len(set(live % 16)) == len(live), (r, sorted(live % 16))


def test_store_t_pitch_clears_every_conflict_that_the_row_layout_has():
    """Without the pitch (rows n2 apart) the reads of one bin conflict at
    n2 = 1024, R = 4 (rows 1056 slots apart, one bank) and n2 = 128, R = 32
    (132 apart: 4-way); under store_t_pitch no half-warp conflicts, at
    every n2 = 128 F <= 16384 with a plan and every R up to 32 that fits."""
    def worst(n2, rows, pitch):
        rp2 = 1 << (rows - 1).bit_length()
        h = min(rp2, 16)
        s = 33 * pitch // 32
        banks = [(c * s + j) % 16 for c in range(h) for j in range(16 // h)]
        return max(banks.count(v) for v in set(banks))

    assert worst(1024, 4, 1024) == 4 and worst(128, 32, 128) == 4
    assert kfft.store_t_pitch(1024, 4) == 1024 + 4 * 32
    assert kfft.store_t_pitch(128, 32) == 128 + 32
    for f in range(1, 129):
        n2 = 128 * f
        if kfft.radix_plan(n2) is None:
            continue
        tr = -(-n2 // _per_thread(n2))
        most = 1 if n2 > kfft.RADIX_WIDE_N else min(32, kfft.RADIX_MAX_THREADS // tr)
        for rows in range(1, most + 1):
            pitch = kfft.store_t_pitch(n2, rows)
            assert pitch % 32 == 0 and n2 <= pitch < n2 + 512
            assert worst(n2, rows, pitch) == 1, (n2, rows)
            smem = 8 * (rows * pitch + (rows * pitch >> 5) + 1 + sum(
                p for p in kfft.radix_plan(n2) if p not in kfft.RADIX_CODELETS))
            assert smem <= kfft.MAX_SMEM, (n2, rows)


@pytest.mark.parametrize("n1,n2,rows", [(144, 128, 32), (1024, 1024, 4), (3, 384, 8)])
@pytest.mark.parametrize("sign", [-1, +1])
def test_the_two_epilogue_models_are_the_four_step(n1, n2, rows, sign):
    """Step 1+2 (numpy's DFT along n1, kernel 7's epilogue) then step 3+4
    (numpy's DFT along n2, kernel 13's epilogue with the scale) give the
    length-n DFT of each row, k = k1 + n1 k2, within 1e-12 in float64."""
    n = n1 * n2
    x = _z64((2, n), n1 + n2)
    dft = np.fft.fft if sign < 0 else lambda a, axis: np.fft.ifft(a, axis=axis) * a.shape[axis]
    z, _ = k7_epilogue_model(dft(x.reshape(2, n1, n2), axis=1), _tw64(n1, n2, sign), 4)
    spectra = dft(z.reshape(2 * n1, n2), axis=1)
    y, _, _ = k13_epilogue_model(spectra, n1, rows, 1.0 / n)
    want = dft(x, axis=1) / n
    assert np.abs(y.reshape(2, n) - want).max() <= TOL64 * np.abs(want).max()


# --------------------------------------------------------------------------
# Forms and the four-step's census
# --------------------------------------------------------------------------


def test_fourstep_form_over_every_stage_length():
    """Over every n1 <= 4096 that the JAX package's _mid_stage_ok takes:
    "radix" wherever radix_plan(n1) exists and "dense" at exactly the 23
    primes from 131 to 251, and n1 = 1 (a DFT-1, no plan); None elsewhere."""
    assert len(PRIMES_131_251) == 23
    dense = []
    for n1 in range(1, kfft.FOURSTEP_MAX_N1 + 1):
        form = kfft.fourstep_form(n1)
        if not ref_pfft._mid_stage_ok(n1):
            assert form is None, n1
            continue
        assert form == ("radix" if kfft.radix_plan(n1) else "dense"), n1
        if form == "dense":
            dense.append(n1)
    assert dense == [1] + PRIMES_131_251
    assert kfft.fourstep_form(0) is None and kfft.fourstep_form(4224) is None


def test_fourstep_census():
    """Every n from 20481 to 2^22 with a four-step split, from the pairs
    (n1, n2) the gate takes with _fourstep_split's tie-break (the least
    n1 + n2, first met in its divisor loop), held against the gate at a
    sample: 18964 lengths, kernel 7 on the radix tile at 14918 and on the
    dense product at 4046; kernel 13 at the 7797 whose n2 has a twostep
    split, every such n2 = 128 F <= 16384 with a plan. A length with a
    prime factor above 128 plans as Bluestein's chirp-z, so the four-step
    itself runs at the other 12993, every one on the radix tile, kernel 13
    at 5572 of them."""
    n1s = [a for a in range(1, 4097) if gates._mid_stage_ok(a)]
    n2s = [b for b in range(1, 16385)
           if gates._mid_stage_ok(b) and kfft.lane_factor(b) is not None]
    best = {}
    for a in n1s:
        for b in n2s:
            n = a * b
            if 20480 < n <= 1 << 22:
                key = (a + b, min(a, b), a < b)
                if n not in best or key < best[n][0]:
                    best[n] = (key, (a, b))
    sample = sorted(best)[::997] + [1 << 20, 1 << 22, 36992, 32768]
    for n in sample:
        assert gates._fourstep_split(n) == best[n][1], n
    forms = {"radix": 0, "dense": 0}
    k13 = ct = ct_k13 = 0
    for n, (_, (a, b)) in best.items():
        forms[kfft.fourstep_form(a)] += 1
        split = gates._twostep_split(b) is not None
        if split:
            k13 += 1
            assert kfft.core_f(b) and kfft.radix_plan(b) and b <= kfft.FOURSTEP_MAX_N2
        if plan.factorize(n) is not None:
            ct += 1
            ct_k13 += split
            assert kfft.fourstep_form(a) == "radix", n
    assert (len(best), forms["radix"], forms["dense"], k13) == (18964, 14918, 4046, 7797)
    assert (ct, ct_k13) == (12993, 5572)
