#!/usr/bin/env python3
"""Time the radix core's kernels of a checkout on one CUDA card.

Run from the root of a checkout:  python3 time_kernels.py [--root DIR] [--reps R]

Imports ndrustfft_tpu_torch from DIR (default: this file's directory), so
that two trees can be timed in turns in one process tree on one card
(parent, change, change, parent), each building its kernels under its own
build/. Times, as the median of R CUDA-event pairs after a warm-up, the
public wrappers at their main shapes: kernel 8 (c2c_generic_rows) and
kernel 15's generic form (r2c_packed_generic) at 360000 rows of 600,
kernel 10 (c2c_rows) at (4096, 4096), kernel 11 (c2c_blue_mid) at
(1, 1031, 1024) and (1, 509, 259081), kernel 8 at n = 256
(c2c_dense_rows) at 65536 and 8388608 rows (the latter over --reps-big
runs), kernel 6 (c2c_generic_mid) at (600, 600, 301) and (1, 600, 180600),
and kernel 4 (c2c_dense_mid) at (1, 256, 65536), (256, 256, 129) and
(1, 256, 33024), each beside one torch.fft call on the same input; then
the 600^3 and 256^3 real steps with the real axis last (ndfft_r2c, ndfft
along axes 1 and 0 and back) beside torch.fft.rfftn + irfftn, and the
509^3 complex round trip (fftn, ifftn) beside torch.fft.fftn + ifftn.
Prints the card's nvidia-smi name and power limit, then one JSON line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--reps-big", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ndrustfft_tpu_torch as nd
    from ndrustfft_tpu_torch.ops.hopper import fft as kfft
    from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def crandn(*shape):
        return torch.complex(torch.randn(*shape, generator=gen, device=dev),
                             torch.randn(*shape, generator=gen, device=dev))

    def ms(fn, reps=None):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps or args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    out = {}
    x = crandn(360000, 600)
    out["c2c_generic_rows_360000x600"] = (ms(lambda: kfft.c2c_generic_rows(x, -1)),
                                          ms(lambda: torch.fft.fft(x, dim=1)))
    x = torch.randn(360000, 600, generator=gen, device=dev)
    out["r2c_packed_generic_360000x600"] = (ms(lambda: krfft.r2c_packed_generic(x)),
                                            ms(lambda: torch.fft.rfft(x, dim=1)))
    x = crandn(4096, 4096)
    out["c2c_rows_4096x4096"] = (ms(lambda: kfft.c2c_rows(x, -1)),
                                 ms(lambda: torch.fft.fft(x, dim=1)))
    x = crandn(1, 1031, 1024)
    out["c2c_blue_mid_1x1031x1024"] = (ms(lambda: kfft.c2c_blue_mid(x, -1)),
                                       ms(lambda: torch.fft.fft(x, dim=1)))
    x = crandn(1, 509, 509 * 509)
    out["c2c_blue_mid_1x509x259081"] = (ms(lambda: kfft.c2c_blue_mid(x, -1)),
                                        ms(lambda: torch.fft.fft(x, dim=1)))
    for shape in ((1, 256, 65536), (256, 256, 129), (1, 256, 33024)):
        x = crandn(*shape)
        out["c2c_dense_mid_" + "x".join(map(str, shape))] = (
            ms(lambda: kfft.c2c_dense_mid(x, -1)), ms(lambda: torch.fft.fft(x, dim=1)))
    x = crandn(65536, 256)
    out["c2c_dense_rows_65536x256"] = (ms(lambda: kfft.c2c_dense_rows(x, -1)),
                                       ms(lambda: torch.fft.fft(x, dim=1)))
    x = crandn(600, 600, 301)
    out["c2c_generic_mid_600x600x301"] = (ms(lambda: kfft.c2c_generic_mid(x, -1)),
                                          ms(lambda: torch.fft.fft(x, dim=1)))
    x = crandn(1, 600, 180600)
    out["c2c_generic_mid_1x600x180600"] = (ms(lambda: kfft.c2c_generic_mid(x, -1)),
                                           ms(lambda: torch.fft.fft(x, dim=1)))
    del x
    for n in (600, 256):
        r = torch.randn(n, n, n, generator=gen, device=dev)
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)

        def step():
            v = nd.ndfft(nd.ndfft(nd.ndfft_r2c(r, hr, axis=2), hc, axis=1), hc, axis=0)
            return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=0), hc, axis=1), hr, axis=2)

        out[f"step_{n}^3"] = (ms(step, 10),
                              ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r), s=r.shape), 10))
        del r
    x = crandn(509, 509, 509)
    out["c2c_fftn_ifftn_509^3"] = (ms(lambda: nd.ifftn(nd.fftn(x)), args.reps_big),
                                   ms(lambda: torch.fft.ifftn(torch.fft.fftn(x)), args.reps_big))
    del x
    torch.cuda.empty_cache()
    x = crandn(8388608, 256)
    out["c2c_dense_rows_8388608x256"] = (ms(lambda: kfft.c2c_dense_rows(x, -1), args.reps_big),
                                         ms(lambda: torch.fft.fft(x, dim=1), args.reps_big))
    del x
    torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "ms_and_torch_fft_ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
