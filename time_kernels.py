#!/usr/bin/env python3
"""Time the radix core's kernels of a checkout on one CUDA card.

Run from the root of a checkout:  python3 time_kernels.py [--root DIR] [--reps R]

Imports ndrustfft_tpu_torch from DIR (default: this file's directory), so
that two trees can be timed in turns in one process tree on one card
(parent, change, change, parent), each building its kernels under its own
build/. Times, as the median of R CUDA-event pairs after a warm-up, the
public wrappers at their main shapes: kernel 8 (c2c_generic_rows) and
kernel 15's generic form (r2c_packed_generic) at 360000 rows of 600,
kernel 10 (c2c_rows) at (4096, 4096), (262144, 512), (259081, 1024) and
(65536, 2048), kernel 2 (r2c_nat) at (262144, 512), (589824, 768) and
(32768, 32768) (the latter over --reps-big runs), kernel 11 (c2c_blue_mid) at
(1, 1031, 1024) and (1, 509, 259081), kernel 8 at n = 256
(c2c_dense_rows) at 65536 and 8388608 rows (the latter over --reps-big
runs), kernel 6 (c2c_generic_mid) at (600, 600, 301) and (1, 600, 180600),
and kernel 4 (c2c_dense_mid) at (1, 256, 65536), (256, 256, 129) and
(1, 256, 33024), each beside one torch.fft call on the same input; then
the 600^3, 512^3 and 256^3 real steps with the real axis last (ndfft_r2c,
ndfft along axes 1 and 0 and back) beside torch.fft.rfftn + irfftn, the
512^3 and 509^3 complex round trips (fftn, ifftn) beside torch.fft.fftn +
ifftn, and the 32768^2 real step (ndfft_r2c along axis 1, ndfft along
axis 0 and back) beside torch.fft.rfftn + irfftn, over --reps-big runs.
Prints the card's nvidia-smi name and power limit, then one JSON line.

With --r2c-mid it times instead the R2C along a middle axis: kernel 20
(r2c_dense_mid) at (1, 256, 65536), (1, 264, 264) and (1, 129, 65536) and
kernel 16 (r2c_mid) at (1, 512, 262144), (512, 512, 512) and
(1, 1280, 1280), each beside torch.fft.rfft(dim=1), kernels 4 and 6 (whose
column kernel the R2C shares) at (1, 256, 65536) and (600, 600, 301), the
rfft2d protocol's forward (ndfft_r2c along axis 0 of n x n, n = 128, 264,
512, 1024) beside torch.fft.rfft(dim=0), and the 256^3 and 512^3 real
steps with the real axis first (ndfft_r2c along axis 0, ndfft along axes 1
and 2, and back) beside torch.fft.rfftn + irfftn over dims (1, 2, 0).

With --axis-mid it times instead kernel 1 (c2c_axis_mid) at (1, 512,
131584), (768, 768, 385), (1, 4096, 4096) and (1024, 1024, 513) beside
torch.fft.fft(dim=1), kernel 18 (r2c_packed_mid, scale -0.5) at (1023, 1024,
1023), (1, 1024, 1046529) and (1, 1536, 1535) beside torch.fft.rfft of the
interleaved column, and the paths that run them: the 4096^2 complex round
trip (ndfft along axes 1 and 0, ndifft back) beside torch.fft.fftn + ifftn,
the 512^3 real step with the real axis first and the 768^3 one with the
real axis last beside torch.fft.rfftn + irfftn, the 1023^3 DST-I pair
(dstn, idstn of type 1) beside the same through torch.fft.rfft of each
axis's odd extension, and S1's 1024^3 periodic Poisson solve (ndfft_r2c
along axis 2, ndfft along axis 1, ndspectral_c2c with a real 1/|k|^2 along
axis 0, and back) beside torch.fft.rfftn * G + irfftn, the large ones over
--reps-big runs. It uses only public wrappers, so --root may name the
parent tree.

With --scan-rows it times instead the radix row core's launches at each
count of rows a block that fits 256 threads (ms by rows, beside the count
that fft.py::radix_block picks), over 2^27 elements: the C2C of rows of n
(kernels 10 and 8) and the R2C of rows of 2h (kernels 2 and 15) at the
lengths that --scan-n and --scan-h name; at h <= 256 each count up to 32
and the count that rfft.py::packed_dense_rows picks as well.

With --scan-cols it times instead kernels 1 and 18 on the radix column
tile at each column count C that fits (kernel 1 also with the read-only
load at C <= 2), beside the count and load that fft.py::axis_mid_tile and
rfft.py::packed_mid_cols pick, at kernel 1's shapes (1, 512, 131584),
(512, 512, 512), (1024, 1024, 513), (768, 768, 385), (1, 768, 295680),
(1, 2048, 65536), (1, 4096, 4096), (1, 8192, 2048) and (1, 20480, 130) and
kernel 18's (1023, 1024, 1023), (1, 1024, 1046529), (1, 1536, 1535) and
(1, 10240, 130); or, with --cols-n and --cols-h, kernel 1 at (1, n, 2^26 / n)
and (b, n, b + 1), b = isqrt(2^26 / n), and kernel 18 at (1, h, 2^27 / h) and
(b, h, b - 1), b = isqrt(2^27 / h), for the lengths they name.

With --c2r it times instead the C2R: kernel 3 (c2r_nat, scale 1/n) at
(262144, 257), (589824, 385) and (32768, 16385) and kernel 17 (c2r_mid,
scale 1/n) at (1, 257, 262144), (512, 257, 512) and (1, 641, 1280), each
beside torch.fft.irfft of the same spectrum; the row core's other kernels
at their main shapes (kernel 10 at (262144, 512), kernel 8 at (65536, 256),
kernel 2 at (262144, 512), kernel 15 at (65536, 256) and its generic form
at (360000, 600)), whose load became a policy of the row skeleton; and the
paths that run kernels 3 and 17: the 32768^2 real step, the 768^3 and
512^3 real steps with the real axis last and the 512^3 one with the real
axis first, and S1's 1024^3 periodic Poisson solve, beside torch.fft, the
large ones over --reps-big runs. It uses only public wrappers, so --root
may name the parent tree.

With --scan-c2r it times instead kernel 3 on the radix row core at each
count of rows a block that fits (beside fft.py::radix_block's count) at
(262144, 257), (589824, 385), (131072, 1025) and (32768, 16385), and
kernel 17 on the radix column tile at each column count C that fits
(beside rfft.py::c2r_mid_cols), at (1, 257, 262144),
(512, 257, 512), (1, 641, 1280), (1, 385, 295680), (1, 513, 131072),
(1, 1025, 65536), (1, 2049, 32768), (1, 4097, 16384) and (1, 10241, 130).

With --route-dense JSON [--route-kernels K ...] it times instead (the
kernels K of 21, 27, 20 and 15, all by default) kernel 27 at every length
that has a radix plan, on the radix column tile and on the dense product,
over (1, n, 2^23 / n) reals; kernels 21 and 20 at every length 4 ... 1100
on the radix column tile (where a plan exists), on their chirp-z at each
column count C that fits and on the dense product, over (1, n, 2^23 / n)
reals (kernel 21: the spectrum of that); and kernel 15 at every half length
h <= 256 that is not 128 F, on the radix row core (where a plan exists; at
rfft.py::packed_dense_rows's count a block and at fft.py::radix_block's)
and on its chirp-z at each count of rows a tile, over (2^23 / 2h, 2h)
reals. It writes the times by n to JSON and prints, for
each family, the lengths where another kernel than the route's was faster,
each route's summed time against the fastest kernel's and against the
dense product's at the lengths off the radix kernel, and the chirp-z's
fastest C by convolution length.

With --ptxas it prints instead the registers and spill bytes of every entry
function of its tree's build (ptxas -v in nvcc.log), to hold two trees'
kernels against each other.

With --dense it times instead kernels 15, 20, 21 and 27 at their main
shapes, each with a digest of its output: kernel 15 (r2c_packed_dense) at
(16384, 128), (200, 200), (16384, 262), (16384, 502), (16384, 62) and
(16384, 2) (h = 131, 251, 31 and 1: the chirp-z, the dense product in a
parent before it) and
kernel 20 (r2c_dense_mid) at (1, 262, 65536), (1, 131, 65536),
(1, 1094, 7668) and (1, 1097, 7647), beside torch.fft.rfft, each also as
device time alone (the replays of a CUDA graph of 20 calls, "_device");
kernel 21 (c2r_dense_mid, scale 1/n) at (1,
129, 65536), (1, 65, 65536) (odd n = 129), (1, 128, 32768) (odd n = 255),
(1, 133, 264), (1, 65, 128), (1, 132, 65536) (n = 262) and (1, 548, 7668)
(n = 1094) beside torch.fft.irfft (the last two also as device time
alone), kernel 27
(dct_dense_mid, scale 2) of types 2 and 3 at (1, 512, 262144) and (1024,
1024, 1024), of type 1 at (129, 129, 129) and of type 4 at (1, 1024, 1024)
beside torch.matmul with the scaled DCT matrix; kernels 16, 17, 18 and 20
(whose column skeleton kernels 21 and 27 share) and kernel 11 (whose
column kernel kernel 20's chirp-z shares) at their main shapes with
digests; and the paths that run kernels 21 and 27: S3's 1024^3 Neumann
Poisson solve (nddct2 on axes 2 and 1, ndspectral_dct on axis 0, nddct3
back) and the 512^3 one (nddct2 on every axis, the division, nddct3 back)
beside a float32 torch.fft Makhoul lowering, and the 256^3 real step with
the real axis first beside torch.fft.rfftn + irfftn. It uses only public
wrappers, so --root may name the parent tree.

With --dct it times instead kernels 23 and 24 (dct2_nat, scale 2;
dct3_nat, scale 1/n) at (262144, 512), (1048576, 1024), (2359296, 1536),
(31104, 31104) and the odd-k (65536, 1152), kernels 25 and 26 (dct2_mid,
dct3_mid) at the same solves' shapes along a middle axis and at
(1, 2048, 2048) and (1, 1152, 1152), kernel 29 (spectral_dct_mid, s2 = 2,
s3 = 1/n) at S3's (1, 1024, 1048576) and G1's (1, 31104, 31104) with a
lane-varying H and at (1, 2048, 4096), (8, 1280, 8192) and (1, 1152, 1152)
with a broadcast one, and kernel 12
(dct23_blue_mid, DCT-II with scale 2 and DCT-III) at (1, 2049, 524544)
and (2049, 2049, 256), each with a digest of its output; kernel 11 (c2c_blue_mid) at (1, 509, 259081), kernel 20's
chirp-z (r2c_dense_mid) at (1, 262, 65536), kernel 21's (c2r_dense_mid,
n = 262) at (1, 132, 65536) and kernel 15's chirp rows (r2c_packed_dense)
at (16384, 262), whose digests must not move; the Makhoul permutations
around kernel 12 (ops/dct.py::makhoul_order and makhoul_interleave) at
the 2049^2 x 256 solve's two views; and the paths that run kernels 23 and
12: the 2049^2 x 256 dctn + idctn pair of type 2, G1's 31104^2 one and its
ndspectral_dct variant (nddct2 along axis 1, ndspectral_dct along axis 0
with a lane-varying H, nddct3 back), the 1536^3 pair (nddct2 along
axes 2, 1, 0, nddct3 back) and S3's 1024^3 Neumann solve (as with
--dense), over --reps-big runs; then the registers and spill bytes
(ptxas -v) of the wide and n-point DCT kernels (kernels 23 to 26's
remnant), the DCT kernels on the radix cores, kernel 29's and every
chirp-z kernel (kernels 11, 20, 21, 15's rows and 12). It uses only public
wrappers, so --root may name the parent tree.

With --dct14 it times instead kernel 28 (DCT-IV along a middle axis) at
(2048, 2048, 256), (1, 2048, 524288), (1, 1536, 1536), (1, 65536, 8192),
(1, 40960, 8192) and at the prime F = 131 and 163 over 1024 columns, and
kernel 19 (DCT-I) at (2049, 2049, 257), (1, 2049, 526593) and
(1, 1537, 1537), each with its output's digest; the other kernels on the
radix column skeleton with digests (kernels 1, 4, 6, 16, 18, 20, 17, 21,
27's DCT-I/II/III, 25, 26 at one main shape each); and the paths that run
kernels 28 and 19: the type-1 dctn + idctn pair on 2049^2 x 257, the
type-4 pair on 2048^2 x 256 and G2's pair on 65536 x 8192, over
--reps-big runs; then the registers and spill bytes (ptxas -v) of every
radix column kernel and kernel 28's. It uses only public wrappers, so
--root may name the parent tree.

With --fourstep it times instead kernels 7 and 13 (the four-step's two
passes, through their wrappers fourstep_mid and rows_store_t, scale 1/n)
at the main paths' shapes (256, 1024, 1024) and (16385, 256, 128), and
kernel 7 at the prime n1 = 131 over (8, 131, 8192) (its dense product in
both trees), each with its output's digest; then the paths that run them,
the 256 x 2^20 complex64 round trip along the last axis (ndfft, ndifft)
and the 32768^2 real step (ndfft_r2c along axis 1, ndfft along axis 0 and
back), beside torch.fft, over --reps-big runs; then the registers and
spill bytes (ptxas -v) of both kernels' entry functions. It uses only
public wrappers, so --root may name the parent tree.

With --scan-dct-mid it times instead kernels 26 and 29 on the radix column
tile at each column count C = 1 ... 16 that fits, at C <= 2 with both
loads: kernel 26 at (1, 1536, 2359296),
(1536, 1536, 1536), (1, 2048, 2048), (1, 1152, 1152) and (1, 31104, 31104),
kernel 29 at the shapes of --dct; beside the counts dct.py::dct2_mid_cols
and rfft.py::spectral_cols pick, then both kernels' ptxas registers and spill
bytes.

With --spectral it times instead kernels 14 and 22 through their wrappers
at their main shapes, each with a digest of its output: kernel 14
(spectral_c2c_mid, scale 1/n) at S1's (1, 1024, 525312) with its
lane-varying real G and at (8, 1280, 8192) with a broadcast real H, kernel
22 (spectral_r2c_mid, scale 1/n) at S2's (1, 1024, 1048576) and (1024,
1024, 1024) with the broadcast Gaussian gain and at (8, 768, 16384); then
the paths that run them, S1's 1024^3 periodic Poisson solve beside
torch.fft.rfftn * G + irfftn and S2's 1024^3 LES filter (ndspectral_r2c
along axes 0, 1 and 2) beside torch.fft.rfftn, the three gains, irfftn,
over --reps-big runs; then the registers and spill bytes (ptxas -v) of
both kernels' entry functions and kernel 29's, and the spill bytes of the
out-of-line transforms each of them calls. It uses only public wrappers,
so --root may name the parent tree.

With --scan-dense it times instead kernels 21 and 27 on the radix column
tile at each column count C that fits, beside the counts that
rfft.py::c2r_dense_cols and dct.py::dct_radix_cols pick: kernel 21 at
(1, 129, 65536), (1, 133, 264), (1, 65, 128) and at odd n = 129 and 255
((1, 65, 65536), (1, 128, 32768)), kernel 27's DCT-II and DCT-III at
(1, 512, 262144), (1024, 1024, 1024) and (1, 1024, 1024), its DCT-I at
(129, 129, 129) and (1, 1025, 1025).
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

# this tree's helpers, before --root puts another tree first on the path:
# the CUDA-graph timer and the float32 Makhoul DCT through torch.fft
from chip_smoke import graph_ms, makhoul_dct


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--reps-big", type=int, default=5)
    ap.add_argument("--scan-rows", action="store_true")
    ap.add_argument("--r2c-mid", action="store_true")
    ap.add_argument("--axis-mid", action="store_true")
    ap.add_argument("--scan-cols", action="store_true")
    ap.add_argument("--c2r", action="store_true")
    ap.add_argument("--scan-c2r", action="store_true")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--dct", action="store_true")
    ap.add_argument("--dct14", action="store_true")
    ap.add_argument("--fourstep", action="store_true")
    ap.add_argument("--scan-dense", action="store_true")
    ap.add_argument("--scan-dct-mid", action="store_true")
    ap.add_argument("--spectral", action="store_true")
    ap.add_argument("--route-dense", default=None, metavar="JSON")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--route-kernels", nargs="*", default=[21, 27, 20, 15], type=int)
    ap.add_argument("--cols-n", type=int, nargs="*", default=[])
    ap.add_argument("--cols-h", type=int, nargs="*", default=[])
    ap.add_argument("--scan-n", type=int, nargs="*", default=[
        264, 300, 384, 500, 512, 600, 640, 768, 896, 1000, 1024, 1152, 1280, 1536, 1792, 2048])
    ap.add_argument("--scan-h", type=int, nargs="*", default=[128, 256, 300, 384, 512, 640, 768,
                                                              1024])
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
    if args.ptxas:
        return ptxas(root)
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

    if args.scan_rows:
        sms = kfft.num_sms(dev)
        scan = {}
        for kind, lengths in (("c2c", args.scan_n), ("r2c", args.scan_h)):
            for n in lengths:
                tr = -(-n // 16)
                t = (1 << 27) // n
                if kind == "c2c":
                    x = crandn(t, n)
                    rows_ms = {r: ms(lambda: kfft._radix_launch(x, -1, None, "scan", r))
                               for r in range(1, min(16, 256 // tr) + 1)}
                else:
                    # at h <= 256 also up to 32 rows, and the counts of
                    # radix_block and of kernel 15's dense rows
                    x = torch.randn(t, 2 * n, generator=gen, device=dev)
                    counts = set(range(1, min(16, 256 // tr) + 1))
                    if n <= 256:
                        counts |= set(range(1, min(32, 256 // tr) + 1)) | {
                            kfft.radix_block(n, t, sms), krfft.packed_dense_rows(n, t, sms)}
                    rows_ms = {r: ms(lambda: krfft.r2c_radix_launch(x, "scan", r))
                               for r in sorted(counts)}
                scan[f"{kind}_{t}x{n}"] = {"ms_by_rows_per_block": rows_ms,
                                           "chosen": kfft.radix_block(n, t, sms)}
                if kind == "r2c" and n <= 256:
                    scan[f"{kind}_{t}x{n}"]["dense_rows"] = krfft.packed_dense_rows(n, t, sms)
                del x
        print(json.dumps({"root": root, "card": card, "rows_scan": scan}), flush=True)
        return 0
    if args.scan_cols:
        k1 = [s for n in args.cols_n for b in [math.isqrt((1 << 26) // n)]
              for s in ((1, n, (1 << 26) // n), (b, n, b + 1))]
        k18 = [s for h in args.cols_h for b in [math.isqrt((1 << 27) // h)]
               for s in ((1, h, (1 << 27) // h), (b, h, b - 1))]
        return scan_cols(torch, kfft, krfft, dev, gen, crandn, ms, card, root, k1 or K1_SHAPES,
                         k18 or K18_SHAPES)
    if args.scan_c2r:
        return scan_c2r(torch, kfft, krfft, dev, crandn, ms, card, root)
    from ndrustfft_tpu_torch.ops.hopper import dct as kdct

    if args.scan_dense:
        return scan_dense(torch, kfft, krfft, kdct, dev, gen, crandn, ms, card, root)
    if args.scan_dct_mid:
        return scan_dct_mid(torch, kfft, krfft, kdct, dev, gen, ms, args.reps_big, card, root)
    if args.route_dense:
        return route_dense(torch, kfft, krfft, kdct, dev, gen, crandn, ms, card, root,
                           args.route_dense, args.route_kernels)
    out = {}
    if args.dct:
        dct(torch, nd, kfft, krfft, kdct, dev, gen, crandn, ms, args.reps_big, out)
        print(json.dumps({"root": root, "card": card, "ms_and_digest": out,
                          "ptxas": ptxas_entries(("dct3", "Dct3", "dct2_mid", "dct2_wide",
                                                  "dct2_npoint", "Makhoul", "spectral_dct",
                                                  "blue_radix_kernel"))}), flush=True)
        return 0
    if args.dct14:
        dct14(torch, nd, kfft, krfft, kdct, dev, gen, crandn, ms, args.reps_big, out)
        print(json.dumps({"root": root, "card": card, "ms_and_digest": out,
                          "ptxas": ptxas_entries(("radix_cols_kernel", "dct4", "Dct4"))}),
              flush=True)
        return 0
    if args.fourstep:
        fourstep(torch, nd, kfft, dev, gen, crandn, ms, args.reps_big, out)
        print(json.dumps({"root": root, "card": card, "ms_and_digest": out,
                          "ptxas": ptxas_entries(("Fourstep", "StoreT", "TwStore",
                                                  "TransposedStore"))}), flush=True)
        return 0
    if args.spectral:
        spectral(torch, nd, kfft, krfft, dev, gen, crandn, ms, args.reps_big, out)
        print(json.dumps({"root": root, "card": card, "ms_and_digest": out,
                          "ptxas": ptxas_entries(("spectral_c2c", "spectral_r2c",
                                                  "spectral_dct_radix")),
                          "ptxas_callees": ptxas_callees(("spectral_c2c_radix",
                                                          "spectral_r2c_radix",
                                                          "spectral_dct_radix"))}), flush=True)
        return 0
    if args.dense:
        dense(torch, nd, krfft, kdct, dev, gen, crandn, ms, args.reps_big, out)
        print(json.dumps({"root": root, "card": card, "ms_and_library_ms": out}), flush=True)
        return 0
    if args.c2r:
        c2r(torch, nd, kfft, krfft, dev, gen, crandn, ms, args.reps_big, out)
        print(json.dumps({"root": root, "card": card, "ms_and_torch_fft_ms": out}), flush=True)
        return 0
    if args.axis_mid:
        axis_mid(torch, nd, kfft, krfft, dev, gen, crandn, ms, args.reps_big, out)
        print(json.dumps({"root": root, "card": card, "ms_and_torch_fft_ms": out}), flush=True)
        return 0
    if args.r2c_mid:
        for name, fn, shapes in (
                ("r2c_dense_mid", krfft.r2c_dense_mid, ((1, 256, 65536), (1, 264, 264),
                                                        (1, 129, 65536))),
                ("r2c_mid", krfft.r2c_mid, ((1, 512, 262144), (512, 512, 512), (1, 1280, 1280)))):
            for shape in shapes:
                x = torch.randn(*shape, generator=gen, device=dev)
                out[name + "_" + "x".join(map(str, shape))] = (
                    ms(lambda: fn(x)), ms(lambda: torch.fft.rfft(x, dim=1)))
        # kernels 4 and 6, whose column kernel the R2C shares
        for name, fn, shape in (("c2c_dense_mid", kfft.c2c_dense_mid, (1, 256, 65536)),
                                ("c2c_generic_mid", kfft.c2c_generic_mid, (600, 600, 301))):
            x = crandn(*shape)
            out[name + "_" + "x".join(map(str, shape))] = (
                ms(lambda: fn(x, -1)), ms(lambda: torch.fft.fft(x, dim=1)))
        del x
        for n in (128, 264, 512, 1024):
            x = torch.randn(n, n, generator=gen, device=dev)
            h = nd.R2cFftHandler(n)
            out[f"rfft2d_axis0_{n}^2"] = (ms(lambda: nd.ndfft_r2c(x, h, axis=0)),
                                          ms(lambda: torch.fft.rfft(x, dim=0)))
        del x
        for n in (256, 512):
            r = torch.randn(n, n, n, generator=gen, device=dev)
            hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)

            def step_first():
                v = nd.ndfft(nd.ndfft(nd.ndfft_r2c(r, hr, axis=0), hc, axis=1), hc, axis=2)
                return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=2), hc, axis=1), hr, axis=0)

            out[f"step_real_axis_first_{n}^3"] = (
                ms(step_first, 10),
                ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r, dim=(1, 2, 0)),
                                            s=r.shape[1:] + r.shape[:1], dim=(1, 2, 0)), 10))
            del r
        print(json.dumps({"root": root, "card": card, "ms_and_torch_fft_ms": out}), flush=True)
        return 0
    x = crandn(360000, 600)
    out["c2c_generic_rows_360000x600"] = (ms(lambda: kfft.c2c_generic_rows(x, -1)),
                                          ms(lambda: torch.fft.fft(x, dim=1)))
    x = torch.randn(360000, 600, generator=gen, device=dev)
    out["r2c_packed_generic_360000x600"] = (ms(lambda: krfft.r2c_packed_generic(x)),
                                            ms(lambda: torch.fft.rfft(x, dim=1)))
    for shape in ((4096, 4096), (262144, 512), (259081, 1024), (65536, 2048)):
        x = crandn(*shape)
        out["c2c_rows_" + "x".join(map(str, shape))] = (ms(lambda: kfft.c2c_rows(x, -1)),
                                                        ms(lambda: torch.fft.fft(x, dim=1)))
    for shape in ((262144, 512), (589824, 768)):
        x = torch.randn(*shape, generator=gen, device=dev)
        out["r2c_nat_" + "x".join(map(str, shape))] = (ms(lambda: krfft.r2c_nat(x)),
                                                       ms(lambda: torch.fft.rfft(x, dim=1)))
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
    for n in (600, 512, 256):
        r = torch.randn(n, n, n, generator=gen, device=dev)
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)

        def step():
            v = nd.ndfft(nd.ndfft(nd.ndfft_r2c(r, hr, axis=2), hc, axis=1), hc, axis=0)
            return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=0), hc, axis=1), hr, axis=2)

        out[f"step_{n}^3"] = (ms(step, 10),
                              ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r), s=r.shape), 10))
        del r
    for n in (512, 509):
        x = crandn(n, n, n)
        out[f"c2c_fftn_ifftn_{n}^3"] = (
            ms(lambda: nd.ifftn(nd.fftn(x)), args.reps_big),
            ms(lambda: torch.fft.ifftn(torch.fft.fftn(x)), args.reps_big))
        del x
    torch.cuda.empty_cache()
    r = torch.randn(32768, 32768, generator=gen, device=dev)
    out["r2c_nat_32768x32768"] = (ms(lambda: krfft.r2c_nat(r), args.reps_big),
                                  ms(lambda: torch.fft.rfft(r, dim=1), args.reps_big))
    torch.cuda.empty_cache()
    hr, hc = nd.R2cFftHandler(32768), nd.FftHandler(32768)

    def step2():
        v = nd.ndfft(nd.ndfft_r2c(r, hr, axis=1), hc, axis=0)
        return nd.ndifft_r2c(nd.ndifft(v, hc, axis=0), hr, axis=1)

    out["step_32768^2"] = (ms(step2, args.reps_big),
                           ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r), s=r.shape),
                              args.reps_big))
    del r
    torch.cuda.empty_cache()
    x = crandn(8388608, 256)
    out["c2c_dense_rows_8388608x256"] = (ms(lambda: kfft.c2c_dense_rows(x, -1), args.reps_big),
                                         ms(lambda: torch.fft.fft(x, dim=1), args.reps_big))
    del x
    torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "ms_and_torch_fft_ms": out}), flush=True)
    return 0


def tile_fits(kfft, n, c):
    """A radix column tile of c columns of length n that a block takes."""
    return n * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(n, c) <= (
        kfft.RADIX_MAX_THREADS if n * c <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS)


K1_SHAPES = ((1, 512, 131584), (512, 512, 512), (1024, 1024, 513), (768, 768, 385),
             (1, 768, 295680), (1, 2048, 65536), (1, 4096, 4096), (1, 8192, 2048),
             (1, 20480, 130))
K18_SHAPES = ((1023, 1024, 1023), (1, 1024, 1046529), (1, 1536, 1535), (1, 10240, 130))


def scan_cols(torch, kfft, krfft, dev, gen, crandn, ms, card, root, k1_shapes, k18_shapes):
    """Kernels 1 and 18 at each column count C (and load) that fits."""
    sms = kfft.num_sms(dev)
    scan = {}
    for shape in k1_shapes:
        nb, n, cols = shape
        x = crandn(*shape)
        y = torch.empty_like(x)
        by = {}
        for c in (1, 2, 4, 8, 16, 32):
            if not tile_fits(kfft, n, c):
                continue
            for ldg in (False, True) if c <= 2 else (False,):
                by[f"{c}{'_ldg' if ldg else ''}"] = ms(
                    lambda: kfft.mid_radix_launch(x, y, -1, 1.0, c, ldg))
        c, ldg = kfft.axis_mid_tile(n, nb, cols, sms)
        scan["c2c_axis_mid_" + "x".join(map(str, shape))] = {
            "ms_by_cols_per_tile": by, "chosen": f"{c}{'_ldg' if ldg else ''}",
            "torch_fft_ms": ms(lambda: torch.fft.fft(x, dim=1))}
        del x, y
        torch.cuda.empty_cache()
    for shape in k18_shapes:
        nb, h, cols = shape
        xe = torch.randn(*shape, generator=gen, device=dev)
        xo = torch.randn(*shape, generator=gen, device=dev)
        out = torch.empty((nb, h + 1, cols), dtype=torch.complex64, device=dev)
        by = {c: ms(lambda: krfft.r2c_packed_mid_launch(xe, xo, out, -0.5, c))
              for c in (1, 2, 4, 8, 16, 32) if tile_fits(kfft, h, c)}
        scan["r2c_packed_mid_" + "x".join(map(str, shape))] = {
            "ms_by_cols_per_tile": by, "chosen": krfft.packed_mid_cols(h, nb, cols, sms)}
        del xe, xo, out
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "cols_scan": scan}), flush=True)
    return 0


K3_SHAPES = ((262144, 257), (589824, 385), (131072, 1025), (32768, 16385))
K17_SHAPES = ((1, 257, 262144), (512, 257, 512), (1, 641, 1280), (1, 385, 295680),
              (1, 513, 131072), (1, 1025, 65536), (1, 2049, 32768), (1, 4097, 16384),
              (1, 10241, 130))


def scan_c2r(torch, kfft, krfft, dev, crandn, ms, card, root):
    """Kernel 3 at each count of rows a block and kernel 17 at each column
    count C and store that fit."""
    sms = kfft.num_sms(dev)
    scan = {}
    for t, m in K3_SHAPES:
        n = 2 * (m - 1)
        h = n // 2
        s = crandn(t, m)
        per = 16 if h <= kfft.RADIX_WIDE_N else 32 if h <= 16384 else 40
        most = kfft.RADIX_MAX_THREADS if h <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS
        by = {r: ms(lambda: krfft.c2r_radix_launch(s, n, 1.0 / n, r))
              for r in range(1, min(16, most // -(-h // per)) + 1) if r * h <= 20480}
        scan[f"c2r_nat_{t}x{m}"] = {"ms_by_rows_per_block": by,
                                    "chosen": kfft.radix_block(h, t, sms),
                                    "torch_fft_ms": ms(lambda: torch.fft.irfft(s, n=n, dim=1))}
        del s
        torch.cuda.empty_cache()
    for shape in K17_SHAPES:
        nb, m, cols = shape
        n = 2 * (m - 1)
        h = n // 2
        s = crandn(*shape)
        out = torch.empty((nb, n, cols), device=dev)
        by = {c: ms(lambda: krfft.c2r_mid_radix_launch(s, out, n, 1.0 / n, c))
              for c in (1, 2, 4, 8, 16, 32) if tile_fits(kfft, h, c)}
        scan["c2r_mid_" + "x".join(map(str, shape))] = {
            "ms_by_cols_per_tile": by, "chosen": krfft.c2r_mid_cols(h, nb, cols, sms),
            "torch_fft_ms": ms(lambda: torch.fft.irfft(s, n=n, dim=1))}
        del s, out
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "c2r_scan": scan}), flush=True)
    return 0


def digest(t) -> str:
    """sha256 of a tensor's bytes, the first 16 hex digits."""
    import hashlib

    import torch

    r = torch.view_as_real(t) if t.is_complex() else t
    return hashlib.sha256(r.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def c2r(torch, nd, kfft, krfft, dev, gen, crandn, ms, reps_big, out):
    """Kernels 3 and 17 at their main shapes, the row core's other kernels,
    and the paths that run kernels 3 and 17."""
    def key(name, shape):
        return name + "_" + "x".join(map(str, shape))

    for t, m in ((262144, 257), (589824, 385), (32768, 16385)):
        n = 2 * (m - 1)
        s = crandn(t, m)
        reps = reps_big if t * m > 1 << 28 else None
        out[key("c2r_nat", (t, m))] = (ms(lambda: krfft.c2r_nat(s, n, 1.0 / n), reps),
                                       ms(lambda: torch.fft.irfft(s, n=n, dim=1), reps))
        del s
        torch.cuda.empty_cache()
    for shape in ((1, 257, 262144), (512, 257, 512), (1, 641, 1280)):
        n = 2 * (shape[1] - 1)
        s = crandn(*shape)
        out[key("c2r_mid", shape)] = (ms(lambda: krfft.c2r_mid(s, n, 1.0 / n)),
                                      ms(lambda: torch.fft.irfft(s, n=n, dim=1)))
        del s
    # the row skeleton's other kernels, with a digest of each output (the
    # same seeded input in every tree: equal digests are bit-identical outputs)
    for name, fn, shape in (("c2c_rows", lambda x: kfft.c2c_rows(x, -1), (262144, 512)),
                            ("c2c_dense_rows", lambda x: kfft.c2c_dense_rows(x, -1),
                             (65536, 256))):
        x = crandn(*shape)
        out[key(name, shape)] = (ms(lambda: fn(x)), ms(lambda: torch.fft.fft(x, dim=1)),
                                 digest(fn(x)))
        del x
    for name, fn, shape in (("r2c_nat", krfft.r2c_nat, (262144, 512)),
                            ("r2c_packed", krfft.r2c_packed, (65536, 256)),
                            ("r2c_packed_generic", krfft.r2c_packed_generic, (360000, 600))):
        x = torch.randn(*shape, generator=gen, device=dev)
        out[key(name, shape)] = (ms(lambda: fn(x)), ms(lambda: torch.fft.rfft(x, dim=1)),
                                 digest(fn(x)))
        del x
    torch.cuda.empty_cache()
    for n, first in ((512, True), (512, False), (768, False)):
        r = torch.randn(n, n, n, generator=gen, device=dev)
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)
        a, b, c = (0, 1, 2) if first else (2, 1, 0)

        def step():
            v = nd.ndfft(nd.ndfft(nd.ndfft_r2c(r, hr, axis=a), hc, axis=b), hc, axis=c)
            return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=c), hc, axis=b), hr, axis=a)

        dims = (1, 2, 0) if first else (0, 1, 2)
        s = tuple(r.shape[d] for d in dims)
        out[f"step_real_axis_{'first' if first else 'last'}_{n}^3"] = (
            ms(step, reps_big), ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r, dim=dims), s=s,
                                                             dim=dims), reps_big))
        del r
        torch.cuda.empty_cache()
    r = torch.randn(32768, 32768, generator=gen, device=dev)
    hr, hc = nd.R2cFftHandler(32768), nd.FftHandler(32768)

    def step2():
        v = nd.ndfft(nd.ndfft_r2c(r, hr, axis=1), hc, axis=0)
        return nd.ndifft_r2c(nd.ndifft(v, hc, axis=0), hr, axis=1)

    out["step_32768^2"] = (ms(step2, reps_big),
                           ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r), s=r.shape), reps_big))
    del r
    torch.cuda.empty_cache()
    s1(torch, nd, dev, gen, ms, reps_big, out)


def s1(torch, nd, dev, gen, ms, reps_big, out):
    """S1, the 1024^3 periodic Poisson solve, beside torch.fft."""
    n = 1024
    f = torch.randn(n, n, n, generator=gen, device=dev)
    kc = torch.fft.fftfreq(n, 1.0 / n, device=dev) ** 2
    kr = torch.arange(n // 2 + 1, device=dev, dtype=torch.float32) ** 2
    g = (kc[:, None, None] + kc[None, :, None] + kr[None, None, :]).reciprocal_()
    g[0, 0, 0] = 0.0
    hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)

    def solve():
        b = nd.ndfft(nd.ndfft_r2c(f, hr, axis=2), hc, axis=1)
        c = nd.ndspectral_c2c(b, g, hc, axis=0)
        del b
        return nd.ndifft_r2c(nd.ndifft(c, hc, axis=1), hr, axis=2)

    out["S1_periodic_poisson_1024^3"] = (
        ms(solve, reps_big), ms(lambda: torch.fft.irfftn(torch.fft.rfftn(f).mul_(g), s=f.shape),
                                reps_big))
    del f, g
    torch.cuda.empty_cache()


def spectral(torch, nd, kfft, krfft, dev, gen, crandn, ms, reps_big, out):
    """Kernels 14 and 22 at their main shapes with digests, and the paths
    S1 and S2 that run them (beside torch.fft)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def key(name, shape):
        return name + "_" + "x".join(map(str, shape))

    n = 1024
    kc = torch.fft.fftfreq(n, 1.0 / n, device=dev) ** 2
    kr = torch.arange(n // 2 + 1, device=dev, dtype=torch.float32) ** 2
    g1 = (kc[:, None, None] + kc[None, :, None] + kr[None, None, :]).reciprocal_()
    g1[0, 0, 0] = 0.0
    g1 = g1.reshape(n, -1)          # S1's lane-varying G, (1024, 525312)
    for shape, h in (((1, n, n * 513), g1), ((8, 1280, 8192), None)):
        x = crandn(*shape)
        h = randn(shape[1], 1) if h is None else h
        s = 1.0 / shape[1]
        out[key("spectral_c2c_mid", shape)] = (
            ms(lambda: kfft.spectral_c2c_mid(x, h, s), reps_big if x.numel() > 1 << 28 else None),
            None, digest(kfft.spectral_c2c_mid(x, h, s)))
        del x
        torch.cuda.empty_cache()
    del g1
    m = torch.arange(n // 2 + 1, device=dev, dtype=torch.float64)
    gain = torch.exp(-(2 * math.pi * m * (2.0 / n)) ** 2 / 24).float()    # S2's, (513,)
    for shape in ((1, n, n * n), (n, n, n), (8, 768, 16384)):
        x = randn(*shape)
        nn = shape[1]
        hr = gain[:, None] if nn == n else randn(nn // 2 + 1, 1)
        out[key("spectral_r2c_mid", shape)] = (
            ms(lambda: krfft.spectral_r2c_mid(x, hr, None, nn, 1.0 / nn),
               reps_big if x.numel() > 1 << 28 else None),
            None, digest(krfft.spectral_r2c_mid(x, hr, None, nn, 1.0 / nn)))
        del x
        torch.cuda.empty_cache()
    s1(torch, nd, dev, gen, ms, reps_big, out)
    f = randn(n, n, n)
    hr = nd.R2cFftHandler(n)
    gf = torch.exp(-(2 * math.pi * torch.fft.fftfreq(n, 1.0 / n, device=dev).double()
                     * (2.0 / n)) ** 2 / 24).float()

    def s2():
        y = nd.ndspectral_r2c(f, gain, hr, axis=0)
        y = nd.ndspectral_r2c(y, gain, hr, axis=1)
        return nd.ndspectral_r2c(y, gain, hr, axis=2)

    def s2_torch():
        sp = torch.fft.rfftn(f)
        sp.mul_(gf[:, None, None]).mul_(gf[None, :, None]).mul_(gain[None, None, :])
        return torch.fft.irfftn(sp, s=f.shape)

    out["S2_les_filter_1024^3"] = (ms(s2, reps_big), ms(s2_torch, reps_big))
    del f
    torch.cuda.empty_cache()


def dense(torch, nd, krfft, kdct, dev, gen, crandn, ms, reps_big, out):
    """Kernels 21 and 27 at their main shapes, kernels 16, 17, 18 and 20
    with digests, and the paths that run kernels 21 and 27."""
    from ndrustfft_tpu_torch.ops.hopper import fft as kfft

    def key(name, shape, *tags):
        return "_".join([name, "x".join(map(str, shape)), *map(str, tags)])

    # kernels 15 and 20 at their main shapes: the radix row core (h = 64,
    # 100) and the dense product (h = 131); the chirp-z at 262, 1094 and
    # 1097 and the dense product at 131 (2^23 reals); each also as device
    # time alone (graph_ms), beside the same for torch.fft.rfft
    for name, fn, shapes in (
            ("r2c_packed_dense", krfft.r2c_packed_dense,
             ((16384, 128), (200, 200), (16384, 262), (16384, 502), (16384, 62),
              (16384, 2))),
            ("r2c_dense_mid", krfft.r2c_dense_mid,
             ((1, 262, 65536), (1, 131, 65536), (1, 1094, 7668), (1, 1097, 7647)))):
        for shape in shapes:
            x = torch.randn(*shape, generator=gen, device=dev)
            dim = -1 if len(shape) == 2 else 1
            out[key(name, shape)] = (ms(lambda: fn(x)), ms(lambda: torch.fft.rfft(x, dim=dim)),
                                     digest(fn(x)))
            out[key(name, shape, "device")] = (graph_ms(lambda: fn(x)),
                                               graph_ms(lambda: torch.fft.rfft(x, dim=dim)))
            del x
    # kernel 11, whose column kernel kernel 20's chirp-z shares
    for shape in ((1, 509, 259081), (1, 1031, 1024)):
        z = crandn(*shape)
        out[key("c2c_blue_mid", shape)] = (ms(lambda: kfft.c2c_blue_mid(z, -1)),
                                           ms(lambda: torch.fft.fft(z, dim=1)),
                                           digest(kfft.c2c_blue_mid(z, -1)))
        del z
    torch.cuda.empty_cache()

    # kernel 21 on the radix tile (n = 256, 255, 264, 128), the dense
    # product (n = 129) and the chirp-z (n = 262, 1094; the product in the
    # parent), the last two also as device time alone
    for shape, n in (((1, 129, 65536), 256), ((1, 65, 65536), 129), ((1, 128, 32768), 255),
                     ((1, 133, 264), 264), ((1, 65, 128), 128), ((1, 132, 65536), 262),
                     ((1, 548, 7668), 1094)):
        s = crandn(*shape)
        out[key("c2r_dense_mid", shape, n)] = (
            ms(lambda: krfft.c2r_dense_mid(s, n, 1.0 / n)),
            ms(lambda: torch.fft.irfft(s, n=n, dim=1)), digest(krfft.c2r_dense_mid(s, n, 1.0 / n)))
        if n in (262, 1094):
            out[key("c2r_dense_mid", shape, n, "device")] = (
                graph_ms(lambda: krfft.c2r_dense_mid(s, n, 1.0 / n)),
                graph_ms(lambda: torch.fft.irfft(s, n=n, dim=1)))
        del s
    for shape, types in (((1, 512, 262144), (2, 3)), ((1024, 1024, 1024), (2, 3)),
                         ((129, 129, 129), (1,)), ((1, 1024, 1024), (4,))):
        x = torch.randn(*shape, generator=gen, device=dev)
        reps = reps_big if x.numel() > 1 << 28 else None
        for t in types:
            m_s = torch.from_numpy(kdct.dense_consts(shape[1], t, 2.0).T.copy()).to(dev)
            out[key("dct_dense_mid", shape, f"type{t}")] = (
                ms(lambda: kdct.dct_dense_mid(x, t, 2.0), reps),
                ms(lambda: torch.matmul(m_s, x), reps),
                digest(kdct.dct_dense_mid(x, t, 2.0)))
        del x
        torch.cuda.empty_cache()
    # the column skeleton's other kernels, with a digest of each output (the
    # same seeded input in every tree: equal digests are bit-identical outputs)
    x = torch.randn(1, 512, 262144, generator=gen, device=dev)
    out[key("r2c_mid", x.shape)] = (ms(lambda: krfft.r2c_mid(x)),
                                    ms(lambda: torch.fft.rfft(x, dim=1)), digest(krfft.r2c_mid(x)))
    s = crandn(1, 257, 262144)
    out[key("c2r_mid", s.shape)] = (ms(lambda: krfft.c2r_mid(s, 512, 1 / 512)),
                                    ms(lambda: torch.fft.irfft(s, n=512, dim=1)),
                                    digest(krfft.c2r_mid(s, 512, 1 / 512)))
    for shape in ((1, 256, 65536), (1, 129, 65536)):
        x = torch.randn(*shape, generator=gen, device=dev)
        out[key("r2c_dense_mid", shape)] = (ms(lambda: krfft.r2c_dense_mid(x)),
                                            ms(lambda: torch.fft.rfft(x, dim=1)),
                                            digest(krfft.r2c_dense_mid(x)))
    xe = torch.randn(64, 1024, 1023, generator=gen, device=dev)
    xo = torch.randn(64, 1024, 1023, generator=gen, device=dev)
    out[key("r2c_packed_mid", xe.shape)] = (ms(lambda: krfft.r2c_packed_mid(xe, xo, -0.5)),
                                            None, digest(krfft.r2c_packed_mid(xe, xo, -0.5)))
    del x, s, xe, xo
    torch.cuda.empty_cache()
    # S3's 1024^3 and the 512^3 Neumann Poisson solves
    for n, fused in ((1024, True), (512, False)):
        name = "S3_neumann_poisson_1024^3" if fused else "neumann_poisson_512^3"
        out[name] = neumann_cube_ms(torch, nd, dev, gen, n, fused, ms, reps_big)
    n = 256
    r = torch.randn(n, n, n, generator=gen, device=dev)
    hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)

    def step():
        v = nd.ndfft(nd.ndfft(nd.ndfft_r2c(r, hr, axis=0), hc, axis=1), hc, axis=2)
        return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=2), hc, axis=1), hr, axis=0)

    out["step_real_axis_first_256^3"] = (
        ms(step), ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r, dim=(1, 2, 0)),
                                              s=(n, n, n), dim=(1, 2, 0))), digest(step()))


def neumann_cube_ms(torch, nd, dev, gen, n, fused, ms, reps_big):
    """(ms, yardstick ms) of the n^3 Neumann Poisson solve on a random
    field with H = 1 / lambda (nddct2 on axes 2 and 1; on axis 0
    ndspectral_dct if ``fused``, else nddct2, the product and nddct3;
    nddct3 back on axes 1 and 2) and of the float32 Makhoul lowering through
    torch.fft, over ``reps_big`` runs."""
    f = torch.randn(n, n, n, generator=gen, device=dev)
    kq = torch.arange(n, device=dev, dtype=torch.float32) ** 2
    h3 = kq[:, None, None] + kq[None, :, None] + kq[None, None, :]
    h3.mul_(math.pi ** 2).reciprocal_()
    h3[0, 0, 0] = 0.0
    hd = nd.DctHandler(n)
    hdi = hd.normalization(nd.Normalization.scalar(1.0 / n))

    def solve():
        a = nd.nddct2(f, hd, axis=2)
        b = nd.nddct2(a, hd, axis=1)
        del a
        if fused:
            c = nd.ndspectral_dct(b, h3, hd, hdi, axis=0)
        else:
            c = nd.nddct2(b, hd, axis=0).mul_(h3)
            c = nd.nddct3(c, hdi, axis=0)
        del b
        return nd.nddct3(nd.nddct3(c, hdi, axis=1), hdi, axis=2)

    def yardstick():
        u = makhoul_dct(makhoul_dct(makhoul_dct(f, 2, 2), 1, 2), 0, 2)
        u.mul_(h3)
        for ax in (0, 1, 2):
            u = makhoul_dct(u, ax, 3) / (2 * n)
        return u

    times = (ms(solve, reps_big), ms(yardstick, reps_big))
    del f, h3
    torch.cuda.empty_cache()
    return times


def scan_dense(torch, kfft, krfft, kdct, dev, gen, crandn, ms, card, root):
    """Kernels 21 and 27 on the radix column tile at each column count C."""
    sms = kfft.num_sms(dev)

    def fits(n, c):
        return n * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(n, c) <= (
            kfft.RADIX_MAX_THREADS if n * c <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS)

    scan = {}
    for shape, n in (((1, 129, 65536), 256), ((1, 133, 264), 264), ((1, 65, 128), 128),
                     ((1, 65, 65536), 129), ((1, 128, 32768), 255)):
        nb, m, cols = shape
        s = crandn(*shape)
        y = torch.empty((nb, n, cols), device=dev)
        by = {c: ms(lambda: krfft.c2r_dense_radix_launch(s, y, n, 1.0 / n, c))
              for c in (1, 2, 4, 8, 16, 32, 64) if fits(krfft.r2c_mid_len(n), c)}
        scan[f"c2r_dense_mid_{nb}x{m}x{cols}_n{n}"] = {
            "ms_by_cols_per_tile": by, "chosen": krfft.c2r_dense_cols(n, nb, cols, sms)}
        del s, y
    for shape, types in (((1, 512, 262144), (2, 3)), ((1024, 1024, 1024), (2, 3)),
                         ((1, 1024, 1024), (2, 3)), ((129, 129, 129), (1,)),
                         ((1, 1025, 1025), (1,))):
        nb, n, cols = shape
        x = torch.randn(*shape, generator=gen, device=dev)
        y = torch.empty_like(x)
        reps = 5 if x.numel() > 1 << 28 else None
        for t in types:
            h = kdct.dct_radix_len(n, t)
            by = {c: ms(lambda: kdct.dct_radix_launch(x, y, t, 2.0, c), reps)
                  for c in (1, 2, 4, 8, 16, 32, 64) if fits(h, c)}
            scan[f"dct_dense_mid_{nb}x{n}x{cols}_type{t}"] = {
                "ms_by_cols_per_tile": by, "chosen": kdct.dct_radix_cols(n, t, nb, cols, sms)}
        del x, y
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "dense_scan": scan}), flush=True)
    return 0


def scan_dct_mid(torch, kfft, krfft, kdct, dev, gen, ms, reps_big, card, root):
    """Kernels 26 and 29 on the radix column tile at each column count
    C = 1 ... 16 that fits (the 16- and the 32/40-element forms), at C <= 2
    with both loads (evict-first and read-only), beside the counts
    dct.py::dct2_mid_cols and rfft.py::spectral_cols pick; then the ptxas
    registers and spill bytes of both kernels' instantiations."""
    sms = kfft.num_sms(dev)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def counts(h):
        for c in (1, 2, 4, 8, 16):
            if h * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(h, c) <= 512:
                for ldg in ((False, True) if c <= 2 else (False,)):
                    yield c, ldg

    scan = {}
    for shape in ((1, 1536, 1536 * 1536), (1536, 1536, 1536), (1, 2048, 2048), (1, 1152, 1152),
                  (1, 31104, 31104)):
        nb, n, cols = shape
        x = randn(*shape)
        y = torch.empty_like(x)
        reps = reps_big if x.numel() > 1 << 28 else None
        by = {f"{c}{'_ldg' if ldg else ''}":
              ms(lambda: kdct.dct_radix_launch(x, y, 3, 1.0 / n, c, ldg), reps)
              for c, ldg in counts(n // 2)}
        scan[f"dct3_mid_{nb}x{n}x{cols}"] = {
            "ms_by_cols_per_tile": by, "chosen": kdct.dct2_mid_cols(n // 2, nb, cols, sms)}
        del x, y
        torch.cuda.empty_cache()
    for shape, hcols in (((1, 1024, 1024 * 1024), 1024 * 1024), ((1, 2048, 4096), 1),
                         ((8, 1280, 8192), 1), ((1, 1152, 1152), 1), ((1, 31104, 31104), 31104)):
        nb, n, cols = shape
        x = randn(*shape)
        hv = randn(n, hcols)
        y = torch.empty_like(x)
        reps = reps_big if x.numel() > 1 << 28 else None
        by = {f"{c}{'_ldg' if ldg else ''}":
              ms(lambda: kdct.spectral_dct_radix_launch(x, y, hv, 2.0, 1.0 / n, c, ldg), reps)
              for c, ldg in counts(n // 2)}
        scan[f"spectral_dct_mid_{nb}x{n}x{cols}_h{hcols}"] = {
            "ms_by_cols_per_tile": by, "chosen": krfft.spectral_cols(n // 2, nb, cols, sms)}
        del x, hv, y
        torch.cuda.empty_cache()
    print(json.dumps({"root": root, "card": card, "dct_mid_scan": scan,
                      "ptxas": ptxas_entries(("spectral_dct", "Dct3ColILb"))}), flush=True)
    return 0


def route_dense(torch, kfft, krfft, kdct, dev, gen, crandn, ms, card, root, path, kernels):
    """Kernel 27 at every length with a radix plan, on the radix column
    tile (the wrapper's column count) and on the dense product; kernels 21
    and 20 at every length and kernel 15's dense rows at every half length
    on each of their kernels, the chirp-z at each column (row) count C that
    fits; over about 2^23 reals a call (the kernels of ``kernels`` alone):
    ms of each by n, written to ``path``; prints each family's lengths where
    another kernel than the route's was faster, and each route's summed time
    against the fastest kernel's."""
    sms = kfft.num_sms(dev)

    def chirp_cols(mk, launch, most=kfft.RADIX_MAX_ELEMS):
        """{C: ms} of a chirp-z launch(c) at each C that fits at M = mk, in
        at most ``most`` elements (kernels 21 and 15: the 16-element form)."""
        return {c: ms(lambda: launch(c), 10) for c in (1, 2, 4, 8, 16, 32)
                if tile_fits(kfft, mk, c) and mk * c <= most}

    scan = {}
    for t in (1, 2, 3) if 27 in kernels else ():
        for n in range(3, 1101):
            if kdct.dct_radix_len(n, t) is None:
                continue
            cols = max(64, (1 << 23) // n)
            x = torch.randn(1, n, cols, generator=gen, device=dev)
            y = torch.empty_like(x)
            c = kdct.dct_radix_cols(n, t, 1, cols, sms)
            scan.setdefault(f"dct_dense_mid_type{t}", {})[n] = (
                ms(lambda: kdct.dct_radix_launch(x, y, t, 2.0, c), 10),
                ms(lambda: kdct.dct_dense_launch(x, y, t, 2.0), 10))
            del x, y
    # kernel 21: the radix column tile (where a plan exists), the chirp-z C2R
    # at each C, the dense product, on the spectrum of (1, n, 2^23 / n)
    k21 = {}
    for n in range(4, 1101) if 21 in kernels else ():
        cols = max(64, (1 << 23) // n)
        s = crandn(1, n // 2 + 1, cols)
        y = torch.empty((1, n, cols), device=dev)
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        row = {"M": mk, "chirp_by_cols": chirp_cols(
            mk, lambda c: krfft.c2r_blue_launch(s, y, n, 1.0 / n, c), kfft.RADIX_WIDE_N),
            "chirp_cols": kfft.radix_mid_cols(mk, 1, cols, sms),
            "dense": ms(lambda: krfft.c2r_dense_launch(s, y, n, 1.0 / n), 10)}
        if krfft.r2c_mid_radix(n):
            c = krfft.c2r_dense_cols(n, 1, cols, sms)
            row["radix"] = ms(lambda: krfft.c2r_dense_radix_launch(s, y, n, 1.0 / n, c), 10)
        row["chirp"] = row["chirp_by_cols"][row["chirp_cols"]]
        k21[n] = row
        del s, y
    # kernel 20: the radix column tile (where a plan exists), the chirp-z at
    # each C, the dense product
    k20 = {}
    for n in range(4, 1101) if 20 in kernels else ():
        cols = max(64, (1 << 23) // n)
        x = torch.randn(1, n, cols, generator=gen, device=dev)
        y = torch.empty((1, n // 2 + 1, cols), dtype=torch.complex64, device=dev)
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        row = {"M": mk, "chirp_by_cols": chirp_cols(mk, lambda c: krfft.r2c_blue_launch(x, y, c)),
               "chirp_cols": kfft.radix_mid_cols(mk, 1, cols, sms),
               "dense": ms(lambda: krfft.r2c_dense_launch(x, y), 10)}
        if krfft.r2c_mid_radix(n):
            c = krfft.r2c_mid_cols(n, 1, cols, sms)
            row["radix"] = ms(lambda: krfft.r2c_mid_radix_launch(x, y, c), 10)
        row["chirp"] = row["chirp_by_cols"][row["chirp_cols"]]
        k20[n] = row
        del x, y
    # kernel 15's rows: the radix row core (where a plan exists; at
    # packed_dense_rows's count a block and at radix_block's) and the
    # chirp-z of the rows at each C
    k15 = {}
    for h in range(1, 257) if 15 in kernels else ():
        if krfft.packed_core(h):
            continue
        x = torch.randn((1 << 23) // (2 * h), 2 * h, generator=gen, device=dev)
        y = torch.empty((x.shape[0], h + 1), dtype=torch.complex64, device=dev)
        mk = kfft.chirp_m(h)
        row = {"M": mk, "chirp_by_cols": chirp_cols(
            mk, lambda c: krfft.r2c_blue_rows_launch(x, y, c), kfft.RADIX_WIDE_N),
            "chirp_cols": krfft.packed_blue_rows(mk, x.shape[0], sms)}
        if kfft.radix_plan(h) is not None:
            rows = krfft.packed_dense_rows(h, x.shape[0], sms)
            small = kfft.radix_block(h, x.shape[0], sms)
            row["radix"] = ms(lambda: krfft.r2c_radix_launch(x, "scan", rows), 10)
            row["radix_small_tile"] = ms(lambda: krfft.r2c_radix_launch(x, "scan", small), 10)
        row["chirp"] = row["chirp_by_cols"][row["chirp_cols"]]
        k15[h] = row
        del x, y
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"root": root, "card": card, "radix_ms_and_dense_ms": scan,
                   "c2r_dense_mid": k21, "r2c_dense_mid": k20, "r2c_packed_dense": k15}, f)

    def summary(rows, route):
        """Summed ms of the route and of the fastest kernel at each length,
        the product's (the remnant's kernel before the chirp-z) where the
        route does not name the radix kernel, and the lengths off the
        route; the chirp-z's fastest C by M."""
        out = {"route_ms": 0.0, "fastest_ms": 0.0, "dense_ms_off_radix": 0.0,
               "route_ms_off_radix": 0.0, "off_route": {}, "chirp_best_cols_by_M": {}}
        for n, row in rows.items():
            fast = min((k for k in ("radix", "chirp", "dense") if k in row), key=row.get)
            form = route(n)
            out["route_ms"] += row[form]
            out["fastest_ms"] += row[fast]
            if form != "radix" and "dense" in row:
                out["dense_ms_off_radix"] += row["dense"]
                out["route_ms_off_radix"] += row[form]
            if fast != form:
                out["off_route"][n] = {"route": form, "fastest": fast, "route_ms": row[form],
                                       "fastest_ms": row[fast]}
            out["chirp_best_cols_by_M"].setdefault(row["M"], []).append(
                min(row["chirp_by_cols"], key=row["chirp_by_cols"].get))
        out["forms"] = {f: [route(n) for n in rows].count(f) for f in ("radix", "chirp", "dense")
                        if f in map(route, rows)}
        return out

    print(json.dumps({"root": root, "card": card, "dense_faster": {
        name: {n: ts for n, ts in by.items() if ts[1] < ts[0]} for name, by in scan.items()},
        "lengths": {name: len(by) for name, by in scan.items()},
        "c2r_dense_mid": summary(k21, krfft.c2r_dense_form),
        "r2c_dense_mid": summary(k20, krfft.r2c_dense_form),
        "r2c_packed_dense": summary(k15, krfft.packed_dense_form),
        "r2c_packed_dense_ms_by_rows_rule": {
            "packed_dense_rows": sum(row.get("radix", 0.0) for row in k15.values()),
            "radix_block": sum(row.get("radix_small_tile", 0.0) for row in k15.values())}}),
        flush=True)
    return 0


def ptxas_entries(parts=None) -> dict:
    """Each entry function of the tree's build (built if need be) -> [its
    registers, spill bytes] from ptxas -v (nvcc.log); only those whose
    mangled name holds one of ``parts``, where given."""
    import re

    from ndrustfft_tpu_torch.ops.hopper import _build

    log = (_build.build().parent / "nvcc.log").read_text()
    entries = {}
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'")[0]
        if parts and not any(p in name for p in parts):
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        entries[name] = [int(regs.group(1)) if regs else None,
                         sum(map(int, spill.groups())) if spill else 0]
    return entries


def ptxas_callees(parts) -> dict:
    """Each entry function of the tree's build whose mangled name holds one
    of ``parts`` -> {callee: spill bytes} of the out-of-line functions it
    calls, as ptxas -v lists them after the entry (a function's spill
    depends on its callers: ptxas allocates it for each)."""
    import re

    from ndrustfft_tpu_torch.ops.hopper import _build

    log = (_build.build().parent / "nvcc.log").read_text()
    out = {}
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'")[0]
        if not any(p in name for p in parts):
            continue
        out[name] = {
            fn: int(st) + int(ld) for fn, st, ld in re.findall(
                r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill "
                r"stores, (\d+) bytes spill loads", entry) if fn != name}
    return out


def ptxas(root) -> int:
    """Build the tree's library and print each entry function's registers
    and spill bytes from ptxas -v (nvcc.log)."""
    print(json.dumps({"root": root, "ptxas": ptxas_entries()}), flush=True)
    return 0


def dct(torch, nd, kfft, krfft, kdct, dev, gen, crandn, ms, reps_big, out):
    """Kernels 23 and 12 at their main shapes, the kernels that share their
    code with digests, the permutations around kernel 12, and the paths
    that run kernels 23 and 12."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def key(name, shape, *tags):
        return "_".join([name, "x".join(map(str, shape)), *map(str, tags)])

    def big(x):
        return reps_big if x.numel() > 1 << 28 else None

    # kernels 23 and 24 on rows, 25 and 26 along a middle axis: the DCT
    # family's (262144, 512), S3's (1048576, 1024), the 1536^3 solve's and
    # G1's shapes, the odd k = 9 (65536, 1152), and kernels 25/26 at the
    # 2048^2 pair's and the n-point length 1152's (1, n, n)
    for shape, rows, views in (
            ((512 * 512, 512), True, ((512, 512, 512), (1, 512, 512 * 512))),
            ((1024 * 1024, 1024), True, ()),
            ((1536 * 1536, 1536), True, ((1536, 1536, 1536), (1, 1536, 1536 * 1536))),
            ((31104, 31104), True, ((1, 31104, 31104),)), ((65536, 1152), True, ()),
            ((2048, 2048), False, ((1, 2048, 2048),)), ((1152, 1152), False, ((1, 1152, 1152),))):
        x = randn(*shape)
        n = shape[1]
        if rows:
            for name, fn in (("dct2_nat", lambda: kdct.dct2_nat(x, 2.0)),
                             ("dct3_nat", lambda: kdct.dct3_nat(x, 1.0 / n))):
                out[key(name, shape)] = (ms(fn, big(x)), None, digest(fn()))
        for view in views:
            v = x.view(view)
            for name, fn in (("dct2_mid", lambda: kdct.dct2_mid(v, 2.0)),
                             ("dct3_mid", lambda: kdct.dct3_mid(v, 1.0 / n))):
                out[key(name, view)] = (ms(fn, big(x)), None, digest(fn()))
            del v
        del x
        torch.cuda.empty_cache()
    # kernel 29 at its main shapes: S3's (1, 1024, 1048576) and G1's
    # (1, 31104, 31104) with a lane-varying H, the Dirichlet solve's
    # (1, 2048, 4096), the spectral lengths' (8, 1280, 8192) and
    # (1, 1152, 1152) with a broadcast one
    for shape, hcols in (((1, 1024, 1024 * 1024), 1024 * 1024), ((1, 2048, 4096), 1),
                         ((8, 1280, 8192), 1), ((1, 1152, 1152), 1), ((1, 31104, 31104), 31104)):
        x = randn(*shape)
        n = shape[1]
        hv = randn(n, hcols)

        def fused():
            return kdct.spectral_dct_mid(x, hv, 2.0, 1.0 / n)

        out[key("spectral_dct_mid", shape, f"h{hcols}")] = (ms(fused, big(x)), None,
                                                             digest(fused()))
        del x, hv
        torch.cuda.empty_cache()
    # kernel 12 and the permutations around it (ops/dct.py)
    from ndrustfft_tpu_torch.ops import dct as tdct

    for shape in ((1, 2049, 2049 * 256), (2049, 2049, 256)):
        x = randn(*shape)
        for t, scale in ((2, 2.0), (3, None)):
            fn = (lambda t=t, scale=scale: kdct.dct23_blue_mid(x, t, scale))
            out[key("dct23_blue_mid", shape, f"type{t}")] = (ms(fn, reps_big), None, digest(fn()))
        for perm in ("makhoul_order", "makhoul_interleave"):   # a parent may not name them
            fn = getattr(tdct, perm, None)
            if fn is not None:
                out[key(perm, shape)] = (ms(lambda: fn(x), reps_big), None)
        del x
        torch.cuda.empty_cache()
    # the chirp-z kernels that share kernel 12's column kernel
    z = crandn(1, 509, 259081)
    out[key("c2c_blue_mid", z.shape)] = (ms(lambda: kfft.c2c_blue_mid(z, -1)), None,
                                         digest(kfft.c2c_blue_mid(z, -1)))
    del z
    x = randn(1, 262, 65536)
    out[key("r2c_dense_mid", x.shape)] = (ms(lambda: krfft.r2c_dense_mid(x)), None,
                                          digest(krfft.r2c_dense_mid(x)))
    s = crandn(1, 132, 65536)
    out[key("c2r_dense_mid", s.shape, 262)] = (
        ms(lambda: krfft.c2r_dense_mid(s, 262, 1.0 / 262)), None,
        digest(krfft.c2r_dense_mid(s, 262, 1.0 / 262)))
    x = randn(16384, 262)
    out[key("r2c_packed_dense", x.shape)] = (ms(lambda: krfft.r2c_packed_dense(x)), None,
                                             digest(krfft.r2c_packed_dense(x)))
    del x, s
    torch.cuda.empty_cache()
    # the paths: random fields (the kernels' time does not depend on them)
    for name, shape in (("neumann_pair_2049^2x256", (2049, 2049, 256)),
                        ("G1_pair_31104^2", (31104, 31104)),
                        ("neumann_pair_1536^3", (1536, 1536, 1536))):
        f = randn(*shape)

        def pair():
            return nd.idctn(nd.dctn(f, 2), 2)

        out[name] = (ms(pair, reps_big), None)
        if name.startswith("G1"):
            n = shape[0]
            h = nd.DctHandler(n)
            hi = h.normalization(nd.Normalization.scalar(1.0 / n))
            hv = torch.rand(n, n, generator=gen, device=dev)

            def spectral():
                a = nd.nddct2(f, h, axis=1)
                b = nd.ndspectral_dct(a, hv, h, hi, axis=0)
                del a
                return nd.nddct3(b, hi, axis=1)

            out["G1_spectral_31104^2"] = (ms(spectral, reps_big), None)
            del hv
        del f
        torch.cuda.empty_cache()
    out["S3_neumann_poisson_1024^3"] = neumann_cube_ms(torch, nd, dev, gen, 1024, True, ms,
                                                       reps_big)


def dct14(torch, nd, kfft, krfft, kdct, dev, gen, crandn, ms, reps_big, out):
    """Kernels 28 and 19 at their main shapes, the column tile's other
    kernels with digests, and the paths that run kernels 28 and 19."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def key(name, shape, *tags):
        return "_".join([name, "x".join(map(str, shape)), *map(str, tags)])

    def big(x):
        return reps_big if x.numel() > 1 << 28 else None

    # kernel 28: the mixed solve's (2048, 2048, 256) and (1, 2048, 524288),
    # F = 6's (1, 1536, 1536), G2's (1, 65536, 8192), the crossover's
    # (1, 40960, 8192) and the remnant's prime F = 131 and 163; kernel 19:
    # the vertex-centred solve's (2049, 2049, 257) and (1, 2049, 526593)
    # and F = 12's (1, 1537, 1537)
    for name, fn, shapes in (
            ("dct4_mid", lambda x: kdct.dct4_mid(x, 2.0),
             ((2048, 2048, 256), (1, 2048, 524288), (1, 1536, 1536), (1, 65536, 8192),
              (1, 40960, 8192), (1, 256 * 131, 1024), (1, 256 * 163, 1024))),
            ("dct1_mid", lambda x: krfft.dct1_mid(x, 0.5),
             ((2049, 2049, 257), (1, 2049, 526593), (1, 1537, 1537)))):
        for shape in shapes:
            x = randn(*shape)
            out[key(name, shape)] = (ms(lambda: fn(x), big(x)), None, digest(fn(x)))
            del x
            torch.cuda.empty_cache()
    # the kernels on the same column skeleton (its load handle changed):
    # kernels 1, 4, 6 (C2C), 16, 18, 20 (R2C), 17, 21 (C2R), 25, 26, 27
    z = crandn(1, 4096, 4096)
    out[key("c2c_axis_mid", z.shape)] = (ms(lambda: kfft.c2c_axis_mid(z, -1)), None,
                                         digest(kfft.c2c_axis_mid(z, -1)))
    z = crandn(1, 256, 65536)
    out[key("c2c_dense_mid", z.shape)] = (ms(lambda: kfft.c2c_dense_mid(z, -1)), None,
                                          digest(kfft.c2c_dense_mid(z, -1)))
    z = crandn(600, 600, 301)
    out[key("c2c_generic_mid", z.shape)] = (ms(lambda: kfft.c2c_generic_mid(z, -1)), None,
                                            digest(kfft.c2c_generic_mid(z, -1)))
    x = randn(1, 512, 262144)
    for name, fn in (("r2c_mid", lambda: krfft.r2c_mid(x)),
                     ("dct2_dense_mid", lambda: kdct.dct_dense_mid(x, 2, 2.0)),
                     ("dct3_dense_mid", lambda: kdct.dct_dense_mid(x, 3, 2.0))):
        out[key(name, x.shape)] = (ms(fn), None, digest(fn()))
    xe, xo = randn(1023, 1024, 1023), randn(1023, 1024, 1023)
    out[key("r2c_packed_mid", xe.shape)] = (
        ms(lambda: krfft.r2c_packed_mid(xe, xo, -0.5), reps_big), None,
        digest(krfft.r2c_packed_mid(xe, xo, -0.5)))
    del xe, xo
    x = randn(1, 256, 65536)
    out[key("r2c_dense_mid", x.shape)] = (ms(lambda: krfft.r2c_dense_mid(x)), None,
                                          digest(krfft.r2c_dense_mid(x)))
    s = crandn(1, 257, 262144)
    out[key("c2r_mid", s.shape)] = (ms(lambda: krfft.c2r_mid(s, 512, 1.0 / 512)), None,
                                    digest(krfft.c2r_mid(s, 512, 1.0 / 512)))
    s = crandn(1, 65, 65536)
    out[key("c2r_dense_mid", s.shape, 129)] = (
        ms(lambda: krfft.c2r_dense_mid(s, 129, 1.0 / 129)), None,
        digest(krfft.c2r_dense_mid(s, 129, 1.0 / 129)))
    x = randn(129, 129, 129)
    out[key("dct1_dense_mid", x.shape)] = (ms(lambda: kdct.dct_dense_mid(x, 1, 2.0)), None,
                                           digest(kdct.dct_dense_mid(x, 1, 2.0)))
    x = randn(1, 2048, 2048)
    for name, fn in (("dct2_mid", lambda: kdct.dct2_mid(x, 2.0)),
                     ("dct3_mid", lambda: kdct.dct3_mid(x, 2.0))):
        out[key(name, x.shape)] = (ms(fn), None, digest(fn()))
    del x, z, s
    torch.cuda.empty_cache()
    # the paths: the vertex-centred Neumann pair (dctn, idctn of type 1) on
    # 2049^2 x 257, the mixed pair of type 4 on 2048^2 x 256 and G2's on
    # 65536 x 8192 (DCT-IV along axis 0, DCT-II along axis 1, and back);
    # random fields (the kernels' time does not depend on them)
    for name, shape, fwd, inv in (
            ("neumann_vertex_pair_2049^2x257", (2049, 2049, 257), lambda f: nd.dctn(f, 1),
             lambda f: nd.idctn(f, 1)),
            ("mixed_pair_2048^2x256", (2048, 2048, 256), lambda f: nd.dctn(f, 4),
             lambda f: nd.idctn(f, 4)),
            ("G2_pair_65536x8192", (65536, 8192),
             lambda f: nd.dctn(nd.dctn(f, 4, axes=(0,)), 2, axes=(1,)),
             lambda f: nd.idctn(nd.idctn(f, 2, axes=(1,)), 4, axes=(0,)))):
        f = randn(*shape)
        out[name] = (ms(lambda: inv(fwd(f)), reps_big), None)
        del f
        torch.cuda.empty_cache()


def fourstep(torch, nd, kfft, dev, gen, crandn, ms, reps_big, out):
    """Kernels 7 and 13 at the main paths' shapes with digests, kernel 7 at
    a prime n1, and the two paths that run them (beside torch.fft)."""
    for shape in ((256, 1024, 1024), (16385, 256, 128), (8, 131, 8192)):
        x = crandn(*shape)
        scale = 1.0 / (shape[1] * shape[2])
        calls = [("fourstep_mid", lambda: kfft.fourstep_mid(x, -1))]
        if shape[1] != 131:
            calls.append(("rows_store_t", lambda: kfft.rows_store_t(x, +1, scale)))
        for name, fn in calls:
            out[name + "_" + "x".join(map(str, shape))] = (ms(fn), None, digest(fn()))
        del x
        torch.cuda.empty_cache()
    xa = crandn(256, 1 << 20)
    ha = nd.FftHandler(1 << 20)
    out["c2c_256x2^20_round_trip"] = (
        ms(lambda: nd.ndifft(nd.ndfft(xa, ha, axis=1), ha, axis=1), reps_big),
        ms(lambda: torch.fft.ifft(torch.fft.fft(xa, dim=1), dim=1), reps_big))
    del xa
    torch.cuda.empty_cache()
    r = torch.randn(32768, 32768, generator=gen, device=dev)
    hr, hc = nd.R2cFftHandler(32768), nd.FftHandler(32768)

    def step2():
        v = nd.ndfft(nd.ndfft_r2c(r, hr, axis=1), hc, axis=0)
        return nd.ndifft_r2c(nd.ndifft(v, hc, axis=0), hr, axis=1)

    out["step_32768^2"] = (ms(step2, reps_big),
                           ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r), s=r.shape), reps_big))
    del r
    torch.cuda.empty_cache()


def axis_mid(torch, nd, kfft, krfft, dev, gen, crandn, ms, reps_big, out):
    """Kernels 1 and 18 at their main shapes and the paths that run them."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def key(name, shape):
        return name + "_" + "x".join(map(str, shape))

    for shape in ((1, 512, 131584), (768, 768, 385), (1, 4096, 4096), (1024, 1024, 513)):
        x = crandn(*shape)
        out[key("c2c_axis_mid", shape)] = (ms(lambda: kfft.c2c_axis_mid(x, -1)),
                                           ms(lambda: torch.fft.fft(x, dim=1)))
        del x
    torch.cuda.empty_cache()
    for shape in ((1023, 1024, 1023), (1, 1024, 1046529), (1, 1536, 1535)):
        nb, h, cols = shape
        xe, xo = randn(*shape), randn(*shape)
        col = torch.stack([xe, xo], dim=2).reshape(nb, 2 * h, cols)
        reps = reps_big if xe.numel() > 1 << 28 else None
        out[key("r2c_packed_mid", shape)] = (
            ms(lambda: krfft.r2c_packed_mid(xe, xo, -0.5), reps),
            ms(lambda: torch.fft.rfft(col, dim=1), reps))
        del xe, xo, col
        torch.cuda.empty_cache()
    x = crandn(4096, 4096)
    h = nd.FftHandler(4096)
    out["c2c_fftn_ifftn_4096^2"] = (
        ms(lambda: nd.ndifft(nd.ndifft(nd.ndfft(nd.ndfft(x, h, axis=1), h, axis=0), h, axis=0),
                             h, axis=1)),
        ms(lambda: torch.fft.ifftn(torch.fft.fftn(x))))
    del x
    for n, first in ((512, True), (768, False)):
        r = randn(n, n, n)
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)
        a, b, c = (0, 1, 2) if first else (2, 1, 0)

        def step():
            v = nd.ndfft(nd.ndfft(nd.ndfft_r2c(r, hr, axis=a), hc, axis=b), hc, axis=c)
            return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=c), hc, axis=b), hr, axis=a)

        dims = (1, 2, 0) if first else (0, 1, 2)
        s = tuple(r.shape[d] for d in dims)
        out[f"step_real_axis_{'first' if first else 'last'}_{n}^3"] = (
            ms(step, reps_big), ms(lambda: torch.fft.irfftn(torch.fft.rfftn(r, dim=dims), s=s,
                                                             dim=dims), reps_big))
        del r
        torch.cuda.empty_cache()
    n = 1023
    f = randn(n, n, n)

    def dst1_torch(x, axis):
        xm = x.movedim(axis, -1)
        z = torch.zeros_like(xm[..., :1])
        ext = torch.cat([z, xm, z, -xm.flip(-1)], dim=-1)
        return (-torch.fft.rfft(ext).imag[..., 1:n + 1]).movedim(-1, axis)

    out["dstn_idstn_1023^3"] = (
        ms(lambda: nd.idstn(nd.dstn(f, 1), 1), reps_big),
        ms(lambda: dst1_torch(dst1_torch(dst1_torch(dst1_torch(dst1_torch(dst1_torch(
            f, 0), 1), 2), 0), 1), 2), reps_big))
    del f
    torch.cuda.empty_cache()
    s1(torch, nd, dev, gen, ms, reps_big, out)


if __name__ == "__main__":
    sys.exit(main())
