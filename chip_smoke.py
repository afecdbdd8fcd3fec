#!/usr/bin/env python3
"""Smoke test of ndrustfft_tpu_torch on one CUDA card (an H100).

Run from the root of a checkout:  python3 chip_smoke.py [--seed S] [--reps R]

Phases (each prints one JSON line; any failure raises and exits non-zero
without the final line):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from ndrustfft_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     slices' shapes (ragged column and row tiles included; the chirp-z
     forms of kernels 20, 21, 15 and 12 at each column or row count a tile,
     kernels 23 and 24 on the radix row core at each count of rows a
     block, kernels 25, 26 and 29 on the radix column tile at each column
     count C, kernel 28's four-step at forced short splits against its
     plain version and the single pass's), and the census of kernels 24,
     25, 26 and 29 against their
     plain versions at each of their 259 radix lengths (within 2e-6 of the
     peak; kernel 29, two transforms, within 5e-6);
  4. the main paths through the public functions, each with every launch
     counter set to 0 just before it and read just after; the counters
     must account for every leg and the torch engine must not run:
     a. the real spectral step through ndfft_r2c / ndfft / ndifft /
        ndifft_r2c: the 512^2 and 1024^2 flagship and a 512^3 grid, against
        torch.fft.rfftn in float64 (oracle only), with the round trip;
     b. the DCT/DST family through nddct1..4 / nddst2..3: the reference's
        dct2d grid (DCT-I along axis 0 of n x n, n = 129, 265, 513, 1025),
        the 1024^2 DCT-II/III and DST-II/III pairs on both axes with
        DCT-IV along axis 0, against scipy.fft in float64, and the Neumann
        Poisson solve on a 512^3 cell-centred grid (DCT-II on axes 2, 1, 0,
        division by the cosine-basis eigenvalues, DCT-III back) against a
        float64 torch.fft Makhoul lowering (oracle only) and the analytic
        solution;
     c. the complex n-D transform through ndfft / ndifft: ndfft along every
        axis and ndifft back (Default normalization) of 1024^2, 256^3 and
        512^3 complex64 fields, and the reference's fft2d protocol (C2C
        along axis 0 of n x n, n = 128, 264, 512, 1024), against
        torch.fft.fftn in complex128 (oracle only), with the round trip;
     d. real transforms along a middle axis through ndfft_r2c /
        ndifft_r2c: the reference's rfft2d protocol (R2C along axis 0 of
        n x n, n = 128, 264, 512, 1024, and back), and the 512^3 and 256^3
        real steps with the real axis first (R2C along axis 0, C2C along
        axes 1 and 2, and the inverse chain), against torch.fft.rfft(dim=0)
        and torch.fft.rfftn(dim=(1, 2, 0)) in float64 (oracle only), with
        the round trip; every R2C on the radix column tile (kernels 16 and
        20);
     e. the lane lowerings along the last axis: the 256^3 and 128^3 real
        steps (R2C along axis 2 on kernel 15, C2C along axes 1 and 0, the
        inverse chain with the C2R's Hermitian extension on kernel 8) and
        the odd 129^3 R2C/C2R (row pairs on kernel 8) against
        torch.fft.rfftn / rfft in float64 (oracle only), with the round
        trip; the Chebyshev DCT-I on all three axes of 129^3 and along the
        last axis of n x n (n = 129, 513, 1025) with DST-I beside it (kernel
        15 on the core), DCT-IV/DST-IV along the last axis of 1024^2 and
        512^3 (kernel 10), DCT-III and DCT-II of 200^2 (kernel 8, kernel
        15's dense rows on the radix row core), against scipy.fft in
        float64;
     f. the lengths without a split (kernel 8 at n > 256 on the radix
        core; kernel 6 along a middle axis on the radix core's column
        tile; kernel 15 at such a half length on the radix row core with
        its unpack epilogue): the 600^3 real step
        with the real axis last (kernel 15 at h = 300, kernel 6 four times,
        kernel 8 at n = 600 after the C2R's Hermitian extension) against torch.fft.rfftn in float64 (oracle
        only), with the round trip; ndfft/ndifft along the last axis of
        264^2 and along axis 0 of 1200 x 256, ndfft_r2c at 530 (odd h) and
        ndifft_r2c at 300, DCT-I at 265 and DST-I at 263, DCT-II/III of
        600^2, DCT-IV of 1000^2 along the last axis, and the DCT-IV/DST-IV
        composite along axis 0 of 1200 x 600 (kernel 6), against float64
        torch.fft / scipy.fft;
     g. the lengths the bts2 wide core took (kernels 10, 2/15 and 3 at
        those F on the radix row core, kernel 1 on the radix column tile):
        the
        768^3 real step with the real axis last (kernel 2 at h = 384, F = 3;
        kernel 1 at F = 6 four times; kernel 3) against torch.fft.rfftn in float64
        (oracle only), with the round trip; the 4096^2 complex round trip
        (kernel 10 on the radix core, kernel 1 at F = 32) against
        torch.fft.fftn in complex128; the 4096^2 real step
        (kernel 1 at the ragged (1, 4096, 2049)), ndfft/ndifft at 384, 1152,
        16256 (F = 127, prime) and 20480 along the last axis and at 640 and
        20480 along axis 0, ndfft_r2c/ndifft_r2c at 1536 and 40960, DCT-I
        at 769 (kernel 15 at h = 768), DCT-IV at 768 and the C2R's
        extension to 640 (kernel 10 inside), against float64 torch.fft /
        scipy.fft;
     h. DCT-II/III on every axis at every length (kernels 25/26 along a
        middle axis on the radix column tile, kernels 23/24 on the radix
        row core): the 3-D Neumann Poisson
        solve at 1536^3 float32 (DCT-II along axes 2, 1, 0 on K23 at
        h = 768 on the radix row core and K25 at h = 768;
        division by the eigenvalues in place, slab by slab; DCT-III back on
        K26 and K24), its forward spectrum against the exact sparse values
        and its solution against the analytic one, slab by slab in float64;
        the DCT-II/III pair along both axes of 2048^2 (K23-K26 on the radix
        cores), nddct2/nddct3 along axis 0 at 1152 and 1280
        and along the last axis at 128, 384 and 768,
        nddst2 along axis 0 at 1536, and the R2C/C2R along axis 0
        at 768 and 1280 (K16/K17 at F = 3, 5) against float64 scipy.fft /
        torch.fft; then each kernel of the solve at its 1536^3 shape
        against its plain version on the same input, slice by slice (the
        plain version does not fit whole), their times, and the solve's
        time against a float32 torch.fft Makhoul solve (in slabs, to fit);
     i. DST-I, DCT-I and DCT-IV along a middle axis (kernels 18, 19 and 28)
        through the multi-axis functions: the Dirichlet Poisson solve on the
        1023^3 interior of a 1024^3 grid (dstn / idstn of type 1: K18 at
        h = 1024 on axes 0 and 1, K15 on axis 2), the vertex-centred Neumann
        solve on 2049 x 2049 x 257 (dctn / idctn of type 1: K19 on axes 0
        and 1) and the mixed Neumann-Dirichlet cell-centred solve on
        2048 x 2048 x 256 (type 4: K28 on axes 0 and 1, the DCT-IV lane on
        axis 2), each forward spectrum against its exact sparse values and
        each solution against the analytic one, slab by slab in float64;
        DST-I, DCT-I, DCT-IV and DST-IV along axis 0 at 255 ... 40960
        against float64 scipy.fft (DCT-IV at 41216 on K28's four-step,
        41728 in its long form and 33536 on its wide core);
        each solve kernel at its shape against its plain version slice by
        slice, their times (K18 against torch.fft.rfft of the interleaved
        column), the solves' times and the Dirichlet solve against a
        float32 torch.fft DST-I solve (in slabs, to fit);
     j. Bluestein lengths (a prime factor above 128; kernels 11 and 12, the
        lane's chirp-z on kernel 10; kernel 11 on the radix core's column
        tile at every F): the 509^3 complex64 round trip (fftn /
        ifftn: K11 at F = 8, M = 1024, on axes 0 and 1; the engine's chirp-z on
        axis 2, its sub-FFTs on K10 at M = 1024) against torch.fft.fftn in
        complex128 with the round trip, its time against torch.fft.fftn +
        ifftn and each forward leg's; the 2049^2 x 256 cell-centred Neumann
        solve (dctn / idctn of type 2: K12's chirp-z at M = 4608 on axes 0
        and 1; K23/K24 on axis 2) against its exact spectrum and analytic
        solution, its time and peak memory against a float32 torch.fft
        Makhoul solve (in slabs, to fit), with K12's Makhoul permutations
        timed alone; ndfft, R2C/C2R, DCT-I..IV and DST-I/II at
        Bluestein lengths 131 ... 6781 on both axis kinds against float64
        torch.fft / scipy.fft; K11, K12 and K10 at the main paths' shapes
        against their plain versions slice by slice, with their times;
     k. the four-step long C2C (kernel 7, the column FFT with the exit
        twiddle, and kernel 13, the row FFT with the transposed store;
        engine._fourstep): the 256 x 2^20 complex64 round trip along the
        last axis (ndfft / ndifft: K7 on the radix column tile and K13 on
        the radix row core, split (1024, 1024)) against complex128
        torch.fft.fft on a slice of rows
        and the round trip, its time and peak memory against torch.fft.fft
        + ifft; the 32768^2 real spectral step (K2 and K3 on the radix row
        core at h = 16384; the
        C2C along axis 0 on the four-step (256, 128): K7 on the radix
        column tile at (16385, 256, 128), K13 at n2 = 128) against float64
        torch.fft.rfftn with the round trip, its time against
        torch.fft.rfftn + irfftn and each public leg's; ndfft at 10007 (the
        lane's chirp-z at M = 20736 on the four-step), 36992 ... 786432 and
        one row of 2^22, ndfft_r2c / ndifft_r2c at 65536, nddct4 at 32768
        and nddct2 / nddct3 at 65536 against float64 torch.fft / scipy.fft;
        K7 and K13 at the paths' shapes against their plain versions slice
        by slice, with their times;
     l. the fused spectral pipelines (kernel 14 IFFT(H FFT(x)), kernel 22
        C2R(H R2C(x)), kernel 29 DCT-III(H DCT-II(x))) through
        ndspectral_c2c / ndspectral_r2c / ndspectral_dct / ndspectral_dst,
        three paths at 1024^3 float32: S1, the periodic pressure Poisson
        solve (K2 on axis 2, K1 on axis 1, ndspectral_c2c on axis 0 with
        the lane-varying G = 1/|k|^2: K14 on the radix column tile, n =
        1024; K1 and K3 back);
        S2, a separable Gaussian LES test filter (ndspectral_r2c on axes 0
        and 1: K22 on the radix column tile, h = 512; the composition K2,
        multiply, K3 on axis
        2) and a spectral derivative (the complex multiplier i k, K22); S3,
        the cell-centred Neumann Poisson solve (K23, K27, ndspectral_dct on
        axis 0 with the lane-varying H = 1/lambda: K29 on the radix column
        tile, h = 512; K27, K24), and ndspectral_dst along axis 0 of a
        2048 x 4096 Dirichlet field (K29 and the flip/sign conjugation);
        each against its
        analytic field slab by slab in float64, its time against the
        torch.fft yardstick (rfftn, multiply, irfftn; the float32 Makhoul
        lowering for S3) and against the port's unfused composition (K1,
        a torch multiply, K1; K16, multiply, K17; K27 or K25, multiply,
        K27 or K26), each fused leg timed beside its unfused one; the
        lengths K14, K22 and K29 open on the radix column tile (K14 at
        384 ... 20480, K22 at 512 ... 40960, K29 at 256
        ... 32768 and 20608) against float64 oracles under
        Default, NONE and scalar norms; each fused kernel at its path's
        shape against its plain version slice by slice (K29 also at the
        Dirichlet leg's shape);
     m. the long DCT lengths (kernels 23 to 26 and 29 at n = 128 k, odd
        k > 160: on the radix cores where n/2 has a plan, in the n-point
        form on the wide core's real tile at the prime k; kernel 28 at
        n = 256 F, F > 160: the column four-step, the long form at a prime
        F): G1, the cell-centred Neumann
        Poisson solve on a 31104^2 grid (F = 243) through dctn / idctn of
        type 2 (K23 on the radix row core and K25, then K26 on the radix
        column tile and K24 on the radix row core) and again with
        ndspectral_dct on axis 0 and the lane-varying H = 1/lambda (K23,
        K29 on the radix column tile, K24), its time against a float32
        torch.fft Makhoul solve; G2, the mixed Neumann-Dirichlet solve on
        65536 x 8192 (DCT-IV on axis 0: K28's four-step, F = 256; DCT-II/III on
        axis 1: K23 on the radix row core, K24 wide);
        each against its exact spectrum and analytic solution, with its
        time and peak memory; DCT-II/III and DST-II/III at 20608 ... 32640,
        DCT-IV/DST-IV at 41216 ... 65536 and ndspectral_dct /
        ndspectral_dst at 20608 ... 32640 against float64 scipy.fft; each
        long kernel at the paths' shapes against its plain version slice by
        slice, with its time;
     n. the radix core's census: every length n in 257 ... 20480 whose
        last-axis C2C over 128 rows the gates send to kernel 10 or to
        kernel 8's generic route (1734 lengths),
        ndfft and ndifft on a (128, n) field against torch.fft in
        complex128 (oracle only), within TOL_KERNEL of the oracle's peak;
     o. the Bluestein census: for each of the 101 convolution factors F
        that kernel 11 takes on the radix column tile, ndfft and ndifft
        along axis 1 of a (1, n, 130) field at the smallest and the largest
        n of that F, against torch.fft in complex128 (oracle only);
     p. kernel 15's census: ndfft_r2c over (128, 2h) at each of the 1582
        generic half lengths h (the radix row core with the unpack
        epilogue), against torch.fft.rfft in float64 (oracle only);
     q. the census of kernels 8 and 6 on the radix core: ndfft and ndifft
        over (128, n) at each of the 232 lengths n <= 256 that the gates
        send to kernel 8's rows, and along axis 1 of (1, n, 130) at each of
        the 1402 lengths that they send to kernel 6, against torch.fft in
        complex128 (oracle only);
     r. the census of kernels 4 and 11 on the radix column tile: ndfft and
        ndifft along axis 1 of (1, n, 130) at each of the 412 lengths that
        the gates send to kernel 4 (C2C_DENSE_MID, n = 2 ... 511) and each of
        the 57 Bluestein lengths that kernel 11 takes at F in {4, 8, 16}
        (M = 512, 1024, 2048), against torch.fft in complex128 (oracle
        only), within 1e-6 of the oracle's peak;
     s. the census of kernels 20 and 16: ndfft_r2c along axis 1 of
        (1, n, 130) at each of the 1094 lengths that the gates send to
        kernel 20 (R2C_DENSE_MID, n = 4 ... 1100, each on the kernel that
        rfft.py::r2c_dense_form names: the radix column tile, the chirp-z
        or the dense product) and each of the 153 that they send to
        kernel 16 (R2C_MID, n = 512 ... 40960, all on the radix column
        tile), against torch.fft.rfft in float64 (oracle only): the radix
        column tile and the chirp-z within 1e-6 of the oracle's peak, the
        dense product within TOL_KERNEL;
     t. the census of kernels 1 and 18 on the radix column tile: ndfft and
        ndifft along axis 1 of (1, n, 130) at each of the 152 lengths that
        the gates send to kernel 1 (C2C_AXIS_MID, n = 384 ... 20480)
        against torch.fft in complex128, and nddst1 along axis 1 of
        (1, n, 130) at each of the 153 that they send to kernel 18
        (R2C_PACKED_MID, n = 255 ... 20479) against scipy's DST-I through
        float64 torch.fft (oracles only), within 1e-6 of the oracle's peak;
     u. the census of kernels 3 and 17 on the radix core: ndifft_r2c along
        the last axis of (128, h + 1) at each of the 153 half lengths that
        the gates send to kernel 3 (C2R_NAT, h = 256 ... 20480) and along
        axis 1 of (1, h + 1, 130) at each of the 153 that they send to
        kernel 17 (C2R_MID), the DC and Nyquist imaginary parts to be
        ignored, against torch.fft.irfft in float64 (oracle only), within
        1e-6 of the oracle's peak;
     v. the census of kernels 21 and 27: ndifft_r2c along axis 1 of
        (1, n/2 + 1, 130) at each 4 <= n <= 1100 (the 701 on the radix
        column tile, with a plan of n/2 at even n and of n at odd n: 698
        on kernel 21, 512, 768 and 1024 on kernel 17; the 396 others on
        kernel 21's chirp-z or dense product as rfft.py::c2r_dense_form
        names, the product within TOL_KERNEL), against torch.fft.irfft in
        float64, and nddct1/2/3 along axis 1 of (1, n, 130) at each of the
        671, 439 and 439 lengths that kernel 27 takes on the radix column
        tile, against scipy.fft.dct in float64 (oracles only), within 1e-6
        of the oracle's peak;
     w. kernel 15's census at its dense rows: r2c_packed_dense over
        (128, 2h) at each of the 254 half lengths h <= 256 that are not
        128 F (229 on the radix row core, h = 1, 31 and the primes 131 ...
        251 on the chirp-z), against torch.fft.rfft in float64 (oracle
        only), within 1e-6 of the oracle's peak;
     x. the census of kernels 23 and 12: nddct2 over (128, n) at each of
        the 259 lengths n = 128 k whose half length has a radix plan
        (kernel 23 on the radix row core), and nddct2 and nddct3 along
        axis 1 of (1, n, 130) at each of the 3264 Bluestein lengths n =
        1101 ... 6782 that the gates send to kernel 12 (its chirp-z at 15
        convolution lengths M = 2304 ... 14336), against a float64
        torch.fft Makhoul lowering (oracle only), within 1e-5 of the
        oracle's peak (the worst error reported);
  5. times with CUDA events (median over --reps runs after warm-up): each
     kernel against its plain version and, where one PyTorch call computes
     the same function, that call (the yardstick, never on the port's
     path), kernel 20's chirp-z at (1, 262, 65536), (1, 131, 65536),
     (1, 1094, 7668) and (1, 1097, 7647) with each column count C beside
     torch.fft.rfft, kernel 21's chirp-z at (1, 132, 65536) and
     (1, 548, 7668) (n = 262, 1094) and kernel 15's rows on it at
     (16384, 262) and (16384, 502) with each column (row) count C beside
     torch.fft (kernel 21 also beside its dense product), and as device
     time alone (a CUDA graph of 20 calls), and kernel 15's dense rows at
     (16384, 128),
     (200, 200), (16384, 262), (16384, 502) and (16384, 62); kernel 23 on
     the radix row core at (262144, 512) and (2359296, 1536) with each
     count of rows a block, and kernel 12 at (1, 2049, 524544) and
     (2049, 2049, 256) with each column count C, kernel 24 on the radix
     row core at (262144, 512) with each count of rows a block, kernel 25
     on the radix column tile at (1, 1536, 2359296), (1536, 1536, 1536),
     (1, 2048, 2048), (1, 1152, 1152) and (1, 31104, 31104) with each
     column count C (1 ... 16, the 16- and the 32/40-element forms; at
     C <= 2 with each load, evict-first and read-only), both
     beside the wide core's and the n-point forms they replaced at their
     main shapes, and at (1, 31104, 31104) kernel 25 beside the composition
     transpose, kernel 23 on rows, transpose back; kernel 26 on the radix
     column tile at kernel 25's shapes and kernel 29 at (1, 1024, 1048576)
     and (1, 31104, 31104) with a lane-varying H and at (1, 2048, 4096),
     (8, 1280, 8192) and (1, 1152, 1152) with a broadcast one, each with
     each column count C and, at C <= 2, each load, beside the bts2 forms
     they replaced (the wide core's half length, the n-point form); the steps
     against torch.fft.rfftn / irfftn, the DCT pair and
     Poisson solve against the same compositions through a float32
     torch.fft Makhoul lowering, the complex paths against
     torch.fft.fftn / ifftn, the real-axis-first steps against
     torch.fft.rfftn / irfftn over the same dims and the rfft2d forward
     against torch.fft.rfft(dim=0), the real-axis-last 256^3 and 128^3
     steps against torch.fft.rfftn / irfftn, each with its public calls
     timed one by one and the C2R's Hermitian extension and kernel 8
     apart, and the same for the 600^3 step; the wide core's and the radix
     core's kernels at the paths' shapes (the radix core against
     torch.fft.fft at each), the 768^3 step and the 4096^2 complex round
     trip (each public call timed alone) against torch.fft, ndfft at
     the Bluestein lengths 131 and 2049 along the last axis (the chirp-z's
     sub-FFTs on the radix core) against torch.fft.fft, kernel 11's
     radix column tile at (1, 1031, 1024), (1, 509, 259081), (509, 509,
     509), (1, 251, 262144) and (1, 1021, 131072) (M = 2176, 1024, 512,
     2048), kernel 6's at (600, 600, 301) and (1, 600, 180600) and kernel
     4's at (1, 256, 65536), (256, 256, 129), (1, 128, 16384) and at
     n = 32, 8, 4 (2^24 elements) with each column count C, kernel 8 at
     (65536, 256), kernel 10 at (262144, 512), (259081, 1024) and
     (65536, 2048) and kernel 2 at (262144, 512) and (589824, 768) with
     each count of rows a block, and the R2C on the radix column tile
     (kernels 16 and 20) at (1, 512, 262144), (512, 512, 512),
     (1, 1280, 1280), (1, 256, 65536), (1, 264, 264) and (1, 129, 65536)
     with each column count C, kernel 1 on the radix column tile at
     (1, 512, 131584), (1024, 1024, 513), (768, 768, 385), (1, 2048, 65536),
     (1, 4096, 4096), (1, 8192, 2048) and (1, 20480, 130) with each column
     count C and, at C <= 2, each load (evict-first, read-only), beside
     torch.fft.fft, kernel 18 at (1023, 1024, 1023), (1, 1024, 1046529)
     and (1, 1536, 1535) with each column count C, kernel 3 on the radix
     row core at (262144, 257), (589824, 385) and (32768, 16385) with each
     count of rows a block, and kernel 17 on the radix column tile at
     (1, 257, 262144), (512, 257, 512) and (1, 641, 1280) with each column
     count C, each beside torch.fft.irfft; kernel 21 on the radix column
     tile at (1, 129, 65536), (1, 133, 264), (1, 65, 128) and at odd
     n = 129 and 255 with each column count C, kernel 21 through its
     wrapper at odd n = 255 (the radix column tile) and 129 (the dense
     product) beside torch.fft.irfft, and kernel 27 on it at
     (1, 512, 262144) and (1024, 1024, 1024) (DCT-II, DCT-III) and
     (129, 129, 129) and (1, 1025, 1025) (DCT-I) with each column count C;
     kernel 7 on the radix column tile at (256, 1024, 1024) and
     (16385, 256, 128) with each column count C (at C <= 2 with each load;
     the form that stores from the last stage at the 16-element tiles) and
     its dense remnant at (8, 131, 8192), and kernel 13 at the same two
     shapes with each count of rows a block the row skeleton holds;
     kernel 27 at each of those and its dense product at the DCT-IV of
     (1, 1024, 1024) and the odd DCT-II lengths, beside torch.matmul with
     the scaled DCT matrix; kernel 28's single pass at (2048, 2048, 256),
     (1, 2048, 524288), (1, 1536, 1536) and (1, 40960, 8192) and kernel 19
     at (2049, 2049, 257), (1, 2049, 526593), (1, 1537, 1537) and
     (1, 20481, 8192) with each
     column count C (at C <= 2 with each load), and kernel 28's four-step
     at (1, 65536, 8192), (1, 40960, 8192) and (1, 20480, 8192), each pass
     at each split (h2 = 32 ... 256) and column count, beside the single
     pass at the latter two.
The kernels line gives each kernel's launches on its main path, its largest
error against its plain version, its times, and its bound: the larger of
the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its FP32 operations over 67 TFLOP/s (H100 SXM data
sheet, 700 W). Its launches are the sum over the main paths of phase 4
(the K11 and K12 rows also give the bound of their two length-M FFTs per
column, ``length_m_bound_ms``); kernels 14 and 22 (each one form, on the
radix column tile), kernels 10, 2, 3 and 15
(``r2c_packed`` at h = 128 F), kernel 8 (its rows at n <= 256
counted in c2c_dense_rows.radix_launches as well, above in
``c2c_generic_rows``), kernels 1, 6, 4, 11, 12, 16, 17, 18 and 19 (each
counted in radix_launches as well) and kernel 15's generic form
(``r2c_packed_generic``) run on the radix core, one row each; kernels 20,
21 and 27 two each: the radix column tile (``r2c_dense_mid_radix``,
``c2r_dense_mid_radix``, ``dct_dense_mid_radix``; radix_launches) and the
dense product at the other lengths and types (``r2c_dense_mid``,
``c2r_dense_mid``, ``dct_dense_mid``), kernel 27's rows with each timed DCT
type under ``by_type``, kernels 20 and 21 a third, their chirp-z
(``r2c_dense_mid_chirp``, ``c2r_dense_mid_chirp``; chirp_launches, with the
bound of the two length-M FFTs), and kernel 15's dense rows two: the radix
row core (``r2c_packed_dense_radix``; radix_launches) and the chirp-z
(``r2c_packed_dense_chirp``; chirp_launches); kernel 13 one, the radix row
core (``rows_store_t``; radix_launches); and
kernels 23 to 26 and 29 three each: the
radix core (``dct2_nat_radix``, ``dct3_nat_radix`` on rows,
``dct2_mid_radix``, ``dct3_mid_radix``, ``spectral_dct_mid_radix`` on the
column tile; radix_launches), the wide core's
half length and the n-point form at the 29 lengths without a plan; kernel 7 two: the
radix column tile (``fourstep_mid_radix``, radix_launches) and the dense
product at the prime n1 (``fourstep_mid_dense``, dense_launches); kernel 28
four: the single pass and the four-step on the radix column tile
(``dct4_mid_radix``, radix_launches; ``dct4_mid_fourstep``,
fourstep_launches), the wide core and the long form at the prime F
(``dct4_mid_wide``, ``dct4_mid_long``).
The n-point rows give the long lengths' shapes (phase 4m) under
``solve_shapes``.
The line before the last is the card as nvidia-smi names it; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
TOL_KERNEL = 5e-6    # kernel vs plain, relative to max |plain| (both float32)
TOL_PACKED = 2e-6    # kernel 15 (core, chirp-z) vs plain: sums of at most 2048 terms
TOL_STEP = 1e-5      # step vs float64 oracle and round trip, relative
# the forms that a wrapper counts apart beside ``launches`` (which counts
# every launch): ``wide_launches``, for the DCT-II/III kernels
# ``npoint_launches``, for kernel 7 ``dense_launches``, for kernel 28
# ``long_launches`` and ``fourstep_launches``, for kernels 1, 10, 2, 3, 15
# (``r2c_packed`` and ``r2c_packed_dense``), 11, 8 (``c2c_dense_rows``), 6,
# 4, 7, 13, 16 to 21, 23 to 29 ``radix_launches`` and for kernels 20, 21 and 15's
# dense rows
# ``chirp_launches``
FORMS = ("wide", "npoint", "dense", "long", "fourstep", "radix", "chirp")
# the wrappers whose every launch is on the radix core: their
# ``radix_launches`` equal their ``launches``
RADIX_ONLY = ("c2c_axis_mid", "c2c_rows", "r2c_nat", "r2c_packed", "c2c_dense_rows",
              "c2c_generic_mid", "c2c_dense_mid", "c2c_blue_mid", "r2c_mid", "r2c_packed_mid",
              "c2r_nat", "c2r_mid", "dct23_blue_mid", "dct1_mid", "rows_store_t")
TOL_CENSUS = 1e-6    # the radix core's censuses (phases 4r to 4v)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
FP32_FLOP_PER_S = 67e12     # FP32 outside the tensor cores, same source


def emit(**kw):
    """One JSON line, with ``t``: the seconds since the script started."""
    print(json.dumps({**kw, "t": round(time.perf_counter() - T0, 1)}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def rel_err(got, ref) -> float:
    import torch

    ref = ref.to(torch.complex128) if ref.is_complex() else ref.double()
    got = got.to(ref.dtype)
    return float((got - ref).abs().max() / ref.abs().max())


def abs_err(got, ref) -> float:
    return float((got - ref).abs().max())


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(name: str, shape, length_m: bool = False, mult=None, n=None, dct_type=2):
    """(bytes, FP32 operations) of one kernel call at ``shape``: inputs
    (constants included) read once, outputs written once; 5 n log2 n per
    complex and 2.5 n log2 n per real FFT of length n. The dense R2C/C2R
    (K20, K21) and the dense DCT (K27)
    count what the function needs, a length-n real FFT per column, not
    their products' 4 n (n/2 + 1) or 2 n^2; K21 and K27 on the radix column
    tile read their radix tables and twiddles. A kernel on the wide
    core reads the fixed core's tables and its (F, F) DFT-F table. A DCT-II/III
    kernel (rows or a middle axis) reads and writes n reals per transform and
    does a real FFT's 2.5 n log2 n, in every form; its tables are the core's
    Wq for its core length (n/2, or n in the n-point form) and its twiddles.
    The chirp-z kernels (K11, K12) read and write 16 or 8 bytes per element
    and do the function's 5 n log2 n or 2.5 n log2 n per column; their tables
    are the chirp (K12: its entry and exit tables), H and the radix table of
    their convolution length M. Kernel 23 on the radix row core reads and
    writes n reals per row, with the radix table of n/2 and its twiddles, as
    do kernel 24 on rows and kernels 25 and 26 on the radix column tile.
    ``length_m``: their operations as two complex FFTs of length M
    per column instead. ``n``: a C2R's real length where the spectrum's
    (B, m, L) does not give it (odd n = 2m - 1); ``dct_type``: the DCT that
    kernel 27 on the radix column tile computes, which sets its tables.
    Kernels 1, 10, 8, 6 and 4 (the radix core) read x and the radix table (n
    entries and each prime stage's row) and write y; kernels 16 and 20 on the
    radix column tile read (B, n, L) float32, the radix table of h = n/2 (of n
    at odd n) and, at even n, the unpack twiddle, and write (B, n/2 + 1, L)
    complex64, kernel 18 the same from its two (B, h, L) streams;
    kernels 2 and 15 (the radix row core with the unpack epilogue) read the
    (T, 2h) float32 rows, the radix table of h and the unpack twiddle and
    write (T, h + 1) complex64, and kernels 3 and 17 (the C2R on the radix
    core) read the (h + 1)-bin spectra, the radix table of h and the (h, 4)
    ab rows and write the 2h reals. The four-step's kernel 7 on
    (B, n1, n2) reads x and the (n1, n2) exit twiddle and writes y, and does an n1-point complex FFT
    per column and a complex product (6 FLOPs) per element; its tables are
    its form's (the radix table of n1, or the dense product's (n1, n1)
    matrix). Kernel 13 reads (B, n1, n2) and writes (B, n2, n1) with the
    radix table of n2, and does an n2-point complex FFT per row. The fused spectral kernels (K14,
    K22, K29) on (B, n, L) read x and their multiplier H (``mult`` = (hc,
    complex): rows x hc, hc = 1 or L, float32 or complex64) and write y,
    with their tables (on the radix column tile the radix tables of the
    transform length, n for K14 and n/2 for K22 and K29, both signs for
    K14 and K22; K29's remnant
    forms both cores' tables; and K22's and K29's twiddles), and do two
    transforms of their kind per column (two complex FFTs of n; two real
    ones of n) and the multiply (6 FLOPs per
    complex product, 2 per complex-by-real, 1 per real)."""
    if name.startswith("spectral_"):
        b, n, cols = shape
        hc, cplx = mult or (1, False)
        k14, k22 = name.startswith("spectral_c2c"), name.startswith("spectral_r2c")
        rows = n // 2 + 1 if k22 else n
        h_bytes = (8 if cplx else 4) * rows * hc
        io = (16 if k14 else 8) * b * n * cols
        npoint = name.endswith("_npoint")
        core = n if k14 or npoint else n // 2
        f = core // 128
        if name.endswith("_radix") or k14 or k22:
            # K14, K22 and K29 on the radix column tile: the radix tables of
            # their transform length (K14 and K22 two, the inverse on the
            # sign +1 table; K29 one, its inverse the conjugate of the
            # forward transform)
            from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
            tables = 8 * len(radix_consts(core, -1)[0])
            if k14 or k22:
                tables += 8 * len(radix_consts(core, +1)[0])
        else:
            tables = (1 if npoint else 2) * 8 * core * 128
            tables += 8 * f * f * (1 if npoint else 2) if name.endswith(("_wide",
                                                                          "_npoint")) else 0
        if k22:
            tables += 8 * core + 16 * core                 # tw, ab
        elif not k14:
            tables += 8 * n + (8 * n if npoint else 8 * core + 16 * core + 8 * (core + 1))
        fft = (5 if k14 else 2.5) * n * math.log2(n)
        mult = (6 if cplx else 2) if (k14 or k22) else 1
        return io + h_bytes + tables, (2 * fft + mult * rows) * b * cols
    if name.startswith(("fourstep_mid", "rows_store_t")):
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        b, n1, n2 = shape
        io = 16 * b * n1 * n2
        if name == "rows_store_t":
            return io + 8 * len(radix_consts(n2, 1)[0]), 5 * n2 * math.log2(n2) * b * n1
        body = 8 * n1 * n1 if name.endswith("_dense") else 8 * len(radix_consts(n1, -1)[0])
        return io + 8 * n1 * n2 + body, (5 * n1 * math.log2(n1) + 6 * n1) * b * n2
    if "blue" in name:
        # K11 at M = 128 ceil((2n - 1) / 128), K12 at M = chirp_m(n), both
        # on the radix column tile: the chirp (K12: its entry and exit
        # tables), H and the radix table of M
        from ndrustfft_tpu_torch.ops.hopper.fft import chirp_m, radix_consts
        b, n, cols = shape
        k11 = name.startswith("c2c")
        mk = -(-(2 * n - 1) // 128) * 128 if k11 else chirp_m(n)
        tables = (8 if k11 else 16) * n + 8 * mk + 8 * len(radix_consts(mk, -1)[0])
        flops = (2 * 5 * mk * math.log2(mk) if length_m
                 else (5 if k11 else 2.5) * n * math.log2(n))
        return (16 if k11 else 8) * b * n * cols + tables, flops * b * cols
    if name in ("dct2_nat_radix", "dct3_nat_radix", "dct2_mid_radix", "dct3_mid_radix"):
        # K23 and K24 on the radix row core, K25 and K26 on the radix column tile:
        # (T, n) or (B, n, L) float32 in and out, the radix table of h = n/2;
        # DCT-II the unpack twiddle (h) and the post twiddle's h + 1 entries
        # that it reads, DCT-III the (h, 4) ab rows and the pre twiddle (h + 1)
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        n = shape[1]
        transforms = math.prod(shape) // n
        h = n // 2
        type3 = name.startswith("dct3")
        tables = 8 * len(radix_consts(h, 1 if type3 else -1)[0]) + (
            16 * h + 8 * (h + 1) if type3 else 8 * (2 * h + 1))
        return 8 * transforms * n + tables, 2.5 * n * math.log2(n) * transforms
    if name.startswith(("dct2_", "dct3_")):
        form = name.split("_")[2] if name.count("_") == 2 else "fixed"
        n = shape[1]
        transforms = math.prod(shape) // n
        core = n if form == "npoint" else n // 2
        f = core // 128
        tables = 8 * core * 128 + 16 * n + (0 if form == "fixed" else 8 * f * f)
        return 8 * transforms * n + tables, 2.5 * n * math.log2(n) * transforms
    if name == "r2c_packed_mid":
        # K18 on the radix column tile: two (B, h, L) streams in, (B, h + 1,
        # L) complex out, the radix table of h and the unpack twiddle
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        b, h, cols = shape
        return (8 * b * h * cols + 8 * b * (h + 1) * cols
                + 8 * (len(radix_consts(h, -1)[0]) + h),
                2.5 * 2 * h * math.log2(2 * h) * b * cols)
    if name.startswith(("dct1_mid", "dct4_mid")):
        # K19 and K28: (B, n, L) in and out, the function's 2.5 * 2h log2 2h
        # (K19, h = n - 1) or 5 hl log2 hl (K28, hl = n/2) per column. K19 on
        # the radix column tile reads the radix table of h and the unpack
        # twiddle (h); K28 its entry and exit chirps (2 hl) and, in the single
        # pass, the radix table of hl, in the four-step those of h1 and h2
        # and W_hl (hl); its remnant the core's Wq and the wide core's DFT-F.
        # The four-step's second write and read of y are not the function's.
        from ndrustfft_tpu_torch.ops.hopper.dct import dct4_split
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        b, w, cols = shape
        k28 = name.startswith("dct4")
        core = w // 2 if k28 else w - 1
        io = 8 * b * w * cols
        if not k28:
            tables = 8 * len(radix_consts(core, -1)[0]) + 8 * core
        elif name.endswith("_radix"):
            tables = 8 * len(radix_consts(core, -1)[0]) + 16 * core
        elif name.endswith("_fourstep"):
            tables = 8 * sum(len(radix_consts(h, -1)[0]) for h in dct4_split(core)) + 24 * core
        else:
            tables = 8 * core * 128 + 16 * core + 8 * (core // 128) ** 2
        flops = (5 * core * math.log2(core) if k28 else 2.5 * 2 * core * math.log2(2 * core))
        return io + tables, flops * b * cols
    if name in ("c2r_nat", "c2r_mid"):
        # K3 and K17 on the radix core: the (T, h + 1) or (B, h + 1, L)
        # spectrum in, (T, 2h) or (B, 2h, L) float32 out, the inverse radix
        # table of h and the (h, 4) ab rows
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        h = shape[1] - 1
        transforms = math.prod(shape) // (h + 1)
        return (8 * transforms * (h + 1) + 8 * transforms * h
                + 8 * len(radix_consts(h, 1)[0]) + 16 * h,
                2.5 * 2 * h * math.log2(2 * h) * transforms)
    if name == "dct_dense_mid":
        # the dense product: x in, y out and its (n, n) table; the function
        # needs a real FFT's operations per column, not the product's 2 n^2
        b, n, cols = shape
        return 8 * b * n * cols + 4 * n * n, 2.5 * n * math.log2(n) * b * cols
    if name == "dct_dense_mid_radix":
        # K27 on the radix column tile: x in, y out and the radix table of
        # its transform length h, with DCT-I (h = n - 1) the unpack twiddle
        # W_2h^k (h entries), DCT-II (h = n/2) W_n^k (h) and the post
        # twiddle (n), DCT-III (h = n/2) the ab rows (16 h bytes) and the
        # pre twiddle (h + 1)
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        b, n, cols = shape
        h = n - 1 if dct_type == 1 else n // 2
        tables = {1: 8 * h, 2: 8 * h + 8 * n, 3: 16 * h + 8 * (h + 1)}[dct_type]
        return (8 * b * n * cols + 8 * len(radix_consts(h, 1 if dct_type == 3 else -1)[0])
                + tables, 2.5 * n * math.log2(n) * b * cols)
    if name == "c2r_dense_mid_radix":
        # K21 on the radix column tile: the (B, m, L) spectrum in, (B, n, L)
        # float32 out, and the inverse radix table of the transform length
        # with, at even n = 2h (kernel 17's form), the (h, 4) ab rows
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        b, m, cols = shape
        n = n or 2 * (m - 1)
        length = n if n % 2 else n // 2
        return (8 * b * m * cols + 4 * b * n * cols + 8 * len(radix_consts(length, 1)[0])
                + (0 if n % 2 else 16 * length), 2.5 * n * math.log2(n) * b * cols)
    if name in ("r2c_mid", "r2c_dense_mid_radix"):
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        b, n, cols = shape      # the radix table of h (n at odd n), the unpack twiddle
        m = n // 2 + 1
        table = (8 * len(radix_consts(n, -1)[0]) if n % 2 else
                 8 * len(radix_consts(n // 2, -1)[0]) + 8 * (n // 2))
        return 4 * b * n * cols + 8 * b * m * cols + table, 2.5 * n * math.log2(n) * b * cols
    if name in ("r2c_dense_mid", "c2r_dense_mid"):
        b, w, cols = shape      # (B, n, L) real in, or (B, m, L) spectrum in
        n = w if name.startswith("r2c") else n or 2 * (w - 1)
        m = n // 2 + 1
        return (4 * b * n * cols + 8 * b * m * cols + 4 * n * 2 * m,
                2.5 * n * math.log2(n) * b * cols)
    if name in ("c2c_axis_mid", "c2c_rows", "c2c_generic_rows", "c2c_dense_rows",
                "c2c_generic_mid", "c2c_dense_mid"):
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        n = shape[1] if name.endswith("_mid") else shape[-1]
        outputs = math.prod(shape) // n     # the radix table: n entries and the prime rows
        return 16 * outputs * n + 8 * len(radix_consts(n, -1)[0]), 5 * n * math.log2(n) * outputs
    if name.endswith("_chirp"):
        # the real-input chirp-z: K20's (B, n, L) float32 in, (B, n/2 + 1, L)
        # complex64 out; K21's the other way ((B, m, L) in, ``n`` its real
        # length); K15's rows (T, 2h) float32 in, (T, h + 1) out. Each reads
        # the chirp of its chirp length (h = n/2 at even n, n at odd n), H
        # and the radix table of M and, at even n, the unpack twiddle (K21:
        # its (h, 4) ab rows); the function's 2.5 n log2 n per transform, or
        # (length_m) its two complex FFTs of length M
        from ndrustfft_tpu_torch.ops.hopper.fft import chirp_m, radix_consts
        if name == "r2c_packed_dense_chirp":
            transforms, n = shape
        else:
            b, w, cols = shape
            transforms = b * cols
            n = (n or 2 * (w - 1)) if name.startswith("c2r") else w
        length = n if n % 2 else n // 2
        mk = chirp_m(length)
        tables = (8 * length + 8 * mk + 8 * len(radix_consts(mk, -1)[0])
                  + (0 if n % 2 else (16 if name.startswith("c2r") else 8) * length))
        flops = 2 * 5 * mk * math.log2(mk) if length_m else 2.5 * n * math.log2(n)
        return (4 * n + 8 * (n // 2 + 1)) * transforms + tables, flops * transforms
    if name in ("r2c_nat", "r2c_packed", "r2c_packed_generic", "r2c_packed_dense_radix"):
        from ndrustfft_tpu_torch.ops.hopper.fft import radix_consts
        t, n = shape            # the radix table of h, and the unpack twiddle
        h = n // 2
        return (4 * t * n + 8 * t * (h + 1) + 8 * (len(radix_consts(h, -1)[0]) + h),
                2.5 * n * math.log2(n) * t)
    raise ValueError(f"no work model for {name}")


def makhoul_dct(x, axis: int, dct_type: int):
    """scipy.fft.dct(x, type=2 or 3, axis) through torch.fft (Makhoul), in
    x's precision: the oracle (float64) and the yardstick (float32), never
    the port's path."""
    import torch

    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    k = torch.arange(n, device=x.device, dtype=x.dtype)
    w = torch.polar(torch.ones_like(k), -math.pi * k / (2 * n))
    if dct_type == 2:
        v = torch.cat([xm[..., 0::2], xm[..., 1::2].flip(-1)], dim=-1)
        y = 2 * (torch.fft.fft(v) * w).real
    else:
        c = torch.cat([xm[..., :1] * 0.5, xm[..., 1:]], dim=-1)
        u = 2 * torch.fft.fft(c * w).real
        y = torch.empty_like(u)
        h = (n + 1) // 2
        y[..., 0::2] = u[..., :h]
        y[..., 1::2] = u[..., h:].flip(-1)
    return y.movedim(-1, axis)


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of fn() over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 20):
    """The device time of one fn(), without the host's time between
    launches: the median over ``reps`` replays of a CUDA graph of ``calls``
    calls, over ``calls``; None where the capture fails."""
    import torch

    try:
        fn()        # tables and plans are built before the capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import ndrustfft_tpu_torch as nd
    from ndrustfft_tpu_torch import api, gates
    from ndrustfft_tpu_torch.ops import dct as tdct
    from ndrustfft_tpu_torch.ops import dst as tdst
    from ndrustfft_tpu_torch.ops import engine
    from ndrustfft_tpu_torch.ops.hopper import _build
    from ndrustfft_tpu_torch.ops.hopper import dct as kdct
    from ndrustfft_tpu_torch.ops.hopper import fft as kfft
    from ndrustfft_tpu_torch.ops.hopper import rfft as krfft

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(nd.__file__)))
    if pkg_root != HERE:
        raise RuntimeError(f"ndrustfft_tpu_torch imported from {pkg_root}, not {HERE}")

    # ---- 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(card, flush=True)
    emit(phase="device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32)

    def crandn(*shape):
        return torch.complex(randn(*shape), randn(*shape))

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log = (lib_path.parent / "nvcc.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [sum(map(int, s)) for s in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    spilling = {}   # entry function -> spill bytes, from ptxas -v
    row_regs = {}   # the radix row kernels (their occupancy) -> registers a thread
    col_regs = {}   # the radix column and chirp-z kernels -> [registers a thread, spill bytes]
    for entry in log.split("Compiling entry function '")[1:]:
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        if m and sum(map(int, m.groups())):
            spilling[entry.split("'")[0]] = sum(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", entry)
        if m and "radix_rows_kernel" in entry.split("'")[0]:
            row_regs[entry.split("'")[0]] = int(m.group(1))
        if m and ("radix_cols_kernel" in entry.split("'")[0]
                  or "blue_radix_kernel" in entry.split("'")[0]):
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            col_regs[entry.split("'")[0]] = [int(m.group(1)),
                                             sum(map(int, sp.groups())) if sp else 0]
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=lib_path.name,
         max_registers=max(regs, default=None),
         spill_bytes=sum(spills), spilling=spilling, radix_rows_registers=row_regs,
         radix_cols_registers=col_regs)

    # ---- 3. kernels against their plain versions
    errs = {"c2c_axis_mid": 0.0, "r2c_nat": 0.0, "c2r_nat": 0.0,
            "dct_dense_mid": 0.0, "dct2_nat_radix": 0.0, "dct3_nat_radix": 0.0,
            "c2c_rows": 0.0, "c2c_dense_rows": 0.0, "c2c_dense_mid": 0.0,
            "r2c_mid": 0.0, "c2r_mid": 0.0, "r2c_dense_mid": 0.0, "c2r_dense_mid": 0.0,
            "c2r_dense_mid_radix": 0.0, "dct_dense_mid_radix": 0.0,
            "r2c_packed": 0.0, "c2c_generic_rows": 0.0,
            "c2c_generic_mid": 0.0, "r2c_packed_generic": 0.0,
            "r2c_dense_mid_radix": 0.0, "r2c_dense_mid_chirp": 0.0,
            "c2r_dense_mid_chirp": 0.0, "r2c_packed_dense_radix": 0.0,
            "r2c_packed_dense_chirp": 0.0,
            "dct2_nat_wide": 0.0, "dct3_nat_wide": 0.0, "dct2_nat_npoint": 0.0,
            "dct3_nat_npoint": 0.0, "dct2_mid_radix": 0.0, "dct3_mid_radix": 0.0,
            "dct2_mid_wide": 0.0,
            "dct3_mid_wide": 0.0, "dct2_mid_npoint": 0.0, "dct3_mid_npoint": 0.0,
            "r2c_packed_mid": 0.0, "dct1_mid": 0.0, "dct4_mid_radix": 0.0,
            "dct4_mid_fourstep": 0.0, "dct4_mid_wide": 0.0, "dct4_mid_long": 0.0,
            "c2c_blue_mid": 0.0, "dct23_blue_mid": 0.0,
            "fourstep_mid_radix": 0.0, "fourstep_mid_dense": 0.0,
            "rows_store_t": 0.0, "spectral_c2c_mid": 0.0, "spectral_r2c_mid": 0.0,
            "spectral_dct_mid_radix": 0.0, "spectral_dct_mid_wide": 0.0,
            "spectral_dct_mid_npoint": 0.0}
    k1_shapes = [(1, 512, 257), (1, 1024, 513), (3, 2048, 130), (512, 512, 257),
                 (1, 512, 512 * 257), (1, 512, 512), (1, 1024, 1024), (512, 512, 512),
                 (1, 512, 512 * 512), (257, 512, 512), (1, 4096, 4096), (1, 20480, 130),
                 (768, 768, 385)]
    for shape in k1_shapes:
        x = crandn(*shape)
        for sign, scale in ((-1, None), (+1, 1.0 / shape[1])):
            got = kfft.c2c_axis_mid(x, sign, scale)
            ref = kfft.c2c_axis_mid_plain(x, sign, scale)
            torch.cuda.synchronize()
            rel = abs_err(got, ref) / float(ref.abs().max())
            errs["c2c_axis_mid"] = max(errs["c2c_axis_mid"], abs_err(got, ref))
            emit(phase="kernel_vs_plain", kernel="c2c_axis_mid", shape=shape,
                 sign=sign, rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"c2c_axis_mid {shape} sign {sign}: {rel}")
        del x, got, ref
    for t, n in ((130, 512), (512, 512), (1024, 1024), (7, 2048), (3, 4096),
                 (512 * 512, 512)):
        x = randn(t, n)
        got = krfft.r2c_nat(x)
        ref = krfft.r2c_nat_plain(x)
        torch.cuda.synchronize()
        rel = abs_err(got, ref) / float(ref.abs().max())
        errs["r2c_nat"] = max(errs["r2c_nat"], abs_err(got, ref))
        emit(phase="kernel_vs_plain", kernel="r2c_nat", shape=(t, n), rel_err=rel)
        if not rel <= TOL_KERNEL:
            raise AssertionError(f"r2c_nat {(t, n)}: {rel}")
        s = crandn(t, n // 2 + 1)
        s[:, 0] += 100j     # DC and Nyquist imaginary parts that must be ignored
        s[:, -1] += 100j
        got = krfft.c2r_nat(s, n, 1.0 / n)
        ref = krfft.c2r_nat_plain(s, n, 1.0 / n)
        torch.cuda.synchronize()
        rel = abs_err(got, ref) / float(ref.abs().max())
        errs["c2r_nat"] = max(errs["c2r_nat"], abs_err(got, ref))
        emit(phase="kernel_vs_plain", kernel="c2r_nat", shape=(t, n // 2 + 1),
             rel_err=rel)
        if not rel <= TOL_KERNEL:
            raise AssertionError(f"c2r_nat {(t, n)}: {rel}")
        del x, s, got, ref

    def form_counts(kern):
        return [kern.launches] + [getattr(kern, f"{f}_launches", 0) for f in FORMS]

    def assert_launched(name, kern, before, shape):
        """One launch of ``kern`` since ``before`` (its form_counts), in the
        form that ``name`` ends with, or on the fixed core where it names
        none."""
        form = "radix" if name in RADIX_ONLY else name.rsplit("_", 1)[-1]
        want = [1] + [int(f == form) for f in FORMS]
        got = [now - then for now, then in zip(form_counts(kern), before)]
        if got != want:
            raise AssertionError(f"{name} {shape}: launches {got}, expected {want}")

    # kernel 27's wrapper: the radix column tile (dct_dense_mid_radix) for
    # DCT-I at a plan of n - 1 and DCT-II/III at even n with a plan of n/2,
    # the dense product for the other types and lengths
    def k27_form(n, t):
        """The kernels line's name and the plain version of the DCT-<t>
        that kernel 27's wrapper runs at n."""
        if kdct.dct_radix_len(n, t) is not None:
            return "dct_dense_mid_radix", kdct.dct_radix_plain
        return "dct_dense_mid", kdct.dct_dense_mid_plain

    for shape in ((1, 129, 129), (3, 265, 130), (1, 265, 265), (1, 513, 513),
                  (1, 1024, 1024), (1, 1025, 1025), (512, 512, 512), (1, 512, 512 * 512)):
        x = randn(*shape)
        for t in (1, 2, 3, 4):
            name, plain = k27_form(shape[1], t)
            before = form_counts(kdct.dct_dense_mid)
            got = kdct.dct_dense_mid(x, t, 2.0)
            ref = plain(x, t, 2.0)
            torch.cuda.synchronize()
            assert_launched(name, kdct.dct_dense_mid, before, shape)
            rel = abs_err(got, ref) / float(ref.abs().max())
            errs[name] = max(errs[name], abs_err(got, ref))
            emit(phase="kernel_vs_plain", kernel=name, shape=shape, dct_type=t, rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"{name} {shape} type {t}: {rel}")
            del got, ref
        del x
    # kernels 23 and 24 on the radix row core (``dct2_nat_radix``,
    # ``dct3_nat_radix``) at the lengths the bts2 fixed core took, the DCT
    # family's 1024^2 and the 2048^2 pair's 2048 among them, at the DCT
    # family's main shape (262144, 512) and S3's (1048576, 1024)
    for t, n in ((130, 512), (1024, 1024), (7, 2048), (512 * 512, 512), (1024 * 1024, 1024)):
        x = randn(t, n)
        for name, kern, plain in (("dct2_nat_radix", kdct.dct2_nat, kdct.dct2_nat_plain),
                                  ("dct3_nat_radix", kdct.dct3_nat, kdct.dct3_nat_plain)):
            before = form_counts(kern)
            got = kern(x, 2.0)
            ref = plain(x, 2.0)
            torch.cuda.synchronize()
            assert_launched(name, kern, before, (t, n))
            rel = abs_err(got, ref) / float(ref.abs().max())
            errs[name] = max(errs[name], abs_err(got, ref))
            emit(phase="kernel_vs_plain", kernel=name, shape=(t, n), rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"{name} {(t, n)}: {rel}")
            del got, ref
        del x
    # kernel 23 on the radix row core at each count of rows a block that
    # phase 5 times (the wrapper takes fft.py::radix_block's at h = n/2):
    # odd and even k, ragged row tiles, h = 64 (n = 128) to 20480 (one row a
    # block, 40 elements a thread), rows off a 16-byte boundary through the
    # wrapper (which copies them)
    for t, n in ((130, 512), (131, 384), (33, 640), (7, 1536), (257, 128), (5, 8192),
                 (3, 128 * 161), (2, 40960)):
        x = randn(t, n)
        ref = kdct.dct2_rows_radix_plain(x, 2.0)
        y = torch.empty_like(x)
        tr = -(-(n // 2) // 16)
        counts = range(1, min(8, kfft.RADIX_MAX_THREADS // tr) + 1) if n // 2 <= 4096 else (1,)
        for rows in counts:
            y.fill_(float("nan"))
            kdct.dct2_rows_radix_launch(x, y, 2.0, rows)
            torch.cuda.synchronize()
            rel = abs_err(y, ref) / float(ref.abs().max())
            errs["dct2_nat_radix"] = max(errs["dct2_nat_radix"], abs_err(y, ref))
            emit(phase="kernel_vs_plain", kernel="dct2_nat_radix", shape=(t, n),
                 rows_per_block=rows, rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"dct2_nat_radix {(t, n)} rows {rows}: {rel}")
        del x, y, ref
    flat = randn(3 * 640 + 1)
    x = flat[1:].view(3, 640)
    before = form_counts(kdct.dct2_nat)
    got = kdct.dct2_nat(x, None)
    ref = kdct.dct2_rows_radix_plain(x, None)
    torch.cuda.synchronize()
    assert_launched("dct2_nat_radix", kdct.dct2_nat, before, (3, 640))
    rel = abs_err(got, ref) / float(ref.abs().max())
    emit(phase="kernel_vs_plain", kernel="dct2_nat_radix", shape=(3, 640), offset_bytes=4,
         rel_err=rel)
    if not rel <= TOL_KERNEL:
        raise AssertionError(f"dct2_nat_radix off a 16-byte boundary: {rel}")
    del flat, x, got, ref
    # kernel 24 on the radix row core likewise, with scale 1/n and none
    for t, n in ((130, 512), (131, 384), (33, 640), (7, 1536), (257, 128), (5, 8192),
                 (3, 128 * 161), (2, 40960)):
        x = randn(t, n)
        tr = -(-(n // 2) // 16)
        counts = range(1, min(8, kfft.RADIX_MAX_THREADS // tr) + 1) if n // 2 <= 4096 else (1,)
        for scale in (1.0 / n, None):
            ref = kdct.dct3_rows_radix_plain(x, scale)
            y = torch.empty_like(x)
            for rows in counts:
                y.fill_(float("nan"))
                kdct.dct3_rows_radix_launch(x, y, scale, rows)
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs["dct3_nat_radix"] = max(errs["dct3_nat_radix"], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel="dct3_nat_radix", shape=(t, n),
                     rows_per_block=rows, scale=scale, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"dct3_nat_radix {(t, n)} rows {rows}: {rel}")
        del x, y, ref
    flat = randn(3 * 640 + 1)
    x = flat[1:].view(3, 640)
    before = form_counts(kdct.dct3_nat)
    got = kdct.dct3_nat(x, 0.5)
    ref = kdct.dct3_rows_radix_plain(x, 0.5)
    torch.cuda.synchronize()
    assert_launched("dct3_nat_radix", kdct.dct3_nat, before, (3, 640))
    rel = abs_err(got, ref) / float(ref.abs().max())
    emit(phase="kernel_vs_plain", kernel="dct3_nat_radix", shape=(3, 640), offset_bytes=4,
         rel_err=rel)
    if not rel <= TOL_KERNEL:
        raise AssertionError(f"dct3_nat_radix off a 16-byte boundary: {rel}")
    del flat, x, got, ref
    # kernel 25 on the radix column tile at each column count C that phase
    # 5 times (the wrapper takes dct.py::dct2_mid_cols's): odd and even k,
    # ragged column tiles, B = 1 and 2, h = 64 to 20480 (one column a tile,
    # 40 elements a thread), the 16- and the 32/40-element forms
    for shape in ((2, 128, 130), (1, 384, 129), (2, 1152, 130), (1, 1536, 257), (1, 2048, 33),
                  (1, 8192, 17), (1, 128 * 161, 5), (1, 31104, 3), (1, 40960, 2)):
        x = randn(*shape)
        h = shape[1] // 2
        ref = kdct.dct_radix_plain(x, 2, 2.0)
        y = torch.empty_like(x)
        for c, ldg in ((1, False), (1, True), (2, False), (2, True), (4, False), (8, False),
                       (16, False)):
            if h * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(h, c) > 512:
                continue
            y.fill_(float("nan"))
            kdct.dct_radix_launch(x, y, 2, 2.0, c, ldg)
            torch.cuda.synchronize()
            rel = abs_err(y, ref) / float(ref.abs().max())
            errs["dct2_mid_radix"] = max(errs["dct2_mid_radix"], abs_err(y, ref))
            emit(phase="kernel_vs_plain", kernel="dct2_mid_radix", shape=shape, cols=c,
                 read_only_load=ldg, rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"dct2_mid_radix {shape} C = {c} ldg {ldg}: {rel}")
        del x, y, ref
    # kernels 26 and 29 on the radix column tile likewise (the wrappers take
    # dct.py::dct2_mid_cols's and rfft.py::spectral_cols's), kernel 29 with a
    # broadcast and a lane-varying H
    for shape in ((2, 128, 130), (1, 384, 129), (2, 1152, 130), (1, 1536, 257), (1, 2048, 33),
                  (1, 8192, 17), (1, 128 * 161, 5), (1, 31104, 3), (1, 40960, 2)):
        x = randn(*shape)
        n = shape[1]
        h = n // 2
        hvs = (randn(n, 1), randn(n, shape[2]))
        ref3 = kdct.dct_radix_plain(x, 3, 1.0 / n)
        refs = [kdct.spectral_dct_mid_plain(x, hv, 2.0, 1.0 / n) for hv in hvs]
        y = torch.empty_like(x)
        for c, ldg in ((1, False), (1, True), (2, False), (2, True), (4, False), (8, False),
                       (16, False)):
            if h * c > kfft.RADIX_MAX_ELEMS or kfft.radix_cols_threads(h, c) > 512:
                continue
            runs = [("dct3_mid_radix", None, ref3,
                     lambda: kdct.dct_radix_launch(x, y, 3, 1.0 / n, c, ldg))]
            runs += [("spectral_dct_mid_radix", list(hv.shape), ref,
                      lambda hv=hv: kdct.spectral_dct_radix_launch(x, y, hv, 2.0, 1.0 / n, c, ldg))
                     for hv, ref in zip(hvs, refs)]
            for name, h_shape, ref, launch in runs:
                y.fill_(float("nan"))
                launch()
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs[name] = max(errs[name], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel=name, shape=shape, cols=c,
                     read_only_load=ldg, h_shape=h_shape, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"{name} {shape} C = {c} ldg {ldg} H {h_shape}: {rel}")
        del x, y, ref3, refs, hvs
    # the census of kernels 24 to 26 and 29 through their wrappers at each
    # of the 259 lengths n = 128 k whose half length has a radix plan
    # (kernel 24 over (4, n), kernels 25, 26 and 29 along axis 1 of
    # (1, n, 8), kernel 29 with a lane-varying H) against their plain
    # versions, within TOL_PACKED of the plain version's peak (kernel 29,
    # two transforms, within TOL_KERNEL)
    t0 = time.perf_counter()
    census_n = [n for n in range(128, 128 * 321, 128) if kdct.dct2_nat_radix(n)]
    if len(census_n) != 259:
        raise AssertionError(f"K24-K26/K29 census: {len(census_n)} lengths, expected 259")
    census = ("dct3_nat_radix", "dct2_mid_radix", "dct3_mid_radix", "spectral_dct_mid_radix")
    worst = dict.fromkeys(census, (0.0, None))
    for n in census_n:
        x, r, hv = randn(1, n, 8), randn(4, n), randn(n, 8)
        for name, kern, run, plain, tol in (
                ("dct3_nat_radix", kdct.dct3_nat, lambda: kdct.dct3_nat(r, 1.0 / n),
                 lambda: kdct.dct3_rows_radix_plain(r, 1.0 / n), TOL_PACKED),
                ("dct2_mid_radix", kdct.dct2_mid, lambda: kdct.dct2_mid(x, 2.0),
                 lambda: kdct.dct_radix_plain(x, 2, 2.0), TOL_PACKED),
                ("dct3_mid_radix", kdct.dct3_mid, lambda: kdct.dct3_mid(x, 1.0 / n),
                 lambda: kdct.dct_radix_plain(x, 3, 1.0 / n), TOL_PACKED),
                ("spectral_dct_mid_radix", kdct.spectral_dct_mid,
                 lambda: kdct.spectral_dct_mid(x, hv, 2.0, 1.0 / n),
                 lambda: kdct.spectral_dct_mid_plain(x, hv, 2.0, 1.0 / n), TOL_KERNEL)):
            before = form_counts(kern)
            got = run()
            ref = plain()
            torch.cuda.synchronize()
            assert_launched(name, kern, before, (n,))
            err = abs_err(got, ref)
            rel = err / float(ref.abs().max())
            errs[name] = max(errs[name], err)
            if not rel <= tol:
                raise AssertionError(f"{name} census n={n}: {rel}")
            worst[name] = max(worst[name], (rel, n))
    emit(phase="kernel_vs_plain", check="dct_mid_radix_census", lengths=len(census_n),
         **{f"worst_rel_err_{k}": v[0] for k, v in worst.items()},
         **{f"worst_n_{k}": v[1] for k, v in worst.items()}, seconds=time.perf_counter() - t0)
    del x, r, hv, got, ref

    def check_form(name, kern, got_fn, ref_fn, shape, **kw):
        """got_fn() (one launch of ``kern`` in the form ``name`` names)
        against ref_fn()."""
        before = form_counts(kern)
        got = got_fn()
        ref = ref_fn()
        torch.cuda.synchronize()
        assert_launched(name, kern, before, shape)
        rel = abs_err(got, ref) / float(ref.abs().max())
        errs[name] = max(errs[name], abs_err(got, ref))
        emit(phase="kernel_vs_plain", kernel=name, shape=shape, rel_err=rel, **kw)
        if not rel <= TOL_KERNEL:
            raise AssertionError(f"{name} {shape} {kw}: {rel}")

    # kernel 27's wrapper at the main paths' radix shapes: S3's DCT-II and
    # DCT-III along axis 1 of 1024^3 (phase 4l), Chebyshev's DCT-I along
    # axis 1 of 129^3 and along axis 0 as (1, 129, 129^2) (phase 4e); the
    # plain version on the first 16 planes
    for shape, types in (((1024, 1024, 1024), (2, 3)), ((129, 129, 129), (1,)),
                         ((1, 129, 129 * 129), (1,))):
        x = randn(*shape)
        cut = min(shape[0], 16)
        for t in types:
            for scale in (2.0, None):
                check_form("dct_dense_mid_radix", kdct.dct_dense_mid,
                           lambda: kdct.dct_dense_mid(x, t, scale)[:cut],
                           lambda: kdct.dct_radix_plain(x[:cut], t, scale), shape, dct_type=t,
                           scale=scale)
        del x
        torch.cuda.empty_cache()
    # the complex transform's kernels: ragged rows and edges, then the main
    # path's shapes (phase 4c)
    c2c_checks = (
        ("c2c_rows", kfft.c2c_rows, kfft.c2c_rows_plain,
         ((130, 512), (128, 1024), (66, 2048), (1, 2048), (1024, 1024), (512 * 512, 512),
          (257 * 512, 512), (65536, 2048))),
        # K8 on the radix row core at n <= 256: one row of n < 16 a thread
        # (256 rows of 2 a block), ragged row counts, odd n at odd row offsets
        # (129, 17), the four-step's no-split row passes of phase 4k (128 *
        # 144 rows of 144 for 10007's M = 20736, 128 * 256 rows of 160 for
        # 40960 along axis 0, 8 * 2176 rows of 17 for 36992)
        ("c2c_dense_rows", kfft.c2c_dense_rows, kfft.c2c_radix_rows_plain,
         ((1001, 2), (7, 17), (8321, 129), (130, 128), (200, 200), (131, 256),
          (256 * 256, 256), (129 * 256, 256), (128 * 144, 144), (128 * 256, 160),
          (8 * 2176, 17))),
        # K4 on the radix column tile: n < 16 (one thread a column), odd n,
        # the dense route's longest n (511), ragged L, the fft2d protocol's
        # 128 and 264 and the 256^3 paths' shapes (phases 4c to 4e)
        ("c2c_dense_mid", kfft.c2c_dense_mid, kfft.c2c_dense_mid_plain,
         ((3, 2, 129), (2, 15, 257), (1, 17, 129), (1, 128, 128), (1, 264, 264), (3, 200, 257),
          (2, 500, 130), (2, 511, 257), (256, 256, 256), (1, 256, 256 * 256), (129, 256, 256),
          (256, 256, 129), (1, 256, 33024), (1, 128, 8320))),
        # the generic schedule's lengths on the radix core: ragged rows and
        # column tiles, two prime stages (11352 = 8 * 3 * 11 * 43), 19272,
        # the longest length (20480, 40 elements a thread), and the main
        # paths' shapes (phase 4f)
        ("c2c_generic_rows", kfft.c2c_generic_rows, kfft.c2c_generic_rows_plain,
         ((130, 264), (7, 600), (129, 1200), (3, 11352), (2, 19272), (2, 20480),
          (264, 264), (300, 300), (530, 530), (2000, 1000), (600 * 600, 600))),
        ("c2c_generic_mid", kfft.c2c_generic_mid, kfft.c2c_generic_mid_plain,
         ((2, 520, 129), (3, 600, 301), (1, 11352, 5), (1, 19272, 3), (1, 20480, 3),
          (1, 1200, 256), (1, 600, 600), (600, 600, 301), (1, 600, 600 * 301))),
    )
    for name, kern, plain, shapes in c2c_checks:
        for shape in shapes:
            x = crandn(*shape)
            n = shape[-1] if x.dim() == 2 else shape[1]
            for sign, scale in ((-1, None), (+1, None), (-1, 1.0 / n), (+1, 1.0 / n)):
                got = kern(x, sign, scale)
                ref = plain(x, sign, scale)
                torch.cuda.synchronize()
                rel = abs_err(got, ref) / float(ref.abs().max())
                errs[name] = max(errs[name], abs_err(got, ref))
                emit(phase="kernel_vs_plain", kernel=name, shape=shape, sign=sign,
                     scale=scale, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"{name} {shape} sign {sign} scale {scale}: {rel}")
                del got, ref
            del x

    def tile_fits(n, c):
        """A radix column tile of c columns of length n that a block takes:
        256 threads in the 16-element form, 512 above it."""
        elems = n * c
        return elems <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(n, c) <= (
            kfft.RADIX_MAX_THREADS if elems <= kfft.RADIX_WIDE_N else 2 * kfft.RADIX_MAX_THREADS)

    def tile16_fits(n, c):
        """A column tile in the 16-element form (kernels 21 and 15's chirp-z
        take no other)."""
        return n * c <= kfft.RADIX_WIDE_N and tile_fits(n, c)

    def blue_launch(x, y, sign, scale, c):
        a, h = kfft._device_blue(x.shape[1], sign, dev)
        kfft.blue_radix_launch(x, y, a, h, scale, c)

    # the radix column tile at each column count C that phase 5 times (the
    # wrappers pick one by radix_mid_cols and blue_radix_cols): kernel 6 at
    # the 600^3 step's ragged L = 301, a ragged few columns at 1200 and the
    # longest length (one column a tile); kernel 4 at n = 2 (one thread a
    # column), 17, 129, the 256^3 paths' ragged (256, 256, 129) and tail
    # (1, 256, 33024), and 511; kernel 11 at M = 512, 1024, 2048 (n = 193,
    # 509, 1021) with ragged tiles
    for name, shapes, counts, plain, launch, tile_len in (
            ("c2c_generic_mid", ((600, 600, 301), (3, 1200, 7), (1, 20480, 5)), (1, 2, 4, 8),
             kfft.c2c_radix_mid_plain, kfft.mid_radix_launch, int),
            ("c2c_dense_mid", ((3, 2, 129), (2, 17, 257), (1, 129, 129), (256, 256, 129),
                               (1, 256, 33024), (1, 511, 257)), (1, 2, 4, 8, 16, 32, 64),
             kfft.c2c_radix_mid_plain, kfft.mid_radix_launch, int),
            ("c2c_blue_mid", ((2, 193, 130), (1, 509, 13), (1, 1021, 257)), (1, 2, 4, 8),
             kfft.c2c_blue_mid_plain, blue_launch, kfft.blue_kernel_M)):
        for shape in shapes:
            x = crandn(*shape)
            y = torch.empty_like(x)
            n = shape[1]
            for sign, scale in ((-1, None), (+1, 1.0 / n)):
                ref = plain(x, sign, scale)
                for c in counts:
                    if not tile_fits(tile_len(n), c):
                        continue
                    y.fill_(float("nan"))
                    launch(x, y, sign, 1.0 if scale is None else scale, c)
                    torch.cuda.synchronize()
                    rel = abs_err(y, ref) / float(ref.abs().max())
                    errs[name] = max(errs[name], abs_err(y, ref))
                    emit(phase="kernel_vs_plain", kernel=name, shape=shape, cols_per_tile=c,
                         sign=sign, scale=scale, rel_err=rel)
                    if not rel <= TOL_KERNEL:
                        raise AssertionError(f"{name} {shape} C {c} sign {sign}: {rel}")
                del ref
            del x, y

    # kernels 16 and 20 on the radix column tile at each column count C that
    # phase 5 times (the wrappers take r2c_mid_cols's): both forms (even n at
    # the half length with the unpack epilogue, odd n storing half the C2C's
    # bins), n = 4 and 5 (one thread a column), a prime stage (129, 1095),
    # the main paths' shapes, ragged L, F = 5 and the longest h = 20480 (one
    # column a tile, 40 elements a thread)
    for shape in ((3, 4, 129), (2, 5, 257), (1, 129, 256 * 256), (1, 256, 256 * 256),
                  (1, 264, 264), (2, 1095, 130), (1, 512, 512 * 512), (512, 512, 512),
                  (2, 1280, 130), (1, 1280, 1280), (1, 40960, 3)):
        nb, n, cols = shape
        name = "r2c_mid" if n >= 512 and n % 256 == 0 else "r2c_dense_mid_radix"
        x = randn(*shape)
        y = torch.empty((nb, n // 2 + 1, cols), dtype=torch.complex64, device=dev)
        ref = krfft.r2c_mid_radix_plain(x)
        for c in (1, 2, 4, 8, 16, 32, 64):
            if not tile_fits(krfft.r2c_mid_len(n), c):
                continue
            y.fill_(float("nan"))
            krfft.r2c_mid_radix_launch(x, y, c)
            torch.cuda.synchronize()
            rel = abs_err(y, ref) / float(ref.abs().max())
            errs[name] = max(errs[name], abs_err(y, ref))
            emit(phase="kernel_vs_plain", kernel=name, shape=shape, cols_per_tile=c, rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"{name} {shape} C {c}: {rel}")
        del x, y, ref

    # kernel 20's chirp-z (kernel 11's column kernel with a real load and the
    # unpack or the odd bins as its store) at each column count C that phase
    # 5 times (the wrapper takes fft.py::radix_mid_cols's at M): even n (262, 1094:
    # chirp length n/2) and odd n (131, 1097, 5), the main paths' shapes
    # (1, 262, 65536) and (1, 131, 65536), ragged L, M = 7 ... 2304
    for shape in ((2, 262, 130), (1, 262, 256 * 256), (1, 131, 256 * 256), (2, 1094, 130),
                  (1, 1097, 33), (3, 5, 257), (2, 4, 129)):
        nb, n, cols = shape
        x = randn(*shape)
        y = torch.empty((nb, n // 2 + 1, cols), dtype=torch.complex64, device=dev)
        ref = krfft.r2c_blue_plain(x)
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        for c in (1, 2, 4, 8, 16):
            if not tile_fits(mk, c):
                continue
            y.fill_(float("nan"))
            krfft.r2c_blue_launch(x, y, c)
            torch.cuda.synchronize()
            rel = abs_err(y, ref) / float(ref.abs().max())
            errs["r2c_dense_mid_chirp"] = max(errs["r2c_dense_mid_chirp"], abs_err(y, ref))
            emit(phase="kernel_vs_plain", kernel="r2c_dense_mid_chirp", shape=shape, M=mk,
                 cols_per_tile=c, rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"r2c_dense_mid_chirp {shape} C {c}: {rel}")
        del x, y, ref

    # kernel 21's chirp-z (kernel 11's column kernel with kernel 17's load
    # and inverse unpack as its prologue at even n, the Hermitian extension
    # at odd n, and a real store) at each column count C that phase 5 times
    # (the wrapper takes fft.py::radix_mid_cols's at M): even n (262, 1094)
    # and odd n (263, 449, 1099, 5), the main paths' spectra (1, 132, 65536)
    # and (1, 548, 7668), ragged L, the scales 1/n and None; the spectra
    # carry DC and Nyquist imaginary parts that must be ignored
    for shape, n in (((2, 132, 130), 262), ((1, 132, 256 * 256), 262), ((1, 132, 65), 263),
                     ((1, 225, 33), 449), ((2, 548, 130), 1094), ((1, 548, 7668), 1094),
                     ((1, 550, 33), 1099), ((3, 3, 257), 5)):
        nb, m, cols = shape
        sp = crandn(*shape)
        sp[:, 0] += 100j
        sp[:, -1] += 100j
        y = torch.empty((nb, n, cols), device=dev)
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        for scale in (1.0 / n, None):
            ref = krfft.c2r_blue_plain(sp, n, scale)
            for c in (1, 2, 4, 8, 16):
                if not tile16_fits(mk, c):
                    continue
                y.fill_(float("nan"))
                krfft.c2r_blue_launch(sp, y, n, scale, c)
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs["c2r_dense_mid_chirp"] = max(errs["c2r_dense_mid_chirp"], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel="c2r_dense_mid_chirp", shape=shape, n=n,
                     M=mk, cols_per_tile=c, scale=scale, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"c2r_dense_mid_chirp {shape} n {n} C {c}: {rel}")
            del ref
        del sp, y

    # kernel 15's rows at a prime half length on the chirp-z (kernel 20's
    # even form, the tile's columns consecutive rows) at each count of rows
    # a tile that phase 5 times (the wrapper takes rfft.py::
    # packed_blue_rows's): h = 131 at the main path's (16384, 262) and
    # ragged counts, 173, 211 and 251
    for t, h in ((300, 131), (128 * 128, 131), (129, 173), (65, 211), (7, 251)):
        x = randn(t, 2 * h)
        y = torch.empty((t, h + 1), dtype=torch.complex64, device=dev)
        ref = krfft.r2c_packed_blue_plain(x)
        mk = kfft.chirp_m(h)
        for c in (1, 2, 4, 8, 16, 32):
            if not tile16_fits(mk, c):
                continue
            y.fill_(float("nan"))
            krfft.r2c_blue_rows_launch(x, y, c)
            torch.cuda.synchronize()
            rel = abs_err(y, ref) / float(ref.abs().max())
            errs["r2c_packed_dense_chirp"] = max(errs["r2c_packed_dense_chirp"], abs_err(y, ref))
            emit(phase="kernel_vs_plain", kernel="r2c_packed_dense_chirp", shape=(t, 2 * h), M=mk,
                 rows_per_tile=c, rel_err=rel)
            if not rel <= TOL_PACKED:
                raise AssertionError(f"r2c_packed_dense_chirp ({t}, {2 * h}) C {c}: {rel}")
        del x, y, ref

    # kernel 1 on the radix column tile at each column count C and, at
    # C <= 2, each load (evict-first, read-only) that phase 5 times (the
    # wrapper takes fft.py::axis_mid_tile's): F = 3, 4, 32 and 160 with
    # ragged L, both signs and the scale 1/n
    for shape in ((3, 384, 130), (2, 512, 257), (1, 2048, 257), (1, 4096, 33), (1, 8192, 5),
                  (1, 20480, 5)):
        x = crandn(*shape)
        y = torch.empty_like(x)
        n = shape[1]
        for sign, scale in ((-1, None), (+1, 1.0 / n)):
            ref = kfft.c2c_axis_mid_plain(x, sign, scale)
            for c in (1, 2, 4, 8, 16):
                if not tile_fits(n, c):
                    continue
                for ldg in (False, True) if c <= 2 else (False,):
                    y.fill_(float("nan"))
                    kfft.mid_radix_launch(x, y, sign, 1.0 if scale is None else scale, c, ldg)
                    torch.cuda.synchronize()
                    rel = abs_err(y, ref) / float(ref.abs().max())
                    errs["c2c_axis_mid"] = max(errs["c2c_axis_mid"], abs_err(y, ref))
                    emit(phase="kernel_vs_plain", kernel="c2c_axis_mid", shape=shape,
                         cols_per_tile=c, ldg=ldg, sign=sign, scale=scale, rel_err=rel)
                    if not rel <= TOL_KERNEL:
                        raise AssertionError(f"c2c_axis_mid {shape} C {c} ldg {ldg}: {rel}")
            del ref
        del x, y

    # kernel 18 on the radix column tile at each column count C that phase
    # 5 times (the wrapper takes rfft.py::packed_mid_cols's): h = 256, 1024,
    # 1536 and 20480 (one column a tile, 40 elements a thread), ragged L,
    # the scales None and -0.5
    for shape in ((2, 256, 130), (1, 1024, 257), (1, 1536, 129), (1, 20480, 3)):
        xe, xo = randn(*shape), randn(*shape)
        nb, h, cols = shape
        y = torch.empty((nb, h + 1, cols), dtype=torch.complex64, device=dev)
        for scale in (None, -0.5):
            ref = krfft.r2c_packed_mid_plain(xe, xo, scale)
            for c in (1, 2, 4, 8, 16, 32):
                if not tile_fits(h, c):
                    continue
                y.fill_(float("nan"))
                krfft.r2c_packed_mid_launch(xe, xo, y, 1.0 if scale is None else scale, c)
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs["r2c_packed_mid"] = max(errs["r2c_packed_mid"], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel="r2c_packed_mid", shape=shape,
                     cols_per_tile=c, scale=scale, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"r2c_packed_mid {shape} C {c} scale {scale}: {rel}")
            del ref
        del xe, xo, y

    # kernel 3 on the radix row core at each count of rows a block and
    # kernel 17 on the radix column tile at each column count C that phase
    # 5 times (the wrappers take fft.py::radix_block's and
    # rfft.py::c2r_mid_cols's): h = 256, 384, 16384 and 20480 (one row or column a
    # tile, 32 and 40 elements a thread), the main paths' spectra (phase 5's
    # shapes, the plain version on a slice of 64 rows or 16 planes), ragged
    # rows and L, the scales 1/n and None; the spectra carry DC and Nyquist
    # imaginary parts that must be ignored
    for t, h, counts in ((131, 256, (1, 2, 4, 8, 16)), (7, 384, (1, 2, 3, 4, 5, 10)),
                         (2, 16384, (1,)), (2, 20480, (1,)), (512 * 512, 256, (1, 2, 4, 8)),
                         (768 * 768, 384, (1, 2, 3, 4, 6, 8, 10))):
        n = 2 * h
        s = crandn(t, h + 1)
        s[:, 0] += 100j
        s[:, -1] += 100j
        cut = min(t, 64)
        for scale in (1.0 / n, None):
            ref = krfft.c2r_nat_plain(s[:cut], n, scale)
            for rows in counts:
                got = krfft.c2r_radix_launch(s, n, scale, rows)[:cut]
                torch.cuda.synchronize()
                rel = abs_err(got, ref) / float(ref.abs().max())
                errs["c2r_nat"] = max(errs["c2r_nat"], abs_err(got, ref))
                emit(phase="kernel_vs_plain", kernel="c2r_nat", shape=(t, h + 1),
                     rows_per_block=rows, scale=scale, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"c2r_nat {(t, h + 1)} rows {rows} scale {scale}: {rel}")
                del got
            del ref
        del s
    for shape in ((2, 257, 130), (1, 385, 383), (1, 1025, 257), (1, 1537, 129), (1, 20481, 3),
                  (1, 257, 512 * 512), (512, 257, 512), (1, 641, 1280)):
        nb, m, cols = shape
        n = 2 * (m - 1)
        s = crandn(*shape)
        s[:, 0] += 100j
        s[:, -1] += 100j
        y = torch.empty((nb, n, cols), device=dev)
        cut = min(nb, 16)
        for scale in (1.0 / n, None):
            ref = krfft.c2r_mid_plain(s[:cut], n, scale)
            for c in (1, 2, 4, 8, 16, 32):
                if not tile_fits(n // 2, c):
                    continue
                y.fill_(float("nan"))
                krfft.c2r_mid_radix_launch(s, y, n, scale, c)
                torch.cuda.synchronize()
                rel = abs_err(y[:cut], ref) / float(ref.abs().max())
                errs["c2r_mid"] = max(errs["c2r_mid"], abs_err(y[:cut], ref))
                emit(phase="kernel_vs_plain", kernel="c2r_mid", shape=shape, cols_per_tile=c,
                     scale=scale, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"c2r_mid {shape} C {c} scale {scale}: {rel}")
            del ref
        del s, y

    # kernel 21 on the radix column tile at each column count C that phase
    # 5 times (the wrapper takes rfft.py::c2r_dense_cols's): even n (kernel
    # 17's kernel at h = n/2 with a plan, n = 4, 6, 130, 256, 264, 1100) and
    # odd n (the length-n inverse of the Hermitian extension, its mirrored
    # half filled in the prologue: n = 5, 129, 255, 1095),
    # the main paths' spectra, ragged L, the scales 1/n and None; the spectra
    # carry DC and Nyquist imaginary parts that must be ignored. Then kernel
    # 27's DCT-I (n = 3, 129, 265, 1025), DCT-II and DCT-III (n = 4, 130, 512,
    # 1024, 1100) on the radix column tile the same way, the scales 2 and
    # None
    for shape, n in (((2, 3, 129), 4), ((2, 3, 130), 5), ((1, 4, 33), 6), ((1, 66, 257), 130),
                     ((1, 129, 256 * 256), 256), ((1, 65, 256 * 256), 129), ((1, 133, 264), 264),
                     ((1, 128, 383), 255), ((1, 548, 130), 1095), ((1, 551, 65), 1100)):
        nb, m, cols = shape
        sp = crandn(*shape)
        sp[:, 0] += 100j
        sp[:, -1] += 100j
        y = torch.empty((nb, n, cols), device=dev)
        for scale in (1.0 / n, None):
            ref = krfft.c2r_dense_radix_plain(sp, n, scale)
            for c in (1, 2, 4, 8, 16, 32, 64):
                if not tile_fits(krfft.r2c_mid_len(n), c):
                    continue
                y.fill_(float("nan"))
                krfft.c2r_dense_radix_launch(sp, y, n, scale, c)
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs["c2r_dense_mid_radix"] = max(errs["c2r_dense_mid_radix"], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel="c2r_dense_mid_radix", shape=shape, n=n,
                     cols_per_tile=c, scale=scale, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"c2r_dense_mid_radix {shape} n {n} C {c}: {rel}")
            del ref
        del sp, y
    for shape in ((2, 3, 129), (1, 4, 130), (2, 129, 257), (1, 130, 130), (1, 265, 383),
                  (1, 512, 512 * 512), (1024, 1024, 64), (1, 1025, 1025), (1, 1100, 65)):
        x = randn(*shape)
        y = torch.empty_like(x)
        cut = min(shape[0], 16)
        for t in (1, 2, 3):
            h = kdct.dct_radix_len(shape[1], t)
            if h is None:
                continue
            for scale in (2.0, None):
                ref = kdct.dct_radix_plain(x[:cut], t, scale)
                for c in (1, 2, 4, 8, 16, 32, 64):
                    if not tile_fits(h, c):
                        continue
                    y.fill_(float("nan"))
                    kdct.dct_radix_launch(x, y, t, scale, c)
                    torch.cuda.synchronize()
                    rel = abs_err(y[:cut], ref) / float(ref.abs().max())
                    errs["dct_dense_mid_radix"] = max(errs["dct_dense_mid_radix"],
                                                      abs_err(y[:cut], ref))
                    emit(phase="kernel_vs_plain", kernel="dct_dense_mid_radix", shape=shape,
                         dct_type=t, cols_per_tile=c, scale=scale, rel_err=rel)
                    if not rel <= TOL_KERNEL:
                        raise AssertionError(f"dct_dense_mid_radix {shape} type {t} C {c}: {rel}")
                del ref
        del x, y

    # the middle-axis R2C/C2R kernels: the main paths' shapes (phase 4d),
    # axis 1 of 512^3, ragged and odd ones; kernel 20's wrapper on the radix
    # column tile (r2c_dense_mid_radix) at the lengths with a plan, on its
    # chirp-z (r2c_dense_mid_chirp) or its dense product at the others
    # (rfft.py::r2c_dense_form); the C2R spectra carry DC and Nyquist
    # imaginary parts that must be ignored
    def r2c_form(r2c_name, n):
        """The kernels line's name and the plain version of the R2C that
        ``r2c_name``'s wrapper runs at n (kernel 20: rfft.py::r2c_dense_form)."""
        if r2c_name == "r2c_mid":
            return "r2c_mid", krfft.r2c_mid_radix_plain
        return {"radix": ("r2c_dense_mid_radix", krfft.r2c_mid_radix_plain),
                "chirp": ("r2c_dense_mid_chirp", krfft.r2c_blue_plain),
                "dense": ("r2c_dense_mid", krfft.r2c_dense_mid_plain)}[krfft.r2c_dense_form(n)]

    def c2r_form(c2r_name, n):
        """The kernels line's name and the plain version of the C2R that
        ``c2r_name``'s wrapper runs at n."""
        if c2r_name == "c2r_mid":
            return c2r_name, krfft.c2r_mid_plain
        form = krfft.c2r_dense_form(n)
        return ("c2r_dense_mid" if form == "dense" else f"c2r_dense_mid_{form}",
                krfft._C2R_DENSE_PLAIN[form])

    rfft_mid_checks = (
        ("r2c_mid", "c2r_mid", krfft.r2c_mid, krfft.c2r_mid,
         ((1, 512, 512 * 512), (512, 512, 512), (1, 1024, 1024), (1, 512, 512), (3, 2048, 200),
          (2, 4096, 130))),
        ("r2c_dense_mid", "c2r_dense_mid", krfft.r2c_dense_mid, krfft.c2r_dense_mid,
         ((1, 128, 128), (1, 264, 264), (1, 256, 256 * 256), (2, 201, 130), (1, 1100, 130),
          (1, 129, 256 * 256), (2, 262, 130), (1, 1095, 130), (3, 5, 257), (2, 4, 130),
          (1, 262, 256 * 256), (1, 1099, 130), (1, 131, 256 * 256), (2, 1094, 130),
          (1, 1097, 7647))),
    )
    for r2c_name, c2r_name, r2c, c2r, shapes in rfft_mid_checks:
        for shape in shapes:
            nb, n, cols = shape
            x = randn(*shape)
            s = crandn(nb, n // 2 + 1, cols)
            s[:, 0] += 100j
            s[:, -1] += 100j
            name, r2c_plain = r2c_form(r2c_name, n)
            check_form(name, r2c, lambda: r2c(x), lambda: r2c_plain(x), shape)
            name, c2r_plain = c2r_form(c2r_name, n)
            for scale in (1.0 / n, None):
                check_form(name, c2r, lambda: c2r(s, n, scale), lambda: c2r_plain(s, n, scale),
                           shape, scale=scale)
            del x, s

    # kernel 15: the core at every factor F = 1 ... 16, the dense rows' wrapper
    # (the radix row core at h <= 256 with a plan, many rows a block at
    # h = 2, 3, 5; the chirp-z at h = 1, 31 and the primes 131 ... 251) and
    # the generic form (the radix row core with the unpack
    # epilogue), at ragged row counts and at the main paths' shapes (phases
    # 4e and 4f)
    packed_checks = (
        ("r2c_packed", krfft.r2c_packed, krfft.r2c_packed_plain,
         ((7, 256), (130, 512), (3, 1024), (33, 2048), (5, 4096), (256 * 256, 256),
          (129 * 129, 256), (129, 256), (513, 1024), (1025, 2048), (256, 256),
          (511, 1024))),
        ("r2c_packed_dense", krfft.r2c_packed_dense, None,
         ((130, 128), (128 * 128, 128), (131, 258), (3, 200), (200, 200), (7, 2),
          (129, 512), (1001, 4), (777, 6), (4097, 10), (4097, 194), (128 * 128, 262),
          (3, 502), (129, 62))),
        # the generic form: odd h (265), h = 300 at a ragged tile of several
        # rows (601 rows, 8 a tile), 530, two prime stages (h = 11352), the
        # longest h (20448, 40 elements a thread), the DCT-I/DST-I
        # extensions (h = 264) and the 600^3 step's R2C
        ("r2c_packed_generic", krfft.r2c_packed_generic, krfft.r2c_packed_generic_plain,
         ((130, 530), (7, 600), (601, 600), (5, 1060), (2, 2 * 11352), (3, 2 * 20448),
          (265, 528), (600, 600), (600 * 600, 600))),
    )
    def packed_form(h):
        """The kernels line's name and the plain version of the dense rows'
        wrapper at half length h (rfft.py::packed_dense_form)."""
        form = krfft.packed_dense_form(h)
        return f"r2c_packed_dense_{form}", krfft._PACKED_DENSE_PLAIN[form]

    for name, kern, plain, shapes in packed_checks:
        tol = TOL_KERNEL if name == "r2c_packed_generic" else TOL_PACKED
        for shape in shapes:
            x = randn(*shape)
            if kern is krfft.r2c_packed_dense:
                name, plain = packed_form(shape[1] // 2)
                before = form_counts(kern)
            got = kern(x)
            ref = plain(x)
            torch.cuda.synchronize()
            if kern is krfft.r2c_packed_dense:
                assert_launched(name, kern, before, shape)
            rel = abs_err(got, ref) / float(ref.abs().max())
            errs[name] = max(errs[name], abs_err(got, ref))
            emit(phase="kernel_vs_plain", kernel=name, shape=shape, rel_err=rel)
            if not rel <= tol:
                raise AssertionError(f"{name} {shape}: {rel}")
            del x, got, ref

    sliced = {}     # kernel -> the solve shapes that check_sliced timed

    def check_sliced(name, kern, plain, ins, dim, extra, reps, tol=TOL_KERNEL, library=None,
                     timed=True):
        """kern(*ins, *extra) on the whole tensors (one launch, in the form
        that ``name`` names) against plain on 64 slices of them along the
        batch axis ``dim`` (the plain versions take ~10x their input's
        memory; a tuple gives each input its own axis, the output's is the
        first input's); then, if ``timed``, the kernel's time, the plain
        version's over the same slices and library()'s (the yardstick) into
        ``timing``."""
        dims = dim if isinstance(dim, tuple) else (dim,) * len(ins)
        dim = dims[0]
        shape = tuple(ins[0].shape)
        step = -(-shape[dim] // 64)
        cuts = [(i0, min(step, shape[dim] - i0)) for i0 in range(0, shape[dim], step)]

        def plain_cut(i0, size):
            return plain(*[t.narrow(d, i0, size) for t, d in zip(ins, dims)], *extra)

        before = form_counts(kern)
        y = kern(*ins, *extra)
        torch.cuda.synchronize()
        assert_launched(name, kern, before, shape)
        err, peak_ref = 0.0, 0.0
        for i0, size in cuts:
            ref = plain_cut(i0, size)
            err = max(err, abs_err(y.narrow(dim, i0, size), ref))
            peak_ref = max(peak_ref, float(ref.abs().max()))
            del ref
        del y
        rel = err / peak_ref
        errs[name] = max(errs[name], err)
        emit(phase="kernel_vs_plain", kernel=name, shape=shape, rel_err=rel, sliced_dim=dim,
             extra=[e if isinstance(e, (int, float, type(None))) else list(e.shape)
                    for e in extra])
        if not rel <= tol:
            raise AssertionError(f"{name} {shape} {extra}: {rel}")
        if not timed:
            return

        def plain_cuts():
            for cut in cuts:
                plain_cut(*cut)

        t_k = cuda_ms(lambda: kern(*ins, *extra), reps, 1)
        t_plain = cuda_ms(plain_cuts, reps, 1)
        t_lib = cuda_ms(library, reps, 1) if library is not None else None
        timing[(name, shape)] = (t_k, t_plain, t_lib)
        sliced.setdefault(name, []).append(shape)
        emit(phase="time", kernel=name, shape=shape, ms=t_k, plain_ms=t_plain,
             library_ms=t_lib, plain_in_slices=len(cuts), card=card)

    # kernel 1 at F outside the bts2 fixed core's factors (the radix column
    # tile) and kernels 10, 2 and 3 at those F on the radix row core: the main
    # paths' shapes (phase 4g),
    # ragged column and row tiles, prime F = 127 and the largest F = 160 (one
    # column or row per block); the C2R spectra carry DC and Nyquist
    # imaginary parts that must be ignored
    for name, kern, plain, shapes, signs in (
            ("c2c_axis_mid", kfft.c2c_axis_mid, kfft.c2c_axis_mid_plain,
             ((1, 768, 295680), (1, 4096, 2049), (3, 640, 129), (1, 640, 256),
              (1, 16256, 128), (1, 20480, 128)),
             ((-1, False), (+1, True))),
            ("c2c_rows", kfft.c2c_rows, kfft.c2c_rows_plain,
             ((4096, 4096), (1536, 768), (128, 384), (7, 1152), (128, 1152), (128, 640),
              (128, 16256), (128, 20480)),
             ((-1, False), (+1, False), (-1, True), (+1, True)))):
        for shape in shapes:
            x = crandn(*shape)
            for sign, inv in signs:
                scale = 1.0 / shape[1] if inv else None
                check_form(name, kern, lambda: kern(x, sign, scale),
                           lambda: plain(x, sign, scale), shape, sign=sign, scale=scale)
            del x
    for t, n in ((589824, 768), (128, 1536), (7, 1536), (5, 2 * 16256), (128, 40960)):
        x = randn(t, n)
        s = crandn(t, n // 2 + 1)
        s[:, 0] += 100j
        s[:, -1] += 100j
        check_form("r2c_nat", krfft.r2c_nat, lambda: krfft.r2c_nat(x),
                   lambda: krfft.r2c_nat_plain(x), (t, n))
        for scale in (1.0 / n, None):
            check_form("c2r_nat", krfft.c2r_nat, lambda: krfft.c2r_nat(s, n, scale),
                       lambda: krfft.c2r_nat_plain(s, n, scale), (t, n // 2 + 1), scale=scale)
        del x, s
    # kernel 15 at h = 128 * F is kernel 2's code: the DCT-I path's (769,
    # 1536), a ragged few rows, F = 127 and 160, and the fixed core's former
    # F = 1 and 8
    for shape in ((769, 1536), (3, 768), (5, 2 * 16256), (2, 40960), (129, 256), (7, 2048)):
        x = randn(*shape)
        check_form("r2c_packed", krfft.r2c_packed, lambda: krfft.r2c_packed(x),
                   lambda: krfft.r2c_packed_plain(x), shape)
        del x
    # kernels 16 and 17 on the radix column tile at the wide core's F (phase
    # 4h's 768 and 1280 along axis 0, ragged columns, h = 20480 with one
    # column per tile) and kernels 23 to
    # 26 in each form: the fixed core, the wide core's half length and the
    # n-point form, at phase 4h's shapes and at ragged tiles, prime F = 131
    # and the largest tiles (n-point F = 159, half length F = 128), and the
    # n-point form's long lengths on the real tile (F = 161, 163 prime, 255:
    # one column per tile); the 1536^3 and 31104^2 shapes are checked in
    # phases 4h and 4m
    for shape in ((1, 768, 768), (1, 1280, 1280), (2, 1280, 130), (1, 40960, 2)):
        nb, n, cols = shape
        x = randn(*shape)
        s = crandn(nb, n // 2 + 1, cols)
        s[:, 0] += 100j
        s[:, -1] += 100j
        check_form("r2c_mid", krfft.r2c_mid, lambda: krfft.r2c_mid(x),
                   lambda: krfft.r2c_mid_plain(x), shape)
        for scale in (1.0 / n, None):
            check_form("c2r_mid", krfft.c2r_mid, lambda: krfft.c2r_mid(s, n, scale),
                       lambda: krfft.c2r_mid_plain(s, n, scale), (nb, n // 2 + 1, cols),
                       scale=scale)
        del x, s
    # (kernels 23 and 24 on the radix row core and kernels 25 and 26 on the
    # radix column tile at every length with a plan of n/2, at the lengths
    # the bts2 forms took before; their old forms at the remnant's n-point
    # k = 131, 163, 251 and half length F = 131, 157)
    dct_forms = (
        ("nat_radix", (2, 3), ((2048, 2048), (130, 1024), (128, 128), (384, 384), (768, 768),
                               (1536, 1536), (7, 1536), (3, 1152), (2, 128 * 159),
                               (2, 128 * 161), (3, 128 * 255), (3, 32768))),
        ("nat_wide", (2, 3), ((3, 128 * 262), (2, 128 * 314))),
        ("nat_npoint", (2, 3), ((2, 128 * 131), (3, 128 * 163), (2, 128 * 251))),
        ("mid_radix", (2, 3), ((1, 2048, 2048), (2, 4096, 33), (3, 512, 130), (1, 1280, 1280),
                               (1, 1536, 1536), (2, 1280, 130), (1, 32768, 2), (1, 1152, 1152),
                               (2, 1152, 130), (3, 384, 385), (1, 128 * 159, 3),
                               (2, 128 * 255, 3))),
        ("mid_wide", (2, 3), ((1, 128 * 262, 3), (2, 128 * 314, 3))),
        ("mid_npoint", (2, 3), ((1, 128 * 131, 3), (1, 128 * 163, 130), (2, 128 * 251, 3))))
    for form, types, shapes in dct_forms:
        for t in types:
            kern = getattr(kdct, f"dct{t}_{form.split('_')[0]}")
            plain = getattr(kdct, f"{kern.__name__}_plain")
            for shape in shapes:
                x = randn(*shape)
                for scale in (2.0, None):
                    check_form(f"dct{t}_{form}", kern, lambda: kern(x, scale),
                               lambda: plain(x, scale), shape, scale=scale)
                del x
    # kernel 18 on the radix column tile at phase 4i's lengths, ragged
    # column tiles and the largest tiles (h = 10240 and 20480: DST-I at
    # 10239 and 20479); kernel 19 on the radix column tile (kernel 27's
    # DCT-I) and kernel 28's single pass there: phase 4i's lengths, ragged
    # column tiles and the largest tiles (h = 20480, one column per tile,
    # read-only loads); kernel 28's four-step at F = 161, 162 and 256 (and at
    # F = 160 where dct.py::dct4_form takes it) and at forced short splits
    # (hl = 1024 = 32 * 32, 1280 = 10 * 128) against its plain version and
    # the single pass's; its remnant on the wide core (the primes F = 131,
    # 157) and in the long form (163, 251); the solves' shapes are checked
    # in phases 4i and 4m, slice by slice
    for shape in ((2, 256, 130), (1, 1024, 1023), (1, 1024, 130), (3, 2048, 33), (1, 384, 383),
                  (1, 1536, 1535), (2, 1152, 130), (1, 20480, 128), (1, 10240, 130),
                  (1, 20480, 130)):
        xe, xo = randn(*shape), randn(*shape)
        for scale in (-1.0, None):
            check_form("r2c_packed_mid", krfft.r2c_packed_mid,
                       lambda: krfft.r2c_packed_mid(xe, xo, scale),
                       lambda: krfft.r2c_packed_mid_plain(xe, xo, scale), shape, scale=scale)
        del xe, xo
    for name, kern, plain, scales, shapes in (
            ("dct1_mid", krfft.dct1_mid, krfft.dct1_mid_plain, (1.0, 0.5),
             ((1, 2049, 2049), (2, 2049, 130), (1, 1025, 257), (1, 1153, 1153),
              (1, 1537, 1537), (2, 1153, 130), (1, 20481, 128), (1, 10241, 130))),
            ("dct4_mid_radix", kdct.dct4_mid, kdct.dct4_mid_plain, (2.0, None),
             ((1, 2048, 2048), (1, 4096, 1024), (2, 2048, 130), (1, 1024, 257),
              (1, 1280, 1280), (1, 1536, 1536), (2, 1280, 130), (1, 20480, 130))),
            ("dct4_mid_fourstep", kdct.dct4_mid, kdct.dct4_mid_plain, (2.0, None),
             ((1, 256 * 161, 130), (2, 256 * 162, 3), (1, 65536, 33))),
            ("dct4_mid_wide", kdct.dct4_mid, kdct.dct4_mid_plain, (2.0, None),
             ((1, 256 * 131, 3), (2, 256 * 157, 130))),
            ("dct4_mid_long", kdct.dct4_mid, kdct.dct4_mid_plain, (2.0, None),
             ((2, 256 * 163, 3), (1, 256 * 251, 33))),
            (f"dct4_mid_{kdct.dct4_form(40960)}", kdct.dct4_mid, kdct.dct4_mid_plain,
             (2.0, None), ((1, 40960, 128),))):
        for shape in shapes:
            x = randn(*shape)
            for scale in scales:
                check_form(name, kern, lambda: kern(x, scale), lambda: plain(x, scale), shape,
                           scale=scale)
            del x
    for shape, h2 in (((2, 2048, 130), 32), ((1, 2560, 33), 128), ((1, 2048, 257), 64)):
        x = randn(*shape)
        y = torch.empty_like(x)
        hl = shape[1] // 2
        c1 = kdct.dct4_fourstep_cols(hl // h2, shape[0] * h2, shape[2], kfft.num_sms(dev))
        c2 = kdct.dct4_fourstep_cols(h2, shape[0] * (hl // h2), shape[2], kfft.num_sms(dev))
        kdct.dct4_fourstep_launch(x, y, 2.0, c1, c2, h2)
        for name, ref in (("dct4_mid_fourstep", kdct.dct4_fourstep_plain(x, 2.0, h2)),
                          ("dct4_mid_radix", kdct.dct4_radix_plain(x, 2.0))):
            torch.cuda.synchronize()
            rel = abs_err(y, ref) / float(ref.abs().max())
            errs["dct4_mid_fourstep"] = max(errs["dct4_mid_fourstep"], abs_err(y, ref))
            emit(phase="kernel_vs_plain", kernel="dct4_mid_fourstep", shape=shape,
                 split=[hl // h2, h2], columns=[c1, c2], plain=name, rel_err=rel)
            if not rel <= TOL_KERNEL:
                raise AssertionError(f"dct4_mid_fourstep {shape} split h2 = {h2} "
                                     f"against {name}: {rel}")
        del x, y
    # kernel 11 on the radix core's column tile at every F: the bts2 fixed
    # core's former factors (F = 4, 8, 16: n = 193, 509, 1021), F = 3, 17, 33
    # and the routes' largest, 106 (n = 131, 1031, 2049, 6781); kernel 12's
    # chirp-z on the same column kernel beside it (M = chirp_m(n) = 400,
    # 1024, 2048, 288, 2304, 4608, 14336); ragged column tiles (L = 13, 130,
    # 257; L = 1030 over tiles of C = 4 columns at n = 131 and 2049), both
    # signs and the scale 1/n (K11), DCT-II with scale 2 and DCT-III unscaled
    # (K12); the main paths' shapes are checked in phase 4j, slice by slice
    for shapes in (((2, 193, 130), (2, 509, 130), (1, 509, 13), (1, 1021, 257), (1, 509, 4096)),
                   ((2, 131, 130), (1, 1031, 130), (1, 2049, 130), (1, 6781, 128),
                    (1, 131, 1030), (1, 2049, 1030))):
        k11 = "c2c_blue_mid"
        k12 = "dct23_blue_mid"
        for shape in shapes:
            x = crandn(*shape)
            for sign, scale in ((-1, None), (+1, 1.0 / shape[1])):
                check_form(k11, kfft.c2c_blue_mid, lambda: kfft.c2c_blue_mid(x, sign, scale),
                           lambda: kfft.c2c_blue_mid_plain(x, sign, scale), shape, sign=sign,
                           scale=scale)
            r = x.real.contiguous()
            del x
            for t, scale in ((2, 2.0), (3, None)):
                check_form(k12, kdct.dct23_blue_mid, lambda: kdct.dct23_blue_mid(r, t, scale),
                           lambda: kdct.dct23_blue_mid_plain(r, t, scale), shape,
                           dct_type=t, scale=scale)
            del r
    # kernel 12's chirp-z at each column count C that phase 5 times (the
    # wrapper takes dct.py::dct23_blue_cols's at M): M = 2304, 4608, 8960 and
    # 14336 (n = 1103, 2049, 4099, 6781; 16, 32 and 40 elements a thread),
    # ragged L, DCT-II with scale 2 and DCT-III unscaled
    for shape in ((2, 1103, 130), (1, 2049, 33), (1, 4099, 7), (1, 6781, 5)):
        x = randn(*shape)
        y = torch.empty_like(x)
        mk = kfft.chirp_m(shape[1])
        for t, scale in ((2, 2.0), (3, None)):
            ref = kdct.dct23_blue_mid_plain(x, t, scale)
            for c in (1, 2, 4, 8, 16):
                if not tile_fits(mk, c):
                    continue
                y.fill_(float("nan"))
                kdct.dct23_blue_launch(x, y, t, scale, c)
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs["dct23_blue_mid"] = max(errs["dct23_blue_mid"], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel="dct23_blue_mid", shape=shape, M=mk,
                     dct_type=t, cols_per_tile=c, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"dct23_blue_mid {shape} type {t} C {c}: {rel}")
            del ref
        del x, y
    # kernel 7 on the radix column tile at the n1 of its old forms (the
    # dense body's 144 and 256, the fixed core's 512 and 1024, the wide
    # core's 384, 640, 2176 and 4096) and at the dense remnant's primes
    # 131 and 251, ragged column tiles (n2 = 17: (2176, 17) and (144, 17)
    # of the lengths 36992 and 10007's sub-FFTs, 33, 130, 160);
    # kernel 13 at n2 = 128, 256, 384, 768, 1024, 2048 with n1 = 144 and 3
    # (a block's rows cross batch boundaries) and 1024; both signs, K13
    # with the scale 1/n. The main paths' shapes are checked in phase 4k,
    # slice by slice
    for name, shapes in (("fourstep_mid_radix", ((2, 144, 144), (1, 256, 160), (3, 256, 128),
                                                 (2, 144, 17), (3, 512, 130), (1, 1024, 1024),
                                                 (2, 1024, 33), (2, 384, 384), (1, 640, 256),
                                                 (2, 2176, 17), (1, 4096, 33))),
                         ("fourstep_mid_dense", ((2, 131, 130), (1, 251, 17)))):
        for shape in shapes:
            x = crandn(*shape)
            for sign in (-1, +1):
                check_form(name, kfft.fourstep_mid, lambda: kfft.fourstep_mid(x, sign),
                           lambda: kfft.fourstep_mid_plain(x, sign), shape, sign=sign)
            del x
    for name, shapes in (("rows_store_t", ((3, 144, 128), (2, 1024, 128), (3, 144, 256),
                                           (3, 144, 384), (2, 144, 768), (5, 3, 128),
                                           (3, 144, 1024), (1, 1024, 1024), (7, 3, 1024),
                                           (3, 144, 2048), (2, 1024, 2048))),):
        for shape in shapes:
            x = crandn(*shape)
            n = shape[1] * shape[2]
            for sign, scale in ((-1, None), (+1, 1.0 / n)):
                check_form(name, kfft.rows_store_t, lambda: kfft.rows_store_t(x, sign, scale),
                           lambda: kfft.rows_store_t_plain(x, sign, scale), shape, sign=sign,
                           scale=scale)
            del x
    # kernels 14 and 22 on the radix column tile through their wrappers at
    # the lengths of their old fixed forms (K14 at n = 512, 1024, 2048; K22
    # at h = n/2 = 256, 512, 1024, 2048) and wide forms (K14 at 384, 640,
    # 1280, 16256 (F = 127) and 20480 (F = 160); K22 at h = 384, 640,
    # 20480), and K29 on the radix column tile
    # at the lengths of its old forms (the fixed core's h = 256 ... 2048, the
    # wide half length's n = 256, 1280, 32768, the n-point form's n = 128,
    # 384, 1152, 20352, 20608, 32640) and at the remnant's wide F = 131, 157
    # and n-point k = 131, 163, 251;
    # ragged column tiles (L = 130, 257), nb > 1, a
    # broadcast and a lane-varying H, real and complex (K14, K22), the
    # scales 1, 1/n and a scalar. The main paths' shapes are checked in
    # phase 4l, slice by slice
    for nb, n, cols in ((2, 512, 130), (1, 1024, 257), (1, 2048, 64), (2, 384, 130),
                        (1, 640, 130), (1, 1280, 257), (1, 16256, 8), (1, 20480, 3)):
        x = crandn(nb, n, cols)
        for h, s in ((randn(n, 1), None), (crandn(n, cols), 1.0 / n), (randn(n, cols), 0.37)):
            check_form("spectral_c2c_mid", kfft.spectral_c2c_mid,
                       lambda: kfft.spectral_c2c_mid(x, h, s),
                       lambda: kfft.spectral_c2c_mid_plain(x, h, s), (nb, n, cols),
                       h_shape=list(h.shape), h_complex=h.is_complex(), scale=s)
        del x, h
    for nb, n, cols in ((2, 512, 130), (1, 1024, 257), (1, 2048, 130), (1, 4096, 64),
                        (2, 768, 130), (1, 1280, 130), (1, 40960, 3)):
        x = randn(nb, n, cols)
        m = n // 2 + 1
        for hr, hi, s in ((randn(m, 1), None, None), (randn(m, cols), randn(m, cols), 1.0 / n),
                          (randn(m, 1), randn(m, 1), 0.37)):
            check_form("spectral_r2c_mid", krfft.spectral_r2c_mid,
                       lambda: krfft.spectral_r2c_mid(x, hr, hi, n, s),
                       lambda: krfft.spectral_r2c_mid_plain(x, hr, hi, n, s), (nb, n, cols),
                       h_shape=list(hr.shape), h_complex=hi is not None, scale=s)
        del x, hr, hi
    # kernels 14 and 22's launches at each column count C that phase 5 scans
    # (C = 1 ... 16 where the tile fits; at C <= 2 with both loads), with a
    # broadcast real and a lane-varying complex H, against the plain
    # versions (the wrappers take fft.py::axis_mid_tile's and
    # rfft.py::spectral_cols's)
    scan_cols = ((1, False), (1, True), (2, False), (2, True), (4, False), (8, False),
                 (16, False))

    def tile_fits(length, c):
        return length * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(length, c) <= 512

    for nb, n, cols in ((1, 1024, 257), (2, 1280, 130), (1, 384, 33)):
        x = crandn(nb, n, cols)
        y = torch.empty_like(x)
        for hr, hi, s in ((randn(n, 1), None, 1.0), (randn(n, cols), randn(n, cols), 1.0 / n)):
            ref = kfft.spectral_c2c_mid_plain(x, hr if hi is None else torch.complex(hr, hi), s)
            for c, ldg in scan_cols:
                if not tile_fits(n, c):
                    continue
                y.fill_(float("nan"))
                kfft.spectral_c2c_launch(x, y, hr, hi, s, c, ldg)
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs["spectral_c2c_mid"] = max(errs["spectral_c2c_mid"], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel="spectral_c2c_mid", shape=(nb, n, cols),
                     cols_per_tile=c, read_only_load=ldg, h_shape=list(hr.shape),
                     h_complex=hi is not None, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"spectral_c2c_mid {n} C = {c} ldg {ldg}: {rel}")
            del ref
        del x, y
    for nb, n, cols in ((1, 1024, 257), (2, 768, 130), (1, 2048, 33), (1, 40960, 2)):
        x = randn(nb, n, cols)
        y = torch.empty_like(x)
        m = n // 2 + 1
        for hr, hi, s in ((randn(m, 1), None, 1.0 / n), (randn(m, cols), randn(m, cols), 0.5)):
            ref = krfft.spectral_r2c_mid_plain(x, hr, hi, n, s)
            for c, ldg in scan_cols:
                if not tile_fits(n // 2, c):
                    continue
                y.fill_(float("nan"))
                krfft.spectral_r2c_launch(x, y, hr, hi, n, s, c, ldg)
                torch.cuda.synchronize()
                rel = abs_err(y, ref) / float(ref.abs().max())
                errs["spectral_r2c_mid"] = max(errs["spectral_r2c_mid"], abs_err(y, ref))
                emit(phase="kernel_vs_plain", kernel="spectral_r2c_mid", shape=(nb, n, cols),
                     cols_per_tile=c, read_only_load=ldg, h_shape=list(hr.shape),
                     h_complex=hi is not None, rel_err=rel)
                if not rel <= TOL_KERNEL:
                    raise AssertionError(f"spectral_r2c_mid {n} C = {c} ldg {ldg}: {rel}")
            del ref
        del x, y
    for name, shapes in (("spectral_dct_mid_radix", ((2, 512, 130), (1, 1024, 257),
                                                     (1, 2048, 130), (1, 4096, 64),
                                                     (2, 256, 130), (1, 1280, 130), (1, 32768, 3),
                                                     (2, 128, 130), (2, 384, 130), (1, 1152, 130),
                                                     (1, 20352, 3), (1, 128 * 161, 130),
                                                     (1, 128 * 255, 3))),
                         ("spectral_dct_mid_wide", ((1, 128 * 262, 3), (2, 128 * 314, 3))),
                         ("spectral_dct_mid_npoint", ((1, 128 * 131, 3), (1, 128 * 163, 130),
                                                      (2, 128 * 251, 3)))):
        for nb, n, cols in shapes:
            x = randn(nb, n, cols)
            for hv, s2, s3 in ((randn(n, 1), 2.0, 2.0), (randn(n, cols), None, 0.37)):
                check_form(name, kdct.spectral_dct_mid,
                           lambda: kdct.spectral_dct_mid(x, hv, s2, s3),
                           lambda: kdct.spectral_dct_mid_plain(x, hv, s2, s3), (nb, n, cols),
                           h_shape=list(hv.shape), s2=s2, s3=s3)
            del x, hv
    torch.cuda.empty_cache()

    # ---- 4a. the spectral step through the public functions
    def step2(x, hr, hc):
        vhat = nd.ndfft(nd.ndfft_r2c(x, hr, axis=1), hc, axis=0)
        return vhat, nd.ndifft_r2c(nd.ndifft(vhat, hc, axis=0), hr, axis=1)

    def fwd3(x, hr, hc):
        return nd.ndfft(nd.ndfft(nd.ndfft_r2c(x, hr, axis=2), hc, axis=1), hc, axis=0)

    def inv3(v, hr, hc):
        return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=0), hc, axis=1), hr,
                             axis=2)

    wrappers = {"c2c_axis_mid": kfft.c2c_axis_mid, "r2c_nat": krfft.r2c_nat,
                "c2r_nat": krfft.c2r_nat, "dct_dense_mid": kdct.dct_dense_mid,
                "dct2_nat": kdct.dct2_nat, "dct3_nat": kdct.dct3_nat,
                "c2c_rows": kfft.c2c_rows, "c2c_dense_rows": kfft.c2c_dense_rows,
                "c2c_dense_mid": kfft.c2c_dense_mid, "r2c_mid": krfft.r2c_mid,
                "c2r_mid": krfft.c2r_mid, "r2c_dense_mid": krfft.r2c_dense_mid,
                "c2r_dense_mid": krfft.c2r_dense_mid, "r2c_packed": krfft.r2c_packed,
                "r2c_packed_dense": krfft.r2c_packed_dense,
                "c2c_generic_rows": kfft.c2c_generic_rows,
                "c2c_generic_mid": kfft.c2c_generic_mid,
                "r2c_packed_generic": krfft.r2c_packed_generic,
                "dct2_mid": kdct.dct2_mid, "dct3_mid": kdct.dct3_mid,
                "r2c_packed_mid": krfft.r2c_packed_mid, "dct1_mid": krfft.dct1_mid,
                "dct4_mid": kdct.dct4_mid, "c2c_blue_mid": kfft.c2c_blue_mid,
                "dct23_blue_mid": kdct.dct23_blue_mid, "fourstep_mid": kfft.fourstep_mid,
                "rows_store_t": kfft.rows_store_t, "spectral_c2c_mid": kfft.spectral_c2c_mid,
                "spectral_r2c_mid": krfft.spectral_r2c_mid,
                "spectral_dct_mid": kdct.spectral_dct_mid}
    # the wide core's launches, the DCT kernels' n-point ones, kernel 7's
    # dense ones and those of the radix-only wrappers and kernels 7, 20, 21,
    # 23 to 27 and 29 on the radix core, counted apart by the same wrappers (their
    # ``launches`` count every launch)
    radix_too = ("r2c_dense_mid", "c2r_dense_mid", "dct_dense_mid", "r2c_packed_dense")
    forms = {f"{name}_{form}": (wrappers[name], f"{form}_launches")
             for name in (*RADIX_ONLY, *radix_too,
                          "dct2_nat", "dct3_nat", "dct2_mid",
                          "dct3_mid", "dct4_mid", "fourstep_mid", "spectral_dct_mid")
             for form in FORMS
             if form == "wide" and name not in (*RADIX_ONLY, *radix_too, "fourstep_mid")
             or form == "radix" and name in (*RADIX_ONLY, *radix_too, "dct2_nat", "dct3_nat",
                                             "dct2_mid", "dct3_mid", "spectral_dct_mid",
                                             "dct4_mid", "fourstep_mid")
             or form == "npoint" and name.startswith(("dct2_", "dct3_", "spectral_dct"))
             or form == "dense" and name == "fourstep_mid"
             or form in ("long", "fourstep") and name == "dct4_mid"
             or form == "chirp" and name in ("r2c_dense_mid", "c2r_dense_mid",
                                             "r2c_packed_dense")}

    def count(name):
        if name in forms:
            wrapper, attr = forms[name]
            return getattr(wrapper, attr)
        return wrappers[name].launches

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        for w, attr in forms.values():
            setattr(w, attr, 0)
        engine.c2c.calls = 0     # the torch engine's runs, every lowering's

    launches = dict.fromkeys(list(wrappers) + list(forms), 0)   # the sum over the main paths

    def read_counts(path, **expected):
        """Check the launches since reset_counts() against ``expected`` (every
        kernel not named: 0; a radix-only wrapper's radix launches, where not
        named, its launches) and no engine call; add them to ``launches``."""
        torch.cuda.synchronize()
        unknown = set(expected) - set(launches)
        if unknown:
            raise ValueError(f"{path}: no launch counter {sorted(unknown)}")
        got = {k: count(k) for k in launches}
        want = {k: expected.get(k, 0) for k in launches}
        for name in RADIX_ONLY:
            want[f"{name}_radix"] = expected.get(f"{name}_radix", want[name])
        engine_calls = engine.c2c.calls
        emit(phase="main_path", path=path, launches=got, engine_calls=engine_calls)
        if got != want or engine_calls:
            raise AssertionError(f"{path}: launches {got} (expected {want}), "
                                 f"engine calls {engine_calls}")
        for k, v in got.items():
            launches[k] += v

    timing = {}     # (kernel, shape) -> (ms, plain ms, library ms or None)
    reps_big = 3    # runs of each 1536^3 time (phase 4h), after one warm-up
    inputs = {n: randn(n, n) for n in (512, 1024)}
    x3 = randn(512, 512, 512)
    reset_counts()
    outs = {}
    for n, x in inputs.items():
        outs[n] = step2(x, nd.R2cFftHandler(n), nd.FftHandler(n))
    h512r, h512c = nd.R2cFftHandler(512), nd.FftHandler(512)
    v3 = fwd3(x3, h512r, h512c)
    back3 = inv3(v3, h512r, h512c)
    read_counts("spectral_step", c2c_axis_mid=8, r2c_nat=3, c2r_nat=3)
    for n, x in inputs.items():
        vhat, back = outs[n]
        ref = torch.fft.rfftn(x.double())
        fwd = rel_err(vhat, ref)
        rt = abs_err(back, x) / float(x.abs().max())
        emit(phase="step", grid=[n, n], fwd_rel_err=fwd, roundtrip_rel_err=rt,
             finite=bool(torch.isfinite(back).all()), shape=list(vhat.shape))
        if not (fwd <= TOL_STEP and rt <= TOL_STEP):
            raise AssertionError(f"{n}^2 step: fwd {fwd}, round trip {rt}")
    ref3 = torch.fft.rfftn(x3.double())
    fwd = rel_err(v3, ref3)
    del ref3
    rt = abs_err(back3, x3) / float(x3.abs().max())
    emit(phase="step", grid=[512, 512, 512], fwd_rel_err=fwd,
         roundtrip_rel_err=rt, finite=bool(torch.isfinite(back3).all()),
         shape=list(v3.shape))
    if not (fwd <= TOL_STEP and rt <= TOL_STEP):
        raise AssertionError(f"512^3 step: fwd {fwd}, round trip {rt}")
    del outs, v3, back3
    torch.cuda.empty_cache()

    # ---- 4b. the DCT/DST family through the public functions
    import scipy.fft as sfft

    def host64(t):
        return t.double().cpu().numpy()

    def check(what, got, want, tol=TOL_STEP, **kw):
        err = float(abs(host64(got) - want).max() / abs(want).max())
        emit(phase="dct_path", check=what, rel_err=err,
             finite=bool(torch.isfinite(got).all()), shape=list(got.shape), **kw)
        if not err <= tol:
            raise AssertionError(f"{what}: {err}")

    grid = {n: randn(n, n) for n in (129, 265, 513, 1025)}
    xp = randn(1024, 1024)
    hd, hs = nd.DctHandler(1024), nd.DstHandler(1024)
    inv_1024 = nd.Normalization.scalar(1.0 / 1024)
    hdi, hsi = hd.normalization(inv_1024), hs.normalization(inv_1024)

    def dct_pair(x):
        f = nd.nddct2(nd.nddct2(x, hd, axis=1), hd, axis=0)
        return f, nd.nddct3(nd.nddct3(f, hdi, axis=0), hdi, axis=1)

    def dst_pair(x):
        f = nd.nddst2(nd.nddst2(x, hs, axis=1), hs, axis=0)
        return f, nd.nddst3(nd.nddst3(f, hsi, axis=0), hsi, axis=1)

    # Neumann Poisson -lap u = f on [0, 1]^3, cell centres x_i = (i + 1/2)/n:
    # u = sum_m amp cos(a pi x) cos(b pi y) cos(c pi z) is a sum of DCT-II
    # basis vectors with eigenvalues pi^2 (a^2 + b^2 + c^2), so the spectral
    # solve reproduces it to roundoff
    n3 = 512
    modes = ((1, 2, 3, 1.0), (5, 3, 2, 0.5))
    xc = (torch.arange(n3, device=dev, dtype=torch.float64) + 0.5) / n3

    def modal_field(weight):
        out = torch.zeros(n3, n3, n3, device=dev, dtype=torch.float64)
        for a, b, c, amp in modes:
            out += (amp * weight(a, b, c) * torch.cos(a * math.pi * xc)[:, None, None]
                    * torch.cos(b * math.pi * xc)[None, :, None]
                    * torch.cos(c * math.pi * xc)[None, None, :])
        return out

    u_exact = modal_field(lambda a, b, c: 1.0)
    f3 = modal_field(lambda a, b, c: math.pi ** 2 * (a * a + b * b + c * c)).float()
    k2 = (torch.arange(n3, device=dev, dtype=torch.float32) * math.pi) ** 2
    inv_lam = 1.0 / (k2[:, None, None] + k2[None, :, None] + k2[None, None, :])
    inv_lam[0, 0, 0] = 0.0          # the zero mode is pinned to 0
    hp = nd.DctHandler(n3)
    hpi = hp.normalization(nd.Normalization.scalar(1.0 / n3))

    def poisson(f):
        fh = nd.nddct2(nd.nddct2(nd.nddct2(f, hp, axis=2), hp, axis=1), hp, axis=0)
        uh = fh * inv_lam
        return fh, nd.nddct3(nd.nddct3(nd.nddct3(uh, hpi, axis=0), hpi, axis=1),
                             hpi, axis=2)

    def yardstick_poisson(f):
        fh = makhoul_dct(makhoul_dct(makhoul_dct(f, 2, 2), 1, 2), 0, 2)
        u = fh * inv_lam
        for ax in (0, 1, 2):
            u = makhoul_dct(u, ax, 3) / (2 * n3)
        return u

    reset_counts()
    grid_out = {n: nd.nddct1(x, nd.DctHandler(n), axis=0) for n, x in grid.items()}
    pair = dct_pair(xp)
    y4 = nd.nddct4(xp, hd, axis=0)
    spair = dst_pair(xp)
    fh3, u3 = poisson(f3)
    # K27 on the radix column tile but for DCT-IV along axis 0 of 1024^2
    read_counts("dct_family", dct_dense_mid=4 + 5 + 4, dct_dense_mid_radix=4 + 4 + 4,
                dct2_nat=2 + 1, dct2_nat_radix=2 + 1, dct3_nat=2 + 1, dct3_nat_radix=2 + 1)
    for n, y in grid_out.items():
        check("dct1_axis0", y, sfft.dct(host64(grid[n]), type=1, axis=0), grid=[n, n])
    x64 = host64(xp)
    check("dct2_both_axes", pair[0], sfft.dctn(x64, type=2), grid=[1024, 1024])
    check("dct3_roundtrip", pair[1], x64, grid=[1024, 1024])
    check("dct4_axis0", y4, sfft.dct(x64, type=4, axis=0), grid=[1024, 1024])
    check("dst2_both_axes", spair[0], sfft.dstn(x64, type=2), grid=[1024, 1024])
    check("dst3_roundtrip", spair[1], x64, grid=[1024, 1024])
    del grid_out, pair, y4, spair
    f64 = f3.double()
    ref_fh = makhoul_dct(makhoul_dct(makhoul_dct(f64, 2, 2), 1, 2), 0, 2)
    del f64
    fwd = float((fh3.double() - ref_fh).abs().max() / ref_fh.abs().max())
    del ref_fh
    sol = float((u3.double() - u_exact).abs().max() / u_exact.abs().max())
    emit(phase="dct_path", check="poisson_512^3", fwd_rel_err=fwd, solution_rel_err=sol,
         finite=bool(torch.isfinite(u3).all()), shape=list(u3.shape))
    if not (fwd <= TOL_STEP and sol <= TOL_STEP):
        raise AssertionError(f"512^3 Poisson: forward {fwd}, solution {sol}")
    del fh3, u3, u_exact
    torch.cuda.empty_cache()

    # ---- 4c. the complex n-D transform through ndfft / ndifft on every axis
    def fftn_all(x, hs):
        for axis, h in enumerate(hs):
            x = nd.ndfft(x, h, axis=axis)
        return x

    def ifftn_all(y, hs):
        for axis in reversed(range(len(hs))):
            y = nd.ndifft(y, hs[axis], axis=axis)
        return y

    def check_c2c(what, got, x, back, dims=None, **kw):
        ref = torch.fft.fftn(x.to(torch.complex128), dim=dims)
        fwd = rel_err(got, ref)
        del ref
        rt = abs_err(back, x) / float(x.abs().max())
        emit(phase="c2c_path", check=what, fwd_rel_err=fwd, roundtrip_rel_err=rt,
             finite=bool(torch.isfinite(torch.view_as_real(back)).all()),
             shape=list(got.shape), **kw)
        if not (fwd <= TOL_STEP and rt <= TOL_STEP):
            raise AssertionError(f"{what} {kw}: fwd {fwd}, round trip {rt}")

    # grid -> expected launches: 1024^2 K10 (F = 8) on axis 1 and K1 on
    # axis 0; 256^3 K8 on axis 2 and K4 on axes 1 and 0; 512^3 K10 (F = 4)
    # on axis 2 and K1 on axes 1 and 0
    c2c_grids = {(1024, 1024): dict(c2c_rows=2, c2c_axis_mid=2),
                 (256, 256, 256): dict(c2c_dense_rows=2, c2c_dense_mid=4),
                 (512, 512, 512): dict(c2c_rows=2, c2c_axis_mid=4)}
    c2c_inputs = {}
    for grid_shape, expected in c2c_grids.items():
        x = crandn(*grid_shape)
        hs = [nd.FftHandler(n) for n in grid_shape]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()    # the input and earlier phases' tensors
        reset_counts()
        y = fftn_all(x, hs)
        back = ifftn_all(y, hs)
        read_counts("c2c_" + "x".join(map(str, grid_shape)), **expected)
        peak = torch.cuda.max_memory_allocated()
        check_c2c("fftn_ifftn", y, x, back, grid=list(grid_shape), peak_bytes=peak,
                  base_bytes=base)
        c2c_inputs[grid_shape] = x
        del y, back
        torch.cuda.empty_cache()

    # the reference's fft2d protocol: forward C2C along axis 0 of n x n
    # (K4 at 128 and 264, K1 at 512 and 1024); the inverse that checks the
    # round trip runs after the counted window
    fft2d_inputs = {n: crandn(n, n) for n in (128, 264, 512, 1024)}
    reset_counts()
    fft2d_out = {n: nd.ndfft(x, nd.FftHandler(n), axis=0) for n, x in fft2d_inputs.items()}
    read_counts("fft2d", c2c_dense_mid=2, c2c_axis_mid=2)
    for n, x in fft2d_inputs.items():
        back = nd.ndifft(fft2d_out[n], nd.FftHandler(n), axis=0)
        check_c2c("fft2d_axis0", fft2d_out[n], x, back, dims=(0,), grid=[n, n])
    del fft2d_out

    # ---- 4d. real transforms along a middle axis through ndfft_r2c /
    # ndifft_r2c: the rfft2d protocol (K20/K21 at 128 and 264, K16/K17 at
    # 512 and 1024; every R2C on the radix column tile), then the real steps
    # with the real axis first
    def check_r2c_mid(what, spec, x, back, dims, **kw):
        ref = torch.fft.rfftn(x.double(), dim=dims)
        fwd = rel_err(spec, ref)
        del ref
        rt = abs_err(back, x) / float(x.abs().max())
        emit(phase="r2c_mid_path", check=what, fwd_rel_err=fwd, roundtrip_rel_err=rt,
             finite=bool(torch.isfinite(back).all()), shape=list(spec.shape), **kw)
        if not (fwd <= TOL_STEP and rt <= TOL_STEP):
            raise AssertionError(f"{what} {kw}: fwd {fwd}, round trip {rt}")

    rfft2d_inputs = {n: randn(n, n) for n in (128, 264, 512, 1024)}
    reset_counts()
    rfft2d_out = {}
    for n, x in rfft2d_inputs.items():
        h = nd.R2cFftHandler(n)
        spec = nd.ndfft_r2c(x, h, axis=0)
        rfft2d_out[n] = spec, nd.ndifft_r2c(spec, h, axis=0)
    read_counts("rfft2d", r2c_dense_mid=2, r2c_dense_mid_radix=2, c2r_dense_mid=2,
                c2r_dense_mid_radix=2, r2c_mid=2, c2r_mid=2)
    for n, x in rfft2d_inputs.items():
        spec, back = rfft2d_out[n]
        check_r2c_mid("rfft2d_axis0", spec, x, back, (0,), grid=[n, n])
    del rfft2d_out, spec, back

    def fwd_first(x, hr, hc):
        return nd.ndfft(nd.ndfft(nd.ndfft_r2c(x, hr, axis=0), hc, axis=1), hc, axis=2)

    def inv_first(v, hr, hc):
        return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=2), hc, axis=1), hr, axis=0)

    # grid -> expected launches: 512^3 K16 (the radix column tile), K1 at
    # (257, 512, 512), K10 on 131584 rows, K17; 256^3 K20 (the radix column
    # tile), K4 at (129, 256, 256), K8 on 33024 rows, K21 (the radix column tile)
    first_grids = {512: dict(r2c_mid=1, c2c_axis_mid=2, c2c_rows=2, c2r_mid=1),
                   256: dict(r2c_dense_mid=1, r2c_dense_mid_radix=1, c2c_dense_mid=2,
                             c2c_dense_rows=2, c2r_dense_mid=1, c2r_dense_mid_radix=1)}
    first_inputs = {}
    for n, expected in first_grids.items():
        x = randn(n, n, n)
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        v = fwd_first(x, hr, hc)
        back = inv_first(v, hr, hc)
        read_counts(f"real_axis_first_{n}^3", **expected)
        peak = torch.cuda.max_memory_allocated()
        check_r2c_mid("step_real_axis_first", v, x, back, (1, 2, 0), grid=[n, n, n],
                      peak_bytes=peak, base_bytes=base)
        first_inputs[n] = x
        del v, back
        torch.cuda.empty_cache()

    # ---- 4e. the lane lowerings along the last axis: the real steps with
    # the real axis last (kernel 15, then kernel 8 after the C2R's Hermitian
    # extension), the odd grid's row pairs, the Chebyshev DCT-I / DST-I and
    # the DCT-II/III/IV lanes
    def check_lane(what, got, ref, back=None, x=None, **kw):
        fwd = rel_err(got, ref)
        rt = abs_err(back, x) / float(x.abs().max()) if back is not None else None
        emit(phase="lane_path", check=what, fwd_rel_err=fwd, roundtrip_rel_err=rt,
             finite=bool(torch.isfinite(torch.view_as_real(got) if got.is_complex()
                                         else got).all()), shape=list(got.shape), **kw)
        if not (fwd <= TOL_STEP and (rt is None or rt <= TOL_STEP)):
            raise AssertionError(f"{what} {kw}: fwd {fwd}, round trip {rt}")

    # grid -> expected launches: 256^3 K15 on the core (h = 128, 65536
    # rows), K4 at (256, 256, 129) and (1, 256, 33024), K8 on 65536 rows
    # after the extension; 128^3 K15's dense rows on the radix row core (h =
    # 64, 16384 rows),
    # K8 on 8320 rows (axis 1 has 65 < 128 columns and moves), K4 at
    # (1, 128, 8320), K8 on 16384 rows after the extension
    last_grids = {256: dict(r2c_packed=1, c2c_dense_mid=4, c2c_dense_rows=1),
                  128: dict(r2c_packed_dense=1, r2c_packed_dense_radix=1, c2c_dense_rows=3,
                            c2c_dense_mid=2)}
    last_inputs = {}
    for n, expected in last_grids.items():
        x = randn(n, n, n)
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        v = fwd3(x, hr, hc)
        back = inv3(v, hr, hc)
        read_counts(f"real_axis_last_{n}^3", **expected)
        peak = torch.cuda.max_memory_allocated()
        check_lane("step_real_axis_last", v, torch.fft.rfftn(x.double()), back, x,
                   grid=[n, n, n], peak_bytes=peak, base_bytes=base)
        last_inputs[n] = x
        del v, back
        torch.cuda.empty_cache()

    # the odd grid: R2C of 16641 rows of 129 as 8321 row pairs on K8, and the
    # C2R's extension on K8
    xo3 = randn(129, 129, 129)
    h129 = nd.R2cFftHandler(129)
    reset_counts()
    vo = nd.ndfft_r2c(xo3, h129, axis=2)
    backo = nd.ndifft_r2c(vo, h129, axis=2)
    read_counts("odd_129^3", c2c_dense_rows=2)
    check_lane("r2c_odd_last", vo, torch.fft.rfft(xo3.double(), dim=2), backo, xo3,
               grid=[129, 129, 129])
    del vo, backo

    # Chebyshev: DCT-I along every axis of 129^3 (K27 on axes 0 and 1, K15
    # at h = 128 on axis 2) and along the last axis of n x n at h = 128,
    # 512, 1024; DST-I at n = 127 (h = 128) and 511 (h = 512)
    cheb = {n: randn(n, n) for n in (129, 513, 1025)}
    dst_in = {127: randn(256, 127), 511: randn(511, 511)}
    h129d = nd.DctHandler(129)
    reset_counts()
    c3 = nd.nddct1(nd.nddct1(nd.nddct1(xo3, h129d, axis=0), h129d, axis=1), h129d, axis=2)
    cheb_out = {n: nd.nddct1(x, nd.DctHandler(n), axis=1) for n, x in cheb.items()}
    dst_out = {n: nd.nddst1(x, nd.DstHandler(n), axis=1) for n, x in dst_in.items()}
    read_counts("chebyshev", dct_dense_mid=2, dct_dense_mid_radix=2, r2c_packed=1 + 3 + 2)
    check("dct1_129^3_all_axes", c3, sfft.dctn(host64(xo3), type=1), grid=[129] * 3)
    for n, y in cheb_out.items():
        check("dct1_last_axis", y, sfft.dct(host64(cheb[n]), type=1, axis=1), grid=[n, n])
    for n, y in dst_out.items():
        check("dst1_last_axis", y, sfft.dst(host64(dst_in[n]), type=1, axis=1),
              grid=list(dst_in[n].shape))
    del c3, cheb_out, dst_out, xo3

    # the DCT lanes: DCT-IV / DST-IV of 1024^2 (K10 on 2048 rows of 1024)
    # and DCT-IV of 512^3 (K10 on 524288 rows of 512, a 2.1 GB intermediate);
    # DCT-III of 200^2 (K8 on 200 rows) and DCT-II of 200^2 (K15's dense
    # product at h = 100)
    x200 = randn(200, 200)
    x4 = randn(512, 512, 512)
    hd512 = nd.DctHandler(512)
    hd1024, hs1024 = nd.DctHandler(1024), nd.DstHandler(1024)
    reset_counts()
    d4 = nd.nddct4(xp, hd1024, axis=1)
    s4 = nd.nddst4(xp, hs1024, axis=1)
    d4_3 = nd.nddct4(x4, hd512, axis=2)
    d3 = nd.nddct3(x200, axis=1)
    d2 = nd.nddct2(x200, axis=1)
    read_counts("dct_lanes", c2c_rows=3, c2c_dense_rows=1,
                r2c_packed_dense=1, r2c_packed_dense_radix=1)
    check("dct4_last_axis", d4, sfft.dct(x64, type=4, axis=1), grid=[1024, 1024])
    check("dst4_last_axis", s4, sfft.dst(x64, type=4, axis=1), grid=[1024, 1024])
    check("dct4_512^3_last_axis", d4_3,
          sfft.dct(host64(x4), type=4, axis=2, workers=os.cpu_count()), grid=[512] * 3)
    check("dct3_last_axis", d3, sfft.dct(host64(x200), type=3, axis=1), grid=[200, 200])
    check("dct2_last_axis", d2, sfft.dct(host64(x200), type=2, axis=1), grid=[200, 200])
    del d4, s4, d4_3, d3, d2, x4
    torch.cuda.empty_cache()

    # ---- 4f. the generic two-factor schedule: the 600^3 real step with the
    # real axis last (K15 at h = 300 on 360000 rows, K6 at (600, 600, 301)
    # and (1, 600, 180600) forward and back, K8 at n = 600 on 360000 rows
    # after the C2R's Hermitian extension: 0.86 GB per field, a 1.73 GB
    # extension), then the reference's sizes and lengths without a split
    n6 = 600
    x600 = randn(n6, n6, n6)
    h600r, h600c = nd.R2cFftHandler(n6), nd.FftHandler(n6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    v = fwd3(x600, h600r, h600c)
    back = inv3(v, h600r, h600c)
    read_counts("real_axis_last_600^3", r2c_packed_generic=1, c2c_generic_mid=4,
                c2c_generic_rows=1)
    peak = torch.cuda.max_memory_allocated()
    check_lane("step_real_axis_last", v, torch.fft.rfftn(x600.double()), back, x600,
               grid=[n6] * 3, peak_bytes=peak, base_bytes=base)
    del v, back
    torch.cuda.empty_cache()

    # K8 at 264 (m = 2, f = 132), 300, 600 and 1000 on rows; K6 along axis 0
    # at 1200 and in the DCT-IV/DST-IV composite (m = 600); K15 at h = 265
    # (odd), 264 (the DCT-I/DST-I extensions) and 300 (DCT-II)
    g264, g1200 = crandn(264, 264), crandn(1200, 256)
    x530, x300, x265, x263 = randn(530, 530), randn(300, 300), randn(265, 265), randn(263, 263)
    x600_2, x1000, x1200 = randn(600, 600), randn(1000, 1000), randn(1200, 600)
    s300 = torch.fft.rfft(x300.double()).to(torch.complex64)    # a Hermitian input
    h264, h1200 = nd.FftHandler(264), nd.FftHandler(1200)
    reset_counts()
    y264 = nd.ndfft(g264, h264, axis=1)
    b264 = nd.ndifft(y264, h264, axis=1)
    y1200 = nd.ndfft(g1200, h1200, axis=0)
    b1200 = nd.ndifft(y1200, h1200, axis=0)
    s530 = nd.ndfft_r2c(x530, nd.R2cFftHandler(530), axis=1)
    b300 = nd.ndifft_r2c(s300, nd.R2cFftHandler(300), axis=1)
    gen_out = {"dct1_265": (nd.nddct1(x265, axis=1), sfft.dct, x265, 1, 1),
               "dst1_263": (nd.nddst1(x263, axis=1), sfft.dst, x263, 1, 1),
               "dct2_600": (nd.nddct2(x600_2, axis=1), sfft.dct, x600_2, 2, 1),
               "dct3_600": (nd.nddct3(x600_2, axis=1), sfft.dct, x600_2, 3, 1),
               "dct4_1000": (nd.nddct4(x1000, axis=1), sfft.dct, x1000, 4, 1),
               "dct4_axis0_1200x600": (nd.nddct4(x1200, axis=0), sfft.dct, x1200, 4, 0),
               "dst4_axis0_1200x600": (nd.nddst4(x1200, axis=0), sfft.dst, x1200, 4, 0)}
    read_counts("generic_lanes", c2c_generic_rows=2 + 1 + 1 + 1, c2c_generic_mid=2 + 2,
                r2c_packed_generic=1 + 1 + 1 + 1)
    check_c2c("fft_last_axis", y264, g264, b264, dims=(1,), grid=[264, 264])
    check_c2c("fft_axis0", y1200, g1200, b1200, dims=(0,), grid=[1200, 256])
    check_lane("r2c_last_axis_odd_h", s530, torch.fft.rfft(x530.double(), dim=1),
               grid=[530, 530])
    check_lane("c2r_last_axis", b300, torch.fft.irfft(s300.to(torch.complex128), n=300, dim=1),
               b300, x300, grid=[300, 300])
    for what, (y, fn, x, t, axis) in gen_out.items():
        check(what, y, fn(host64(x), type=t, axis=axis), grid=list(x.shape))
    del g264, g1200, y264, b264, y1200, b1200, s530, b300, gen_out
    torch.cuda.empty_cache()

    # ---- 4g. the lengths the bts2 wide core took: the 768^3 real step
    # with the real axis last (the 3/2-dealiased grid of a 512^3-mode DNS;
    # K2 at h = 384, F = 3, on 589824 rows; K1 at F = 6 at (768, 768, 385)
    # and (1, 768, 295680) forward and back; K3: 1.81 GB per field, 1.82 GB
    # per spectrum), then the 4096^2 complex round trip (K10 on 4096 rows
    # and K1 at (1, 4096, 4096), F = 32)
    n7 = 768
    x768 = randn(n7, n7, n7)
    h768r, h768c = nd.R2cFftHandler(n7), nd.FftHandler(n7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    v = fwd3(x768, h768r, h768c)
    back = inv3(v, h768r, h768c)
    read_counts("real_axis_last_768^3", r2c_nat=1, c2c_axis_mid=4, c2r_nat=1)
    peak = torch.cuda.max_memory_allocated()
    check_lane("step_real_axis_last", v, torch.fft.rfftn(x768.double()), back, x768,
               grid=[n7] * 3, peak_bytes=peak, base_bytes=base)
    del v, back
    torch.cuda.empty_cache()

    def fft2_last_first(x, h):
        return nd.ndfft(nd.ndfft(x, h, axis=1), h, axis=0)

    def ifft2_first_last(y, h):
        return nd.ndifft(nd.ndifft(y, h, axis=0), h, axis=1)

    x4k = crandn(4096, 4096)
    h4k = nd.FftHandler(4096)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    y4k = fft2_last_first(x4k, h4k)
    b4k = ifft2_first_last(y4k, h4k)
    read_counts("c2c_4096x4096", c2c_rows=2, c2c_axis_mid=2)
    peak = torch.cuda.max_memory_allocated()
    check_c2c("fftn_ifftn", y4k, x4k, b4k, grid=[4096, 4096], peak_bytes=peak,
              base_bytes=base)
    del y4k, b4k

    # the other lengths the wide core opened: the 4096^2 real step (K2/K3 at
    # F = 16, K1 at the ragged (1, 4096, 2049)); C2C
    # of 128 rows at 384, 1152, 16256 (F = 127) and 20480 (F = 160); along
    # axis 0 at 640 (F = 5) and 20480 (one column per block); R2C/C2R of
    # 128 rows at 1536 (h = 768) and 40960 (h = 20480); DCT-I at 769 (K15
    # at h = 768), DCT-IV at 768 (K10 at F = 6 on 1536 rows) and the C2R's
    # Hermitian extension to 640 (K10 at F = 5)
    xr4k = randn(4096, 4096)
    hr4k = nd.R2cFftHandler(4096)
    rows_in = {n: crandn(128, n) for n in (384, 1152, 16256, 20480)}
    cols_in = {n: crandn(n, c) for n, c in ((640, 256), (20480, 128))}
    real_in = {n: randn(128, n) for n in (1536, 40960)}
    x769, x768_2 = randn(769, 769), randn(768, 768)
    s640 = torch.fft.rfft(randn(128, 640).double()).to(torch.complex64)   # Hermitian
    reset_counts()
    v4k = nd.ndfft(nd.ndfft_r2c(xr4k, hr4k, axis=1), h4k, axis=0)
    r4k = nd.ndifft_r2c(nd.ndifft(v4k, h4k, axis=0), hr4k, axis=1)
    rows_out = {n: (lambda y: (y, nd.ndifft(y, axis=1)))(nd.ndfft(x, axis=1))
                for n, x in rows_in.items()}
    cols_out = {n: (lambda y: (y, nd.ndifft(y, axis=0)))(nd.ndfft(x, axis=0))
                for n, x in cols_in.items()}
    real_out = {n: (lambda y: (y, nd.ndifft_r2c(y, axis=1)))(nd.ndfft_r2c(x, axis=1))
                for n, x in real_in.items()}
    d1 = nd.nddct1(x769, axis=1)
    d4 = nd.nddct4(x768_2, axis=1)
    b640 = nd.ndifft_r2c(s640, axis=1, n=640)
    read_counts("wide_lanes", r2c_nat=1 + 2, c2c_axis_mid=2 + 4, c2r_nat=1 + 2,
                c2c_rows=8 + 1 + 1, r2c_packed=1)
    check_r2c_mid("step_4096^2_real_axis_last", v4k, xr4k, r4k, (0, 1), grid=[4096, 4096])
    for n, (y, b) in rows_out.items():
        check_c2c("fft_last_axis", y, rows_in[n], b, dims=(1,), grid=[128, n])
    for n, (y, b) in cols_out.items():
        check_c2c("fft_axis0", y, cols_in[n], b, dims=(0,), grid=list(cols_in[n].shape))
    for n, (y, b) in real_out.items():
        check_lane("r2c_last_axis", y, torch.fft.rfft(real_in[n].double(), dim=1), b,
                   real_in[n], grid=[128, n])
    check("dct1_769", d1, sfft.dct(host64(x769), type=1, axis=1), grid=[769, 769])
    check("dct4_768", d4, sfft.dct(host64(x768_2), type=4, axis=1), grid=[768, 768])
    check_lane("c2r_extension_640", b640,
               torch.fft.irfft(s640.to(torch.complex128), n=640, dim=1), grid=[128, 640])
    del v4k, r4k, rows_out, cols_out, real_out, d1, d4, b640, rows_in, cols_in, real_in

    del x768_2
    torch.cuda.empty_cache()

    # ---- 4h. DCT-II/III on every axis at every length: the 3-D Neumann
    # Poisson solve at 1536^3 float32, the 3/2-dealiased grid of a
    # 1024^3-mode box (K23 at h = 768 on the radix row core, on 2359296
    # rows; K25 at
    # (1536, 1536, 1536) and (1, 1536, 2359296) on the wide core; K26 twice
    # and K24 back; 14.5 GB per field). The solve holds the right-hand side
    # and at most two more fields; the eigenvalue division, the checks and
    # the analytic fields go slab by slab along axis 0, never as whole
    # float64 fields (29 GB each).
    n8 = 1536
    modes8 = ((1, 2, 3, 1.0), (5, 3, 2, 0.5))
    x8 = (torch.arange(n8, device=dev, dtype=torch.float64) + 0.5) / n8
    cos8 = {m: torch.cos(m * math.pi * x8) for mode in modes8 for m in mode[:3]}
    k2_8 = (torch.arange(n8, device=dev, dtype=torch.float32) * math.pi) ** 2
    slab = 32           # slabs along axis 0 per pass (0.3 GB of float32)

    def slabs():
        return [(i0, min(i0 + slab, n8)) for i0 in range(0, n8, slab)]

    def eig(a, b, c):
        return math.pi ** 2 * (a * a + b * b + c * c)

    def modal_slab(i0, i1, weight):
        out = torch.zeros(i1 - i0, n8, n8, device=dev, dtype=torch.float64)
        for a, b, c, amp in modes8:
            out += (amp * weight(a, b, c) * cos8[a][i0:i1, None, None]
                    * cos8[b][None, :, None] * cos8[c][None, None, :])
        return out

    def divide_by_eigenvalues(fh):
        """fh / pi^2 (a^2 + b^2 + c^2) in place, slab by slab; the zero mode
        is pinned to 0."""
        for i0, i1 in slabs():
            lam = k2_8[i0:i1, None, None] + k2_8[None, :, None] + k2_8[None, None, :]
            if i0 == 0:
                lam[0, 0, 0] = math.inf
            fh[i0:i1].div_(lam)

    h8 = nd.DctHandler(n8)
    h8i = h8.normalization(nd.Normalization.scalar(1.0 / n8))

    def solve8(f, on_spectrum=None):
        """-lap u = f: DCT-II along axes 2, 1, 0, the division, DCT-III back
        along axes 0, 1, 2, each intermediate freed as soon as it is used."""
        a = nd.nddct2(f, h8, axis=2)
        b = nd.nddct2(a, h8, axis=1)
        del a
        fh = nd.nddct2(b, h8, axis=0)
        del b
        if on_spectrum is not None:
            on_spectrum(fh)
        divide_by_eigenvalues(fh)
        d = nd.nddct3(fh, h8i, axis=0)
        del fh
        e = nd.nddct3(d, h8i, axis=1)
        del d
        return nd.nddct3(e, h8i, axis=2)

    fwd8 = {}

    def check_spectrum8(fh):
        """The forward spectrum against its exact values: mode (a, b, c) of
        f at n^3 (scipy's DCT-II on every axis), zero elsewhere."""
        err = 0.0
        for i0, i1 in slabs():
            d = fh[i0:i1].double()
            for a, b, c, amp in modes8:
                if i0 <= a < i1:
                    d[a - i0, b, c] -= amp * eig(a, b, c) * n8 ** 3
            err = max(err, float(d.abs().max()))
        fwd8["rel_err"] = err / max(abs(amp) * eig(a, b, c) * n8 ** 3
                                    for a, b, c, amp in modes8)

    def solution_err8(u):
        err, peak, finite = 0.0, 0.0, True
        for i0, i1 in slabs():
            want = modal_slab(i0, i1, lambda a, b, c: 1.0)
            err = max(err, float((u[i0:i1].double() - want).abs().max()))
            peak = max(peak, float(want.abs().max()))
            finite = finite and bool(torch.isfinite(u[i0:i1]).all())
        return err / peak, finite

    f8 = torch.empty(n8, n8, n8, device=dev)
    for i0, i1 in slabs():
        f8[i0:i1] = modal_slab(i0, i1, eig)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()    # the right-hand side and earlier phases' tensors
    reset_counts()
    u8 = solve8(f8, check_spectrum8)
    read_counts("neumann_1536^3", dct2_nat=1, dct2_nat_radix=1, dct2_mid=2, dct2_mid_radix=2,
                dct3_mid=2, dct3_mid_radix=2, dct3_nat=1, dct3_nat_radix=1)
    peak = torch.cuda.max_memory_allocated()
    sol, finite = solution_err8(u8)
    emit(phase="dct_path", check="poisson_1536^3", fwd_rel_err=fwd8["rel_err"],
         solution_rel_err=sol, finite=finite, shape=list(u8.shape), peak_bytes=peak,
         base_bytes=base)
    if not (fwd8["rel_err"] <= TOL_STEP and sol <= TOL_STEP):
        raise AssertionError(f"1536^3 Poisson: forward {fwd8['rel_err']}, solution {sol}")
    del u8
    torch.cuda.empty_cache()

    # the shorter checks: the DCT-II/III pair along both axes of 2048^2
    # (K23/K24 on the radix row core, K25/K26 on the radix column tile),
    # nddct2/nddct3 along axis 0 at 1152 and 1280 (the lengths of K26's old
    # n-point and wide forms) and along the last axis at 128, 384 and 768,
    # nddst2 along axis 0 at 1536, and the R2C/C2R along axis 0 at 768 and
    # 1280 (K16/K17 at F = 3, 5)
    x2k = randn(2048, 2048)
    h2k = nd.DctHandler(2048)
    h2ki = h2k.normalization(nd.Normalization.scalar(1.0 / 2048))
    sq = {n: randn(n, n) for n in (128, 384, 768, 1152, 1280, 1536)}
    reset_counts()
    f2k = nd.nddct2(nd.nddct2(x2k, h2k, axis=1), h2k, axis=0)
    b2k = nd.nddct3(nd.nddct3(f2k, h2ki, axis=0), h2ki, axis=1)
    mid_out = {(n, t): getattr(nd, f"nddct{t}")(sq[n], axis=0)
               for n in (1152, 1280) for t in (2, 3)}
    last_out = {(n, t): getattr(nd, f"nddct{t}")(sq[n], axis=1)
                for n in (128, 384, 768) for t in (2, 3)}
    dst_out = nd.nddst2(sq[1536], axis=0)
    rfft_out = {}
    for n in (768, 1280):
        spec = nd.ndfft_r2c(sq[n], axis=0)
        rfft_out[n] = spec, nd.ndifft_r2c(spec, axis=0)
    read_counts("dct_mid_lanes", dct2_nat=1 + 3, dct2_nat_radix=1 + 3,
                dct3_nat=1 + 3, dct3_nat_radix=1 + 3,
                dct2_mid=1 + 2 + 1, dct2_mid_radix=1 + 2 + 1,
                dct3_mid=1 + 2, dct3_mid_radix=1 + 2,
                r2c_mid=2, c2r_mid=2)
    x64 = host64(x2k)
    check("dct2_both_axes", f2k, sfft.dctn(x64, type=2), grid=[2048, 2048])
    check("dct3_roundtrip", b2k, x64, grid=[2048, 2048])
    for (n, t), y in mid_out.items():
        check(f"dct{t}_axis0", y, sfft.dct(host64(sq[n]), type=t, axis=0), grid=[n, n])
    for (n, t), y in last_out.items():
        check(f"dct{t}_last_axis", y, sfft.dct(host64(sq[n]), type=t, axis=1), grid=[n, n])
    check("dst2_axis0", dst_out, sfft.dst(host64(sq[1536]), type=2, axis=0), grid=[1536, 1536])
    for n, (spec, back) in rfft_out.items():
        check_r2c_mid("rfft_axis0_wide", spec, sq[n], back, (0,), grid=[n, n])
    del x2k, f2k, b2k, mid_out, last_out, dst_out, rfft_out, spec, back

    # each kernel of the solve at its 1536^3 shape against its plain version
    # on the same input, slice by slice, and their times
    reps8 = max(2, min(reps_big, args.reps))
    x8r = randn(n8, n8, n8)
    legs8 = (("dct2_nat_radix", kdct.dct2_nat, (n8 * n8, n8), 0, 2.0),
             ("dct3_nat_radix", kdct.dct3_nat, (n8 * n8, n8), 0, 1.0 / n8),
             ("dct2_mid_radix", kdct.dct2_mid, (n8, n8, n8), 0, 2.0),
             ("dct2_mid_radix", kdct.dct2_mid, (1, n8, n8 * n8), 2, 2.0),
             ("dct3_mid_radix", kdct.dct3_mid, (n8, n8, n8), 0, 1.0 / n8),
             ("dct3_mid_radix", kdct.dct3_mid, (1, n8, n8 * n8), 2, 1.0 / n8))
    for name, kern, shape, dim, scale in legs8:
        check_sliced(name, kern, getattr(kdct, f"{kern.__name__}_plain"), [x8r.view(shape)],
                     dim, (scale,), reps8)
    del x8r
    torch.cuda.empty_cache()

    # the solve's time, and a float32 torch.fft Makhoul solve (the
    # yardstick, never on the port's path) in slabs of 32 along another axis,
    # so that its complex FFTs fit beside the fields
    def makhoul_into(x, axis, dct_type, scale=1.0):
        other = 1 if axis == 0 else 0
        out = torch.empty_like(x)
        for i0, i1 in slabs():
            idx = (slice(None),) * other + (slice(i0, i1),)
            out[idx] = makhoul_dct(x[idx], axis, dct_type).mul_(scale)
        return out

    def yardstick8(f):
        a = makhoul_into(f, 2, 2)
        b = makhoul_into(a, 1, 2)
        del a
        fh = makhoul_into(b, 0, 2)
        del b
        divide_by_eigenvalues(fh)
        d = makhoul_into(fh, 0, 3, 1.0 / (2 * n8))
        del fh
        e = makhoul_into(d, 1, 3, 1.0 / (2 * n8))
        del d
        return makhoul_into(e, 2, 3, 1.0 / (2 * n8))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: solve8(f8), reps8, 1)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_yard = cuda_ms(lambda: yardstick8(f8), reps8, 1)
    peak_yard = torch.cuda.max_memory_allocated()
    yard_sol, _ = solution_err8(yardstick8(f8))
    emit(phase="time", poisson=[n8] * 3, ms=t_port, torch_fft_makhoul_ms=t_yard,
         peak_bytes=peak, yardstick_peak_bytes=peak_yard,
         yardstick_solution_rel_err=yard_sol, card=card)
    del f8
    torch.cuda.empty_cache()

    # ---- 4i. DST-I, DCT-I and DCT-IV along a middle axis (K18, K19, K28)
    # through the multi-axis functions. The main path: the Dirichlet Poisson
    # solve on the 1023^3 interior of a 1024^3 grid (dstn / idstn of type 1:
    # K15 at h = 1024 on axis 2, K18 at h = 1024, F = 8, at (1023, 1024, 1023)
    # and (1, 1024, 1046529); 4.28 GB per field), its forward spectrum
    # against the exact sparse values and its solution against the analytic
    # one, slab by slab in float64. Then the vertex-centred Neumann solve on
    # 2049 x 2049 x 257 (dctn / idctn of type 1: K19 on the radix column
    # tile, h = 2048, on axes 0 and 1, K15 at h = 256 on axis 2), the mixed
    # Neumann-Dirichlet cell-centred solve on 2048 x 2048 x 256 (type 4: K28's
    # single pass, hl = 1024, on axes 0 and 1, the DCT-IV lane's K8 on 2 x
    # 4194304 rows of 256 on axis
    # 2), the lengths against float64 scipy.fft, each solve kernel at its
    # shape against its plain version slice by slice, and the times.
    def slab_ranges(n, step=32):
        return [(i0, min(i0 + step, n)) for i0 in range(0, n, step)]

    def poisson_solve(path, grid, modes, basis, lam, shift, spec_scale, fwd, inv, expected):
        """-lap_h u = f on a 3-D grid for u = sum amp * basis_0(a) basis_1(b)
        basis_2(c) (modes (a, b, c, amp); on a 2-D grid (a, b, amp)): f = sum
        amp * eig(a, b, c) * the same mode, built slab by slab; the solve
        fwd, division by the eigenvalues in place, inv, with the launches
        counted; the spectrum (exact: amp * eig * spec_scale at (a, b, c))
        and the solution checked slab by slab in float64. basis[i](m): mode
        m on axis i (float64); lam[i]: float64 eigenvalue of index k on axis
        i, mode m at index k = m - shift (the sines start at m = 1); a zero
        eigenvalue (the Neumann zero mode) pins that mode of u to 0. Returns
        f and the solve as a function of f."""
        l32 = [v.float() for v in lam]
        rank = len(grid)
        step = 32 if rank == 3 else max(32, (1 << 25) // grid[1])   # rows per slab

        def along(v, i):
            return v.reshape((1,) * i + (-1,) + (1,) * (rank - 1 - i))

        def eig(*m):
            return float(sum(lam[i][mi - shift] for i, mi in enumerate(m)))

        def modal(i0, i1, weight):
            out = torch.zeros(i1 - i0, *grid[1:], device=dev, dtype=torch.float64)
            for *m, amp in modes:
                term = amp * weight(*m) * along(basis[0](m[0])[i0:i1], 0)
                for i in range(1, rank):
                    term = term * along(basis[i](m[i]), i)
                out += term
            return out

        def divide(fh):
            for i0, i1 in slab_ranges(grid[0], step):
                lam_s = along(l32[0][i0:i1], 0)
                for i in range(1, rank):
                    lam_s = lam_s + along(l32[i], i)
                lam_s[lam_s == 0] = math.inf    # the zero mode of u is pinned to 0
                fh[i0:i1].div_(lam_s)
            return fh

        def solve(f, on_spectrum=None):
            fh = fwd(f)
            if on_spectrum is not None:
                on_spectrum(fh)
            return inv(divide(fh))

        spec = {}

        def check_spectrum(fh):
            err = 0.0
            for i0, i1 in slab_ranges(grid[0], step):
                d = fh[i0:i1].double()
                for *m, amp in modes:
                    if i0 <= m[0] - shift < i1:
                        d[(m[0] - shift - i0,) + tuple(mi - shift for mi in m[1:])] -= \
                            amp * eig(*m) * spec_scale
                err = max(err, float(d.abs().max()))
                del d
            spec["rel_err"] = err / max(abs(m[-1]) * eig(*m[:-1]) * spec_scale for m in modes)

        f = torch.empty(*grid, device=dev)
        for i0, i1 in slab_ranges(grid[0], step):
            f[i0:i1] = modal(i0, i1, eig)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        u = solve(f, check_spectrum)
        read_counts(path, **expected)
        peak = torch.cuda.max_memory_allocated()
        err, ref_peak, finite = 0.0, 0.0, True
        for i0, i1 in slab_ranges(grid[0], step):
            want = modal(i0, i1, lambda *m: 1.0)
            err = max(err, float((u[i0:i1].double() - want).abs().max()))
            ref_peak = max(ref_peak, float(want.abs().max()))
            finite = finite and bool(torch.isfinite(u[i0:i1]).all())
        sol = err / ref_peak
        emit(phase="packed_mid_path", check=path, fwd_rel_err=spec["rel_err"],
             solution_rel_err=sol, finite=finite, shape=list(u.shape), peak_bytes=peak,
             base_bytes=base)
        if not (spec["rel_err"] <= TOL_STEP and sol <= TOL_STEP and finite):
            raise AssertionError(f"{path}: forward {spec['rel_err']}, solution {sol}")
        return f, solve

    def grid_pts(n, offset, den):
        return (torch.arange(n, device=dev, dtype=torch.float64) + offset) / den

    def eigs(n, shift, den):
        """(2 - 2 cos(pi (k + shift) / den)) den^2 over k = 0 .. n - 1: the
        3-point Laplacian's eigenvalue on a grid of spacing 1 / den."""
        return (2 - 2 * torch.cos(math.pi * (torch.arange(n, device=dev, dtype=torch.float64)
                                             + shift) / den)) * den * den

    n9 = 1023
    pts9 = grid_pts(n9, 1, n9 + 1)
    f9, solve9 = poisson_solve(
        "dirichlet_1023^3", (n9,) * 3, ((1, 2, 3, 1.0), (5, 3, 2, 0.5), (100, 7, 300, 0.25)),
        [lambda m: torch.sin(m * math.pi * pts9)] * 3, [eigs(n9, 1, n9 + 1)] * 3, 1,
        float(n9 + 1) ** 3, lambda f: nd.dstn(f, 1), lambda fh: nd.idstn(fh, 1),
        dict(r2c_packed=2, r2c_packed_mid=4))

    # the yardstick, never on the port's path: scipy's DST-I through float32
    # torch.fft (-Im of the R2C of the odd extension) along each axis, in
    # slabs of 64 along another axis so that the extension fits
    def dst1_fft(x, axis, scale):
        other = 1 if axis == 0 else 0
        n = x.shape[axis]
        out = torch.empty_like(x)
        for i0, i1 in slab_ranges(x.shape[other], 64):
            idx = (slice(None),) * other + (slice(i0, i1),)
            xs = x[idx].movedim(axis, -1)
            z = torch.zeros_like(xs[..., :1])
            ext = torch.cat([z, xs, z, -xs.flip(-1)], dim=-1)
            out[idx] = (torch.fft.rfft(ext).imag[..., 1:n + 1] * -scale).movedim(-1, axis)
        return out

    lam9 = eigs(n9, 1, n9 + 1).float()

    def yardstick9(f):
        fh = dst1_fft(dst1_fft(dst1_fft(f, 0, 1.0), 1, 1.0), 2, 1.0)
        for i0, i1 in slab_ranges(n9):
            fh[i0:i1].div_(lam9[i0:i1, None, None] + lam9[None, :, None] + lam9[None, None, :])
        inv_scale = 1.0 / (2 * (n9 + 1))
        return dst1_fft(dst1_fft(dst1_fft(fh, 0, inv_scale), 1, inv_scale), 2, inv_scale)

    reps9 = max(2, min(reps_big, args.reps))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: solve9(f9), reps9, 1)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_yard = cuda_ms(lambda: yardstick9(f9), reps9, 1)
    peak_yard = torch.cuda.max_memory_allocated()
    y9 = yardstick9(f9)
    u9 = solve9(f9)
    yard_vs_port = abs_err(y9, u9) / float(u9.abs().max())
    del y9, u9
    emit(phase="time", dirichlet=[n9] * 3, ms=t_port, torch_fft_dst1_ms=t_yard,
         peak_bytes=peak, yardstick_peak_bytes=peak_yard, yardstick_vs_port=yard_vs_port,
         card=card)
    # where the solve's time goes: each forward leg alone (the inverse legs
    # do the same work) and the axis-0 leg's stream assembly; K15 alone on
    # the axis-2 leg's extension rows is timed with the solve kernels below
    h9 = nd.DstHandler(n9)
    a9 = nd.nddst1(f9, h9, axis=0)
    b9 = nd.nddst1(a9, h9, axis=1)
    legs = {"dst1_axis0": lambda: nd.nddst1(f9, h9, axis=0),
            "dst1_axis1": lambda: nd.nddst1(a9, h9, axis=1),
            "dst1_axis2": lambda: nd.nddst1(b9, h9, axis=2),
            "streams_axis0": lambda: tdst.dst1_streams(f9.reshape(1, n9, n9 * n9))}
    leg_ms = {k: cuda_ms(fn, reps9, 1) for k, fn in legs.items()}
    del a9, b9
    emit(phase="time", breakdown="dirichlet_1023^3", solve_ms=t_port, legs_ms=leg_ms,
         card=card)
    del f9
    torch.cuda.empty_cache()

    nn_grid = (2049, 2049, 257)
    nn_pts = [grid_pts(n, 0, n - 1) for n in nn_grid]
    f_nn, solve_nn = poisson_solve(
        "neumann_2049^2x257", nn_grid, ((1, 2, 3, 1.0), (5, 3, 2, 0.5), (300, 40, 100, 0.25)),
        [lambda m, p=p: torch.cos(m * math.pi * p) for p in nn_pts],
        [eigs(n, 0, n - 1) for n in nn_grid], 0, float(2048 * 2048 * 256),
        lambda f: nd.dctn(f, 1), lambda fh: nd.idctn(fh, 1), dict(dct1_mid=4, r2c_packed=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: solve_nn(f_nn), reps9, 1)
    emit(phase="time", neumann_vertex=list(nn_grid), ms=t_port,
         peak_bytes=torch.cuda.max_memory_allocated(), card=card)
    del f_nn
    torch.cuda.empty_cache()

    mx_grid = (2048, 2048, 256)
    mx_pts = [grid_pts(n, 0.5, n) for n in mx_grid]
    f_mx, solve_mx = poisson_solve(
        "mixed_2048^2x256", mx_grid, ((1, 2, 3, 1.0), (5, 3, 2, 0.5), (300, 40, 100, 0.25)),
        [lambda m, p=p: torch.cos((m + 0.5) * math.pi * p) for p in mx_pts],
        [eigs(n, 0.5, n) for n in mx_grid], 0, float(2048 * 2048 * 256),
        lambda f: nd.dctn(f, 4), lambda fh: nd.idctn(fh, 4),
        dict(dct4_mid=4, dct4_mid_radix=4, c2c_dense_rows=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: solve_mx(f_mx), reps9, 1)
    emit(phase="time", mixed_cell=list(mx_grid), ms=t_port,
         peak_bytes=torch.cuda.max_memory_allocated(), card=card)
    del f_mx
    torch.cuda.empty_cache()

    # the lengths along axis 0 against float64 scipy.fft: DST-I at 255
    # (F = 2), 383 (F = 3, wide), 1535, 20479 (F = 160) and 1023 with a
    # ragged L = 130; DCT-I at 1153 (F = 9), 1537, 20481 and the bench row
    # 2049^2; DCT-IV at 1280 (F = 5), 1536, 4096 (F = 16), 40960 (F = 160),
    # the bench row 2048^2, 41216 (F = 161, the four-step), 41728 (163,
    # the long form) and 33536 (131, the wide core); DST-IV at 2048
    len_in = {(kind, shape): randn(*shape) for kind, shapes in (
        ("dst1", ((255, 255), (383, 383), (1535, 1535), (20479, 128), (1023, 130))),
        ("dct1", ((1153, 1153), (1537, 1537), (20481, 128), (2049, 2049))),
        ("dct4", ((1280, 1280), (1536, 1536), (4096, 1024), (40960, 128), (2048, 2048),
                  (41216, 128), (41728, 128), (33536, 128))),
        ("dst4", ((2048, 2048),))) for shape in shapes}
    forms4 = [f"dct4_mid_{kdct.dct4_form(shape[0])}" for kind, shape in len_in
              if kind.endswith("4")]
    reset_counts()
    len_out = {key: getattr(nd, f"nd{key[0]}")(x, axis=0) for key, x in len_in.items()}
    read_counts("packed_mid_lengths", r2c_packed_mid=5, dct1_mid=4, dct4_mid=len(forms4),
                **{f: forms4.count(f) for f in set(forms4)})
    for (kind, shape), y in len_out.items():
        oracle = sfft.dct if kind.startswith("dct") else sfft.dst
        check(f"{kind}_axis0", y, oracle(host64(len_in[(kind, shape)]), type=int(kind[3]),
                                         axis=0), grid=list(shape))
    del len_in, len_out

    # each kernel of the solves at its shape against its plain version on
    # the same input, slice by slice, and their times: K18 at both of the
    # Dirichlet solve's shapes, K15 at its axis-2 leg's (1023^2 rows of the
    # 2048-point extension) and the Neumann solve's (2049^2 rows of 512),
    # K19 and K28 at theirs, and K8 at the mixed solve's DCT-IV lane (2 x
    # 2048^2 rows of 256, 2^31 complex values) in both directions. The
    # yardsticks: K18's the torch.fft.rfft of the interleaved column, K15's
    # torch.fft.rfft and K8's torch.fft.fft of the rows; the DCTs have none.
    def interleaved_rfft(xe, xo):
        col = torch.stack([xe, xo], dim=2).reshape(xe.shape[0], 2 * xe.shape[1], xe.shape[2])
        return lambda: torch.fft.rfft(col, dim=1)

    legs9 = (("r2c_packed_mid", krfft.r2c_packed_mid, krfft.r2c_packed_mid_plain,
              ((n9, n9 + 1, n9),) * 2, 0, (-1.0,), interleaved_rfft),
             ("r2c_packed_mid", krfft.r2c_packed_mid, krfft.r2c_packed_mid_plain,
              ((1, n9 + 1, n9 * n9),) * 2, 2, (-1.0,), interleaved_rfft),
             ("r2c_packed", krfft.r2c_packed, krfft.r2c_packed_plain,
              ((n9 * n9, 2 * (n9 + 1)),), 0, (), lambda x: lambda: torch.fft.rfft(x, dim=1)),
             ("r2c_packed", krfft.r2c_packed, krfft.r2c_packed_plain,
              ((2049 * 2049, 512),), 0, (), lambda x: lambda: torch.fft.rfft(x, dim=1)),
             ("dct1_mid", krfft.dct1_mid, krfft.dct1_mid_plain, (nn_grid,), 0, (1.0,), None),
             ("dct1_mid", krfft.dct1_mid, krfft.dct1_mid_plain, ((1, 2049, 2049 * 257),), 2,
              (1.0,), None),
             ("dct4_mid_radix", kdct.dct4_mid, kdct.dct4_mid_plain, (mx_grid,), 0, (2.0,),
              None),
             ("dct4_mid_radix", kdct.dct4_mid, kdct.dct4_mid_plain, ((1, 2048, 2048 * 256),), 2,
              (2.0,), None))
    for name, kern, plain, shapes, dim, fargs, library in legs9:
        ins = [randn(*shape) for shape in shapes]
        check_sliced(name, kern, plain, ins, dim, fargs, reps9,
                     tol=TOL_PACKED if name == "r2c_packed" else TOL_KERNEL,
                     library=library and library(*ins))
        del ins
        torch.cuda.empty_cache()
    x = crandn(2 * 2048 * 2048, 256)
    for sign, scale in ((-1, None), (+1, 1.0 / 256)):
        check_sliced("c2c_dense_rows", kfft.c2c_dense_rows, kfft.c2c_radix_rows_plain, [x], 0,
                     (sign, scale), reps9, library=lambda: torch.fft.fft(x, dim=1),
                     timed=sign < 0)
    del x
    torch.cuda.empty_cache()

    # ---- 4j. Bluestein lengths (a prime factor above 128): the fused chirp-z
    # along a middle axis (K11, K12) and the lane's chirp-z on K10. The main
    # paths: the 509^3 complex64 round trip (fftn / ifftn, 1.06 GB per
    # field: K11 at F = 8, M = 1024, on axes 0 and 1 at (1, 509, 259081)
    # and (509, 509, 509); axis 2 on the engine's chirp-z, its two sub-FFTs
    # on K10 fixed over 259081 rows of 1024), against torch.fft.fftn in
    # complex128 with the round trip; and the 2049^2 x 256 cell-centred
    # Neumann solve (dctn / idctn of type 2, 4.30 GB per field: K12's chirp-z
    # at M = 4608 on axes 0 and 1 at (1, 2049, 524544) and (2049, 2049, 256);
    # K23/K24 at n = 256 on axis 2), its spectrum against the exact
    # sparse values and its solution against the analytic one. Then the
    # lengths against float64 torch.fft / scipy.fft,
    # each kernel of the main paths against its plain version slice by
    # slice, and the times.
    n10 = 509
    x10 = crandn(n10, n10, n10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    y10 = nd.fftn(x10)
    back10 = nd.ifftn(y10)
    read_counts("c2c_509^3", c2c_blue_mid=4, c2c_rows=4)
    peak = torch.cuda.max_memory_allocated()
    check_c2c("fftn_ifftn", y10, x10, back10, grid=[n10] * 3, peak_bytes=peak, base_bytes=base)
    del y10, back10
    torch.cuda.empty_cache()
    reps10 = max(2, min(reps_big, args.reps))
    t_port = cuda_ms(lambda: nd.ifftn(nd.fftn(x10)), reps10, 1)
    t_torch = cuda_ms(lambda: torch.fft.ifftn(torch.fft.fftn(x10)), reps10, 1)
    h10 = nd.FftHandler(n10)
    legs = {f"fft_axis{a}": (lambda a=a: nd.ndfft(x10, h10, axis=a)) for a in range(3)}
    leg_ms = {k: cuda_ms(fn, reps10, 1) for k, fn in legs.items()}
    emit(phase="time", c2c_fftn_ifftn=[n10] * 3, ms=t_port, torch_fft_ms=t_torch,
         legs_ms=leg_ms, card=card)

    nb_grid = (2049, 2049, 256)
    nb_pts = [grid_pts(n, 0.5, n) for n in nb_grid]
    f_nb, solve_nb = poisson_solve(
        "neumann_2049^2x256", nb_grid, ((1, 2, 3, 1.0), (5, 3, 2, 0.5), (300, 40, 100, 0.25)),
        [lambda m, p=p: torch.cos(m * math.pi * p) for p in nb_pts],
        [eigs(n, 0, n) for n in nb_grid], 0, float(2049 * 2049 * 256),
        lambda f: nd.dctn(f, 2), lambda fh: nd.idctn(fh, 2),
        dict(dct23_blue_mid=4, dct2_nat=1, dct2_nat_radix=1, dct3_nat=1, dct3_nat_radix=1))

    # the yardstick, never on the port's path: the same solve through the
    # float32 torch.fft Makhoul lowering (makhoul_dct) along each axis, in
    # slabs of 32 along another axis so that its complex FFTs fit
    def makhoul_slabs(x, axis, dct_type, scale=1.0):
        other = 1 if axis == 0 else 0
        out = torch.empty_like(x)
        for i0, i1 in slab_ranges(x.shape[other]):
            idx = (slice(None),) * other + (slice(i0, i1),)
            out[idx] = makhoul_dct(x[idx], axis, dct_type).mul_(scale)
        return out

    lam_nb = [eigs(n, 0, n).float() for n in nb_grid]

    def yardstick10(f):
        fh = makhoul_slabs(makhoul_slabs(makhoul_slabs(f, 2, 2), 1, 2), 0, 2)
        for i0, i1 in slab_ranges(nb_grid[0]):
            lam3 = (lam_nb[0][i0:i1, None, None] + lam_nb[1][None, :, None]
                    + lam_nb[2][None, None, :])
            lam3[lam3 == 0] = math.inf
            fh[i0:i1].div_(lam3)
        for axis in (0, 1, 2):
            fh = makhoul_slabs(fh, axis, 3, 1.0 / (2 * nb_grid[axis]))
        return fh

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_port = cuda_ms(lambda: solve_nb(f_nb), reps10, 1)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_yard = cuda_ms(lambda: yardstick10(f_nb), reps10, 1)
    peak_yard = torch.cuda.max_memory_allocated()
    y_nb = yardstick10(f_nb)
    u_nb = solve_nb(f_nb)
    yard_vs_port = abs_err(y_nb, u_nb) / float(u_nb.abs().max())
    del y_nb, u_nb
    hb = nd.DctHandler(2049)
    # each public leg, and kernel 12's Makhoul permutations alone (the torch
    # passes around it in ops/dct.py: DCT-II's order before it, DCT-III's
    # interleave after it) on the (B, n, L) views of axes 0 and 1
    v0, v1 = f_nb.view(1, 2049, 2049 * 256), f_nb
    legs = {"dct2_axis0": lambda: nd.nddct2(f_nb, hb, axis=0),
            "dct2_axis1": lambda: nd.nddct2(f_nb, hb, axis=1),
            "dct2_axis2": lambda: nd.nddct2(f_nb, nd.DctHandler(256), axis=2),
            "perm_axis0": lambda: tdct.makhoul_order(v0),
            "perm_axis1": lambda: tdct.makhoul_order(v1),
            "interleave_axis0": lambda: tdct.makhoul_interleave(v0),
            "interleave_axis1": lambda: tdct.makhoul_interleave(v1)}
    leg_ms = {k: cuda_ms(fn, reps10, 1) for k, fn in legs.items()}
    emit(phase="time", neumann_cell=list(nb_grid), ms=t_port, torch_fft_makhoul_ms=t_yard,
         peak_bytes=peak, base_bytes=base, yardstick_peak_bytes=peak_yard,
         yardstick_vs_port=yard_vs_port, legs_ms=leg_ms, card=card)
    del f_nb, v0, v1
    torch.cuda.empty_cache()

    # the lengths against float64 oracles: ndfft along axis 0 at 131 (K11,
    # F = 3), 1021 (F = 16), 1031 (F = 17) and 6781 (F =
    # 106, the largest tile); along the last axis at 131 (K10 wide at M =
    # 384) and 2049 (M = 4608, F = 36); R2C/C2R at 2062 along axis 0 (the
    # lane after a moveaxis: h = 1031, M = 2304; the C2R's extension at M =
    # 4608) and at 263 along the last axis (row pairs, M = 768); DCT-II/III
    # and DST-II at 2049 along axis 0 (K12, M = 4608); DCT-IV at 2042 along axis
    # 0 (the composite's C2C on K11 at F = 16, m = 1021); DCT-I at 1032 and DST-I
    # at 1030 along the last axis (the packed lowering's C2C at h = 1031 on
    # the lane's chirp-z, M = 2304, F = 18); ndfft at 10007 (M = 20736, on
    # the four-step) is checked in phase 4k
    c_in = {(n, 0): crandn(n, 1024) for n in (131, 1021, 1031, 6781)}
    c_in.update({(n, 1): crandn(256, n) for n in (131, 2049)})
    r_in = {(2062, 0): randn(2062, 256), (263, 1): randn(256, 263)}
    # Hermitian half-spectra of other real inputs (torch.fft only builds them)
    s_in = {key: torch.fft.rfft(randn(*x.shape), dim=key[1]) for key, x in r_in.items()}
    d_in = {kind: randn(*shape) for kind, shape in (
        ("dct2", (2049, 256)), ("dct3", (2049, 256)), ("dst2", (2049, 256)),
        ("dct4", (2042, 256)), ("dct1", (256, 1032)), ("dst1", (256, 1030)))}
    reset_counts()
    c_out = {key: nd.ndfft(x, axis=key[1]) for key, x in c_in.items()}
    r_out = {key: nd.ndfft_r2c(x, axis=key[1]) for key, x in r_in.items()}
    s_out = {key: nd.ndifft_r2c(s, nd.R2cFftHandler(key[0]), axis=key[1])
             for key, s in s_in.items()}
    d_out = {kind: getattr(nd, f"nd{kind}")(x, axis=0 if x.shape[0] > 1024 else 1)
             for kind, x in d_in.items()}
    read_counts("blue_lengths", c2c_blue_mid=5, c2c_rows=16,
                dct23_blue_mid=3)
    for (n, axis), y in c_out.items():
        x = c_in[(n, axis)]
        check_c2c("fft_length", y, x, nd.ndifft(y, axis=axis), dims=(axis,), n=n, axis=axis)
    for (n, axis), y in r_out.items():
        x = r_in[(n, axis)]
        check_r2c_mid("r2c_length", y, x, nd.ndifft_r2c(y, nd.R2cFftHandler(n), axis=axis),
                      (axis,), n=n, axis=axis)
        want = torch.fft.irfft(s_in[(n, axis)].to(torch.complex128), n=n, dim=axis)
        check("c2r_length", s_out[(n, axis)], host64(want), n=n, axis=axis)
    for kind, y in d_out.items():
        axis = 0 if d_in[kind].shape[0] > 1024 else 1
        oracle = sfft.dct if kind.startswith("dct") else sfft.dst
        check(f"{kind}_length", y, oracle(host64(d_in[kind]), type=int(kind[3]), axis=axis),
              grid=list(d_in[kind].shape), axis=axis)
    del c_in, c_out, r_in, r_out, s_in, s_out, d_in, d_out

    # each kernel of the main paths at its shape against its plain version,
    # slice by slice, and their times: K11 at both of the round trip's
    # shapes (its yardstick torch.fft.fft along the axis), K10 at the lane's
    # (259081, 1024) rows in both directions, K12 at both of the solve's
    # shapes (no single PyTorch call computes it)
    legs10 = (("c2c_blue_mid", kfft.c2c_blue_mid, kfft.c2c_blue_mid_plain,
               (1, n10, n10 * n10), 2, True, lambda x: lambda: torch.fft.fft(x, dim=1)),
              ("c2c_blue_mid", kfft.c2c_blue_mid, kfft.c2c_blue_mid_plain,
               (n10, n10, n10), 0, True, lambda x: lambda: torch.fft.fft(x, dim=1)),
              ("dct23_blue_mid", kdct.dct23_blue_mid, kdct.dct23_blue_mid_plain,
               (1, 2049, 2049 * 256), 2, False, None),
              ("dct23_blue_mid", kdct.dct23_blue_mid, kdct.dct23_blue_mid_plain,
               nb_grid, 0, False, None))
    for name, kern, plain, shape, dim, cplx, library in legs10:
        x = crandn(*shape) if cplx else randn(*shape)
        check_sliced(name, kern, plain, [x], dim, (-1, None) if cplx else (2, 2.0), reps10,
                     library=library and library(x))
        if not cplx:
            check_sliced(name, kern, plain, [x], dim, (3, None), reps10, timed=False)
        del x
        torch.cuda.empty_cache()
    x = crandn(n10 * n10, 1024)
    for sign, scale in ((-1, None), (+1, 1.0 / 1024)):
        check_sliced("c2c_rows", kfft.c2c_rows, kfft.c2c_rows_plain, [x], 0, (sign, scale),
                     reps10, library=lambda: torch.fft.fft(x, dim=1), timed=sign < 0)
    del x, x10
    torch.cuda.empty_cache()

    # ---- 4k. the four-step long C2C (engine._fourstep: K7, the column FFT
    # of length n1 with the exit twiddle W_n^{k1 t2}, then K13, the row FFT
    # of length n2 with the scale, stored transposed). Path A: the 256 x 2^20
    # complex64 round trip along the last axis (ndfft, then ndifft with the
    # Default norm; 2.15 GB per field; split (1024, 1024): K7 on the radix
    # column tile at (256, 1024, 1024), K13 on the radix row core over
    # 262144 rows), the forward
    # against complex128 torch.fft.fft on a slice of rows and the round trip
    # against x; a batch of long 1-D fields, such as an ensemble of
    # split-step runs. Path B: the 32768^2 float32 real spectral step (4.3 GB
    # per field; R2C along the last axis on K2 wide, h = 16384, F = 128; the
    # C2C along axis 0 after a moveaxis on the four-step (256, 128): K7 on
    # the radix column tile at (16385, 256, 128), K13 over 4194560 rows of
    # 128; the
    # inverse chain, C2R on K3), against float64 torch.fft.rfftn and the
    # round trip; a periodic 2-D Navier-Stokes step at 32768^2. Then the
    # lengths against float64 oracles, each kernel at the paths' shapes
    # against its plain version slice by slice, and the times.
    n_a, b_a = 1 << 20, 256
    xa = crandn(b_a, n_a)
    ha = nd.FftHandler(n_a)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    ya = nd.ndfft(xa, ha, axis=1)
    backa = nd.ndifft(ya, ha, axis=1)
    read_counts("c2c_256x2^20", fourstep_mid=2, fourstep_mid_radix=2, rows_store_t=2)
    peak = torch.cuda.max_memory_allocated()
    rows = slice(0, b_a, b_a // 8)
    fwd = rel_err(ya[rows], torch.fft.fft(xa[rows].to(torch.complex128), dim=1))
    rt = abs_err(backa, xa) / float(xa.abs().max())
    emit(phase="fourstep_path", check="c2c_256x2^20", fwd_rel_err=fwd, fwd_rows=8,
         roundtrip_rel_err=rt, finite=bool(torch.isfinite(torch.view_as_real(backa)).all()),
         shape=list(ya.shape), peak_bytes=peak, base_bytes=base)
    if not (fwd <= TOL_STEP and rt <= TOL_STEP):
        raise AssertionError(f"256 x 2^20 round trip: fwd {fwd}, round trip {rt}")
    del ya, backa
    torch.cuda.empty_cache()
    reps_a = max(5, min(reps_big, args.reps))
    t_port = cuda_ms(lambda: nd.ndifft(nd.ndfft(xa, ha, axis=1), ha, axis=1), reps_a, 1)
    t_torch = cuda_ms(lambda: torch.fft.ifft(torch.fft.fft(xa, dim=1), dim=1), reps_a, 1)
    leg_ms = {"fft": cuda_ms(lambda: nd.ndfft(xa, ha, axis=1), reps_a, 1),
              "torch_fft": cuda_ms(lambda: torch.fft.fft(xa, dim=1), reps_a, 1)}
    emit(phase="time", c2c_rows_round_trip=[b_a, n_a], ms=t_port, torch_fft_ms=t_torch,
         legs_ms=leg_ms, peak_bytes=peak, base_bytes=base, reps=reps_a, card=card)
    del xa
    torch.cuda.empty_cache()

    n_b = 32768
    xb = randn(n_b, n_b)
    hbr, hbc = nd.R2cFftHandler(n_b), nd.FftHandler(n_b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    vb, backb = step2(xb, hbr, hbc)
    read_counts("step_32768^2", r2c_nat=1, fourstep_mid=2, fourstep_mid_radix=2,
                rows_store_t=2, c2r_nat=1)
    peak = torch.cuda.max_memory_allocated()
    rt = abs_err(backb, xb) / float(xb.abs().max())
    finite = bool(torch.isfinite(backb).all())
    del backb
    torch.cuda.empty_cache()
    fwd = rel_err(vb, torch.fft.rfftn(xb.double()))
    emit(phase="fourstep_path", check="step_32768^2", fwd_rel_err=fwd, roundtrip_rel_err=rt,
         finite=finite, shape=list(vb.shape), peak_bytes=peak, base_bytes=base)
    if not (fwd <= TOL_STEP and rt <= TOL_STEP):
        raise AssertionError(f"32768^2 step: fwd {fwd}, round trip {rt}")
    torch.cuda.empty_cache()
    reps_b = max(2, min(reps_big, args.reps))
    t_port = cuda_ms(lambda: step2(xb, hbr, hbc), reps_b, 1)
    t_torch = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(xb), s=xb.shape), reps_b, 1)
    sb = nd.ndfft_r2c(xb, hbr, axis=1)
    legs = {"r2c_axis1": lambda: nd.ndfft_r2c(xb, hbr, axis=1),
            "fft_axis0": lambda: nd.ndfft(sb, hbc, axis=0),
            "ifft_axis0": lambda: nd.ndifft(vb, hbc, axis=0),
            "c2r_axis1": lambda: nd.ndifft_r2c(sb, hbr, axis=1)}
    leg_ms = {k: cuda_ms(fn, reps_b, 1) for k, fn in legs.items()}
    emit(phase="time", step=[n_b, n_b], ms=t_port, torch_fft_ms=t_torch, legs_ms=leg_ms,
         peak_bytes=peak, base_bytes=base, reps=reps_b, card=card)
    del xb, vb, sb
    torch.cuda.empty_cache()

    # the lengths against float64 oracles (K7 on the radix column tile at
    # every n1: a prime n1 = 131 ... 251 comes only with a length whose plan
    # is Bluestein's): ndfft at 10007 on 128 rows (the lane's chirp-z, its
    # sub-FFTs at M = 20736 = (144, 144): K7, then K8's rows of 144 and the
    # swap); 40960 = (256, 160) along the last axis and along axis 0 of
    # (40960, 128) (K7, K8's rows of 160); 131072 = (512, 256), 147456 =
    # (384, 384), 163840 = (640, 256), 786432 = (1024, 768) (K7 and K13)
    # and 36992 = (2176, 17: K7, K8's rows of 17) over a few rows; one row
    # of 2^22 = (2048, 2048); ndfft_r2c / ndifft_r2c at 65536 on
    # 128 rows (the packed lane's C2C of 32768 and the Hermitian
    # extension's of 65536: K7, K13); nddct4 at (256, 32768) and nddct2 /
    # nddct3 at (128, 65536) (their C2Cs of 32768 and 65536: K7, K13)
    c_in = {(10007, 1): crandn(128, 10007), (40960, 1): crandn(4, 40960),
            (40960, 0): crandn(40960, 128), (131072, 1): crandn(8, 131072),
            (147456, 1): crandn(64, 147456), (163840, 1): crandn(8, 163840),
            (786432, 1): crandn(4, 786432), (36992, 1): crandn(8, 36992),
            (1 << 22, 1): crandn(1, 1 << 22)}
    r_in = randn(128, 65536)
    s_in = torch.fft.rfft(randn(128, 65536), dim=1)
    d_in = {kind: randn(*shape) for kind, shape in (
        ("dct4", (256, 32768)), ("dct2", (128, 65536)), ("dct3", (128, 65536)))}
    reset_counts()
    c_out = {key: nd.ndfft(x, axis=key[1]) for key, x in c_in.items()}
    r_out = nd.ndfft_r2c(r_in, axis=1)
    s_out = nd.ndifft_r2c(s_in, nd.R2cFftHandler(65536), axis=1)
    d_out = {kind: getattr(nd, f"nd{kind}")(x, axis=1) for kind, x in d_in.items()}
    read_counts("fourstep_lengths", fourstep_mid=15, fourstep_mid_radix=15, rows_store_t=10,
                c2c_dense_rows=5)
    for (n, axis), y in c_out.items():
        x = c_in[(n, axis)]
        check_c2c("fft_length", y, x, nd.ndifft(y, axis=axis), dims=(axis,), n=n, axis=axis)
    check_r2c_mid("r2c_length", r_out, r_in, nd.ndifft_r2c(r_out, nd.R2cFftHandler(65536), axis=1),
                  (1,), n=65536, axis=1)
    want = torch.fft.irfft(s_in.to(torch.complex128), n=65536, dim=1)
    check("c2r_length", s_out, host64(want), n=65536, axis=1)
    for kind, y in d_out.items():
        check(f"{kind}_length", y, sfft.dct(host64(d_in[kind]), type=int(kind[3]), axis=1),
              grid=list(d_in[kind].shape), axis=1)
    del c_in, c_out, r_in, r_out, s_in, s_out, d_in, d_out, want

    # each kernel of the main paths at its shape against its plain version,
    # slice by slice, and their times: K7 and K13 at path A's
    # (256, 1024, 1024) and at path B's (16385, 256, 128); no single
    # PyTorch call computes either function (library_ms null)
    legs11 = (("fourstep_mid_radix", kfft.fourstep_mid, kfft.fourstep_mid_plain,
               (b_a, 1024, 1024), (-1,)),
              ("rows_store_t", kfft.rows_store_t, kfft.rows_store_t_plain, (b_a, 1024, 1024),
               (+1, 1.0 / n_a)),
              ("fourstep_mid_radix", kfft.fourstep_mid, kfft.fourstep_mid_plain,
               (n_b // 2 + 1, 256, 128), (-1,)),
              ("rows_store_t", kfft.rows_store_t, kfft.rows_store_t_plain,
               (n_b // 2 + 1, 256, 128), (+1, 1.0 / n_b)))
    for name, kern, plain, shape, fargs in legs11:
        x = crandn(*shape)
        check_sliced(name, kern, plain, [x], 0, fargs, reps_a)
        del x
        torch.cuda.empty_cache()
    # K2 and K3 at path B's real legs (h = 16384, F = 128, one row per tile),
    # both on the radix row core, timed beside torch.fft.rfft and irfft
    xb = randn(n_b, n_b)
    check_sliced("r2c_nat", krfft.r2c_nat, krfft.r2c_nat_plain, [xb], 0, (), reps_a,
                 library=lambda: torch.fft.rfft(xb, dim=1))
    del xb
    torch.cuda.empty_cache()
    sb = crandn(n_b, n_b // 2 + 1)
    check_sliced("c2r_nat", krfft.c2r_nat, krfft.c2r_nat_plain, [sb], 0,
                 (n_b, 1.0 / n_b), reps_a, library=lambda: torch.fft.irfft(sb, n=n_b, dim=1))
    del sb
    torch.cuda.empty_cache()

    # ---- 4l. the fused spectral pipelines (kernels 14, 22 and 29) through
    # ndspectral_c2c / ndspectral_r2c / ndspectral_dct / ndspectral_dst: three
    # paths at 1024^3 float32 (4.3 GB per field), each against its analytic
    # field slab by slab in float64 (an exact finite sum of the transform's
    # basis vectors, so the solve or filter reproduces it to roundoff). The
    # fields are built slab by slab; no whole float64 field (8.6 GB) is made.
    n_s = 1024
    reps_s = max(2, min(reps_big, args.reps))
    spectral_h = {}   # (kernel, shape) -> (hc, complex) of the multiplier timed there
    two_pi = 2 * math.pi
    grid_p = torch.arange(n_s, device=dev, dtype=torch.float64) / n_s          # periodic i / n
    grid_c = (torch.arange(n_s, device=dev, dtype=torch.float64) + 0.5) / n_s  # cell centres

    def slab(terms, i0, rows):
        """Rows i0 .. i0 + rows of sum amp vx(x) vy(y) vz(z) over the terms
        (amp, vx, vy, vz), float64."""
        out = None
        for amp, vx, vy, vz in terms:
            t = amp * vx[i0:i0 + rows, None, None] * vy[None, :, None] * vz[None, None, :]
            out = t if out is None else out.add_(t)
        return out

    def build(terms):
        f = torch.empty(n_s, n_s, n_s, device=dev)
        for i0 in range(0, n_s, 64):
            f[i0:i0 + 64] = slab(terms, i0, 64)
        return f

    def check_field(what, got, terms, **kw):
        err, peak = 0.0, 0.0
        for i0 in range(0, n_s, 64):
            want = slab(terms, i0, 64)
            err = max(err, float((got[i0:i0 + 64].double() - want).abs().max()))
            peak = max(peak, float(want.abs().max()))
            del want
        rel = err / peak
        emit(phase="spectral_path", check=what, rel_err=rel,
             finite=bool(torch.isfinite(got).all()), shape=list(got.shape), **kw)
        if not rel <= TOL_STEP:
            raise AssertionError(f"{what}: {rel}")

    def run_path(name, fn, expected):
        """fn() once between reset_counts() and read_counts(name, **expected),
        with its peak device memory and the base of live tensors."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        out = fn()
        read_counts(name, **expected)
        return out, torch.cuda.max_memory_allocated(), base

    hsr, hsc = nd.R2cFftHandler(n_s), nd.FftHandler(n_s)

    # S1: the pressure Poisson solve of a periodic DNS projection step
    # (examples/fused_filter.py case 5 in 3-D): -lap u = f on [0, 1)^3 with
    # u = sum amp cos(2 pi a x) sin(2 pi b y) cos(2 pi c z); K2 (h = 512) on
    # axis 2, K1 at (1024, 1024, 513) on axis 1, ndspectral_c2c on axis 0
    # with the lane-varying real G = 1/|k|^2 of shape (1024, 1024, 513)
    # (K14 on the radix column tile at (1, 1024, 525312); G is 2.15 GB), K1
    # and K3 back
    p_modes = ((1, 2, 3, 1.0), (4, 1, 2, 0.5), (7, 5, 1, 0.25))

    def p_terms(lap):
        return [(amp * (two_pi ** 2 * (a * a + b * b + c * c) if lap else 1.0),
                 torch.cos(two_pi * a * grid_p), torch.sin(two_pi * b * grid_p),
                 torch.cos(two_pi * c * grid_p)) for a, b, c, amp in p_modes]

    f1 = build(p_terms(True))
    kc = torch.fft.fftfreq(n_s, 1.0 / n_s, device=dev) ** 2       # integer squares, exact
    kr = torch.arange(n_s // 2 + 1, device=dev, dtype=torch.float32) ** 2
    g1 = kc[:, None, None] + kc[None, :, None] + kr[None, None, :]
    g1.mul_(two_pi ** 2).reciprocal_()
    g1[0, 0, 0] = 0.0                # the mean is pinned to 0

    def s1_solve(f, fused=True):
        a = nd.ndfft_r2c(f, hsr, axis=2)
        b = nd.ndfft(a, hsc, axis=1)
        del a
        if fused:
            c = nd.ndspectral_c2c(b, g1, hsc, axis=0)
        else:   # the port's unfused composition: K1, a torch multiply, K1
            c = nd.ndifft(g1 * nd.ndfft(b, hsc, axis=0), hsc, axis=0)
        del b
        d = nd.ndifft(c, hsc, axis=1)
        del c
        return nd.ndifft_r2c(d, hsr, axis=2)

    u1, peak, base = run_path("S1_periodic_poisson_1024^3", lambda: s1_solve(f1),
                              dict(r2c_nat=1, c2c_axis_mid=2, spectral_c2c_mid=1, c2r_nat=1))
    check_field("S1_periodic_poisson_1024^3", u1, p_terms(False), peak_bytes=peak,
                base_bytes=base)
    del u1
    t_port = cuda_ms(lambda: s1_solve(f1), reps_s, 1)
    t_unfused = cuda_ms(lambda: s1_solve(f1, False), reps_s, 1)
    t_torch = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(f1).mul_(g1), s=f1.shape),
                      reps_s, 1)
    # where the time goes: each public call on its own input (the inverse
    # legs' inputs are the forward spectra: the same shapes and routes)
    a1 = nd.ndfft_r2c(f1, hsr, axis=2)
    b1 = nd.ndfft(a1, hsc, axis=1)
    leg_ms = {"r2c_axis2_k2": cuda_ms(lambda: nd.ndfft_r2c(f1, hsr, axis=2), reps_s, 1),
              "fft_axis1_k1": cuda_ms(lambda: nd.ndfft(a1, hsc, axis=1), reps_s, 1),
              "fused_axis0_k14": cuda_ms(lambda: nd.ndspectral_c2c(b1, g1, hsc, axis=0),
                                         reps_s, 1),
              "unfused_axis0_k1_mul_k1": cuda_ms(
                  lambda: nd.ndifft(g1 * nd.ndfft(b1, hsc, axis=0), hsc, axis=0), reps_s, 1),
              "ifft_axis1_k1": cuda_ms(lambda: nd.ndifft(b1, hsc, axis=1), reps_s, 1),
              "c2r_axis2_k3": cuda_ms(lambda: nd.ndifft_r2c(a1, hsr, axis=2), reps_s, 1)}
    del a1
    emit(phase="time", path="S1_periodic_poisson_1024^3", ms=t_port, torch_fft_ms=t_torch,
         unfused_ms=t_unfused, legs_ms=leg_ms, peak_bytes=peak, base_bytes=base, reps=reps_s,
         card=card)
    del f1
    torch.cuda.empty_cache()
    b1 = b1.reshape(1, n_s, -1)
    g1 = g1.reshape(n_s, -1)
    spectral_h[("spectral_c2c_mid", tuple(b1.shape))] = (g1.shape[1], False)
    check_sliced("spectral_c2c_mid", kfft.spectral_c2c_mid, kfft.spectral_c2c_mid_plain,
                 [b1, g1], (2, 1), (1.0 / n_s,), reps_s)
    del b1, g1
    torch.cuda.empty_cache()

    # S2: a separable Gaussian LES test filter, gain exp(-k^2 D^2 / 24) of the
    # angular wavenumber k = 2 pi m at the test-filter width D = 2 / 1024
    # (0.78 at m = 200, 0.19 at the Nyquist m = 512): ndspectral_r2c on axes
    # 0 and 1 (K22 on the radix column tile, h = 512, at (1, 1024, 1048576)
    # and (1024, 1024, 1024)), on the last axis the composition (K2, the
    # multiply, K3),
    # as in the JAX package; then the spectral derivative d/dy of the
    # filtered field (the complex multiplier i k along axis 1, K22)
    delta = 2.0 / n_s
    s_modes = ((200, 3, 7, 1.0), (5, 150, 40, 0.5), (2, 9, 300, 0.25))

    def gain(m):
        return math.exp(-(two_pi * m * delta) ** 2 / 24)

    def s_terms(deriv):
        return [(amp * gain(a) * gain(b) * gain(c) * (-two_pi * b if deriv else 1.0),
                 torch.cos(two_pi * a * grid_p + 0.3),
                 (torch.sin if deriv else torch.cos)(two_pi * b * grid_p),
                 torch.cos(two_pi * c * grid_p + 0.1)) for a, b, c, amp in s_modes]

    x2 = build([(amp, torch.cos(two_pi * a * grid_p + 0.3), torch.cos(two_pi * b * grid_p),
                 torch.cos(two_pi * c * grid_p + 0.1)) for a, b, c, amp in s_modes])
    m_r = torch.arange(n_s // 2 + 1, device=dev, dtype=torch.float64)
    g_s = torch.exp(-(two_pi * m_r * delta) ** 2 / 24).float()          # (513,)
    d_y = torch.complex(torch.zeros_like(g_s), (two_pi * m_r).float())  # i k

    def s2_filter(x, fused=True):
        if fused:
            y = nd.ndspectral_r2c(x, g_s, hsr, axis=0)
            y = nd.ndspectral_r2c(y, g_s, hsr, axis=1)
        else:   # the port's unfused composition on axes 0 and 1: K16, multiply, K17
            y = nd.ndifft_r2c(g_s[:, None, None] * nd.ndfft_r2c(x, hsr, axis=0), hsr, axis=0)
            y = nd.ndifft_r2c(g_s[None, :, None] * nd.ndfft_r2c(y, hsr, axis=1), hsr, axis=1)
        return nd.ndspectral_r2c(y, g_s, hsr, axis=2)

    def s2_path():
        y = s2_filter(x2)
        return y, nd.ndspectral_r2c(y, d_y, hsr, axis=1)

    (y2, dy2), peak, base = run_path("S2_les_filter_1024^3", s2_path,
                                     dict(spectral_r2c_mid=3, r2c_nat=1, c2r_nat=1))
    check_field("S2_les_filter_1024^3", y2, s_terms(False), peak_bytes=peak, base_bytes=base)
    check_field("S2_derivative_y_1024^3", dy2, s_terms(True))
    del dy2
    gf = torch.exp(-(two_pi * torch.fft.fftfreq(n_s, 1.0 / n_s, device=dev).double() * delta)
                   ** 2 / 24).float()

    def torch_filter(x):
        s = torch.fft.rfftn(x)
        s.mul_(gf[:, None, None]).mul_(gf[None, :, None]).mul_(g_s[None, None, :])
        return torch.fft.irfftn(s, s=x.shape)

    t_port = cuda_ms(lambda: s2_filter(x2), reps_s, 1)
    t_unfused = cuda_ms(lambda: s2_filter(x2, False), reps_s, 1)
    t_torch = cuda_ms(lambda: torch_filter(x2), reps_s, 1)
    leg_ms = {"fused_axis0_k22": cuda_ms(lambda: nd.ndspectral_r2c(x2, g_s, hsr, axis=0),
                                         reps_s, 1),
              "unfused_axis0_k16_mul_k17": cuda_ms(
                  lambda: nd.ndifft_r2c(g_s[:, None, None] * nd.ndfft_r2c(x2, hsr, axis=0),
                                        hsr, axis=0), reps_s, 1),
              "fused_axis1_k22": cuda_ms(lambda: nd.ndspectral_r2c(x2, g_s, hsr, axis=1),
                                         reps_s, 1),
              "composed_axis2_k2_mul_k3": cuda_ms(
                  lambda: nd.ndspectral_r2c(x2, g_s, hsr, axis=2), reps_s, 1),
              "derivative_axis1_k22": cuda_ms(lambda: nd.ndspectral_r2c(y2, d_y, hsr, axis=1),
                                              reps_s, 1)}
    emit(phase="time", path="S2_les_filter_1024^3", ms=t_port, torch_fft_ms=t_torch,
         unfused_ms=t_unfused, legs_ms=leg_ms, peak_bytes=peak, base_bytes=base, reps=reps_s,
         card=card)
    del y2
    torch.cuda.empty_cache()
    for shape in ((1, n_s, n_s * n_s), (n_s, n_s, n_s)):
        check_sliced("spectral_r2c_mid", krfft.spectral_r2c_mid, krfft.spectral_r2c_mid_plain,
                     [x2.reshape(shape)], 2 if shape[0] == 1 else 0,
                     (g_s[:, None], None, n_s, 1.0 / n_s), reps_s)
    del x2
    torch.cuda.empty_cache()

    # S3: the Neumann Poisson solve on the cell-centred grid x_i = (i + 1/2)/n
    # of [0, 1]^3: u = sum amp cos(a pi x) cos(b pi y) cos(c pi z) with the
    # cosine-basis eigenvalues pi^2 (a^2 + b^2 + c^2); nddct2 on axis 2 (K23,
    # h = 512) and axis 1 (K27), ndspectral_dct on axis 0 with the
    # lane-varying H = 1/lambda of shape 1024^3 (K29 fixed, F = 4, at (1,
    # 1024, 1048576); H is 4.3 GB), nddct3 back on axes 1 (K27) and 2 (K24)
    c_modes = ((1, 2, 3, 1.0), (5, 3, 2, 0.5), (40, 7, 11, 0.25))

    def c_terms(lap):
        return [(amp * (math.pi ** 2 * (a * a + b * b + c * c) if lap else 1.0),
                 torch.cos(a * math.pi * grid_c), torch.cos(b * math.pi * grid_c),
                 torch.cos(c * math.pi * grid_c)) for a, b, c, amp in c_modes]

    f3s = build(c_terms(True))
    kq = torch.arange(n_s, device=dev, dtype=torch.float32) ** 2
    h3 = kq[:, None, None] + kq[None, :, None] + kq[None, None, :]
    h3.mul_(math.pi ** 2).reciprocal_()
    h3[0, 0, 0] = 0.0
    hdn = nd.DctHandler(n_s)
    hdni = hdn.normalization(nd.Normalization.scalar(1.0 / n_s))

    def s3_solve(f, fused=True):
        a = nd.nddct2(f, hdn, axis=2)
        b = nd.nddct2(a, hdn, axis=1)
        del a
        if fused:
            c = nd.ndspectral_dct(b, h3, hdn, hdni, axis=0)
        else:   # the public composition: K27, a torch multiply, K27
            c = nd.nddct3(h3 * nd.nddct2(b, hdn, axis=0), hdni, axis=0)
        del b
        d = nd.nddct3(c, hdni, axis=1)
        del c
        return nd.nddct3(d, hdni, axis=2)

    def torch_neumann(f):
        u = makhoul_dct(makhoul_dct(makhoul_dct(f, 2, 2), 1, 2), 0, 2)
        u.mul_(h3)
        for ax in (0, 1, 2):
            u = makhoul_dct(u, ax, 3) / (2 * n_s)
        return u

    u3s, peak, base = run_path("S3_neumann_poisson_1024^3", lambda: s3_solve(f3s),
                               dict(dct2_nat=1, dct2_nat_radix=1, dct_dense_mid=2,
                                    dct_dense_mid_radix=2, spectral_dct_mid=1,
                                    spectral_dct_mid_radix=1, dct3_nat=1, dct3_nat_radix=1))
    check_field("S3_neumann_poisson_1024^3", u3s, c_terms(False), peak_bytes=peak,
                base_bytes=base)
    del u3s
    t_port = cuda_ms(lambda: s3_solve(f3s), reps_s, 1)
    t_unfused = cuda_ms(lambda: s3_solve(f3s, False), reps_s, 1)
    t_torch = cuda_ms(lambda: torch_neumann(f3s), reps_s, 1)
    a3 = nd.nddct2(f3s, hdn, axis=2)
    b3 = nd.nddct2(a3, hdn, axis=1)
    b3k, h3k = b3.reshape(1, n_s, -1), h3.reshape(n_s, -1)
    leg_ms = {"dct2_axis2_k23": cuda_ms(lambda: nd.nddct2(f3s, hdn, axis=2), reps_s, 1),
              "dct2_axis1_k27": cuda_ms(lambda: nd.nddct2(a3, hdn, axis=1), reps_s, 1),
              "dct3_axis1_k27": cuda_ms(lambda: nd.nddct3(b3, hdni, axis=1), reps_s, 1),
              "dct3_axis2_k24": cuda_ms(lambda: nd.nddct3(a3, hdni, axis=2), reps_s, 1),
              "fused_axis0_k29": cuda_ms(lambda: nd.ndspectral_dct(b3, h3, hdn, hdni, axis=0),
                                         reps_s, 1),
              "unfused_axis0_k25_mul_k26": cuda_ms(
                  lambda: kdct.dct3_mid(h3k * kdct.dct2_mid(b3k, 2.0), 1.0 / n_s), reps_s, 1),
              "public_axis0_k27_mul_k27": cuda_ms(
                  lambda: nd.nddct3(h3 * nd.nddct2(b3, hdn, axis=0), hdni, axis=0), reps_s, 1)}
    emit(phase="time", path="S3_neumann_poisson_1024^3", ms=t_port,
         torch_fft_makhoul_ms=t_torch, unfused_ms=t_unfused, legs_ms=leg_ms, peak_bytes=peak,
         base_bytes=base, reps=reps_s, card=card)
    del f3s, a3, b3, h3
    torch.cuda.empty_cache()
    spectral_h[("spectral_dct_mid_radix", tuple(b3k.shape))] = (h3k.shape[1], False)
    check_sliced("spectral_dct_mid_radix", kdct.spectral_dct_mid, kdct.spectral_dct_mid_plain,
                 [b3k, h3k], (2, 1), (2.0, 1.0 / n_s), reps_s)
    del b3k, h3k
    torch.cuda.empty_cache()

    # the Dirichlet twin through ndspectral_dst: -u'' = f along axis 0 of a
    # 2048 x 4096 cell-centred field, u = sum amp sin(m pi x) cos(2 pi q y),
    # H[k] = 1 / ((k + 1) pi)^2 (DST-II index k is frequency k + 1): K29 on
    # the radix column tile (h = 1024) between the flip/sign conjugations
    n_d, c_d = 2048, 4096
    xd = (torch.arange(n_d, device=dev, dtype=torch.float64) + 0.5) / n_d
    yd = torch.arange(c_d, device=dev, dtype=torch.float64) / c_d
    d_modes = ((1, 1, 1.0), (7, 3, 0.5), (40, 5, 0.25))   # a stiffer mode's float32
    # roundoff in f, over the lowest eigenvalue pi^2, would pass 1e-5 of u

    def d_field(lap):
        return sum(amp * (m * math.pi) ** (2 if lap else 0) * torch.sin(m * math.pi * xd)[:, None]
                   * torch.cos(two_pi * q * yd)[None, :] for m, q, amp in d_modes)

    fd = d_field(True).float()
    hk = 1.0 / ((torch.arange(n_d, device=dev, dtype=torch.float64) + 1) * math.pi) ** 2
    hsd = nd.DstHandler(n_d)
    hsdi = hsd.normalization(nd.Normalization.scalar(1.0 / n_d))
    ud, _, _ = run_path("dirichlet_dst_2048x4096",
                        lambda: nd.ndspectral_dst(fd, hk.float(), hsd, hsdi, axis=0),
                        dict(spectral_dct_mid=1, spectral_dct_mid_radix=1))
    want = d_field(False)
    rel = float((ud.double() - want).abs().max() / want.abs().max())
    emit(phase="spectral_path", check="dirichlet_dst_2048x4096", rel_err=rel,
         finite=bool(torch.isfinite(ud).all()), shape=list(ud.shape))
    if not rel <= TOL_STEP:
        raise AssertionError(f"2048 x 4096 Dirichlet solve: {rel}")
    del ud, want
    # K29 at the Dirichlet leg's own shape (the radix column tile, h = 1024)
    # against its plain version: the conjugated input alt * f, the flipped
    # multiplier and the DST handlers' scalars, as ndspectral_dst hands them on
    xdk = (tdst.alt_tensor(n_d, torch.float32, dev)[:, None] * fd).reshape(1, n_d, c_d)
    check_sliced("spectral_dct_mid_radix", kdct.spectral_dct_mid, kdct.spectral_dct_mid_plain,
                 [xdk], 2, (hk.float().flip(0)[:, None], 2.0, 1.0 / n_d), reps_s, timed=False)
    del fd, xdk

    # the lengths K14, K22 and K29 open, against float64 oracles, all on the
    # radix column tile: K14 at 384, 640, 1280 (along axis 1 of (2, n,
    # 130)), 16256 (F = 127) and 20480 (F = 160); K22 at 512, 4096, 768
    # (axis 1) and 40960 (h = 20480); K29 at the lengths
    # of its old wide and n-point forms: 256, 384 (axis 1), 1152, 20352,
    # 32768 and 20608 (h = 128 ... 16384); L = 130 (ragged), a broadcast and a lane-varying
    # multiplier, real and complex, under Default, NONE and scalar norms.
    norms = {"default": nd.Normalization.DEFAULT, "none": nd.Normalization.NONE,
             "scalar": nd.Normalization.scalar(0.37)}
    c_cases = ((384, 0, "lane", "default"), (640, 0, "bcast", "none"),
               (1280, 1, "lane", "scalar"), (16256, 0, "bcast", "default"),
               (20480, 0, "lane", "default"))
    r_cases = ((512, 0, "bcast", "default"), (768, 1, "lane", "none"),
               (4096, 0, "lane", "scalar"), (40960, 0, "bcast", "default"))
    d_cases = ((256, 0, "bcast", "default"), (384, 1, "lane", "none"),
               (1152, 0, "lane", "scalar"), (20352, 0, "bcast", "default"),
               (32768, 0, "lane", "none"), (20608, 0, "lane", "default"))

    def case_input(n, axis, lane, rows, cplx_x, cplx_h):
        shape = (n, 130) if axis == 0 else (2, n, 130)
        x = crandn(*shape) if cplx_x else randn(*shape)
        hshape = (rows, 130) if lane == "lane" else (rows,)
        h = crandn(*hshape) if cplx_h else randn(*hshape)
        return x, h, h if lane == "lane" else h.reshape((rows,) + (1,) * (x.dim() - axis - 1))

    outs = []
    reset_counts()
    for kind, cases in (("c2c", c_cases), ("r2c", r_cases), ("dct", d_cases)):
        for n, axis, lane, norm in cases:
            rows = n // 2 + 1 if kind == "r2c" else n
            x, h, hb = case_input(n, axis, lane, rows, kind == "c2c", kind != "dct")
            cls = {"c2c": nd.FftHandler, "r2c": nd.R2cFftHandler, "dct": nd.DctHandler}[kind]
            hd_ = cls(n).normalization(norms[norm])
            y = getattr(nd, f"ndspectral_{kind}")(x, h, hd_, axis=axis)
            outs.append((kind, n, axis, lane, norm, x, hb, y))
    read_counts("spectral_lengths", spectral_c2c_mid=5, spectral_r2c_mid=4, spectral_dct_mid=6,
                spectral_dct_mid_radix=6)
    for kind, n, axis, lane, norm, x, hb, y in outs:
        x64, h64 = x.to(torch.complex128 if kind == "c2c" else torch.float64), hb.to(
            torch.complex128 if kind != "dct" else torch.float64)
        if kind == "c2c":
            s = {"default": 1.0 / n, "none": 1.0, "scalar": 0.37}[norm]
            want = torch.fft.ifft(h64 * torch.fft.fft(x64, dim=axis), dim=axis) * (n * s)
        elif kind == "r2c":
            s = {"default": 1.0 / n, "none": 1.0, "scalar": 0.37}[norm]
            want = torch.fft.irfft(h64 * torch.fft.rfft(x64, dim=axis), n=n, dim=axis) * (n * s)
        else:   # each norm's scalar over scipy's 2: Default 1, NONE 1/2, scalar 0.37/2
            s = {"default": 1.0, "none": 0.5, "scalar": 0.185}[norm]
            want = makhoul_dct(h64 * makhoul_dct(x64, axis, 2), axis, 3) * (s * s)
        rel = rel_err(y, want)
        emit(phase="spectral_path", check=f"{kind}_length", n=n, axis=axis, multiplier=lane,
             norm=norm, rel_err=rel, finite=bool(torch.isfinite(torch.view_as_real(y)
                                                               if y.is_complex() else y).all()))
        if not rel <= TOL_STEP:
            raise AssertionError(f"ndspectral_{kind} n={n} axis={axis} {lane} {norm}: {rel}")
    del outs, x, h, hb, y, x64, h64, want
    torch.cuda.empty_cache()

    # ---- 4m. the long DCT lengths: kernels 23 to 26 and 29 at n = 128 k with
    # odd k > 160 (on the radix cores where n/2 has a plan, in the n-point
    # form on the wide core's real tile at the prime k), and kernel 28 at
    # n = 256 F with F > 160 (the column four-step; the long form, two passes
    # of the real tile, at a prime F). G1: the
    # cell-centred Neumann Poisson solve on a 31104^2 grid (31104 = 128 *
    # 243, F = 243; 3.87 GB per field), the pressure solve of a wall-bounded
    # 2-D box, through dctn / idctn of type 2 (K23 on the radix row core over
    # 31104 rows, h = 15552, K25 and K26 on the radix column tile at (1,
    # 31104, 31104), one column a tile, then K24 on the radix row core), and
    # again with ndspectral_dct along axis 0 and the lane-varying H =
    # 1/lambda between the axis-1 DCTs (K23, K29 on the radix column tile,
    # K24); G2: the
    # mixed Neumann-Dirichlet solve on a 65536 x 8192 cell-centred channel
    # (2.15 GB per field; DCT-IV along axis 0 on K28's four-step at (1,
    # 65536, 8192), F = 256, split (128, 256); DCT-II/III along axis 1 on K23
    # and K24 on the radix
    # row core, h = 4096). Each against its exact spectrum (G1, G2) and its
    # analytic solution, slab by slab in float64, timed with its peak memory;
    # G1 against a float32 torch.fft Makhoul solve. Then the lengths against
    # float64 scipy.fft, and each long kernel at the paths' shapes against
    # its plain version, slice by slice, with its time.
    n_g1 = 31104
    reps_g = 1      # each leg takes seconds: one timed run after one warm-up
    g1_pts = grid_pts(n_g1, 0.5, n_g1)
    g1_eig = eigs(n_g1, 0, n_g1)
    g1_modes = ((1, 2, 1.0), (5, 3, 0.5), (300, 40, 0.25))
    g1_basis = [lambda m: torch.cos(m * math.pi * g1_pts)] * 2
    f_g1, solve_g1 = poisson_solve(
        "neumann_31104^2", (n_g1, n_g1), g1_modes, g1_basis, [g1_eig, g1_eig], 0,
        float(n_g1 * n_g1), lambda f: nd.dctn(f, 2), lambda fh: nd.idctn(fh, 2),
        dict(dct2_nat=1, dct2_nat_radix=1, dct2_mid=1, dct2_mid_radix=1, dct3_mid=1,
             dct3_mid_radix=1, dct3_nat=1, dct3_nat_radix=1))
    h_g1 = g1_eig.float()[:, None] + g1_eig.float()[None, :]
    h_g1.reciprocal_()
    h_g1[0, 0] = 0.0     # the zero mode of u is pinned to 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_g1 = cuda_ms(lambda: solve_g1(f_g1), reps_g, 1)
    peak = torch.cuda.max_memory_allocated()

    def g1_yardstick(f):
        u = makhoul_dct(makhoul_dct(f, 1, 2), 0, 2)
        u.mul_(h_g1)
        return makhoul_dct(makhoul_dct(u, 0, 3), 1, 3) / (4.0 * n_g1 * n_g1)

    t_yard = cuda_ms(lambda: g1_yardstick(f_g1), reps_g, 1)
    emit(phase="time", path="G1_neumann_31104^2", ms=t_g1, torch_fft_makhoul_ms=t_yard,
         peak_bytes=peak, base_bytes=base, reps=reps_g, card=card)
    hg1 = nd.DctHandler(n_g1)
    hg1i = hg1.normalization(nd.Normalization.scalar(1.0 / n_g1))

    def g1_spectral(f):
        a = nd.nddct2(f, hg1, axis=1)
        b = nd.ndspectral_dct(a, h_g1, hg1, hg1i, axis=0)
        del a
        return nd.nddct3(b, hg1i, axis=1)

    u_g1, peak, base = run_path("G1_spectral_neumann_31104^2", lambda: g1_spectral(f_g1),
                                dict(dct2_nat=1, dct2_nat_radix=1, spectral_dct_mid=1,
                                     spectral_dct_mid_radix=1, dct3_nat=1, dct3_nat_radix=1))
    err, ref_peak = 0.0, 0.0
    for i0 in range(0, n_g1, 1024):
        want = sum(amp * torch.cos(a * math.pi * g1_pts[i0:i0 + 1024])[:, None]
                   * torch.cos(b * math.pi * g1_pts)[None, :] for a, b, amp in g1_modes)
        err = max(err, float((u_g1[i0:i0 + 1024].double() - want).abs().max()))
        ref_peak = max(ref_peak, float(want.abs().max()))
        del want
    rel = err / ref_peak
    emit(phase="long_dct_path", check="G1_spectral_neumann_31104^2", solution_rel_err=rel,
         finite=bool(torch.isfinite(u_g1).all()), shape=list(u_g1.shape), peak_bytes=peak,
         base_bytes=base)
    if not rel <= TOL_STEP:
        raise AssertionError(f"G1 spectral solve: {rel}")
    del u_g1
    t_g1s = cuda_ms(lambda: g1_spectral(f_g1), reps_g, 1)
    emit(phase="time", path="G1_spectral_neumann_31104^2", ms=t_g1s, reps=reps_g, card=card)
    # the solve's kernels at their shapes against their plain versions
    x_g1 = f_g1.view(1, n_g1, n_g1)
    for name, kern, plain, x, dim, fargs in (
            ("dct2_nat_radix", kdct.dct2_nat, kdct.dct2_nat_plain, f_g1, 0, (2.0,)),
            ("dct2_mid_radix", kdct.dct2_mid, kdct.dct2_mid_plain, x_g1, 2, (2.0,)),
            ("dct3_mid_radix", kdct.dct3_mid, kdct.dct3_mid_plain, x_g1, 2, (1.0 / n_g1,)),
            ("dct3_nat_radix", kdct.dct3_nat, kdct.dct3_nat_plain, f_g1, 0, (1.0 / n_g1,))):
        check_sliced(name, kern, plain, [x], dim, fargs, reps_g)
    spectral_h[("spectral_dct_mid_radix", tuple(x_g1.shape))] = (n_g1, False)
    check_sliced("spectral_dct_mid_radix", kdct.spectral_dct_mid, kdct.spectral_dct_mid_plain,
                 [x_g1, h_g1], (2, 1), (2.0, 1.0 / n_g1), reps_g)
    del f_g1, x_g1, h_g1, solve_g1
    torch.cuda.empty_cache()

    g2_grid = (65536, 8192)
    g2_pts = [grid_pts(n, 0.5, n) for n in g2_grid]
    f_g2, solve_g2 = poisson_solve(
        "mixed_65536x8192", g2_grid, ((0, 2, 1.0), (5, 3, 0.5), (300, 40, 0.25)),
        [lambda m: torch.cos((m + 0.5) * math.pi * g2_pts[0]),
         lambda m: torch.cos(m * math.pi * g2_pts[1])],
        [eigs(g2_grid[0], 0.5, g2_grid[0]), eigs(g2_grid[1], 0, g2_grid[1])], 0,
        float(g2_grid[0] * g2_grid[1]),
        lambda f: nd.dctn(nd.dctn(f, 4, axes=(0,)), 2, axes=(1,)),
        lambda fh: nd.idctn(nd.idctn(fh, 2, axes=(1,)), 4, axes=(0,)),
        dict(dct4_mid=2, dct4_mid_fourstep=2, dct2_nat=1, dct2_nat_radix=1, dct3_nat=1,
             dct3_nat_radix=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_g2 = cuda_ms(lambda: solve_g2(f_g2), reps_g, 1)
    emit(phase="time", path="G2_mixed_65536x8192", ms=t_g2,
         peak_bytes=torch.cuda.max_memory_allocated(), base_bytes=base, reps=reps_g, card=card)
    check_sliced("dct4_mid_fourstep", kdct.dct4_mid, kdct.dct4_mid_plain,
                 [f_g2.view(1, *g2_grid)], 2, (2.0,), reps_g)
    del f_g2, solve_g2
    torch.cuda.empty_cache()

    # the lengths against float64 scipy.fft: DCT-II/III and DST-II/III at
    # 20608 (k = 161), 20864 (163, prime), 24192 (189) and 32640 (255) along
    # axis 0 of (n, 130), axis 1 of (2, n, 130) and the last axis of
    # (128, n); DCT-IV/DST-IV at 41216 (F = 161), 41728 (163, prime), 49152
    # (192) and 65536 (256) along axis 0 of (n, 130) and axis 1 of
    # (2, n, 130); ndspectral_dct / ndspectral_dst at 20608, 20864 and 32640
    # along axis 0 with a broadcast and a lane-varying H; Default norms
    len_cases = [(kind, shape, axis) for n in (20608, 20864, 24192, 32640)
                 for kind in ("dct2", "dct3", "dst2", "dst3")
                 for shape, axis in (((n, 130), 0), ((2, n, 130), 1), ((128, n), 1))]
    len_cases += [(kind, shape, axis) for n in (41216, 41728, 49152, 65536)
                  for kind in ("dct4", "dst4") for shape, axis in (((n, 130), 0),
                                                                   ((2, n, 130), 1))]
    len_in = [randn(*shape) for _, shape, _ in len_cases]
    spec_cases = [(kind, n, lane) for n in (20608, 20864, 32640) for kind in ("dct", "dst")
                  for lane in (False, True)]
    spec_in = [(randn(n, 130), randn(n, 130) if lane else randn(n)) for _, n, lane in spec_cases]
    reset_counts()
    len_out = [getattr(nd, f"nd{kind}")(x, axis=axis) for (kind, _, axis), x in
               zip(len_cases, len_in)]
    spec_out = [getattr(nd, f"ndspectral_{kind}")(x, h, axis=0) for (kind, _, _), (x, h) in
                zip(spec_cases, spec_in)]
    read_counts("long_dct_lengths", dct2_mid=16, dct2_mid_radix=12, dct2_mid_npoint=4,
                dct3_mid=16, dct3_mid_radix=12, dct3_mid_npoint=4, dct2_nat=8, dct2_nat_radix=6,
                dct2_nat_npoint=2, dct3_nat=8, dct3_nat_radix=6, dct3_nat_npoint=2, dct4_mid=16,
                dct4_mid_fourstep=12, dct4_mid_long=4, spectral_dct_mid=12,
                spectral_dct_mid_radix=8,
                spectral_dct_mid_npoint=4)
    for (kind, shape, axis), x, y in zip(len_cases, len_in, len_out):
        oracle = sfft.dct if kind.startswith("dct") else sfft.dst
        check(f"{kind}_long", y, oracle(host64(x), type=int(kind[3]), axis=axis), grid=list(shape),
              axis=axis)
    for (kind, n, lane), (x, h), y in zip(spec_cases, spec_in, spec_out):
        oracle = sfft.dct if kind == "dct" else sfft.dst
        h64 = host64(h) if lane else host64(h)[:, None]
        want = oracle(h64 * oracle(host64(x), type=2, axis=0), type=3, axis=0)
        check(f"spectral_{kind}_long", y, want, n=n, multiplier="lane" if lane else "bcast")
    del len_in, len_out, spec_in, spec_out, x, y, h
    torch.cuda.empty_cache()

    # ---- 4n. the radix core's census: every length whose last-axis C2C over
    # 128 rows takes kernel 10 (C2C_ROWS) or kernel 8 above 256
    # (C2C_GENERIC_ROWS), as the gates name them over 257 ... 20480, through
    # ndfft and ndifft on a (128, n) field,
    # each against torch.fft in complex128 (an oracle only, run on the host,
    # where a new length costs no cuFFT planning; compared on the card)
    routes = {n: gates.lane_c2c_route(n, 128) for n in range(257, kfft.GENERIC_MAX_N + 1)}
    census = [n for n, route in routes.items()
              if route in (gates.C2C_ROWS, gates.C2C_GENERIC_ROWS)]
    rows_n = sum(routes[n] == gates.C2C_ROWS for n in census)
    t0 = time.perf_counter()
    worst = (0.0, None)
    reset_counts()
    for n in census:
        x = crandn(128, n)
        y = nd.ndfft(x, axis=1)
        back = nd.ndifft(y, axis=1)
        x64, y64 = (t.cpu().to(torch.complex128) for t in (x, y))
        oracles = (torch.fft.fft(x64, dim=1).to(dev), torch.fft.ifft(y64, dim=1).to(dev))
        for got, want in zip((y, back), oracles):
            err = rel_err(got, want)
            if not err <= TOL_KERNEL:
                raise AssertionError(f"census n={n}: {err}")
            worst = max(worst, (err, n))
    read_counts("radix_census", c2c_rows=2 * rows_n,
                c2c_generic_rows=2 * (len(census) - rows_n))
    emit(phase="radix_census", lengths=len(census), c2c_rows_lengths=rows_n,
         c2c_generic_rows_lengths=len(census) - rows_n, worst_rel_err=worst[0], worst_n=worst[1],
         seconds=time.perf_counter() - t0)
    del x, y, back, x64, y64, oracles
    torch.cuda.empty_cache()

    # ---- 4o. the Bluestein census: for each convolution factor F that kernel
    # 11 takes on the radix column tile (the route C2C_BLUE_MID at F outside
    # {4, 8, 16}: 101 values), ndfft and ndifft along axis 1 of a (1, n, 130)
    # field at the smallest and the largest n of that F, each against
    # torch.fft in complex128 (an oracle only, run on the host)
    ends = {}
    for n in range(kfft.M + 1, kfft.GENERIC_MAX_N + 1):
        if api._route("fft", (1, n, 130), 1, torch.complex64, "cuda") == api.C2C_BLUE_MID:
            f = kfft.blue_f(n)
            if f not in kfft.C2C_F:
                ends[f] = (ends.get(f, (n, n))[0], n)
    blue_n = sorted({n for lo_hi in ends.values() for n in lo_hi})
    t0 = time.perf_counter()
    worst = (0.0, None)
    reset_counts()
    for n in blue_n:
        x = crandn(1, n, 130)
        y = nd.ndfft(x, axis=1)
        back = nd.ndifft(y, axis=1)
        x64, y64 = (t.cpu().to(torch.complex128) for t in (x, y))
        oracles = (torch.fft.fft(x64, dim=1).to(dev), torch.fft.ifft(y64, dim=1).to(dev))
        for got, want in zip((y, back), oracles):
            err = rel_err(got, want)
            if not err <= TOL_KERNEL:
                raise AssertionError(f"blue census n={n}: {err}")
            worst = max(worst, (err, n))
    read_counts("blue_census", c2c_blue_mid=2 * len(blue_n))
    emit(phase="blue_census", factors=len(ends), lengths=len(blue_n), worst_rel_err=worst[0],
         worst_n=worst[1], seconds=time.perf_counter() - t0)
    if len(ends) != 101:
        raise AssertionError(f"blue census: {len(ends)} factors, expected 101")
    del x, y, back, x64, y64, oracles

    # ---- 4p. kernel 15's census: ndfft_r2c over 128 rows of 2h at every half
    # length h that kernel 15 takes in its generic form (the radix row core
    # with the unpack epilogue: 1582 lengths), against torch.fft.rfft in
    # float64 (an oracle only, run on the host)
    hs = [h for h in range(257, kfft.GENERIC_MAX_N + 1)
          if gates.r2c_lane_route(2 * h, 128) == gates.R2C_PACKED
          and gates.packed_kernel(h, 128) and not krfft.packed_core(h)]
    t0 = time.perf_counter()
    worst = (0.0, None)
    reset_counts()
    for h in hs:
        x = randn(128, 2 * h)
        y = nd.ndfft_r2c(x, axis=1)
        err = rel_err(y, torch.fft.rfft(x.cpu().double(), dim=1).to(dev))
        if not err <= TOL_KERNEL:
            raise AssertionError(f"r2c census h={h}: {err}")
        worst = max(worst, (err, h))
    read_counts("r2c_generic_census", r2c_packed_generic=len(hs))
    emit(phase="r2c_generic_census", lengths=len(hs), worst_rel_err=worst[0], worst_h=worst[1],
         seconds=time.perf_counter() - t0)
    if len(hs) != 1582:
        raise AssertionError(f"r2c census: {len(hs)} lengths, expected 1582")
    del x, y
    torch.cuda.empty_cache()

    # ---- 4q. the census of kernels 8 and 6 on the radix core: ndfft and
    # ndifft over (128, n) at every n <= 256 that the gates send to kernel
    # 8's rows (C2C_DENSE_ROWS: 232 lengths), and along axis 1 of a
    # (1, n, 130) field at every n that they send to kernel 6
    # (C2C_GENERIC_MID: 1402 lengths), each against torch.fft in complex128
    # (an oracle only, run on the host); ---- 4r. the same along axis 1 of
    # (1, n, 130) for kernels 4 and 11 on the radix column tile, at every n
    # that the gates send to kernel 4 (C2C_DENSE_MID: 412 lengths, 2 ...
    # 511) and every Bluestein n that kernel 11 takes at F in {4, 8, 16}
    # (C2C_BLUE_MID at M = 512, 1024, 2048: 57 lengths, 193 ... 1021),
    # within TOL_CENSUS of the oracle's peak
    def mid_route(n):
        return api._route("fft", (1, n, 130), 1, torch.complex64, "cuda")

    k8_n = [n for n in range(2, 257) if gates.lane_c2c_route(n, 128) == gates.C2C_DENSE_ROWS]
    k6_n = [n for n in range(257, kfft.GENERIC_MAX_N + 1) if mid_route(n) == api.C2C_GENERIC_MID]
    k4_n = [n for n in range(2, 2049) if mid_route(n) == api.C2C_DENSE_MID]
    k11_n = [n for n in range(kfft.M + 1, 2049)
             if mid_route(n) == api.C2C_BLUE_MID and kfft.blue_f(n) in kfft.C2C_F]
    for what, name, lengths, shape_of, want, tol in (
            ("dense_rows", "c2c_dense_rows", k8_n, lambda n: (128, n), 232, TOL_KERNEL),
            ("generic_mid", "c2c_generic_mid", k6_n, lambda n: (1, n, 130), 1402, TOL_KERNEL),
            ("dense_mid", "c2c_dense_mid", k4_n, lambda n: (1, n, 130), 412, TOL_CENSUS),
            ("blue_fixed", "c2c_blue_mid", k11_n, lambda n: (1, n, 130), 57, TOL_CENSUS)):
        if len(lengths) != want:
            raise AssertionError(f"{what} census: {len(lengths)} lengths, expected {want}")
        t0 = time.perf_counter()
        worst = (0.0, None)
        reset_counts()
        for n in lengths:
            x = crandn(*shape_of(n))
            y = nd.ndfft(x, axis=1)
            back = nd.ndifft(y, axis=1)
            x64, y64 = (t.cpu().to(torch.complex128) for t in (x, y))
            oracles = (torch.fft.fft(x64, dim=1).to(dev), torch.fft.ifft(y64, dim=1).to(dev))
            for got, ref in zip((y, back), oracles):
                err = rel_err(got, ref)
                if not err <= tol:
                    raise AssertionError(f"{what} census n={n}: {err}")
                worst = max(worst, (err, n))
        read_counts(f"{what}_census", **{name: 2 * len(lengths)})
        emit(phase=f"{what}_census", lengths=len(lengths), worst_rel_err=worst[0], worst_n=worst[1],
             seconds=time.perf_counter() - t0)
        del x, y, back, x64, y64, oracles
    torch.cuda.empty_cache()

    # ---- 4s. the census of kernels 20 and 16: ndfft_r2c along axis 1 of a
    # (1, n, 130) field at every n that the gates send to kernel 20
    # (R2C_DENSE_MID: 1094 lengths, 4 ... 1100, each on the kernel that
    # rfft.py::r2c_dense_form names: the radix column tile, the chirp-z or
    # the dense product) and every n that they send to kernel 16 (R2C_MID:
    # 153 lengths, 512 ... 40960), against torch.fft.rfft in float64 (an
    # oracle only, run on the host): the radix column tile and the chirp-z
    # within TOL_CENSUS of the oracle's peak, the dense product (its float32
    # sums of n terms reach ~1e-6 of the peak at n ~ 600, as its plain
    # version does on the host) within TOL_KERNEL
    def r2c_route(n):
        return api._route("r2c", (1, n, 130), 1, torch.float32, "cuda")

    k20_n = [n for n in range(2, 1101) if r2c_route(n) == api.R2C_DENSE_MID]
    k16_n = [n for n in range(2, 2 * kfft.GENERIC_MAX_N + 1) if r2c_route(n) == api.R2C_MID]
    k20_forms = {f: [n for n in k20_n if krfft.r2c_dense_form(n) == f]
                 for f in ("radix", "chirp", "dense")}
    if (len(k20_n), len(k16_n)) != (1094, 153):
        raise AssertionError(f"r2c census: {len(k20_n)} K20 lengths, {len(k16_n)} K16 lengths, "
                             "expected 1094, 153")
    t0 = time.perf_counter()
    worst = dict.fromkeys(k20_forms, (0.0, None))
    reset_counts()
    for n in k20_n + k16_n:
        x = randn(1, n, 130)
        y = nd.ndfft_r2c(x, axis=1)
        err = rel_err(y, torch.fft.rfft(x.cpu().double(), dim=1).to(dev))
        form = "radix" if n in k16_n else krfft.r2c_dense_form(n)
        if not err <= (TOL_KERNEL if form == "dense" else TOL_CENSUS):
            raise AssertionError(f"r2c_mid census n={n} ({form}): {err}")
        worst[form] = max(worst[form], (err, n))
    read_counts("r2c_mid_census", r2c_dense_mid=len(k20_n),
                r2c_dense_mid_radix=len(k20_forms["radix"]),
                r2c_dense_mid_chirp=len(k20_forms["chirp"]), r2c_mid=len(k16_n))
    emit(phase="r2c_mid_census", lengths=len(k20_n) + len(k16_n), k16=len(k16_n),
         **{f"k20_{f}": len(v) for f, v in k20_forms.items()},
         **{f"worst_rel_err_{f}": w[0] for f, w in worst.items()},
         **{f"worst_n_{f}": w[1] for f, w in worst.items()},
         seconds=time.perf_counter() - t0)
    del x, y
    torch.cuda.empty_cache()

    # ---- 4w. kernel 15's census at its dense rows' half lengths: the
    # wrapper r2c_packed_dense over (128, 2h) at each of the 254 h <= 256
    # that are not 128 F (the radix row core where rfft.py::
    # packed_dense_radix holds, the chirp-z at the others), against
    # torch.fft.rfft in float64 (an oracle only, run on the host), within
    # TOL_CENSUS of the oracle's peak
    k15_h = [h for h in range(1, 257) if not krfft.packed_core(h)]
    k15_forms = {f: [h for h in k15_h if krfft.packed_dense_form(h) == f]
                 for f in ("radix", "chirp")}
    if (len(k15_h), len(k15_forms["radix"])) != (254, 229):
        raise AssertionError(f"r2c_packed_dense census: {len(k15_h)} h, "
                             f"{len(k15_forms['radix'])} radix")
    t0 = time.perf_counter()
    worst = dict.fromkeys(k15_forms, (0.0, None))
    reset_counts()
    for h in k15_h:
        x = randn(128, 2 * h)
        y = krfft.r2c_packed_dense(x)
        err = rel_err(y, torch.fft.rfft(x.cpu().double(), dim=1).to(dev))
        form = krfft.packed_dense_form(h)
        if not err <= TOL_CENSUS:
            raise AssertionError(f"r2c_packed_dense census h={h} ({form}): {err}")
        worst[form] = max(worst[form], (err, h))
    read_counts("r2c_packed_dense_census", r2c_packed_dense=len(k15_h),
                r2c_packed_dense_radix=len(k15_forms["radix"]),
                r2c_packed_dense_chirp=len(k15_forms["chirp"]))
    emit(phase="r2c_packed_dense_census", half_lengths=len(k15_h),
         **{f: len(v) for f, v in k15_forms.items()},
         **{f"worst_rel_err_{f}": w[0] for f, w in worst.items()},
         **{f"worst_h_{f}": w[1] for f, w in worst.items()},
         seconds=time.perf_counter() - t0)
    del x, y
    torch.cuda.empty_cache()

    # ---- 4t. the census of kernels 1 and 18 on the radix column tile:
    # ndfft and ndifft along axis 1 of a (1, n, 130) field at every n that
    # the gates send to kernel 1 (C2C_AXIS_MID: 152 lengths, 384 ... 20480),
    # against torch.fft in complex128, and nddst1 along axis 1 of a
    # (1, n, 130) field at every n that they send to kernel 18
    # (R2C_PACKED_MID: 153 lengths, 255 ... 20479; streams of h = n + 1),
    # against scipy's DST-I through float64 torch.fft (-Im of the R2C of the
    # odd extension); oracles only, run on the host; each within TOL_CENSUS
    # of the oracle's peak
    k1_n = [n for n in range(2, kfft.GENERIC_MAX_N + 1)
            if api._route("fft", (1, n, 130), 1, torch.complex64, "cuda") == api.C2C_AXIS_MID]
    k18_n = [n for n in range(2, kfft.GENERIC_MAX_N)
             if api._route("dst1", (1, n, 130), 1, torch.float32, "cuda") == api.R2C_PACKED_MID]
    if (len(k1_n), len(k18_n)) != (152, 153):
        raise AssertionError(f"axis-mid census: {len(k1_n)} K1 lengths, {len(k18_n)} K18 "
                             "lengths, expected 152, 153")
    t0 = time.perf_counter()
    worst = {"c2c_axis_mid": (0.0, None), "r2c_packed_mid": (0.0, None)}
    reset_counts()
    for n in k1_n:
        x = crandn(1, n, 130)
        xh = x.cpu().to(torch.complex128)
        for y, ref in ((nd.ndfft(x, axis=1), torch.fft.fft(xh, dim=1)),
                       (nd.ndifft(x, axis=1), torch.fft.ifft(xh, dim=1))):
            err = rel_err(y, ref.to(dev))
            if not err <= TOL_CENSUS:
                raise AssertionError(f"c2c_axis_mid census n={n}: {err}")
            worst["c2c_axis_mid"] = max(worst["c2c_axis_mid"], (err, n))
    for n in k18_n:
        x = randn(1, n, 130)
        xh = x.cpu().double()
        z = torch.zeros_like(xh[:, :1])
        ext = torch.cat([z, xh, z, -xh.flip(1)], dim=1)
        err = rel_err(nd.nddst1(x, axis=1), (-torch.fft.rfft(ext, dim=1).imag[:, 1:n + 1]).to(dev))
        if not err <= TOL_CENSUS:
            raise AssertionError(f"r2c_packed_mid census n={n}: {err}")
        worst["r2c_packed_mid"] = max(worst["r2c_packed_mid"], (err, n))
    read_counts("axis_mid_census", c2c_axis_mid=2 * len(k1_n), r2c_packed_mid=len(k18_n))
    emit(phase="axis_mid_census", k1_lengths=len(k1_n), k18_lengths=len(k18_n),
         worst_rel_err_k1=worst["c2c_axis_mid"][0], worst_n_k1=worst["c2c_axis_mid"][1],
         worst_rel_err_k18=worst["r2c_packed_mid"][0], worst_n_k18=worst["r2c_packed_mid"][1],
         seconds=time.perf_counter() - t0)
    del x, xh, y, ref
    torch.cuda.empty_cache()

    # ---- 4u. the census of kernels 3 and 17 on the radix core: ndifft_r2c
    # (the default 1/n) along the last axis of a (128, h + 1) spectrum at
    # every half length h that the gates send to kernel 3 (C2R_NAT: 153
    # lengths, h = 256 ... 20480) and along axis 1 of a (1, h + 1, 130) one
    # at every h that they send to kernel 17 (C2R_MID: the same 153), with
    # DC and Nyquist imaginary parts that must be ignored, against
    # torch.fft.irfft in float64 (an oracle only, run on the host), within
    # TOL_CENSUS of the oracle's peak
    def c2r_halves(shape_of, route):
        return [h for h in range(1, kfft.GENERIC_MAX_N + 1)
                if api._route("c2r", shape_of(h), 1, torch.complex64, "cuda", n=2 * h) == route]

    census_c2r = (("c2r_nat", lambda h: (128, h + 1), api.C2R_NAT),
                  ("c2r_mid", lambda h: (1, h + 1, 130), api.C2R_MID))
    halves = {name: c2r_halves(shape_of, route) for name, shape_of, route in census_c2r}
    if [len(v) for v in halves.values()] != [153, 153]:
        raise AssertionError(f"c2r census: {[len(v) for v in halves.values()]} half lengths, "
                             "expected 153, 153")
    t0 = time.perf_counter()
    worst = {name: (0.0, None) for name in halves}
    reset_counts()
    for name, shape_of, _ in census_c2r:
        for h in halves[name]:
            sp = crandn(*shape_of(h))
            sp[:, 0] += 100j
            sp[:, -1] += 100j
            y = nd.ndifft_r2c(sp, axis=1)
            err = rel_err(y, torch.fft.irfft(sp.cpu().to(torch.complex128), n=2 * h,
                                             dim=1).to(dev))
            if not err <= TOL_CENSUS:
                raise AssertionError(f"{name} census h={h}: {err}")
            worst[name] = max(worst[name], (err, h))
    read_counts("c2r_census", c2r_nat=len(halves["c2r_nat"]), c2r_mid=len(halves["c2r_mid"]))
    emit(phase="c2r_census", k3_lengths=len(halves["c2r_nat"]),
         k17_lengths=len(halves["c2r_mid"]),
         worst_rel_err_k3=worst["c2r_nat"][0], worst_h_k3=worst["c2r_nat"][1],
         worst_rel_err_k17=worst["c2r_mid"][0], worst_h_k17=worst["c2r_mid"][1],
         seconds=time.perf_counter() - t0)
    del sp, y
    torch.cuda.empty_cache()

    # ---- 4v. the census of kernels 21 and 27: ndifft_r2c (the default 1/n)
    # along axis 1 of a (1, n/2 + 1, 130) spectrum at every 4 <= n <= 1100
    # (the 701 on the radix column tile, with a plan of n/2 at even n and
    # of n at odd n: 698 of them kernel 21's and 512, 768 and 1024 kernel
    # 17's; the 396 others on kernel 21's chirp-z (within TOL_CENSUS) or
    # its dense product (rfft.py::c2r_dense_form), whose float32 sums of n
    # terms are held to TOL_KERNEL as in phase 4s), with DC and
    # (even n) Nyquist imaginary parts that must be ignored, against
    # torch.fft.irfft in float64; and nddct1, nddct2 and
    # nddct3 along axis 1 of a (1, n, 130) field at every n that kernel 27
    # takes on the radix column tile (671, 439 and 439 lengths) against
    # scipy.fft.dct in float64 (oracles only, run on the host); each within
    # TOL_CENSUS of the oracle's peak
    k21_all = list(range(4, 1101))
    k21_forms = {f: [n for n in k21_all if krfft.c2r_dense_form(n) == f]
                 for f in ("radix", "chirp", "dense")}
    k21_n = k21_forms["radix"]
    k27_n = {t: [n for n in range(2, 1101) if kdct.dct_radix_len(n, t) is not None]
             for t in (1, 2, 3)}
    k21_k17 = [n for n in k21_n if api._route("c2r", (1, n // 2 + 1, 130), 1, torch.complex64,
                                              "cuda", n=n) == api.C2R_MID]
    if (len(k21_n), k21_k17, [len(v) for v in k27_n.values()]) != (
            701, [512, 768, 1024], [671, 439, 439]):
        raise AssertionError(f"dense census: {len(k21_n)} K21 lengths ({k21_k17} K17), "
                             f"{[len(v) for v in k27_n.values()]} K27 lengths")
    t0 = time.perf_counter()
    worst = {name: (0.0, None) for name in ("radix", "chirp", "dense", 1, 2, 3)}
    reset_counts()
    for n in k21_all:
        sp = crandn(1, n // 2 + 1, 130)
        sp[:, 0] += 100j
        if n % 2 == 0:
            sp[:, -1] += 100j
        y = nd.ndifft_r2c(sp, nd.R2cFftHandler(n), axis=1)
        err = rel_err(y, torch.fft.irfft(sp.cpu().to(torch.complex128), n=n, dim=1).to(dev))
        form = krfft.c2r_dense_form(n)
        if not err <= (TOL_KERNEL if form == "dense" else TOL_CENSUS):
            raise AssertionError(f"c2r_dense_mid census n={n} ({form}): {err}")
        worst[form] = max(worst[form], (err, n))
    for t, lengths in k27_n.items():
        fn = (nd.nddct1, nd.nddct2, nd.nddct3)[t - 1]
        for n in lengths:
            x = randn(1, n, 130)
            err = rel_err(fn(x, nd.DctHandler(n), axis=1),
                          torch.from_numpy(sfft.dct(host64(x), type=t, axis=1)).to(dev))
            if not err <= TOL_CENSUS:
                raise AssertionError(f"dct{t} census n={n}: {err}")
            worst[t] = max(worst[t], (err, n))
    k27_total = sum(len(v) for v in k27_n.values())
    read_counts("dense_census", c2r_dense_mid=len(k21_all) - 3,
                c2r_dense_mid_radix=len(k21_n) - 3,
                c2r_dense_mid_chirp=len(k21_forms["chirp"]), c2r_mid=3,
                dct_dense_mid=k27_total, dct_dense_mid_radix=k27_total)
    emit(phase="dense_census", k21_radix=len(k21_n) - 3, k21_chirp=len(k21_forms["chirp"]),
         k21_dense=len(k21_forms["dense"]), k17_lengths=3,
         k27_lengths={f"dct{t}": len(v) for t, v in k27_n.items()},
         **{f"worst_rel_err_c2r_{f}": worst[f][0] for f in ("radix", "chirp", "dense")},
         **{f"worst_n_c2r_{f}": worst[f][1] for f in ("radix", "chirp", "dense")},
         **{f"worst_rel_err_dct{t}": worst[t][0] for t in (1, 2, 3)},
         **{f"worst_n_dct{t}": worst[t][1] for t in (1, 2, 3)},
         seconds=time.perf_counter() - t0)
    del sp, y, x
    torch.cuda.empty_cache()

    # ---- 4x. the census of kernels 23 and 12: the wrapper dct2_nat (scale
    # 2, scipy's DCT-II) over (128, n) at each of the 259 lengths n = 128 k
    # whose half length has a radix plan (233 of them, k <= 256, are the
    # routes' for nddct2 along the last axis; the wrapper takes k <= 320),
    # and nddct2 and nddct3 along axis 1 of a (1, n, 130) field at each of
    # the 3264 Bluestein lengths that the gates send to kernel 12
    # (DCT23_BLUE_MID, n = 1101 ... 6782, 15 convolution lengths M), against
    # the float64 torch.fft Makhoul lowering (an oracle only), within
    # TOL_STEP of the oracle's peak, the worst error reported
    k23_n = [n for n in range(128, 128 * 321, 128) if kdct.dct2_nat_radix(n)]
    k12_n = [n for n in range(2, 8000)
             if api._route("dct2", (1, n, 130), 1, torch.float32, "cuda") == api.DCT23_BLUE_MID]
    k12_m = sorted({kfft.chirp_m(n) for n in k12_n})
    if (len(k23_n), len(k12_n), len(k12_m)) != (259, 3264, 15):
        raise AssertionError(f"K23/K12 census: {len(k23_n)} K23 lengths, {len(k12_n)} K12 "
                             f"lengths at {len(k12_m)} M, expected 259, 3264, 15")
    t0 = time.perf_counter()
    worst = {name: (0.0, None) for name in ("dct2_nat", 2, 3)}
    reset_counts()
    for n in k23_n:
        x = randn(128, n)
        err = rel_err(kdct.dct2_nat(x, 2.0), makhoul_dct(x.double(), 1, 2))
        if not err <= TOL_STEP:
            raise AssertionError(f"dct2_nat census n={n}: {err}")
        worst["dct2_nat"] = max(worst["dct2_nat"], (err, n))
    for n in k12_n:
        x = randn(1, n, 130)
        xd = x.double()
        for t, fn in ((2, nd.nddct2), (3, nd.nddct3)):
            err = rel_err(fn(x, nd.DctHandler(n), axis=1), makhoul_dct(xd, 1, t))
            if not err <= TOL_STEP:
                raise AssertionError(f"dct{t} (kernel 12) census n={n}: {err}")
            worst[t] = max(worst[t], (err, n))
    read_counts("dct_rows_blue_census", dct2_nat=len(k23_n), dct2_nat_radix=len(k23_n),
                dct23_blue_mid=2 * len(k12_n))
    emit(phase="dct_rows_blue_census", k23_lengths=len(k23_n), k12_lengths=len(k12_n),
         k12_m=k12_m, worst_rel_err_k23=worst["dct2_nat"][0], worst_n_k23=worst["dct2_nat"][1],
         **{f"worst_rel_err_k12_dct{t}": worst[t][0] for t in (2, 3)},
         **{f"worst_n_k12_dct{t}": worst[t][1] for t in (2, 3)},
         seconds=time.perf_counter() - t0)
    del x, xd
    torch.cuda.empty_cache()

    # ---- 5. times: each kernel against its plain version and, at the main
    # path's shape, the PyTorch call that computes the same function (the
    # yardstick); the steps against torch.fft (the 1536^3 solve's kernels
    # and the solve itself are timed in phase 4h, beside their fields)
    reps = args.reps
    main_shapes = {"c2c_axis_mid": (1, 512, 512 * 257), "r2c_nat": (512 * 512, 512),
                   "c2r_nat": (512 * 512, 257), "dct_dense_mid": (1, 1024, 1024),
                   "dct_dense_mid_radix": (1, 512, 512 * 512),
                   "dct2_nat_radix": (512 * 512, 512), "dct3_nat_radix": (512 * 512, 512),
                   "c2c_rows": (512 * 512, 512), "c2c_dense_rows": (256 * 256, 256),
                   "c2c_dense_mid": (1, 256, 256 * 256), "r2c_mid": (1, 512, 512 * 512),
                   "c2r_mid": (1, 257, 512 * 512), "r2c_dense_mid": (1, 131, 256 * 256),
                   "r2c_dense_mid_radix": (1, 256, 256 * 256),
                   "r2c_dense_mid_chirp": (1, 262, 256 * 256),
                   "c2r_dense_mid": (1, 65, 256 * 256),
                   "c2r_dense_mid_chirp": (1, 132, 256 * 256),
                   "c2r_dense_mid_radix": (1, 129, 256 * 256), "r2c_packed": (256 * 256, 256),
                   "r2c_packed_dense_chirp": (128 * 128, 262),
                   "r2c_packed_dense_radix": (128 * 128, 128), "c2c_generic_rows": (600 * 600, 600),
                   "c2c_generic_mid": (600, 600, 301), "r2c_packed_generic": (600 * 600, 600),
                   "dct2_nat_wide": (2048, 128 * 262),
                   "dct3_nat_wide": (2048, 128 * 262), "dct2_nat_npoint": (4096, 128 * 131),
                   "dct3_nat_npoint": (4096, 128 * 131), "dct2_mid_radix": (1, 2048, 2048),
                   "dct3_mid_radix": (1, 2048, 2048), "dct2_mid_wide": (1, 128 * 262, 2048),
                   "dct3_mid_wide": (1, 128 * 262, 2048), "dct2_mid_npoint": (1, 128 * 131, 4096),
                   "dct3_mid_npoint": (1, 128 * 131, 4096), "r2c_packed_mid": (1023, 1024, 1023),
                   "dct1_mid": (2049, 2049, 257), "dct4_mid_radix": (2048, 2048, 256),
                   "dct4_mid_fourstep": (1, 65536, 8192), "dct4_mid_wide": (1, 256 * 131, 1024),
                   "dct4_mid_long": (1, 256 * 163, 1024),
                   "c2c_blue_mid": (1, 509, 509 * 509), "dct23_blue_mid": (1, 2049, 2049 * 256),
                   "fourstep_mid_radix": (256, 1024, 1024),
                   "fourstep_mid_dense": (8, 131, 8192), "rows_store_t": (256, 1024, 1024),
                   "spectral_c2c_mid": (1, 1024, 1024 * 513),
                   "spectral_r2c_mid": (1, 1024, 1024 * 1024),
                   "spectral_dct_mid_radix": (1, 1024, 1024 * 1024),
                   "spectral_dct_mid_wide": (1, 128 * 262, 2048),
                   "spectral_dct_mid_npoint": (1, 128 * 131, 4096)}

    # the radix core's kernels: the yardstick at every shape timed
    library_every_shape = ("c2c_generic_rows", "r2c_packed_generic", "c2r_dense_mid_radix",
                           "dct_dense_mid_radix", "r2c_dense_mid_radix", "r2c_dense_mid_chirp",
                           "r2c_dense_mid", "r2c_packed_dense_radix", "c2r_dense_mid_chirp",
                           "r2c_packed_dense_chirp", "c2r_dense_mid",
                           *RADIX_ONLY)

    def time_kernel(name, shape, kern, plain, library=None, runs=None, **kw):
        runs = runs or reps
        t_plain = cuda_ms(plain, runs)
        t_k = cuda_ms(kern, runs)
        t_lib = (cuda_ms(library, runs) if library is not None and (
            shape == main_shapes[name] or name in library_every_shape) else None)
        timing[(name, shape)] = (t_k, t_plain, t_lib)
        emit(phase="time", kernel=name, shape=shape, ms=t_k, plain_ms=t_plain,
             library_ms=t_lib, card=card, **kw)

    for shape in ((1, 512, 257), (1, 1024, 513), (512, 512, 257), (1, 512, 512 * 257),
                  (1, 1024, 1024), (512, 512, 512), (1, 512, 512 * 512), (257, 512, 512)):
        x = crandn(*shape)
        s = 1.0 / shape[1]
        time_kernel("c2c_axis_mid", shape, lambda: kfft.c2c_axis_mid(x, +1, s),
                    lambda: kfft.c2c_axis_mid_plain(x, +1, s),
                    lambda: torch.fft.ifft(x, dim=1))
    for t, n in ((512, 512), (1024, 1024), (512 * 512, 512)):
        x = randn(t, n)
        sp = crandn(t, n // 2 + 1)
        time_kernel("r2c_nat", (t, n), lambda: krfft.r2c_nat(x),
                    lambda: krfft.r2c_nat_plain(x), lambda: torch.fft.rfft(x, dim=1))
        time_kernel("c2r_nat", (t, n // 2 + 1), lambda: krfft.c2r_nat(sp, n, 1.0 / n),
                    lambda: krfft.c2r_nat_plain(sp, n, 1.0 / n),
                    lambda: torch.fft.irfft(sp, n=n, dim=1))
    del x, sp
    # kernel 27: the dense product at its main path's DCT-IV and at odd
    # DCT-II lengths; the radix column tile at DCT-II (the kernels line's
    # main shape and (512, 512, 512)), DCT-III and S3's (1024, 1024, 1024),
    # and DCT-I (the Chebyshev 129^3 and the dct2d grid's 1025), each beside
    # torch.matmul with the scaled DCT matrix; the plain version in slices
    # of 64 at S3's shape
    dct_types = {}      # (name, shape, DCT type) -> (ms, plain ms, library ms)
    for name, shape, types in (
            ("dct_dense_mid", (1, 1024, 1024), (4,)), ("dct_dense_mid", (1, 129, 129), (2,)),
            ("dct_dense_mid", (1, 1025, 1025), (2,)),
            ("dct_dense_mid_radix", (1, 512, 512 * 512), (2, 3)),
            ("dct_dense_mid_radix", (512, 512, 512), (2,)),
            ("dct_dense_mid_radix", (1024, 1024, 1024), (2, 3)),
            ("dct_dense_mid_radix", (129, 129, 129), (1,)),
            ("dct_dense_mid_radix", (1, 1025, 1025), (1,))):
        x = randn(*shape)
        step = 64 if x.numel() > 1 << 28 else shape[0]
        for t in types:
            m_s = torch.from_numpy(kdct.dense_consts(shape[1], t, 2.0).T.copy()).to(dev)
            plain = kdct.dct_radix_plain if name.endswith("_radix") else kdct.dct_dense_mid_plain
            time_kernel(name, shape, lambda: kdct.dct_dense_mid(x, t, 2.0),
                        lambda: [plain(x[i:i + step], t, 2.0) for i in range(0, shape[0], step)],
                        lambda: torch.matmul(m_s, x), runs=5 if step < shape[0] else None,
                        dct_type=t)
            dct_types[(name, shape, t)] = timing.pop((name, shape))
        timing[(name, shape)] = dct_types[(name, shape, types[0])]
        del x, m_s
        torch.cuda.empty_cache()
    for t, n in ((1024, 1024), (512 * 512, 512), (1024 * 1024, 1024)):
        x = randn(t, n)
        if t < 1024 * 1024:
            time_kernel("dct2_nat_radix", (t, n), lambda: kdct.dct2_nat(x, 2.0),
                        lambda: kdct.dct2_nat_plain(x, 2.0))
        time_kernel("dct3_nat_radix", (t, n), lambda: kdct.dct3_nat(x, 2.0),
                    lambda: kdct.dct3_nat_plain(x, 2.0))
    del x
    # kernel 23 on the radix row core at each count of rows a block that
    # fits (the wrapper takes fft.py::radix_block's at h = n/2), at the DCT
    # family's (262144, 512) and the 1536^3 solve's (2359296, 1536); and
    # its remnant forms (the 29 lengths without a plan of n/2) at n = 128 *
    # 131 (the n-point form) and 128 * 262 (the wide core's half length)
    for t, n in ((512 * 512, 512), (1536 * 1536, 1536)):
        x = randn(t, n)
        y = torch.empty_like(x)
        tr = -(-(n // 2) // 16)
        runs = 5 if x.numel() > 1 << 28 else reps
        rows_ms = {r: cuda_ms(lambda: kdct.dct2_rows_radix_launch(x, y, 2.0, r), runs)
                   for r in range(1, kfft.RADIX_MAX_THREADS // tr + 1)}
        emit(phase="time", kernel="dct2_nat_radix", shape=(t, n), ms_by_rows_per_block=rows_ms,
             chosen=kfft.radix_block(n // 2, t, kfft.num_sms(dev)), card=card)
        del x, y
        torch.cuda.empty_cache()
    # kernel 24 on the radix row core at each count of rows a block that
    # fits at (262144, 512) and (2359296, 1536), beside the parent's form at
    # the 1536^3 solve's shape (the wide core's half length; its fixed core
    # at (262144, 512) is gone: time_kernels.py --dct --root on the parent
    # tree times it)
    for t, n in ((512 * 512, 512), (1536 * 1536, 1536)):
        x = randn(t, n)
        y = torch.empty_like(x)
        tr = -(-(n // 2) // 16)
        runs = 5 if x.numel() > 1 << 28 else reps
        rows_ms = {r: cuda_ms(lambda: kdct.dct3_rows_radix_launch(x, y, 1.0 / n, r), runs)
                   for r in range(1, kfft.RADIX_MAX_THREADS // tr + 1)}
        parent = ({"wide": cuda_ms(lambda: kdct.bts2_launch(x, y, 1.0 / n, True, True, "wide"),
                                   runs)} if n == 1536 else {})
        emit(phase="time", kernel="dct3_nat_radix", shape=(t, n), ms_by_rows_per_block=rows_ms,
             chosen=kfft.radix_block(n // 2, t, kfft.num_sms(dev)), parent_form_ms=parent,
             card=card)
        del x, y
        torch.cuda.empty_cache()
    # kernel 25 on the radix column tile at each column count C = 1 ... 16
    # that fits (h C <= 20480 elements; the 16-element form to h C = 4096,
    # the 32/40-element form above; at C <= 2 also with the read-only
    # load that the wrapper takes there), beside the parent's form at the same
    # shape (the wide core's half length at 1536, the n-point form at 1152
    # and 31104; the fixed core at 2048 is gone: time_kernels.py --dct
    # --root on the parent tree times it); at (1, 31104, 31104) also the
    # composition transpose, kernel 23 on the rows, transpose back
    for shape in ((1, 1536, 1536 * 1536), (1536, 1536, 1536), (1, 2048, 2048), (1, 1152, 1152),
                  (1, 31104, 31104)):
        x = randn(*shape)
        y = torch.empty_like(x)
        h = shape[1] // 2
        runs = 1 if shape[1] > 20480 else 5 if x.numel() > 1 << 28 else reps
        cols_ms = {c: cuda_ms(lambda: kdct.dct_radix_launch(x, y, 2, 2.0, c), runs)
                   for c in (1, 2, 4, 8, 16)
                   if h * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(h, c) <= 512}
        ldg_ms = {c: cuda_ms(lambda: kdct.dct_radix_launch(x, y, 2, 2.0, c, True), runs)
                  for c in (1, 2) if c in cols_ms}
        form = kdct.dct_form(shape[1])[0]
        parent = ({} if shape[1] == 2048 else
                  {form: cuda_ms(lambda: kdct.bts2_launch(x, y, 2.0, False, False,
                                                          "npoint" if form == "npoint" else "wide"),
                                 runs, 1)})
        extra = {}
        if shape[1] == 31104:
            extra["transpose_k23_transpose_ms"] = cuda_ms(
                lambda: kdct.dct2_nat(x[0].t().contiguous(), 2.0).t().contiguous(), runs, 1)
        emit(phase="time", kernel="dct2_mid_radix", shape=shape, ms_by_cols=cols_ms,
             read_only_load_ms_by_cols=ldg_ms,
             chosen=kdct.dct2_mid_cols(h, shape[0], shape[2], kfft.num_sms(dev)),
             parent_form_ms=parent, card=card, **extra)
        del x, y
        torch.cuda.empty_cache()
    # kernel 26 on the radix column tile likewise, at each column count C
    # and at C <= 2 with each load, beside the parent's form at the same
    # shape (the wide core's half length at 1536, the n-point form at 1152
    # and 31104; the fixed core at 2048 is gone: time_kernels.py --dct
    # --root on the parent tree times it)
    for shape in ((1, 1536, 1536 * 1536), (1536, 1536, 1536), (1, 2048, 2048), (1, 1152, 1152),
                  (1, 31104, 31104)):
        x = randn(*shape)
        y = torch.empty_like(x)
        n = shape[1]
        h = n // 2
        runs = 1 if n > 20480 else 5 if x.numel() > 1 << 28 else reps
        cols_ms = {c: cuda_ms(lambda: kdct.dct_radix_launch(x, y, 3, 1.0 / n, c), runs)
                   for c in (1, 2, 4, 8, 16)
                   if h * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(h, c) <= 512}
        ldg_ms = {c: cuda_ms(lambda: kdct.dct_radix_launch(x, y, 3, 1.0 / n, c, True), runs)
                  for c in (1, 2) if c in cols_ms}
        form = kdct.dct_form(n)[0]
        parent = ({} if n == 2048 else
                  {form: cuda_ms(lambda: kdct.bts2_launch(x, y, 1.0 / n, True, False,
                                                          "npoint" if form == "npoint" else "wide"),
                                 runs, 1)})
        emit(phase="time", kernel="dct3_mid_radix", shape=shape, ms_by_cols=cols_ms,
             read_only_load_ms_by_cols=ldg_ms,
             chosen=kdct.dct2_mid_cols(h, shape[0], shape[2], kfft.num_sms(dev)),
             parent_form_ms=parent, card=card)
        del x, y
        torch.cuda.empty_cache()
    # kernel 29 on the radix column tile likewise, at S3's (1, 1024,
    # 1048576) and G1's (1, 31104, 31104) with a lane-varying H and at the
    # Dirichlet solve's (1, 2048, 4096), (8, 1280, 8192) and (1, 1152, 1152)
    # with a broadcast one, beside the parent's form at the same shape (the
    # wide core's half length at 1280, the n-point form at 1152 and 31104;
    # the fixed core at 1024 and 2048 is gone: time_kernels.py --dct --root
    # on the parent tree times it)
    for shape, hcols in (((1, 1024, 1024 * 1024), 1024 * 1024), ((1, 2048, 4096), 1),
                         ((8, 1280, 8192), 1), ((1, 1152, 1152), 1), ((1, 31104, 31104), 31104)):
        x = randn(*shape)
        y = torch.empty_like(x)
        n = shape[1]
        h = n // 2
        hv = randn(n, hcols)
        runs = 1 if n > 20480 else 5 if x.numel() > 1 << 28 else reps
        cols_ms = {c: cuda_ms(lambda: kdct.spectral_dct_radix_launch(x, y, hv, 2.0, 1.0 / n, c),
                              runs)
                   for c in (1, 2, 4, 8, 16)
                   if h * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(h, c) <= 512}
        ldg_ms = {c: cuda_ms(lambda: kdct.spectral_dct_radix_launch(x, y, hv, 2.0, 1.0 / n, c,
                                                                    True), runs)
                  for c in (1, 2) if c in cols_ms}
        form = kdct.dct_form(n)[0]
        parent = ({} if n in (1024, 2048) else
                  {form: cuda_ms(lambda: kdct.spectral_dct_bts2_launch(
                      x, y, hv, 2.0, 1.0 / n, "npoint" if form == "npoint" else "wide"), runs, 1)})
        emit(phase="time", kernel="spectral_dct_mid_radix", shape=shape, h_cols=hcols,
             ms_by_cols=cols_ms, read_only_load_ms_by_cols=ldg_ms,
             chosen=krfft.spectral_cols(h, shape[0], shape[2], kfft.num_sms(dev)),
             parent_form_ms=parent, card=card)
        del x, y, hv
        torch.cuda.empty_cache()
    # kernel 28's single pass on the radix column tile at each column count
    # C that fits (at C <= 2 also with the read-only load), at the mixed
    # solve's (2048, 2048, 256) and (1, 2048, 524288), F = 6's (1, 1536,
    # 1536) and the crossover's (1, 40960, 8192) (hl = 20480: one column a
    # tile), beside the count that dct.py::dct4_mid_cols picks; kernel 19
    # (kernel 27's DCT-I) likewise at the vertex-centred solve's (2049, 2049,
    # 257) and (1, 2049, 526593) (ragged tiles: L = 257), F = 12's
    # (1, 1537, 1537) and F = 160's (1, 20481, 8192) (one column a tile),
    # beside rfft.py::dct1_mid_cols's count
    sms = kfft.num_sms(dev)

    def cols_scan(kernel, shape, h, launch, chosen):
        x = randn(*shape)
        y = torch.empty_like(x)
        runs = 5 if x.numel() > 1 << 28 else reps
        fits = [c for c in (1, 2, 4, 8, 16)
                if h * c <= kfft.RADIX_MAX_ELEMS and kfft.radix_cols_threads(h, c) <= 512]
        cols_ms = {c: cuda_ms(lambda: launch(x, y, c, False), runs) for c in fits}
        ldg_ms = {c: cuda_ms(lambda: launch(x, y, c, True), runs) for c in (1, 2) if c in fits}
        emit(phase="time", kernel=kernel, shape=shape, ms_by_cols=cols_ms,
             read_only_load_ms_by_cols=ldg_ms, chosen=chosen, card=card)
        del x, y
        torch.cuda.empty_cache()

    for shape in ((2048, 2048, 256), (1, 2048, 2048 * 256), (1, 1536, 1536), (1, 40960, 8192)):
        hl = shape[1] // 2
        cols_scan("dct4_mid_radix", shape, hl,
                  lambda x, y, c, ldg: kdct.dct4_radix_launch(x, y, 2.0, c, ldg),
                  kdct.dct4_mid_cols(hl, shape[0], shape[2], sms))
    for shape in ((2049, 2049, 257), (1, 2049, 2049 * 257), (1, 1537, 1537), (1, 20481, 8192)):
        h = shape[1] - 1
        cols_scan("dct1_mid", shape, h,
                  lambda x, y, c, ldg: kdct.dct_radix_launch(x, y, 1, 2.0, c, ldg),
                  krfft.dct1_mid_cols(h, shape[0], shape[2], sms))
    # kernel 28's four-step at G2's (1, 65536, 8192), the crossover's
    # (1, 40960, 8192) and (1, 20480, 8192) (hl = 10240, the single pass's
    # last two-column tile): each pass alone at each split hl = h1 h2 with
    # h2 = 32, 64, 128 and 256 and each column count C that fits, beside
    # the split and counts that dct.py::dct4_split and dct4_fourstep_cols
    # pick, the four-step's whole call, and the single pass at the count
    # that dct.py::dct4_mid_cols picks (dct.py::dct4_form)
    for shape in ((1, 65536, 8192), (1, 40960, 8192), (1, 20480, 8192)):
        x = randn(*shape)
        y = torch.empty_like(x)
        n = shape[1]
        hl = n // 2
        tw = kdct._device_dct4("fourstep_tw", n, 1.0, dev)
        post = kdct._device_dct4("post", n, 2.0, dev)
        splits = {}
        for h2 in (32, 64, 128, 256):
            h1 = hl // h2
            if hl % h2 or kfft.radix_plan(h1) is None:
                continue
            splits[f"{h1}x{h2}"] = [
                {c: cuda_ms(lambda: kdct._dct4_pass(step, x, y, length, t, c), 5)
                 for c in (2, 4, 8, 16, 32, 64)
                 if length * c <= kfft.RADIX_MAX_ELEMS
                 and kfft.radix_cols_threads(length, c) <= 512}
                for step, length, t in ((1, h1, tw), (2, h2, post))]
        h1, h2 = kdct.dct4_split(hl)
        c = kdct.dct4_mid_cols(hl, shape[0], shape[2], sms)
        single = (cuda_ms(lambda: kdct.dct4_radix_launch(x, y, 2.0, c, c <= 2), 5)
                  if hl <= kdct.DCT4_RADIX_MAX_HL else None)
        emit(phase="time", kernel="dct4_mid_fourstep", shape=shape,
             pass_ms_by_split_and_cols=splits, chosen_split=[h1, h2],
             chosen_cols=[kdct.dct4_fourstep_cols(h1, h2, shape[2], sms),
                          kdct.dct4_fourstep_cols(h2, h1, shape[2], sms)],
             fourstep_call_ms=cuda_ms(lambda: kdct.dct4_fourstep_launch(
                 x, y, 2.0, kdct.dct4_fourstep_cols(h1, h2, shape[2], sms),
                 kdct.dct4_fourstep_cols(h2, h1, shape[2], sms)), 5),
             single_pass_ms=single, form=kdct.dct4_form(n), card=card)
        del x, y
        torch.cuda.empty_cache()
    # the remnant forms of kernels 23 to 26 (the 29 lengths without a plan
    # of n/2) at n = 128 * 131 (the n-point form) and 128 * 262 (the wide
    # core's half length), the plain versions in slices of 64
    for name, kern, plain, shape in (
            ("dct2_nat_npoint", kdct.dct2_nat, kdct.dct2_nat_plain, (4096, 128 * 131)),
            ("dct2_nat_wide", kdct.dct2_nat, kdct.dct2_nat_plain, (2048, 128 * 262)),
            ("dct3_nat_npoint", kdct.dct3_nat, kdct.dct3_nat_plain, (4096, 128 * 131)),
            ("dct3_nat_wide", kdct.dct3_nat, kdct.dct3_nat_plain, (2048, 128 * 262)),
            ("dct2_mid_npoint", kdct.dct2_mid, kdct.dct2_mid_plain, (1, 128 * 131, 4096)),
            ("dct2_mid_wide", kdct.dct2_mid, kdct.dct2_mid_plain, (1, 128 * 262, 2048)),
            ("dct3_mid_npoint", kdct.dct3_mid, kdct.dct3_mid_plain, (1, 128 * 131, 4096)),
            ("dct3_mid_wide", kdct.dct3_mid, kdct.dct3_mid_plain, (1, 128 * 262, 2048))):
        x = randn(*shape)
        dim = 2 if len(shape) == 3 else 0
        time_kernel(name, shape, lambda: kern(x, 2.0),
                    lambda: [plain(x.narrow(dim, i, min(64, shape[dim] - i)), 2.0)
                             for i in range(0, shape[dim], 64)])
        del x
    for n, x in inputs.items():
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)
        t_port = cuda_ms(lambda: step2(x, hr, hc), reps)
        t_torch = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x), s=x.shape),
                          reps)
        emit(phase="time", step=[n, n], ms=t_port, torch_fft_ms=t_torch, card=card)
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: inv3(fwd3(x3, h512r, h512c), h512r, h512c), reps, 2)
    peak = torch.cuda.max_memory_allocated()
    t_torch = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x3), s=x3.shape),
                      reps, 2)
    emit(phase="time", step=[512, 512, 512], ms=t_port, torch_fft_ms=t_torch,
         peak_bytes=peak, card=card)
    del x3
    torch.cuda.empty_cache()

    for name, kern, plain, shapes in (
            ("c2c_rows", kfft.c2c_rows, kfft.c2c_rows_plain,
             ((1024, 1024), (512 * 512, 512), (257 * 512, 512), (65536, 2048))),
            ("c2c_dense_rows", kfft.c2c_dense_rows, kfft.c2c_radix_rows_plain,
             ((128, 256), (256 * 256, 256), (129 * 256, 256), (200, 200))),
            ("c2c_dense_mid", kfft.c2c_dense_mid, kfft.c2c_dense_mid_plain,
             ((1, 128, 128), (1, 264, 264), (256, 256, 256), (1, 256, 256 * 256),
              (129, 256, 256), (256, 256, 129), (1, 256, 33024), (1, 128, 16384)))):
        for shape in shapes:
            x = crandn(*shape)
            dim = -1 if len(shape) == 2 else 1
            time_kernel(name, shape, lambda: kern(x, -1), lambda: plain(x, -1),
                        lambda: torch.fft.fft(x, dim=dim))
    del x
    # kernel 4 at the 256^3 paths' shapes and at n = 128, 32, 8 and 4 (2^24
    # elements) with each column count C (the wrapper's radix_mid_cols takes
    # 16 at n = 256, 32 below; above 4096 elements a tile the 32- and
    # 40-element forms)
    for shape in ((1, 256, 256 * 256), (256, 256, 129), (1, 128, 16384), (1, 32, 1 << 19),
                  (1, 8, 1 << 21), (1, 4, 1 << 22)):
        x = crandn(*shape)
        y = torch.empty_like(x)
        cols_ms = {c: cuda_ms(lambda: kfft.mid_radix_launch(x, y, -1, 1.0, c), reps)
                   for c in (4, 8, 16, 32, 64) if tile_fits(shape[1], c)}
        emit(phase="time", kernel="c2c_dense_mid", shape=shape, ms_by_cols_per_tile=cols_ms,
             chosen=kfft.radix_mid_cols(shape[1], shape[0], shape[2], kfft.num_sms(dev)),
             card=card)
        del x, y
    # kernel 8 at its main shape with each count of rows a block (the
    # wrapper's radix_block takes 2 rows of 256)
    x = crandn(256 * 256, 256)
    rows_ms = {r: cuda_ms(lambda: kfft._radix_launch(x, -1, None, "c2c_dense_rows", r), reps)
               for r in (2, 4, 8, 10, 16)}
    emit(phase="time", kernel="c2c_dense_rows", shape=(256 * 256, 256),
         ms_by_rows_per_block=rows_ms, chosen=kfft.radix_block(256, 256 * 256, kfft.num_sms(dev)),
         card=card)
    del x
    # kernel 10 at its main shapes (n = 512, 1024, 2048: 32, 64, 128
    # threads a row), kernel 2 at its main shapes (h = 256, 384) and kernels
    # 8 and 15 at their generic main shape (n = 600, h = 300) with counts of
    # rows a block that fit 256 threads (the wrapper's radix_block takes the
    # fewest rows that leave at most one lane in eight idle)
    for name, shape, counts in (("c2c_rows", (512 * 512, 512), (1, 2, 3, 4, 5, 6, 8)),
                                ("c2c_rows", (509 * 509, 1024), (1, 2, 3, 4)),
                                ("c2c_rows", (65536, 2048), (1, 2)),
                                ("c2c_generic_rows", (600 * 600, 600), (1, 2, 3, 4, 5, 6)),
                                ("r2c_nat", (512 * 512, 512), (1, 2, 4, 5, 8, 10, 16)),
                                ("r2c_nat", (768 * 768, 768), (1, 2, 3, 4, 6, 8, 10)),
                                ("r2c_packed_generic", (600 * 600, 600), (2, 3, 4, 5, 8))):
        t, n = shape
        if name.startswith("c2c"):
            x = crandn(t, n)
            rows_ms = {r: cuda_ms(lambda: kfft._radix_launch(x, -1, None, name, r), reps)
                       for r in counts}
            chosen = kfft.radix_block(n, t, kfft.num_sms(dev))
        else:
            x = randn(t, n)
            rows_ms = {r: cuda_ms(lambda: krfft.r2c_radix_launch(x, name, r), reps)
                       for r in counts}
            chosen = kfft.radix_block(n // 2, t, kfft.num_sms(dev))
        emit(phase="time", kernel=name, shape=shape, ms_by_rows_per_block=rows_ms,
             chosen=chosen, card=card)
        del x
    # kernels 16 and 20 on the radix column tile at their main shapes with
    # each column count C that fits (the wrappers take r2c_mid_cols's)
    for shape in ((1, 512, 512 * 512), (512, 512, 512), (1, 1280, 1280), (1, 256, 256 * 256),
                  (1, 264, 264), (1, 129, 256 * 256)):
        nb, n, cols = shape
        x = randn(*shape)
        y = torch.empty((nb, n // 2 + 1, cols), dtype=torch.complex64, device=dev)
        cols_ms = {c: cuda_ms(lambda: krfft.r2c_mid_radix_launch(x, y, c), reps)
                   for c in (1, 2, 4, 8, 16, 32, 64) if tile_fits(krfft.r2c_mid_len(n), c)}
        emit(phase="time", kernel="r2c_mid" if n >= 512 else "r2c_dense_mid_radix", shape=shape,
             ms_by_cols_per_tile=cols_ms, chosen=krfft.r2c_mid_cols(n, nb, cols, kfft.num_sms(dev)),
             card=card)
        del x, y
    # kernel 20's chirp-z at 2^23 reals with each column count C that fits
    # (the wrapper takes fft.py::radix_mid_cols's at M), by convolution length M,
    # beside torch.fft.rfft(dim=1)
    for shape in ((1, 262, 256 * 256), (1, 131, 256 * 256), (1, 1094, 7668), (1, 1097, 7647)):
        nb, n, cols = shape
        x = randn(*shape)
        y = torch.empty((nb, n // 2 + 1, cols), dtype=torch.complex64, device=dev)
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        cols_ms = {c: cuda_ms(lambda: krfft.r2c_blue_launch(x, y, c), reps)
                   for c in (1, 2, 4, 8, 16) if tile_fits(mk, c)}
        emit(phase="time", kernel="r2c_dense_mid_chirp", shape=shape, M=mk,
             ms_by_cols_per_tile=cols_ms, chosen=kfft.radix_mid_cols(mk, nb, cols,
                                                                     kfft.num_sms(dev)),
             torch_fft_ms=cuda_ms(lambda: torch.fft.rfft(x, dim=1), reps), card=card)
        del x, y
    # kernel 21's chirp-z at (1, 132, 65536) (n = 262) and (1, 548, 7668)
    # (n = 1094), and kernel 15's rows on it at (16384, 262) (h = 131) and
    # (16384, 502) (h = 251), with each column (row) count C that fits (the
    # wrappers take fft.py::radix_mid_cols's at M and rfft.py::
    # packed_blue_rows's), beside torch.fft.irfft / rfft (kernel 21 also
    # beside the dense product it replaced); then the wrapper's device time
    # alone (graph_ms: a CUDA graph of 20 calls, replayed) beside torch.fft's
    # (and the dense product's)
    for shape, n in (((1, 132, 256 * 256), 262), ((1, 548, 7668), 1094)):
        nb, m, cols = shape
        sp = crandn(*shape)
        y = torch.empty((nb, n, cols), device=dev)
        mk = kfft.chirp_m(krfft.r2c_mid_len(n))
        cols_ms = {c: cuda_ms(lambda: krfft.c2r_blue_launch(sp, y, n, 1.0 / n, c), reps)
                   for c in (1, 2, 4, 8, 16) if tile16_fits(mk, c)}
        emit(phase="time", kernel="c2r_dense_mid_chirp", shape=shape, n=n, M=mk,
             ms_by_cols_per_tile=cols_ms, chosen=kfft.radix_mid_cols(mk, nb, cols,
                                                                     kfft.num_sms(dev)),
             dense_ms=cuda_ms(lambda: krfft.c2r_dense_launch(sp, y, n, 1.0 / n), reps),
             torch_fft_ms=cuda_ms(lambda: torch.fft.irfft(sp, n=n, dim=1), reps),
             device_ms=graph_ms(lambda: krfft.c2r_dense_mid(sp, n, 1.0 / n)),
             dense_device_ms=graph_ms(lambda: krfft.c2r_dense_launch(sp, y, n, 1.0 / n)),
             torch_fft_device_ms=graph_ms(lambda: torch.fft.irfft(sp, n=n, dim=1)), card=card)
        del sp, y
    for t, h in ((128 * 128, 131), (128 * 128, 251)):
        x = randn(t, 2 * h)
        y = torch.empty((t, h + 1), dtype=torch.complex64, device=dev)
        mk = kfft.chirp_m(h)
        rows_ms = {c: cuda_ms(lambda: krfft.r2c_blue_rows_launch(x, y, c), reps)
                   for c in (1, 2, 4, 8, 16, 32) if tile16_fits(mk, c)}
        emit(phase="time", kernel="r2c_packed_dense_chirp", shape=(t, 2 * h), M=mk,
             ms_by_rows_per_tile=rows_ms, chosen=krfft.packed_blue_rows(mk, t, kfft.num_sms(dev)),
             torch_fft_ms=cuda_ms(lambda: torch.fft.rfft(x, dim=1), reps),
             device_ms=graph_ms(lambda: krfft.r2c_packed_dense(x)),
             torch_fft_device_ms=graph_ms(lambda: torch.fft.rfft(x, dim=1)), card=card)
        del x, y
    # kernels 21 and 27 on the radix column tile at their main shapes with
    # each column count C that fits (the wrappers take rfft.py::
    # c2r_dense_cols's and dct.py::dct_radix_cols's)
    for shape, n in (((1, 129, 256 * 256), 256), ((1, 133, 264), 264), ((1, 65, 128), 128),
                     ((1, 65, 256 * 256), 129), ((1, 128, 128 * 256), 255)):
        nb, m, cols = shape
        sp = crandn(*shape)
        y = torch.empty((nb, n, cols), device=dev)
        cols_ms = {c: cuda_ms(lambda: krfft.c2r_dense_radix_launch(sp, y, n, 1.0 / n, c), reps)
                   for c in (1, 2, 4, 8, 16, 32, 64) if tile_fits(krfft.r2c_mid_len(n), c)}
        emit(phase="time", kernel="c2r_dense_mid_radix", shape=shape, n=n,
             ms_by_cols_per_tile=cols_ms,
             chosen=krfft.c2r_dense_cols(n, nb, cols, kfft.num_sms(dev)), card=card)
        del sp, y
    for shape, types in (((1, 512, 512 * 512), (2, 3)), ((1024, 1024, 1024), (2, 3)),
                         ((129, 129, 129), (1,)), ((1, 1025, 1025), (1,))):
        nb, n, cols = shape
        x = randn(*shape)
        y = torch.empty_like(x)
        for t in types:
            cols_ms = {c: cuda_ms(lambda: kdct.dct_radix_launch(x, y, t, 2.0, c),
                                  5 if x.numel() > 1 << 28 else reps)
                       for c in (1, 2, 4, 8, 16, 32, 64) if tile_fits(kdct.dct_radix_len(n, t), c)}
            emit(phase="time", kernel="dct_dense_mid_radix", shape=shape, dct_type=t,
                 ms_by_cols_per_tile=cols_ms,
                 chosen=kdct.dct_radix_cols(n, t, nb, cols, kfft.num_sms(dev)), card=card)
        del x, y
        torch.cuda.empty_cache()
    # kernel 1 on the radix column tile at its main shapes with each column
    # count C that fits, and at C <= 2 with each load ("_ldg": read-only;
    # the wrapper takes fft.py::axis_mid_tile's), beside torch.fft.fft
    for shape in ((1, 512, 512 * 257), (1024, 1024, 513), (768, 768, 385), (1, 2048, 65536),
                  (1, 4096, 4096), (1, 8192, 2048), (1, 20480, 130)):
        nb, n, cols = shape
        x = crandn(*shape)
        y = torch.empty_like(x)
        cols_ms = {f"{c}{'_ldg' if ldg else ''}": cuda_ms(
            lambda: kfft.mid_radix_launch(x, y, -1, 1.0, c, ldg), reps)
            for c in (1, 2, 4, 8, 16) if tile_fits(n, c)
            for ldg in ((False, True) if c <= 2 else (False,))}
        c, ldg = kfft.axis_mid_tile(n, nb, cols, kfft.num_sms(dev))
        emit(phase="time", kernel="c2c_axis_mid", shape=shape, ms_by_cols_per_tile=cols_ms,
             chosen=f"{c}{'_ldg' if ldg else ''}",
             torch_fft_ms=cuda_ms(lambda: torch.fft.fft(x, dim=1), reps), card=card)
        del x, y
    torch.cuda.empty_cache()
    # kernel 18 at the Dirichlet solve's two shapes and at h = 1536 with
    # each column count C that fits (the wrapper takes
    # rfft.py::packed_mid_cols's)
    for shape in ((n9, n9 + 1, n9), (1, n9 + 1, n9 * n9), (1, 1536, 1535)):
        nb, h, cols = shape
        xe, xo = randn(*shape), randn(*shape)
        y = torch.empty((nb, h + 1, cols), dtype=torch.complex64, device=dev)
        cols_ms = {c: cuda_ms(lambda: krfft.r2c_packed_mid_launch(xe, xo, y, -1.0, c), reps)
                   for c in (1, 2, 4, 8, 16, 32) if tile_fits(h, c)}
        emit(phase="time", kernel="r2c_packed_mid", shape=shape, ms_by_cols_per_tile=cols_ms,
             chosen=krfft.packed_mid_cols(h, nb, cols, kfft.num_sms(dev)), card=card)
        del xe, xo, y
    torch.cuda.empty_cache()
    # kernel 3 on the radix row core at its three main shapes with each
    # count of rows a block that fits (the wrapper takes fft.py::
    # radix_block's), and kernel 17 on the radix column tile at its main
    # shapes with each column count C that fits (the wrapper takes
    # rfft.py::c2r_mid_cols's), beside torch.fft.irfft
    for shape, counts in (((512 * 512, 257), (1, 2, 4, 8, 16)),
                          ((768 * 768, 385), (1, 2, 3, 4, 6, 8, 10)),
                          ((n_b, n_b // 2 + 1), (1,))):
        t, m = shape
        n = 2 * (m - 1)
        sp = crandn(t, m)
        rows_ms = {r: cuda_ms(lambda: krfft.c2r_radix_launch(sp, n, 1.0 / n, r), reps)
                   for r in counts}
        emit(phase="time", kernel="c2r_nat", shape=shape, ms_by_rows_per_block=rows_ms,
             chosen=kfft.radix_block(n // 2, t, kfft.num_sms(dev)),
             torch_fft_ms=cuda_ms(lambda: torch.fft.irfft(sp, n=n, dim=1), reps), card=card)
        del sp
        torch.cuda.empty_cache()
    for shape in ((1, 257, 512 * 512), (512, 257, 512), (1, 641, 1280)):
        nb, m, cols = shape
        n = 2 * (m - 1)
        sp = crandn(*shape)
        y = torch.empty((nb, n, cols), device=dev)
        cols_ms = {c: cuda_ms(lambda: krfft.c2r_mid_radix_launch(sp, y, n, 1.0 / n, c), reps)
                   for c in (1, 2, 4, 8, 16, 32) if tile_fits(n // 2, c)}
        emit(phase="time", kernel="c2r_mid", shape=shape, ms_by_cols_per_tile=cols_ms,
             chosen=krfft.c2r_mid_cols(n // 2, nb, cols, kfft.num_sms(dev)),
             torch_fft_ms=cuda_ms(lambda: torch.fft.irfft(sp, n=n, dim=1), reps), card=card)
        del sp, y
    torch.cuda.empty_cache()
    for grid_shape, x in c2c_inputs.items():
        hs = [nd.FftHandler(n) for n in grid_shape]
        torch.cuda.reset_peak_memory_stats()
        t_port = cuda_ms(lambda: ifftn_all(fftn_all(x, hs), hs), reps, 2)
        peak = torch.cuda.max_memory_allocated()
        t_torch = cuda_ms(lambda: torch.fft.ifftn(torch.fft.fftn(x)), reps, 2)
        emit(phase="time", c2c_fftn_ifftn=list(grid_shape), ms=t_port,
             torch_fft_ms=t_torch, peak_bytes=peak, card=card)
    del c2c_inputs
    for n, x in fft2d_inputs.items():
        h = nd.FftHandler(n)
        t_port = cuda_ms(lambda: nd.ndfft(x, h, axis=0), reps)
        t_torch = cuda_ms(lambda: torch.fft.fft(x, dim=0), reps)
        emit(phase="time", fft2d_axis0=[n, n], ms=t_port, torch_fft_ms=t_torch, card=card)
    del fft2d_inputs
    torch.cuda.empty_cache()

    # the middle-axis R2C/C2R kernels (kernels 20 and 21 on the radix column
    # tile as r2c_dense_mid_radix and c2r_dense_mid_radix, at 262 = 2 * 131
    # on their dense products, and kernel 21 at 129 = 3 * 43 on its dense
    # product, where fft.dense_beats_radix holds), the real-axis-first
    # steps and rfft2d
    for r2c_name, c2r_name, r2c, c2r, shapes in (
            ("r2c_mid", "c2r_mid", krfft.r2c_mid, krfft.c2r_mid,
             ((1, 512, 512), (1, 1024, 1024), (512, 512, 512), (1, 512, 512 * 512))),
            ("r2c_dense_mid", "c2r_dense_mid", krfft.r2c_dense_mid, krfft.c2r_dense_mid,
             ((1, 128, 128), (1, 264, 264), (1, 256, 256 * 256), (1, 129, 256 * 256),
              (1, 255, 128 * 256), (1, 262, 256 * 256), (1, 131, 256 * 256), (1, 1094, 7668),
              (1, 1097, 7647)))):
        for nb, n, cols in shapes:
            x = randn(nb, n, cols)
            sp = crandn(nb, n // 2 + 1, cols)
            name, r2c_plain = r2c_form(r2c_name, n)
            time_kernel(name, (nb, n, cols), lambda: r2c(x), lambda: r2c_plain(x),
                        lambda: torch.fft.rfft(x, dim=1))
            name, c2r_plain = c2r_form(c2r_name, n)
            time_kernel(name, (nb, n // 2 + 1, cols), lambda: c2r(sp, n, 1.0 / n),
                        lambda: c2r_plain(sp, n, 1.0 / n),
                        lambda: torch.fft.irfft(sp, n=n, dim=1), n=n)
    del x, sp
    for n, x in first_inputs.items():
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)
        torch.cuda.reset_peak_memory_stats()
        t_port = cuda_ms(lambda: inv_first(fwd_first(x, hr, hc), hr, hc), reps, 2)
        peak = torch.cuda.max_memory_allocated()
        t_torch = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x, dim=(1, 2, 0)),
                                                   s=x.shape[1:] + x.shape[:1],
                                                   dim=(1, 2, 0)), reps, 2)
        emit(phase="time", step_real_axis_first=[n, n, n], ms=t_port, torch_fft_ms=t_torch,
             peak_bytes=peak, card=card)
    del first_inputs
    # kernel 15 and the real-axis-last steps; its dense rows' wrapper on the
    # radix row core at h = 64 and 100 and on the dense product at h = 131
    for name, kern, plain, shapes in (
            ("r2c_packed", krfft.r2c_packed, krfft.r2c_packed_plain,
             ((256 * 256, 256), (129 * 129, 256), (1025, 2048))),
            ("r2c_packed_dense", krfft.r2c_packed_dense, None,
             ((128 * 128, 128), (200, 200), (128 * 128, 262), (128 * 128, 502),
              (128 * 128, 62)))):
        for shape in shapes:
            x = randn(*shape)
            if kern is krfft.r2c_packed_dense:
                name, plain = packed_form(shape[1] // 2)
            time_kernel(name, shape, lambda: kern(x), lambda: plain(x),
                        lambda: torch.fft.rfft(x, dim=1))
    del x
    # kernel 8 on the radix core, the generic schedule (kernel 6), and the
    # 600^3 step among the real-axis-last steps
    for name, kern, plain, shapes in (
            ("c2c_generic_rows", kfft.c2c_generic_rows, kfft.c2c_generic_rows_plain,
             ((600 * 600, 600), (264, 264), (2000, 1000))),
            ("c2c_generic_mid", kfft.c2c_generic_mid, kfft.c2c_generic_mid_plain,
             ((600, 600, 301), (1, 600, 600 * 301), (1, 1200, 256)))):
        for shape in shapes:
            x = crandn(*shape)
            dim = -1 if len(shape) == 2 else 1
            time_kernel(name, shape, lambda: kern(x, -1), lambda: plain(x, -1),
                        lambda: torch.fft.fft(x, dim=dim))
        del x
    # kernel 6 at the 600^3 step's two shapes with each column count C
    for shape in ((600, 600, 301), (1, 600, 600 * 301)):
        x = crandn(*shape)
        y = torch.empty_like(x)
        cols_ms = {c: cuda_ms(lambda: kfft.mid_radix_launch(x, y, -1, 1.0, c), reps)
                   for c in (1, 2, 4, 8)}
        emit(phase="time", kernel="c2c_generic_mid", shape=shape, ms_by_cols_per_tile=cols_ms,
             chosen=kfft.radix_mid_cols(600, shape[0], shape[2], kfft.num_sms(dev)), card=card)
        del x, y
    for shape in ((600 * 600, 600), (530, 530)):
        x = randn(*shape)
        time_kernel("r2c_packed_generic", shape, lambda: krfft.r2c_packed_generic(x),
                    lambda: krfft.r2c_packed_generic_plain(x), lambda: torch.fft.rfft(x, dim=1))
    del x
    torch.cuda.empty_cache()
    last_inputs[n6] = x600
    for n, x in last_inputs.items():
        hr, hc = nd.R2cFftHandler(n), nd.FftHandler(n)
        torch.cuda.reset_peak_memory_stats()
        t_port = cuda_ms(lambda: inv3(fwd3(x, hr, hc), hr, hc), reps, 2)
        peak = torch.cuda.max_memory_allocated()
        t_torch = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x), s=x.shape), reps, 2)
        emit(phase="time", step_real_axis_last=[n, n, n], ms=t_port, torch_fft_ms=t_torch,
             peak_bytes=peak, card=card)
        # where the step's time goes: each public call on its own input, and
        # the C2R's two parts (the Hermitian extension, then K8)
        a = nd.ndfft_r2c(x, hr, axis=2)
        b = nd.ndfft(a, hc, axis=1)
        v = nd.ndfft(b, hc, axis=0)
        w0 = nd.ndifft(v, hc, axis=0)
        w = nd.ndifft(w0, hc, axis=1)
        e = engine.hermitian_extension(w, n).reshape(-1, n)
        k8 = kfft.c2c_dense_rows if n <= 256 else kfft.c2c_generic_rows
        legs = {"r2c_axis2": lambda: nd.ndfft_r2c(x, hr, axis=2),
                "fft_axis1": lambda: nd.ndfft(a, hc, axis=1),
                "fft_axis0": lambda: nd.ndfft(b, hc, axis=0),
                "ifft_axis0": lambda: nd.ndifft(v, hc, axis=0),
                "ifft_axis1": lambda: nd.ndifft(w0, hc, axis=1),
                "c2r_axis2": lambda: nd.ndifft_r2c(w, hr, axis=2),
                "c2r_extension": lambda: engine.hermitian_extension(w, n),
                "c2r_k8": lambda: k8(e, +1, 1.0 / n)}
        leg_ms = {k: cuda_ms(f, reps) for k, f in legs.items()}
        emit(phase="time", breakdown=f"step_real_axis_last_{n}^3", step_ms=t_port,
             legs_ms=leg_ms, sum_public_ms=sum(leg_ms[k] for k in list(legs)[:6]),
             card=card)
        del a, b, v, w0, w, e
    del last_inputs, x600
    for n, x in rfft2d_inputs.items():
        h = nd.R2cFftHandler(n)
        t_port = cuda_ms(lambda: nd.ndfft_r2c(x, h, axis=0), reps)
        t_torch = cuda_ms(lambda: torch.fft.rfft(x, dim=0), reps)
        emit(phase="time", rfft2d_axis0=[n, n], ms=t_port, torch_fft_ms=t_torch, card=card)
    del rfft2d_inputs
    torch.cuda.empty_cache()

    # kernel 1 on the radix column tile and kernels 10, 2, 3 and 15 on the
    # radix row core at the wide core's F: each kernel
    # at the paths' shapes (phase 4g), the 768^3 step with each public call
    # timed alone, and the 4096^2 round trip
    for name, kern, plain, dim, shapes in (
            ("c2c_axis_mid", kfft.c2c_axis_mid, kfft.c2c_axis_mid_plain, 1,
             ((768, 768, 385), (1, 768, 295680), (1, 4096, 4096), (1, 4096, 2049))),
            ("c2c_rows", kfft.c2c_rows, kfft.c2c_rows_plain, -1,
             ((4096, 4096), (1536, 768), (128, 20480)))):
        for shape in shapes:
            x = crandn(*shape)
            time_kernel(name, shape, lambda: kern(x, -1), lambda: plain(x, -1),
                        lambda: torch.fft.fft(x, dim=dim))
        del x
    for t, n in ((768 * 768, 768), (128, 40960)):
        x = randn(t, n)
        sp = crandn(t, n // 2 + 1)
        time_kernel("r2c_nat", (t, n), lambda: krfft.r2c_nat(x),
                    lambda: krfft.r2c_nat_plain(x), lambda: torch.fft.rfft(x, dim=1))
        time_kernel("c2r_nat", (t, n // 2 + 1), lambda: krfft.c2r_nat(sp, n, 1.0 / n),
                    lambda: krfft.c2r_nat_plain(sp, n, 1.0 / n),
                    lambda: torch.fft.irfft(sp, n=n, dim=1))
        del x, sp
    x = randn(769, 1536)
    time_kernel("r2c_packed", (769, 1536), lambda: krfft.r2c_packed(x),
                lambda: krfft.r2c_packed_plain(x), lambda: torch.fft.rfft(x, dim=1))
    del x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: inv3(fwd3(x768, h768r, h768c), h768r, h768c), reps, 2)
    peak = torch.cuda.max_memory_allocated()
    t_torch = cuda_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x768), s=x768.shape), reps, 2)
    emit(phase="time", step_real_axis_last=[n7] * 3, ms=t_port, torch_fft_ms=t_torch,
         peak_bytes=peak, card=card)
    a = nd.ndfft_r2c(x768, h768r, axis=2)
    b = nd.ndfft(a, h768c, axis=1)
    v = nd.ndfft(b, h768c, axis=0)
    w0 = nd.ndifft(v, h768c, axis=0)
    w = nd.ndifft(w0, h768c, axis=1)
    legs = {"r2c_axis2": lambda: nd.ndfft_r2c(x768, h768r, axis=2),
            "fft_axis1": lambda: nd.ndfft(a, h768c, axis=1),
            "fft_axis0": lambda: nd.ndfft(b, h768c, axis=0),
            "ifft_axis0": lambda: nd.ndifft(v, h768c, axis=0),
            "ifft_axis1": lambda: nd.ndifft(w0, h768c, axis=1),
            "c2r_axis2": lambda: nd.ndifft_r2c(w, h768r, axis=2)}
    leg_ms = {k: cuda_ms(f, reps) for k, f in legs.items()}
    emit(phase="time", breakdown=f"step_real_axis_last_{n7}^3", step_ms=t_port,
         legs_ms=leg_ms, sum_public_ms=sum(leg_ms.values()), card=card)
    del a, b, v, w0, w, x768
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: ifft2_first_last(fft2_last_first(x4k, h4k), h4k), reps, 2)
    peak = torch.cuda.max_memory_allocated()
    t_torch = cuda_ms(lambda: torch.fft.ifftn(torch.fft.fftn(x4k)), reps, 2)
    emit(phase="time", c2c_fftn_ifftn=[4096, 4096], ms=t_port, torch_fft_ms=t_torch,
         peak_bytes=peak, card=card)
    # where the round trip's time goes: each public call alone (K10 on the
    # radix core along axis 1, K1 wide along axis 0)
    y1 = nd.ndfft(x4k, h4k, axis=1)
    y0 = nd.ndfft(y1, h4k, axis=0)
    w0 = nd.ndifft(y0, h4k, axis=0)
    legs = {"fft_axis1": lambda: nd.ndfft(x4k, h4k, axis=1),
            "fft_axis0": lambda: nd.ndfft(y1, h4k, axis=0),
            "ifft_axis0": lambda: nd.ndifft(y0, h4k, axis=0),
            "ifft_axis1": lambda: nd.ndifft(w0, h4k, axis=1)}
    leg_ms = {k: cuda_ms(f, reps) for k, f in legs.items()}
    emit(phase="time", breakdown="c2c_fftn_ifftn_4096^2", round_trip_ms=t_port, legs_ms=leg_ms,
         sum_public_ms=sum(leg_ms.values()), card=card)
    del x4k, y1, y0, w0
    torch.cuda.empty_cache()
    # the Bluestein lengths along the last axis (phase 4j): the lane's
    # chirp-z, its two sub-FFTs of length M on kernel 10's radix core
    # (M = 384 at n = 131, M = 4608 at n = 2049), against torch.fft.fft
    for n in (131, 2049):
        x = crandn(256, n)
        t_port = cuda_ms(lambda: nd.ndfft(x, axis=1), reps)
        t_torch = cuda_ms(lambda: torch.fft.fft(x, dim=1), reps)
        emit(phase="time", blue_lane=[256, n], ms=t_port, torch_fft_ms=t_torch, card=card)
    del x

    def yardstick_pair(x):
        f = makhoul_dct(makhoul_dct(x, 1, 2), 0, 2)
        return makhoul_dct(makhoul_dct(f, 0, 3), 1, 3) / (2 * 1024) ** 2

    # kernels 16 and 17 at F = 3 and 5 (the radix column tile), kernels 24
    # to 26 on the radix cores at phase 4h's shapes (the DCT kernels at
    # 1536^3 were timed there);
    # K16/K17's yardstick is torch.fft.rfft / irfft along the axis, the DCTs
    # have no single PyTorch call
    for n in (768, 1280):
        x = randn(1, n, n)
        sp = crandn(1, n // 2 + 1, n)
        time_kernel("r2c_mid", (1, n, n), lambda: krfft.r2c_mid(x),
                    lambda: krfft.r2c_mid_plain(x), lambda: torch.fft.rfft(x, dim=1))
        time_kernel("c2r_mid", (1, n // 2 + 1, n), lambda: krfft.c2r_mid(sp, n, 1.0 / n),
                    lambda: krfft.c2r_mid_plain(sp, n, 1.0 / n),
                    lambda: torch.fft.irfft(sp, n=n, dim=1))
        del x, sp
    for name, kern, plain, shapes in (
            ("dct3_nat_radix", kdct.dct3_nat, kdct.dct3_nat_plain, ((128, 128), (384, 384))),
            ("dct2_mid_radix", kdct.dct2_mid, kdct.dct2_mid_plain, ((1, 2048, 2048),
                                                                    (1, 1152, 1152))),
            ("dct3_mid_radix", kdct.dct3_mid, kdct.dct3_mid_plain, ((1, 2048, 2048),
                                                                    (1, 1152, 1152)))):
        for shape in shapes:
            x = randn(*shape)
            time_kernel(name, shape, lambda: kern(x, 2.0), lambda: plain(x, 2.0))
            del x
    # kernel 18 (the radix column tile) at h = 1536 and kernels 19 and 28's
    # single pass at phase 4i's lengths (K18, K19 and K28 at the solves'
    # shapes were timed there), kernel 28's remnant on the wide core (prime
    # F = 131) and in the long form (163); K18's yardstick is
    # torch.fft.rfft of the interleaved column
    xe, xo = randn(1, 1536, 1535), randn(1, 1536, 1535)
    col = torch.stack([xe, xo], dim=2).reshape(1, 3072, 1535)
    time_kernel("r2c_packed_mid", (1, 1536, 1535),
                lambda: krfft.r2c_packed_mid(xe, xo, -1.0),
                lambda: krfft.r2c_packed_mid_plain(xe, xo, -1.0),
                lambda: torch.fft.rfft(col, dim=1))
    del xe, xo, col
    for name, kern, plain, shape, scale in (
            ("dct1_mid", krfft.dct1_mid, krfft.dct1_mid_plain, (1, 1537, 1537), 1.0),
            ("dct4_mid_radix", kdct.dct4_mid, kdct.dct4_mid_plain, (1, 1536, 1536), 2.0),
            ("dct4_mid_wide", kdct.dct4_mid, kdct.dct4_mid_plain, (1, 256 * 131, 1024), 2.0),
            ("dct4_mid_long", kdct.dct4_mid, kdct.dct4_mid_plain, (1, 256 * 163, 1024), 2.0)):
        x = randn(*shape)
        time_kernel(name, shape, lambda: kern(x, scale), lambda: plain(x, scale))
        del x
    # kernel 11 at phase 4j's length 1031 (F = 17; at the main paths' shapes
    # it and kernel 12 were timed there), then at each column count C the
    # tile allows at 1031 (M = 2176: the wrapper's choice is C = 1), at the
    # 509^3 round trip's shapes (M = 1024: C = 2) and at 251 and 1021
    # (M = 512, 2048: C = 4, 2), and kernel 12 at each column count C the
    # tile allows at the 2049^2 x 256 solve's shapes (M = 4608)
    x = crandn(1, 1031, 1024)
    time_kernel("c2c_blue_mid", (1, 1031, 1024), lambda: kfft.c2c_blue_mid(x, -1),
                lambda: kfft.c2c_blue_mid_plain(x, -1), lambda: torch.fft.fft(x, dim=1))
    del x
    for shape in ((1, 1031, 1024), (1, 509, 509 * 509), (509, 509, 509), (1, 251, 1 << 18),
                  (1, 1021, 1 << 17)):
        x = crandn(*shape)
        y = torch.empty_like(x)
        mk = kfft.blue_kernel_M(shape[1])
        a, h = kfft._device_blue(shape[1], -1, dev)
        cols_ms = {c: cuda_ms(lambda: kfft.blue_radix_launch(x, y, a, h, 1.0, c), reps)
                   for c in (1, 2, 4, 8) if tile_fits(mk, c)}
        emit(phase="time", kernel="c2c_blue_mid", shape=shape, ms_by_cols_per_tile=cols_ms,
             chosen=kfft.blue_radix_cols(mk, shape[0], shape[2], kfft.num_sms(dev)), card=card)
        del x, y
    for shape in ((1, 2049, 2049 * 256), (2049, 2049, 256)):
        x = randn(*shape)
        y = torch.empty_like(x)
        mk = kfft.chirp_m(shape[1])
        cols_ms = {c: cuda_ms(lambda: kdct.dct23_blue_launch(x, y, 2, 2.0, c), 5)
                   for c in (1, 2, 4, 8) if tile_fits(mk, c)}
        emit(phase="time", kernel="dct23_blue_mid", shape=shape, M=mk,
             ms_by_cols_per_tile=cols_ms,
             chosen=kdct.dct23_blue_cols(mk, shape[0], shape[2], kfft.num_sms(dev)), card=card)
        del x, y
        torch.cuda.empty_cache()
    # kernel 7's dense remnant at the prime n1 = 131 over (8, 131, 8192) (the
    # split of 1073152, whose plan is Bluestein's: no main path sends it);
    # then kernels 7 and 13 at the main
    # paths' shapes (timed through their wrappers in phase 4k) by tile:
    # kernel 7 with each column count C that fits (at C <= 2 with each load;
    # the form that stores from the last stage at the 16-element tiles),
    # kernel 13 with each count of rows a block that the row skeleton
    # holds, each output held against the wrapper's
    x = crandn(8, 131, 8192)
    time_kernel("fourstep_mid_dense", (8, 131, 8192), lambda: kfft.fourstep_mid(x, -1),
                lambda: kfft.fourstep_mid_plain(x, -1))
    del x
    sms = kfft.num_sms(dev)

    def scan_check(name, got, want, tile):
        rel = abs_err(got, want) / float(want.abs().max())
        if not rel <= TOL_KERNEL:
            raise AssertionError(f"{name} {tuple(want.shape)} tile {tile}: {rel}")

    for shape in ((256, 1024, 1024), (16385, 256, 128)):
        nb, n1, n2 = shape
        x = crandn(*shape)
        want = kfft.fourstep_mid(x, -1)
        tw = kfft.device_fourstep_tw(n1, n2, -1, dev)
        y = torch.empty_like(x)
        cols_ms = {}
        for c in (1, 2, 4, 8, 16, 32):
            for ldg in (False, True):
                if not tile_fits(n1, c) or ldg and c > 2:
                    continue
                key = f"{c}_ldg" if ldg else str(c)
                cols_ms[key] = cuda_ms(lambda: kfft.fourstep_launch(x, y, -1, tw, c, ldg), 5)
                scan_check("fourstep_mid_radix", y, want, key)
        emit(phase="time", kernel="fourstep_mid_radix", shape=shape, ms_by_cols_per_tile=cols_ms,
             chosen=list(kfft.axis_mid_tile(n1, nb, n2, sms)), card=card)
        del y, want
        scale = 1.0 / (n1 * n2)
        want = kfft.rows_store_t(x, +1, scale)
        y = torch.empty_like(want)
        tr = -(-n2 // 16)
        most = 1 if n2 > kfft.RADIX_WIDE_N else min(32, kfft.RADIX_MAX_THREADS // tr)
        rows_ms = {}
        for rows in range(1, most + 1):
            rows_ms[rows] = cuda_ms(lambda: kfft.rows_store_t_launch(x, y, +1, scale, rows), 5)
            scan_check("rows_store_t", y, want, rows)
        emit(phase="time", kernel="rows_store_t", shape=shape, ms_by_rows_per_block=rows_ms,
             chosen=kfft.store_t_rows(n2, nb * n1, sms), card=card)
        del x, y, want
        torch.cuda.empty_cache()
    # kernels 14 and 22 on the radix column tile at each column count C = 1
    # ... 16 that fits (at C <= 2 with both loads), beside the count that
    # the wrappers take (fft.py::axis_mid_tile, rfft.py::spectral_cols):
    # K14 at S1's (1, 1024, 525312) with its lane-varying real G and at
    # (8, 1280, 8192) with a broadcast one, K22 at S2's (1, 1024, 1048576)
    # and (1024, 1024, 1024) with the broadcast gain and at (8, 768, 16384)
    for name, shape, hcols in (("spectral_c2c_mid", (1, 1024, 1024 * 513), 1024 * 513),
                               ("spectral_c2c_mid", (8, 1280, 8192), 1),
                               ("spectral_r2c_mid", (1, 1024, 1024 * 1024), 1),
                               ("spectral_r2c_mid", (1024, 1024, 1024), 1),
                               ("spectral_r2c_mid", (8, 768, 16384), 1)):
        nb, n, cols = shape
        k14 = name == "spectral_c2c_mid"
        x = crandn(*shape) if k14 else randn(*shape)
        y = torch.empty_like(x)
        length = n if k14 else n // 2
        hr = randn(length if k14 else length + 1, hcols)
        runs = 5 if x.numel() > 1 << 28 else reps

        def launch(c, ldg):
            if k14:
                return lambda: kfft.spectral_c2c_launch(x, y, hr, None, 1.0 / n, c, ldg)
            return lambda: krfft.spectral_r2c_launch(x, y, hr, None, n, 1.0 / n, c, ldg)

        cols_ms = {c: cuda_ms(launch(c, False), runs) for c, ldg in scan_cols
                   if not ldg and tile_fits(length, c)}
        ldg_ms = {c: cuda_ms(launch(c, True), runs) for c in (1, 2) if c in cols_ms}
        if k14:
            chosen, chosen_ldg = kfft.axis_mid_tile(n, nb, cols, sms)
        else:
            chosen = krfft.spectral_cols(length, nb, cols, sms)
            chosen_ldg = chosen <= 2
        emit(phase="time", kernel=name, shape=shape, h_cols=hcols, ms_by_cols=cols_ms,
             read_only_load_ms_by_cols=ldg_ms, chosen=chosen, chosen_read_only=chosen_ldg,
             card=card)
        del x, y, hr
        torch.cuda.empty_cache()
    # kernel 29's remnant forms, which the main paths do not take, with a
    # broadcast real multiplier: the wide half form at F = 131 (n = 128 *
    # 262) and the n-point form at k = 131
    for name, shape in (("spectral_dct_mid_wide", (1, 128 * 262, 2048)),
                        ("spectral_dct_mid_npoint", (1, 128 * 131, 4096))):
        x = randn(*shape)
        n = shape[1]
        hv = randn(n, 1)
        time_kernel(name, shape, lambda: kdct.spectral_dct_mid(x, hv, 2.0, 1.0 / n),
                    lambda: kdct.spectral_dct_mid_plain(x, hv, 2.0, 1.0 / n))
        del x, hv
    torch.cuda.empty_cache()
    t_port = cuda_ms(lambda: dct_pair(xp), reps)
    t_yard = cuda_ms(lambda: yardstick_pair(xp), reps)
    emit(phase="time", dct_pair=[1024, 1024], ms=t_port, torch_fft_makhoul_ms=t_yard,
         card=card)
    torch.cuda.reset_peak_memory_stats()
    t_port = cuda_ms(lambda: poisson(f3), reps, 2)
    peak = torch.cuda.max_memory_allocated()
    t_yard = cuda_ms(lambda: yardstick_poisson(f3), reps, 2)
    emit(phase="time", poisson=[n3, n3, n3], ms=t_port, torch_fft_makhoul_ms=t_yard,
         peak_bytes=peak, card=card)

    sources = {
        "c2c_axis_mid": ("ndrustfft_tpu_torch/csrc/fft_mid_radix.cu",
                         "ndrustfft_tpu/ops/pallas/fft.py:1124"),
        "r2c_nat": ("ndrustfft_tpu_torch/csrc/rfft_radix.cu",
                    "ndrustfft_tpu/ops/pallas/rfft.py:242"),
        "c2r_nat": ("ndrustfft_tpu_torch/csrc/rfft_radix.cu",
                    "ndrustfft_tpu/ops/pallas/rfft.py:323"),
        "dct_dense_mid": ("ndrustfft_tpu_torch/csrc/dct_dense.cu",
                          "ndrustfft_tpu/ops/pallas/dct.py:545"),
        "dct_dense_mid_radix": ("ndrustfft_tpu_torch/csrc/dct_mid_radix.cu",
                                "ndrustfft_tpu/ops/pallas/dct.py:545"),
        "dct2_nat_radix": ("ndrustfft_tpu_torch/csrc/dct_rows_radix.cu",
                           "ndrustfft_tpu/ops/pallas/dct.py:190"),
        "dct3_nat_radix": ("ndrustfft_tpu_torch/csrc/dct_rows_radix.cu",
                           "ndrustfft_tpu/ops/pallas/dct.py:208"),
        "c2c_rows": ("ndrustfft_tpu_torch/csrc/fft_rows_radix.cu",
                     "ndrustfft_tpu/ops/pallas/fft.py:743"),
        "c2c_dense_rows": ("ndrustfft_tpu_torch/csrc/fft_rows_radix.cu",
                           "ndrustfft_tpu/ops/pallas/fft.py:521"),
        "c2c_dense_mid": ("ndrustfft_tpu_torch/csrc/fft_mid_radix.cu",
                          "ndrustfft_tpu/ops/pallas/fft.py:1565"),
        "r2c_mid": ("ndrustfft_tpu_torch/csrc/rfft_mid_radix.cu",
                    "ndrustfft_tpu/ops/pallas/rfft.py:443"),
        "c2r_mid": ("ndrustfft_tpu_torch/csrc/rfft_mid_radix.cu",
                    "ndrustfft_tpu/ops/pallas/rfft.py:470"),
        "r2c_dense_mid": ("ndrustfft_tpu_torch/csrc/rfft_dense.cu",
                          "ndrustfft_tpu/ops/pallas/rfft.py:882"),
        "r2c_dense_mid_radix": ("ndrustfft_tpu_torch/csrc/rfft_mid_radix.cu",
                                "ndrustfft_tpu/ops/pallas/rfft.py:882"),
        "r2c_dense_mid_chirp": ("ndrustfft_tpu_torch/csrc/fft_blue_radix.cu",
                                "ndrustfft_tpu/ops/pallas/rfft.py:882"),
        "c2r_dense_mid": ("ndrustfft_tpu_torch/csrc/rfft_dense.cu",
                          "ndrustfft_tpu/ops/pallas/rfft.py:898"),
        "c2r_dense_mid_radix": ("ndrustfft_tpu_torch/csrc/rfft_mid_radix.cu",
                                "ndrustfft_tpu/ops/pallas/rfft.py:898"),
        "c2r_dense_mid_chirp": ("ndrustfft_tpu_torch/csrc/rfft_blue_radix.cu",
                                "ndrustfft_tpu/ops/pallas/rfft.py:898"),
        "r2c_packed": ("ndrustfft_tpu_torch/csrc/rfft_radix.cu",
                       "ndrustfft_tpu/ops/pallas/rfft.py:163"),
        "r2c_packed_dense_radix": ("ndrustfft_tpu_torch/csrc/rfft_radix.cu",
                                   "ndrustfft_tpu/ops/pallas/rfft.py:163"),
        "r2c_packed_dense_chirp": ("ndrustfft_tpu_torch/csrc/rfft_blue_radix.cu",
                                   "ndrustfft_tpu/ops/pallas/rfft.py:163"),
        "c2c_generic_rows": ("ndrustfft_tpu_torch/csrc/fft_radix.cuh",
                             "ndrustfft_tpu/ops/pallas/fft.py:521"),
        "c2c_generic_mid": ("ndrustfft_tpu_torch/csrc/fft_mid_radix.cu",
                            "ndrustfft_tpu/ops/pallas/fft.py:1794"),
        "r2c_packed_generic": ("ndrustfft_tpu_torch/csrc/rfft_radix.cu",
                               "ndrustfft_tpu/ops/pallas/rfft.py:163"),
        "dct2_nat_wide": ("ndrustfft_tpu_torch/csrc/dct_nat.cu",
                          "ndrustfft_tpu/ops/pallas/dct.py:190"),
        "dct3_nat_wide": ("ndrustfft_tpu_torch/csrc/dct_nat.cu",
                          "ndrustfft_tpu/ops/pallas/dct.py:208"),
        "dct2_nat_npoint": ("ndrustfft_tpu_torch/csrc/dct_nat.cu",
                            "ndrustfft_tpu/ops/pallas/dct.py:190"),
        "dct3_nat_npoint": ("ndrustfft_tpu_torch/csrc/dct_nat.cu",
                            "ndrustfft_tpu/ops/pallas/dct.py:208"),
        "dct2_mid_radix": ("ndrustfft_tpu_torch/csrc/dct_mid_radix.cu",
                           "ndrustfft_tpu/ops/pallas/dct.py:333"),
        "dct3_mid_radix": ("ndrustfft_tpu_torch/csrc/dct_mid_radix.cu",
                           "ndrustfft_tpu/ops/pallas/dct.py:351"),
        "dct2_mid_wide": ("ndrustfft_tpu_torch/csrc/dct_mid.cu",
                          "ndrustfft_tpu/ops/pallas/dct.py:333"),
        "dct3_mid_wide": ("ndrustfft_tpu_torch/csrc/dct_mid.cu",
                          "ndrustfft_tpu/ops/pallas/dct.py:351"),
        "dct2_mid_npoint": ("ndrustfft_tpu_torch/csrc/dct_mid.cu",
                            "ndrustfft_tpu/ops/pallas/dct.py:333"),
        "dct3_mid_npoint": ("ndrustfft_tpu_torch/csrc/dct_mid.cu",
                            "ndrustfft_tpu/ops/pallas/dct.py:351"),
        "r2c_packed_mid": ("ndrustfft_tpu_torch/csrc/rfft_mid_radix.cu",
                           "ndrustfft_tpu/ops/pallas/rfft.py:627"),
        "dct1_mid": ("ndrustfft_tpu_torch/csrc/dct_mid_radix.cu",
                     "ndrustfft_tpu/ops/pallas/rfft.py:724"),
        "dct4_mid_radix": ("ndrustfft_tpu_torch/csrc/dct4_mid_radix.cu",
                           "ndrustfft_tpu/ops/pallas/dct.py:670"),
        "dct4_mid_fourstep": ("ndrustfft_tpu_torch/csrc/dct4_mid_radix.cu",
                              "ndrustfft_tpu/ops/pallas/dct.py:670"),
        "dct4_mid_wide": ("ndrustfft_tpu_torch/csrc/dct4_mid.cu",
                          "ndrustfft_tpu/ops/pallas/dct.py:670"),
        "dct4_mid_long": ("ndrustfft_tpu_torch/csrc/dct4_mid.cu",
                          "ndrustfft_tpu/ops/pallas/dct.py:670"),
        "c2c_blue_mid": ("ndrustfft_tpu_torch/csrc/fft_blue_radix.cu",
                         "ndrustfft_tpu/ops/pallas/fft.py:1277"),
        "dct23_blue_mid": ("ndrustfft_tpu_torch/csrc/dct_blue_radix.cu",
                           "ndrustfft_tpu/ops/pallas/fft.py:1473"),
        "fourstep_mid_radix": ("ndrustfft_tpu_torch/csrc/fft_fourstep.cu",
                               "ndrustfft_tpu/ops/pallas/fft.py:1549"),
        "fourstep_mid_dense": ("ndrustfft_tpu_torch/csrc/fft_dense.cu",
                               "ndrustfft_tpu/ops/pallas/fft.py:1549"),
        "rows_store_t": ("ndrustfft_tpu_torch/csrc/fft_fourstep.cu",
                         "ndrustfft_tpu/ops/pallas/fft.py:1863"),
        "spectral_c2c_mid": ("ndrustfft_tpu_torch/csrc/spectral_c2c_radix.cu",
                             "ndrustfft_tpu/ops/pallas/fft.py:2000"),
        "spectral_r2c_mid": ("ndrustfft_tpu_torch/csrc/spectral_r2c_radix.cu",
                             "ndrustfft_tpu/ops/pallas/rfft.py:1021"),
        "spectral_dct_mid_radix": ("ndrustfft_tpu_torch/csrc/spectral_dct_radix.cu",
                                   "ndrustfft_tpu/ops/pallas/dct.py:779"),
        "spectral_dct_mid_wide": ("ndrustfft_tpu_torch/csrc/spectral_dct_mid.cu",
                                  "ndrustfft_tpu/ops/pallas/dct.py:779"),
        "spectral_dct_mid_npoint": ("ndrustfft_tpu_torch/csrc/spectral_dct_mid.cu",
                                    "ndrustfft_tpu/ops/pallas/dct.py:779"),
    }
    # the real lengths of kernel 21's main spectra (an odd n has the same
    # spectrum length as n - 1)
    main_n = {"c2r_dense_mid": 129, "c2r_dense_mid_chirp": 262}
    kernels = []
    for name, (src, rep) in sources.items():
        t_k, t_plain, t_lib = timing[(name, main_shapes[name])]
        bound_ms, bound_by = bound(*work(name, main_shapes[name], n=main_n.get(name),
                                         mult=spectral_h.get((name, main_shapes[name]))))
        # a wrapper's ``launches`` counts its wide, n-point and dense
        # launches too; a radix-only wrapper's row gives its radix launches
        fixed = launches[name] - sum(launches.get(f"{name}_{f}", 0) for f in FORMS)
        if name in RADIX_ONLY:
            fixed = launches[f"{name}_radix"]
        row = {"name": name, "route": "cuda", "source": src, "replaces": rep,
               "launches": fixed, "max_abs_err": errs[name], "ms": t_k, "plain_ms": t_plain,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t_lib,
               "shape": list(main_shapes[name])}
        if "blue" in name or name.endswith("_chirp"):
            # the work of the chirp-z's two length-M FFTs per column, beside
            # the function's own (the bound above)
            nbytes, m_flops = work(name, main_shapes[name], length_m=True, n=main_n.get(name))
            row["length_m_bound_ms"], row["length_m_bound_by"] = bound(nbytes, m_flops)
        # the same numbers at the shapes of phases 4h, 4i and 4j's main paths
        # and, for the kernels whose other main shapes phase 5 times, at those
        row["solve_shapes"] = [
            dict(zip(("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                     (list(shape), *timing[(name, shape)],
                      *bound(*work(name, shape, mult=spectral_h.get((name, shape)))))))
            for shape in sliced.get(name, ())]
        if name in ("c2c_axis_mid", "r2c_packed_mid", "dct1_mid", "dct4_mid_radix",
                    "c2r_nat", "c2r_mid",
                    "r2c_dense_mid_chirp", "r2c_packed_dense_radix", "r2c_packed_dense_chirp",
                    "dct2_nat_radix", "dct3_nat_radix", "dct2_mid_radix", "dct3_mid_radix"):
            row["other_shapes"] = [
                dict(zip(("shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                         (list(shape), *timing[(nm, shape)], *bound(*work(name, shape)))))
                for nm, shape in timing if nm == name and shape != main_shapes[name]
                and shape not in sliced.get(name, ())]
        if name.startswith("c2r_dense_mid"):
            # kernel 21's other timed spectra with their lengths: the radix
            # column tile at odd n = 255 and two even n, the chirp-z at
            # n = 1094 and the odd 1097, the dense product at n = 131 (odd,
            # no plan)
            other = {"c2r_dense_mid_radix": (((1, 128, 128 * 256), 255), ((1, 133, 264), 264),
                                             ((1, 65, 128), 128)),
                     "c2r_dense_mid_chirp": (((1, 548, 7668), 1094), ((1, 549, 7647), 1097)),
                     "c2r_dense_mid": (((1, 66, 256 * 256), 131),)}[name]
            row["other_shapes"] = [
                dict(zip(("shape", "n", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                         (list(shape), n, *timing[(name, shape)],
                          *bound(*work(name, shape, n=n)))))
                for shape, n in other]
        if name.startswith("dct_dense_mid"):
            # every timed (shape, DCT type), each with its type's bound
            row["by_type"] = [
                dict(zip(("shape", "dct_type", "ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_by"),
                         (list(shape), t, *dct_types[(nm, shape, t)],
                          *bound(*work(name, shape, dct_type=t)))))
                for nm, shape, t in dct_types if nm == name]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
