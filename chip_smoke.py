#!/usr/bin/env python3
"""Smoke test of ndrustfft_tpu_torch on one CUDA card (an H100).

Run from the root of a checkout:  python3 chip_smoke.py [--seed S] [--reps R]

Phases (each prints one JSON line; any failure raises and exits non-zero
without the final line):
  1. require a CUDA device; print the card's name and power limit;
  2. build the CUDA kernels from ndrustfft_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     slice's shapes (ragged column and row tiles included);
  4. the real spectral step through ndfft_r2c / ndfft / ndifft / ndifft_r2c:
     the 512^2 and 1024^2 flagship and a 512^3 grid, against
     torch.fft.rfftn in float64 (oracle only), with the round trip; the
     kernels' launch counters must account for every leg and the torch
     engine must not run;
  5. times with CUDA events (median over --reps runs after warm-up): each
     kernel against its plain version, and the steps against
     torch.fft.rfftn / irfftn.
The line before the last is the card as nvidia-smi names it; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_KERNEL = 5e-6    # kernel vs plain, relative to max |plain| (both float32)
TOL_STEP = 1e-5      # step vs float64 oracle and round trip, relative


def emit(**kw):
    print(json.dumps(kw), flush=True)


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
    from ndrustfft_tpu_torch.ops import engine
    from ndrustfft_tpu_torch.ops.hopper import _build
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
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds, library=lib_path.name,
         max_registers=max(regs, default=None),
         spill_bytes=sum(spills))

    # ---- 3. kernels against their plain versions
    errs = {"c2c_axis_mid": 0.0, "r2c_nat": 0.0, "c2r_nat": 0.0}
    k1_shapes = [(1, 512, 257), (1, 1024, 513), (3, 2048, 130), (512, 512, 257),
                 (1, 512, 512 * 257)]
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

    # ---- 4. the spectral step through the public functions
    def step2(x, hr, hc):
        vhat = nd.ndfft(nd.ndfft_r2c(x, hr, axis=1), hc, axis=0)
        return vhat, nd.ndifft_r2c(nd.ndifft(vhat, hc, axis=0), hr, axis=1)

    def fwd3(x, hr, hc):
        return nd.ndfft(nd.ndfft(nd.ndfft_r2c(x, hr, axis=2), hc, axis=1), hc, axis=0)

    def inv3(v, hr, hc):
        return nd.ndifft_r2c(nd.ndifft(nd.ndifft(v, hc, axis=0), hc, axis=1), hr,
                             axis=2)

    wrappers = {"c2c_axis_mid": kfft.c2c_axis_mid, "r2c_nat": krfft.r2c_nat,
                "c2r_nat": krfft.c2r_nat}
    engine_fns = (engine.c2c, engine.r2c, engine.c2r)
    inputs = {n: randn(n, n) for n in (512, 1024)}
    x3 = randn(512, 512, 512)
    for w in wrappers.values():
        w.launches = 0
    for f in engine_fns:
        f.calls = 0
    outs = {}
    for n, x in inputs.items():
        outs[n] = step2(x, nd.R2cFftHandler(n), nd.FftHandler(n))
    h512r, h512c = nd.R2cFftHandler(512), nd.FftHandler(512)
    v3 = fwd3(x3, h512r, h512c)
    back3 = inv3(v3, h512r, h512c)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    engine_calls = sum(f.calls for f in engine_fns)
    emit(phase="main_path", launches=launches, engine_calls=engine_calls)
    expected = {"c2c_axis_mid": 8, "r2c_nat": 3, "c2r_nat": 3}
    if launches != expected or engine_calls:
        raise AssertionError(f"launches {launches} (expected {expected}), "
                             f"engine calls {engine_calls}")
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

    # ---- 5. times (each kernel against its plain version; steps against torch.fft)
    reps = args.reps
    timing = {}
    main_shapes = {"c2c_axis_mid": (1, 512, 512 * 257), "r2c_nat": (512 * 512, 512),
                   "c2r_nat": (512 * 512, 257)}
    for shape in ((1, 512, 257), (1, 1024, 513), (512, 512, 257), (1, 512, 512 * 257)):
        x = crandn(*shape)
        s = 1.0 / shape[1]
        t_plain = cuda_ms(lambda: kfft.c2c_axis_mid_plain(x, +1, s), reps)
        t_k = cuda_ms(lambda: kfft.c2c_axis_mid(x, +1, s), reps)
        timing[("c2c_axis_mid", shape)] = (t_k, t_plain)
        emit(phase="time", kernel="c2c_axis_mid", shape=shape, ms=t_k,
             plain_ms=t_plain, card=card)
    for t, n in ((512, 512), (1024, 1024), (512 * 512, 512)):
        x = randn(t, n)
        sp = crandn(t, n // 2 + 1)
        t_plain = cuda_ms(lambda: krfft.r2c_nat_plain(x), reps)
        t_k = cuda_ms(lambda: krfft.r2c_nat(x), reps)
        timing[("r2c_nat", (t, n))] = (t_k, t_plain)
        emit(phase="time", kernel="r2c_nat", shape=(t, n), ms=t_k,
             plain_ms=t_plain, card=card)
        t_plain = cuda_ms(lambda: krfft.c2r_nat_plain(sp, n, 1.0 / n), reps)
        t_k = cuda_ms(lambda: krfft.c2r_nat(sp, n, 1.0 / n), reps)
        timing[("c2r_nat", (t, n // 2 + 1))] = (t_k, t_plain)
        emit(phase="time", kernel="c2r_nat", shape=(t, n // 2 + 1), ms=t_k,
             plain_ms=t_plain, card=card)
    del x, sp
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

    sources = {
        "c2c_axis_mid": ("ndrustfft_tpu_torch/csrc/fft_axis_mid.cu",
                         "ndrustfft_tpu/ops/pallas/fft.py:1124"),
        "r2c_nat": ("ndrustfft_tpu_torch/csrc/rfft_nat.cu",
                    "ndrustfft_tpu/ops/pallas/rfft.py:242"),
        "c2r_nat": ("ndrustfft_tpu_torch/csrc/rfft_nat.cu",
                    "ndrustfft_tpu/ops/pallas/rfft.py:323"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        t_k, t_plain = timing[(name, main_shapes[name])]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t_k, "plain_ms": t_plain})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
