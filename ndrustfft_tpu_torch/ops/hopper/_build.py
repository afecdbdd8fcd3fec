"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, at first use, under ``build/ndrustfft_tpu_torch/``
at the root of the checkout (or under ``$NDRUSTFFT_TORCH_BUILD_DIR``). The
library's name carries a hash of the sources, so an edited source is
rebuilt. It is loaded with ``ctypes``; every pointer and the stream pass as
``c_void_p``, a scale as ``c_float``.

A missing ``nvcc``, a failed build or a library that does not load raises:
there is no other route for a CUDA tensor. Inside :func:`no_launch` the
loaded library stands behind a stub whose entry points launch nothing, so
that a handler's ``warmup(run=False)`` walks its routes and uploads their
tables without running a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types (see csrc/*.cu)
_SIGNATURES = {
    "ndfft_c2c_dense": [_P, _P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_r2c_dense_mid": [_P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_c2r_dense_mid": [_P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_dct_dense_mid": [_P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_c2c_rows_radix": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _F, _P],
    "ndfft_c2c_mid_radix": [_P, _P, _P, _P, _I, _LL, _I, _LL, _I, _I, _F, _I, _P],
    "ndfft_r2c_radix": [_P, _P, _P, _P, _I, _P, _LL, _I, _I, _P],
    "ndfft_dct2_rows_radix": [_P, _P, _P, _P, _I, _P, _P, _LL, _I, _I, _P],
    "ndfft_dct3_rows_radix": [_P, _P, _P, _P, _I, _P, _P, _LL, _I, _I, _P],
    "ndfft_r2c_mid_radix": [_P, _P, _P, _P, _I, _P, _LL, _I, _LL, _I, _P],
    "ndfft_r2c_packed_mid_radix": [_P, _P, _P, _P, _P, _I, _P, _F, _LL, _I, _LL, _I, _P],
    "ndfft_c2r_radix": [_P, _P, _P, _P, _I, _P, _LL, _I, _I, _P],
    "ndfft_c2r_mid_radix": [_P, _P, _P, _P, _I, _P, _LL, _I, _LL, _I, _P],
    "ndfft_c2r_odd_mid_radix": [_P, _P, _P, _P, _I, _F, _LL, _I, _LL, _I, _P],
    "ndfft_dct_mid_radix": [_I, _P, _P, _P, _P, _I, _P, _P, _F, _LL, _I, _LL, _I, _I, _P],
    "ndfft_dct_nat_wide": [_I, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "ndfft_dct_nat_npoint": [_I, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "ndfft_dct_mid_wide": [_I, _P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_dct_mid_npoint": [_I, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_dct4_mid_radix": [_I, _P, _P, _P, _P, _I, _P, _P, _LL, _I, _LL, _I, _I, _I, _P],
    "ndfft_dct4_mid_wide": [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_dct4_mid_long": [_P, _P, _P, _P, _P, _P, _LL, _I, _LL, _I, _P],
    "ndfft_c2c_blue_radix": [_P] * 6 + [_I, _LL, _I, _I, _LL, _I, _F, _P],
    "ndfft_r2c_blue_radix": [_P] * 7 + [_I, _LL, _I, _I, _LL, _I, _P],
    "ndfft_c2r_blue_radix": [_P] * 7 + [_I, _F, _LL, _I, _I, _LL, _I, _P],
    "ndfft_r2c_blue_rows": [_P] * 7 + [_I, _LL, _I, _I, _I, _P],
    "ndfft_dct23_blue_radix": [_P] * 7 + [_I, _LL, _I, _I, _LL, _I, _P],
    "ndfft_fourstep_mid": [_P, _P, _P, _P, _I, _P, _LL, _I, _LL, _I, _I, _I, _P],
    "ndfft_rows_store_t": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _F, _P],
    "ndfft_spectral_c2c_radix": ([_P] * 4 + [_LL] + [_P] * 3
                                 + [_I, _LL, _I, _LL, _I, _F, _I, _P]),
    "ndfft_spectral_r2c_radix": ([_P] * 4 + [_LL] + [_P] * 3
                                 + [_I, _P, _P, _LL, _I, _LL, _I, _I, _P]),
    "ndfft_spectral_dct_radix": ([_P] * 3 + [_LL] + [_P] * 2 + [_I] + [_P] * 4
                                 + [_LL, _I, _LL, _I, _I, _P]),
    "ndfft_spectral_dct_mid_wide": [_P] * 3 + [_LL] + [_P] * 8 + [_LL, _I, _LL, _I, _P],
    "ndfft_spectral_dct_mid_npoint": [_P] * 3 + [_LL] + [_P] * 4 + [_LL, _I, _LL, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build in this process, if it built


def build_dir() -> Path:
    env = os.environ.get("NDRUSTFFT_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parent / "build" / "ndrustfft_tpu_torch"


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "ndrustfft_tpu_torch CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    cu, cuh = _sources()
    digest = hashlib.sha256()
    for p in cu + cuh:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libndfft_hopper_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands as parallel processes; (cmd, returncode, output) each."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(cmd, p.returncode, out) for cmd, p, out in zip(cmds, procs, outs)]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. The compilers' output goes to ``nvcc.log`` beside it."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{p.stem}.o" for p in cu]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    results = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                         str(p)] for p, o in zip(cu, objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)]])
    (out.parent / "nvcc.log").write_text("".join(
        " ".join(cmd) + "\n" + text for cmd, _, text in results))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(cmd, rc, text) for cmd, rc, text in results if rc != 0]
    if failed:
        cmd, rc, text = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {cmd[-1]}\n{text[-4000:]}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


class _NoLaunch:
    """The library's entry points as functions that launch nothing and
    return 0 (success)."""

    def __getattr__(self, name):
        if name not in _SIGNATURES:
            raise AttributeError(name)
        return lambda *args: 0


_dry = threading.local()


@contextmanager
def no_launch():
    """Build and load the library, then, in this thread, let every entry
    point launch nothing (the wrappers still upload their tables and
    allocate their outputs)."""
    lib()
    _dry.on = True
    try:
        yield
    finally:
        _dry.on = False


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (inside
    :func:`no_launch`, the stub that launches nothing)."""
    global _lib
    if getattr(_dry, "on", False):
        return _NoLaunch()
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
