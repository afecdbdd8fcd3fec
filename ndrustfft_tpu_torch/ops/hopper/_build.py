"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, under
``build/ndrustfft_tpu_torch/`` at the root of the checkout (or under
``$NDRUSTFFT_TORCH_BUILD_DIR``). The library's name carries a hash of the
sources, so an edited source is rebuilt. It is loaded with ``ctypes``; every
pointer and the stream pass as ``c_void_p``.

A missing ``nvcc``, a failed build or a library that does not load raises:
there is no other route for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points and their argument types (see csrc/*.cu)
_SIGNATURES = {
    "ndfft_c2c_axis_mid": [_P, _P, _P, _LL, _I, _LL, _I, _I, _P],
    "ndfft_r2c_nat": [_P, _P, _P, _P, _LL, _I, _I, _P],
    "ndfft_c2r_nat": [_P, _P, _P, _P, _LL, _I, _I, _P],
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


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path. The compiler's output goes to ``nvcc.log`` beside it."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *[str(p) for p in cu]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "nvcc.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
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
