"""Build and load the port's CUDA kernels (csrc/*.cu) as a ctypes library.

The library is compiled with nvcc on first use into iamr_tpu_torch/_build/,
named by a hash of the source and the flags, so a fresh checkout builds it
once and an edited source rebuilds. There is no fallback: a failed build
raises with nvcc's output. Nothing here runs at import time.

Flags: sm_90a (Hopper), -O3, and -fmad=false so the kernels round op by op
like the plain PyTorch path they are tested against (FMA contraction would
widen the f32 tie-flip band; it is a lever for a faster build later).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "godunov_plm.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LIB = None
BUILD_INFO = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin)")
    return exe


def _build() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libiamr_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        BUILD_INFO.update(path=str(so), seconds=0.0, cached=True, log="")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    BUILD_INFO.update(path=str(so), seconds=secs, cached=False,
                      log=proc.stdout + proc.stderr)
    return so


def kernels():
    """The loaded kernel library (built on first call), argtypes declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build()))
    lib.extrap_plm.argtypes = [ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P]
    lib.extrap_plm.restype = ctypes.c_int
    lib.godunov_plm_multi.argtypes = [
        ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _P, _P, _P, _P, _P, _P,
    ]
    lib.godunov_plm_multi.restype = ctypes.c_int
    _LIB = lib
    return lib
