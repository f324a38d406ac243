"""Build and load the port's CUDA kernels (csrc/*.cu) as a ctypes library.

The library is compiled with nvcc on first use into iamr_tpu_torch/_build/
(one nvcc per source, run in parallel, then one link), named by a hash of
the sources and the flags, so a fresh checkout builds it once and an
edited source rebuilds. There is no fallback: a failed build
raises with nvcc's output. Nothing here runs at import time.

Flags: sm_90a (Hopper), -O3 and -Xptxas -v for every source (the ptxas
report of registers, shared memory and spills lands in BUILD_INFO["log"]
and beside the library). godunov_plm.cu adds -fmad=false, so K1 and K2
round op by op like their plain versions, bit for bit, which the
thresholded upwind pick needs; the multigrid sources make no such pick and
let nvcc contract multiply-adds (they agree with their plain versions to a
bound, not bit for bit).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# each source with the flags it adds
SOURCES = {
    _PKG / "csrc" / "godunov_plm.cu": ("-fmad=false",),
    _PKG / "csrc" / "mg_cell.cu": (),
    _PKG / "csrc" / "mg_nodal.cu": (),
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_LIB = None
BUILD_INFO = {}
DTYPES = {torch.float32: 0, torch.float64: 1}  # the kernels' dtype codes


def check_tensor(name, t, shape, dtype, device):
    """Raise unless t has this dtype, device and shape and is contiguous."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, want {dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def check_rc(rc, name):
    """Raise on a non-zero cudaError_t returned by a kernel entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin)")
    return exe


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def _build() -> Path:
    """Compile every source to an object file, all at once (one nvcc per
    source), then link them into one shared library."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src, flags in SOURCES.items():
        h.update(src.read_bytes())
        h.update(" ".join(flags).encode())
    so = BUILD_DIR / f"libiamr_kernels_{h.hexdigest()[:16]}.so"
    log_path = so.with_suffix(".log")
    if so.exists():
        log = log_path.read_text() if log_path.exists() else ""
        BUILD_INFO.update(path=str(so), seconds=0.0, cached=True, log=log)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", o, str(src)]
                       for (src, flags), o in zip(SOURCES.items(), objs)]))
        tmp = os.path.join(tmpdir, "lib.so")
        logs.append(_run([nvcc, *ARCH, "-shared", "-o", tmp, *objs]))
        log_path.write_text("".join(logs))
        os.replace(tmp, so)
    BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0, cached=False,
                      log="".join(logs))
    return so


def ptxas_report(log=None):
    """Lines of the -Xptxas -v log per compiled kernel (mangled name):
    registers, barriers and shared memory, then stack and spill bytes."""
    log = BUILD_INFO.get("log", "") if log is None else log
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            out.append(f"{name}: {line.split('info    :')[-1].strip()}")
        elif "spill stores" in line and name is not None:
            out.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    return out


def kernels():
    """The loaded kernel library (built on first call), argtypes declared."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build()))
    lib.extrap_plm.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P]
    lib.extrap_plm.restype = _I
    lib.godunov_plm_multi.argtypes = [
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ]
    lib.godunov_plm_multi.restype = _I
    lib.godunov_plm_smem_bytes.argtypes = [_I, _I]
    lib.godunov_plm_smem_bytes.restype = _I
    lib.mg_cell_gsrb.argtypes = [
        _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _D, _P, _D, _P, _P, _P, _P, _P, _P,
    ]
    lib.mg_cell_gsrb.restype = _I
    lib.mg_nodal_jacobi.argtypes = [
        _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _D, _P, _D, _P, _P, _P, _P, _P,
    ]
    lib.mg_nodal_jacobi.restype = _I
    _LIB = lib
    return lib
