"""Build and load the hand-written CUDA kernels of ``tpeps_torch/csrc``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build happens at the first CUDA call (or an explicit :func:`build`), never
at import, so the package imports on a machine without ``nvcc``.  The
library goes to ``tpeps_torch/_build/`` under a name that hashes the
sources and flags, so an edited source is always rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("layer_contract.cu", "corner_apply.cu", "cholqr.cu", "t_epilogue.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _i, _i64, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
# name -> argtypes; every function returns a cudaError_t as int
_SIGNATURES = {
    "tpeps_layer_contract_f64": (_vp, _vp, _vp, _vp, _i, _vp),
    "tpeps_layer_contract_f32": (_vp, _vp, _vp, _vp, _i, _vp),
    "tpeps_corner_apply_f64": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_corner_apply_f32": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_gram_ridge_f64": (_vp, _vp, _vp, _i, _i, _d, _vp),
    "tpeps_gram_ridge_f32": (_vp, _vp, _vp, _i, _i, _d, _vp),
    "tpeps_gram_splits": (_i,),
    "tpeps_trsm_right_lower_h_f64": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_trsm_right_lower_h_f32": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_t_epilogue_f64": (_vp, _vp, _vp, _i64, _i, _i, _vp),
    "tpeps_t_epilogue_f32": (_vp, _vp, _vp, _i64, _i, _i, _vp),
    "tpeps_t_epilogue_partials": (),
}


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        self.cdll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.cdll.tpeps_cuda_error_string.restype = ctypes.c_char_p
        self.cdll.tpeps_cuda_error_string.argtypes = (_i,)

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            msg = self.cdll.tpeps_cuda_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile the sources (unless this exact build exists) and load them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libtpeps_kernels_{_source_hash()}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC_DIR / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(out, time.perf_counter() - t0, log)


_LIB: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = build()
    return _LIB
