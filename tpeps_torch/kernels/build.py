"""Build and load the hand-written CUDA kernels of ``tpeps_torch/csrc``.

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) in its own
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build
happens at the first CUDA call (or an explicit :func:`build`), never at
import, so the package imports on a machine without ``nvcc``.  The library
goes to ``tpeps_torch/_build/`` under a name that hashes the sources and
flags, so an edited source is always rebuilt.
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
SOURCES = ("layer_contract.cu", "corner_apply.cu", "cholqr.cu", "t_epilogue.cu", "polar.cu",
           "eigh_small.cu", "ozaki.cu", "ctm_commit.cu", "block_sparse.cu", "frozen_commit.cu",
           "frozen_generic.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _i, _i64, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_double
# name -> argtypes; every function returns a cudaError_t as int
_SIGNATURES = {
    "tpeps_layer_contract_f64": (_vp, _vp, _vp, _vp, _i, _vp),
    "tpeps_layer_contract_f32": (_vp, _vp, _vp, _vp, _i, _vp),
    "tpeps_corner_apply_f64": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_corner_apply_f32": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_gram_clusters_f64": (_vp, _vp, _vp, _vp, _i, _vp, _i, _i, _i, _d, _i, _vp),
    "tpeps_gram_clusters_f32": (_vp, _vp, _vp, _vp, _i, _vp, _i, _i, _i, _d, _i, _vp),
    "tpeps_trsm_right_lower_h_f64": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_trsm_right_lower_h_f32": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_trsm_right_lower_f64": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_trsm_right_lower_f32": (_vp, _vp, _vp, _i, _i, _vp),
    "tpeps_polar_unitary_f64": (_vp, _vp, _vp, _vp, _i, _i, _vp),
    "tpeps_polar_vjp_f64": (_vp, _vp, _vp, _i, _vp),
    "tpeps_polar_vjp_f32": (_vp, _vp, _vp, _i, _vp),
    "tpeps_eigh_small_f64": (_vp, _vp, _vp, _vp, _i, _i, _vp),
    "tpeps_ozaki_max_slices": (),
    "tpeps_ozaki_split": (_vp, _vp, _vp, _i64, _i, _i, _i, _i, _i, _vp),
    "tpeps_ozaki_gemm": (_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i, _i, _i, _vp, _vp, _vp),
    "tpeps_ctm_commit_f64": (_vp,) * 14 + (_i64, _i64, _i64, _i64, _i, _i, _vp),
    "tpeps_ctm_commit_f32": (_vp,) * 14 + (_i64, _i64, _i64, _i64, _i, _i, _vp),
    "tpeps_ctm_commit_partials": (),
    "tpeps_t_epilogue_f64": (_vp, _vp, _vp, _i64, _i, _i, _vp),
    "tpeps_t_epilogue_f32": (_vp, _vp, _vp, _i64, _i, _i, _vp),
    "tpeps_t_epilogue_partials": (),
    "tpeps_block_permute_f64": (_vp,) * 9 + (_i, _i, _i64, _vp),
    "tpeps_block_permute_f32": (_vp,) * 9 + (_i, _i, _i64, _vp),
    "tpeps_block_permute_max_rank": (),
    "tpeps_block_gemm_f64": (_vp,) * 12 + (_i, _i, _i, _vp),
    "tpeps_block_gemm_f32": (_vp,) * 12 + (_i, _i, _i, _vp),
    "tpeps_frozen_commit_f64": (_vp,) * 11 + (_i64, _i64, _vp),
    "tpeps_frozen_commit_f32": (_vp,) * 11 + (_i64, _i64, _vp),
    "tpeps_frozen_commit_partials": (),
    "tpeps_frozen_epilogue_vjp_f64": (_vp,) * 10 + (_i, _i, _vp, _vp, _vp, _i64, _i64, _i, _vp),
    "tpeps_frozen_epilogue_vjp_f32": (_vp,) * 10 + (_i, _i, _vp, _vp, _vp, _i64, _i64, _i, _vp),
    "tpeps_frozen_epilogue_vjp_partials": (),
    "tpeps_adjoint_commit_f64": (_vp, _vp, _i64, _vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp),
    "tpeps_adjoint_commit_f32": (_vp, _vp, _i64, _vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp),
    "tpeps_adjoint_commit_partials": (),
    "tpeps_generic_epilogue_f64": (_vp, _vp, _i, _vp, _vp, _vp),
    "tpeps_generic_epilogue_f32": (_vp, _vp, _i, _vp, _vp, _vp),
    "tpeps_generic_epilogue_partials": (),
    "tpeps_sweep_commit_f64": (_vp, _vp, _i64, _vp, _vp, _vp, _vp, _vp),
    "tpeps_sweep_commit_f32": (_vp, _vp, _i64, _vp, _vp, _vp, _vp, _vp),
    "tpeps_generic_epilogue_vjp_f64": (_vp, _vp, _vp, _i, _vp, _vp, _vp, _i, _vp, _vp),
    "tpeps_generic_epilogue_vjp_f32": (_vp, _vp, _vp, _i, _vp, _vp, _vp, _i, _vp, _vp),
}


# name -> argtypes of the size queries, which return int64
_SIZE_QUERIES = {
    "tpeps_polar_smem": (_i, _i),
    "tpeps_gram_scratch_f64": (_i, _i, _i, _i),
    "tpeps_gram_scratch_f32": (_i, _i, _i, _i),
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
        for name, argtypes in _SIZE_QUERIES.items():
            getattr(self.cdll, name).restype = ctypes.c_int64
            getattr(self.cdll, name).argtypes = argtypes
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


def _compile_all(nvcc: str, objdir: Path) -> tuple[list[Path], str]:
    """One nvcc process per source, all running at once; returns the
    objects and the compilers' output.  Every process is reaped, and the
    others are killed if one fails."""
    procs = []
    try:
        for name in SOURCES:
            obj = objdir / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        return [obj for _, obj, _ in procs], "\n".join(logs)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build() -> KernelLibrary:
    """Compile the sources (unless this exact build exists) and load them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _source_hash()
    out = BUILD_DIR / f"libtpeps_kernels_{tag}.so"
    log_path = out.with_suffix(".log")
    t0 = time.perf_counter()
    if not out.exists():
        nvcc = find_nvcc()
        objdir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
        objdir.mkdir(exist_ok=True)
        objs, log = _compile_all(nvcc, objdir)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, check=False)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)
        shutil.rmtree(objdir, ignore_errors=True)
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(out, time.perf_counter() - t0, log)


_LIB: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = build()
    return _LIB
