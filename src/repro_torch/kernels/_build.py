"""Build the CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/lib<name>.so`` at the
repository root, compiled for ``sm_90a`` at first use (or all at once, in
parallel, by ``build_all``).  The sources expose plain C entry points; the
wrappers pass device pointers and PyTorch's current stream as integers, and
every entry point returns ``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of every entry point, by library
SIGNATURES = {
    "rdp_matmul": {
        "rdp_matmul_cols": [_P, _P, _P, _P] + [_I] * 11 + [_F, _P],
        "rdp_matmul_rows": [_P, _P, _P, _P] + [_I] * 11 + [_F, _P],
    },
    "fused_ffn": {
        "fused_ffn_fwd": [_P] * 6 + [_I] * 11 + [_P],
    },
    "rdp_matmul_bwd": {
        name: [_P] * 4 + [_I] * 9 + [_F, _P]
        for name in ("rdp_cols_dgrad", "rdp_cols_wgrad", "rdp_rows_dgrad",
                     "rdp_rows_wgrad")
    },
    "tdp_matmul": {
        "tdp_matmul": [_P] * 4 + [_I] * 10 + [_F, _P],
    },
    "tdp_matmul_bwd": {
        name: [_P] * 4 + [_I] * 9 + [_F, _P]
        for name in ("tdp_dgrad", "tdp_wgrad")
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times a wrapper launched it (a plain count; callers reset it)."""

    name: str
    source: str          # path in the repository
    replaces: str        # file:line of the TPU kernel it replaces
    launches: int = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    """Where the shared library for ``csrc/<name>.cu`` is built."""
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return out.stat().st_mtime < newest


def build_all(names=None, *, force: bool = False) -> dict[str, float]:
    """Compile the named libraries (default: all), one nvcc per source, all
    started together.  Returns seconds per library; raises with the
    compiler's output if any build fails.  ``ptxas`` resource usage of each
    kernel is kept in ``build/repro_torch/<name>.log``."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
               str(lib_path(n)) + ".tmp", str(CSRC / f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    seconds, failed = {}, []
    for n, p in procs.items():
        out, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(out)
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (exit {p.returncode}) ---\n{out}")
        else:
            os.replace(str(lib_path(n)) + ".tmp", lib_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
