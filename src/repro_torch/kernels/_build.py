"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into `_build/lib<name>.so`, a
shared library with a plain C interface that the wrappers load with
ctypes.  Sources build at first use (and again when a source, or any
`csrc/*.cuh` header, is newer than its library); `build()` starts one nvcc
per stale source, all at once.
The build directory is listed in .gitignore.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = ("gemm", "flash_decode", "gemm_int8", "quant", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_f32", "gemm_pipelined")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if not cand.exists():
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
        nvcc = str(cand)
    return nvcc


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    """No library yet, or one older than its source or than any header in
    csrc/ (a source may include any of them)."""
    so = _lib_path(name)
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime
                 for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return so.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale source in `names` in parallel; returns each
    build's compiler output (ptxas register / shared-memory report).
    Raises with the compiler's output if any build fails."""
    BUILD.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        if name not in SOURCES:
            raise KeyError(f"unknown kernel source {name!r}; known: {SOURCES}")
        if _stale(name):
            tmp = BUILD / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(name))   # atomic: readers never see half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
