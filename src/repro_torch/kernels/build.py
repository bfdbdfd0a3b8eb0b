"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/*.cu`` file is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). Libraries go into
``build/kernels/`` at the root of the checkout, named by a hash of their
source and flags, and are built at first use; each keeps its compiler's
``-Xptxas -v`` report beside it (``ptxas_log``). Nothing here runs at
import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its source, relative to this package
SOURCES = {
    "scaffold_update": "scaffold_update/csrc/scaffold_update.cu",
    "local_loop": "scaffold_update/csrc/local_loop.cu",
    "swa_attention": "swa_attention/csrc/swa_attention.cu",
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def toolkit(binary: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", binary), shutil.which(binary)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{binary} not found: the port's kernels are built "
                       f"with the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")


def library(name: str) -> Path:
    """Path of kernel ``name``'s shared library (built or not)."""
    src = _PKG / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _log_path(name: str) -> Path:
    return library(name).with_suffix(".ptxas.txt")


def ptxas_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``: registers, spills) of kernel
    ``name``'s built library, whichever process built it."""
    path = _log_path(name)
    if not path.exists():
        raise FileNotFoundError(f"{name}: no ptxas report at {path}; "
                                f"build it first")
    return path.read_text()


def build(names: Iterable[str] = tuple(SOURCES)) -> float:
    """Compile the named kernels that are not built yet (library or its
    ptxas report missing), all ``nvcc`` processes started together;
    returns the wall seconds spent. Raises with the compiler's output
    when one fails."""
    t0 = time.perf_counter()
    todo = [n for n in names
            if not (library(n).exists() and _log_path(n).exists())]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = toolkit()
    procs = {}
    for n in todo:
        tmp = library(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exit {p.returncode}\n{out}")
        else:
            _log_path(n).write_text(out)
            os.replace(tmp, library(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (``cudaGetLastError``
    right after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
