"""Build the hand-written CUDA kernels at first use.

Each kernel source under ``csrc/`` has a plain ``extern "C"`` interface and is
compiled by ``nvcc`` into a shared library that :mod:`ctypes` loads (no
PyTorch headers, so a build takes seconds). Nothing here runs on import: a
machine without ``nvcc`` imports the package and runs its CPU paths.

The library lands in ``build/cuda_kernels/`` at the repository root, named by
a hash of the source bytes and the compiler flags, so a stale library never
loads after a source edit. It is written under a temporary name and then
``os.replace``-d into place, so processes building at the same time never load
a half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "load_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME): the CUDA kernels "
        "are built from source at first use and need the CUDA toolkit"
    )


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if no library of the same sources and flags
    exists yet, and load it."""
    src = os.path.join(_CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(_BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(lib_path)
