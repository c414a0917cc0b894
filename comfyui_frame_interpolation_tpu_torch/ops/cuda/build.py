"""Build the hand-written CUDA kernels at first use, and check what their
wrappers hand them.

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

import torch

__all__ = ["DTYPE_CODES", "NVCC_FLAGS", "check_planes_and_flow", "load_library"]

# the kernels' dtype codes (csrc/*.cu: enum DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_GRID_LIMIT = 65535  # the kernels' grids put rows on y and images on z

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


def check_planes_and_flow(what: str, x: torch.Tensor, flow: torch.Tensor) -> None:
    """Raise unless ``x`` ``[N, C, H, W]`` and ``flow`` ``[N, 2, H, W]`` are
    CUDA tensors on one device, of the kernels' dtypes, within their grid
    limits, and need no gradient (the kernels have no backward yet)."""
    if not (x.is_cuda and flow.is_cuda):
        raise ValueError(f"{what} runs on CUDA tensors, got {x.device} and {flow.device}")
    if x.device != flow.device:
        raise ValueError(f"{what}: input on {x.device} but flow on {flow.device}")
    if x.dtype not in DTYPE_CODES or flow.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} takes float32/bfloat16/float16, got {x.dtype} and {flow.dtype}")
    if x.dim() != 4 or flow.dim() != 4:
        raise ValueError(f"{what}: expected 4-D input and flow, got {tuple(x.shape)} and {tuple(flow.shape)}")
    n, _, h, w = x.shape
    if tuple(flow.shape) != (n, 2, h, w):
        raise ValueError(f"{what}: flow must be {(n, 2, h, w)}, got {tuple(flow.shape)}")
    if n > _GRID_LIMIT or h > _GRID_LIMIT:
        raise ValueError(f"{what}: batch {n} and height {h} must each be <= {_GRID_LIMIT}")
    if x.requires_grad or flow.requires_grad:
        raise NotImplementedError(f"{what} has no backward yet")
