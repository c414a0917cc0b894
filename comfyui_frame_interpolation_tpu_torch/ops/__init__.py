"""Op surface of the port. ``warp`` and ``softsplat_func`` dispatch on the
tensor's device: the hand-written Hopper kernel (``ops/cuda``) for CUDA
tensors, the plain PyTorch twin for CPU tensors; the mode wrappers
``softsplat`` and ``function_softsplat`` run on ``softsplat_func``.
``bicubic_sample``, ``costvol_func``, ``adacof_func``, ``correlation_func``,
``sepconv_func`` and ``batch_edt`` are plain PyTorch, as their JAX versions
are XLA."""

from .adacof import adacof_func
from .correlation import correlation_func
from .costvol import costvol_func
from .edt import batch_edt
from .sepconv import sepconv_func
from .softsplat import function_softsplat, softsplat, softsplat_func, softsplat_torch
from .warp import bicubic_sample, bilinear_sample, grid_sample, warp, warp_torch

__all__ = [
    "warp", "warp_torch", "bicubic_sample", "bilinear_sample", "grid_sample",
    "softsplat", "function_softsplat", "softsplat_func", "softsplat_torch", "costvol_func",
    "adacof_func", "correlation_func", "sepconv_func", "batch_edt",
]
