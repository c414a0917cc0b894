"""Op surface of the port. ``warp`` dispatches on the tensor's device: the
hand-written Hopper kernel (``ops/cuda``) for CUDA tensors, the plain PyTorch
twin for CPU tensors. The JAX package's other ops (softsplat, sepconv, adacof,
costvol, correlation, edt) are not ported yet (``ROADMAP.md``)."""

from .warp import bilinear_sample, grid_sample, warp, warp_torch

__all__ = ["warp", "warp_torch", "bilinear_sample", "grid_sample"]
