"""Layer primitives for the ported models: the subset of the JAX package's
``models/common.py`` that RIFE and M2M use, as plain functions on NCHW tensors.

The JAX versions take NHWC arrays and parameter dicts in torch layout; here
the tensors are torch's own NCHW (held in ``channels_last`` memory by the
models, so a permute to NHWC is a view and cuDNN runs NHWC), and weights are
passed in torch layout directly: OIHW for convolutions, IOHW for transposed
convolutions, which ``F.conv_transpose2d`` takes as they are.

``resize_bilinear`` is ``F.interpolate(mode="bilinear")`` with ``size=``:
the JAX version's integer-factor fast paths compute the same two taps (for an
even downscale factor s, rows ``s*k + s/2 - 1`` and ``s*k + s/2`` at 0.5
each), so one call reproduces all of its paths.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = [
    "avg_pool2d",
    "cast_params",
    "conv2d",
    "conv_transpose2d",
    "prelu",
    "leaky_relu",
    "sigmoid",
    "pixel_shuffle",
    "resize_bilinear",
    "resize_by_scale",
]

IntPair = Union[int, Tuple[int, int]]


def cast_params(params: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast every floating tensor of a state dict to ``dtype`` (the analog of
    the reference's ``model.half()``): bf16 activations against f32 weights
    would promote every convolution back to f32."""
    return {
        k: v.to(dtype) if torch.is_floating_point(v) else v for k, v in params.items()
    }


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: IntPair = 0,
    dilation: IntPair = 1,
) -> torch.Tensor:
    """torch ``nn.Conv2d`` with an OIHW ``weight``."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding, dilation=dilation)


def conv_transpose2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 2,
    padding: IntPair = 1,
) -> torch.Tensor:
    """torch ``nn.ConvTranspose2d`` (output_padding=0) with an IOHW ``weight``."""
    return F.conv_transpose2d(x, weight, bias, stride=stride, padding=padding)


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """torch ``nn.PReLU``; ``weight`` of shape (C,) over the channel axis."""
    return torch.where(x >= 0, x, x * weight.view(1, -1, 1, 1))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch ``nn.PixelShuffle``: out[n, c, h*r+i, w*r+j] = x[n, c*r*r + i*r + j, h, w]."""
    return F.pixel_shuffle(x, r)


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """torch ``F.interpolate(mode="bilinear")``, no antialias, either convention."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


def resize_by_scale(x: torch.Tensor, scale: float, align_corners: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(scale_factor=scale)``: output = floor(in * scale),
    mapped with the realized in/out ratio (``size=``), as the JAX version does
    (the same whenever ``in * scale`` is integral)."""
    h, w = x.shape[-2:]
    return resize_bilinear(
        x, (int(math.floor(h * scale)), int(math.floor(w * scale))), align_corners
    )


def avg_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None) -> torch.Tensor:
    """torch ``F.avg_pool2d`` without padding: VALID windows, each sum divided
    by ``kernel**2``."""
    return F.avg_pool2d(x, kernel, stride or kernel)
