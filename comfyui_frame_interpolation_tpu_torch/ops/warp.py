"""Backward bilinear warping (grid-sample), PyTorch port of the JAX package's
``ops/warp.py``.

Semantics (reference ``rife_arch.py:31-70``): sample ``img`` at
``(x + flow_x, y + flow_y)``, bilinear, with ``align_corners=True``
normalization (which cancels against the grid construction, leaving pure
pixel offsets) and ``padding_mode="border"``; :func:`grid_sample` covers
torch ``grid_sample`` on normalized grids.

Layout: NHWC images and ``[N, H, W, 2]`` flows/grids (channel 0 = x, 1 = y),
as in the JAX package.

:func:`bicubic_sample` (MoMo's sampler) is torch ``grid_sample(mode="bicubic")``
itself, on a grid normalized from pixel coordinates: the JAX version computes
that function outside any Pallas kernel, so the port has no kernel for it.

:func:`warp` dispatches on the tensor's device: a CUDA tensor goes to a
hand-written Hopper kernel (``ops.cuda.warp_kernel``), a CPU tensor to the
plain twin :func:`warp_torch`. On the card, ``ops.cuda.warp_kernel.route``
picks the kernel from C, the dtype and the channel stride: the wide-channel
kernel for channel-stride-1 pixels of 32 bytes or more or of whole 16-byte
vectors, K1 (the tiled kernel, any strides) for every other input.
``prefer_wide=True`` (the JAX ``prefer_mxu``, which FILM sets for its C >= 32
feature warps) always takes the wide kernel. Every body computes the twin's
function bit for bit, so neither the rule nor the flag ever changes a result,
and unlike JAX the flag applies to every dtype. The twin also runs on CUDA
tensors when called directly, which is how the kernels are checked on the
card.

One deliberate difference from the JAX ``warp_xla``: in zeros mode a
non-finite coordinate samples nothing (output 0), as the Pallas kernel does,
where ``warp_xla`` propagates NaN. Coordinates are also clamped to
``+-2w``/``+-2h`` in zeros mode, which moves no sample (both taps stay off
the frame) and keeps the float-to-int conversion defined.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["warp", "warp_torch", "bicubic_sample", "bilinear_sample", "grid_sample"]


def _gather_2d(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """``img[n, iy, ix, :]`` for integer index maps of shape ``[N, H', W']``."""
    n, h, w, c = img.shape
    flat = img.reshape(n, h * w, c)
    idx = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
    return torch.gather(flat, 1, idx).reshape(n, ix.shape[1], ix.shape[2], c)


def bilinear_sample(
    img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Bilinear sample ``img`` (NHWC) at unnormalized pixel coordinates
    ``sx, sy`` (``[N, H', W']``), matching torch ``grid_sample``'s corner cases.

    Coordinates and weights are f32; the four taps are summed in f32 in the
    order y0x0, y0x1, y1x0, y1x1 and cast once to the image dtype. ``border``
    clamps the coordinate (not only the index) before the weights; ``zeros``
    gives taps outside the frame weight 0."""
    n, h, w, c = img.shape
    sx = sx.float()
    sy = sy.float()
    if padding_mode == "border":
        sx = sx.clamp(0.0, w - 1.0)
        sy = sy.clamp(0.0, h - 1.0)
    elif padding_mode == "zeros":
        finite = torch.isfinite(sx) & torch.isfinite(sy)
        sx = torch.where(finite, sx, -4.0 * w).clamp(-2.0 * w, 2.0 * w)
        sy = torch.where(finite, sy, -4.0 * h).clamp(-2.0 * h, 2.0 * h)
    else:
        raise ValueError(f"unsupported padding_mode {padding_mode}")

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    w00 = (1.0 - wx) * (1.0 - wy)
    w01 = wx * (1.0 - wy)
    w10 = (1.0 - wx) * wy
    w11 = wx * wy
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    if padding_mode == "zeros":
        vx0 = (x0 >= 0) & (x0 <= w - 1)
        vx1 = (x1 >= 0) & (x1 <= w - 1)
        vy0 = (y0 >= 0) & (y0 <= h - 1)
        vy1 = (y1 >= 0) & (y1 <= h - 1)
        w00 = torch.where(vy0 & vx0, w00, 0.0)
        w01 = torch.where(vy0 & vx1, w01, 0.0)
        w10 = torch.where(vy1 & vx0, w10, 0.0)
        w11 = torch.where(vy1 & vx1, w11, 0.0)

    def index(v: torch.Tensor, hi: int) -> torch.Tensor:
        # a NaN coordinate (border mode) reads index 0; its weights stay NaN
        return torch.nan_to_num(v, nan=0.0).long().clamp(0, hi)

    ix0, ix1 = index(x0, w - 1), index(x1, w - 1)
    iy0, iy1 = index(y0, h - 1), index(y1, h - 1)
    out = (
        _gather_2d(img, ix0, iy0).float() * w00[..., None]
        + _gather_2d(img, ix1, iy0).float() * w01[..., None]
        + _gather_2d(img, ix0, iy1).float() * w10[..., None]
        + _gather_2d(img, ix1, iy1).float() * w11[..., None]
    )
    return out.to(img.dtype)


def warp_torch(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """Plain PyTorch warp (the kernel's twin). The grid is built in f32 from an
    integer iota; bf16/f16 flows are not rounded into a low-precision grid."""
    n, h, w, _ = flow.shape
    gx = torch.arange(w, dtype=torch.float32, device=flow.device).view(1, 1, w)
    gy = torch.arange(h, dtype=torch.float32, device=flow.device).view(1, h, 1)
    return bilinear_sample(img, gx + flow[..., 0].float(), gy + flow[..., 1].float(), padding_mode)


def warp(
    img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border", prefer_wide: bool = False
) -> torch.Tensor:
    """Backward-warp ``img`` (NHWC) by ``flow`` (``[N, H, W, 2]``).

    CUDA tensors launch the Hopper kernel that
    ``ops.cuda.warp_kernel.route`` names for their shape, strides, dtype and
    ``prefer_wide``. CPU tensors take the plain twin; any other device raises.
    There is no fallback from a kernel to the twin or to another kernel."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode {padding_mode}")
    if img.device.type == "cuda":
        from .cuda import warp_kernel

        planes, flow_planes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
        zeros = padding_mode == "zeros"
        if warp_kernel.route(planes.shape, planes.stride(), planes.dtype, prefer_wide) == "wide":
            out = warp_kernel.warp_bilinear_wide(planes, flow_planes, zeros)
        else:
            out = warp_kernel.warp_bilinear(planes, flow_planes, zeros)
        return out.permute(0, 2, 3, 1)
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warp_torch(img, flow, padding_mode)
    raise ValueError(f"warp runs on cuda or cpu tensors, got {img.device} and {flow.device}")


def grid_sample(
    img: torch.Tensor,
    grid: torch.Tensor,
    padding_mode: str = "zeros",
    align_corners: bool = False,
) -> torch.Tensor:
    """torch ``F.grid_sample(mode="bilinear")`` on NHWC images for normalized
    grids ``[N, H', W', 2]`` in [-1, 1] (channel 0 = x, 1 = y). Plain
    PyTorch, as the JAX package keeps it on XLA."""
    n, h, w, _ = img.shape
    gx = grid[..., 0].float()
    gy = grid[..., 1].float()
    if align_corners:
        sx = (gx + 1.0) * 0.5 * (w - 1)
        sy = (gy + 1.0) * 0.5 * (h - 1)
    else:
        sx = ((gx + 1.0) * w - 1.0) * 0.5
        sy = ((gy + 1.0) * h - 1.0) * 0.5
    return bilinear_sample(img, sx, sy, padding_mode)


def bicubic_sample(
    img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """Bicubic sample ``img`` (NHWC) at pixel coordinates ``sx, sy``
    (``[N, H', W']``): torch ``grid_sample(mode="bicubic",
    align_corners=False)``, a 4x4 cubic-convolution kernel with a = -0.75;
    ``zeros`` gives taps outside the image weight 0, ``border`` clamps them
    (JAX ``ops/warp.py:bicubic_sample``).

    The coordinates are normalized in f32 and the image is sampled in f32,
    then cast once to its dtype (the JAX version sums its taps in f32). The
    normalized grid rounds the coordinate by up to about ``1e-7 * W`` pixels.
    ``grid_sample`` writes NCHW memory; the result comes back as an NHWC view
    of ``channels_last`` memory, as the models keep their tensors."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode}")
    n, h, w, _ = img.shape
    gx = (2.0 * sx.float() + 1.0) / w - 1.0
    gy = (2.0 * sy.float() + 1.0) / h - 1.0
    out = F.grid_sample(
        img.permute(0, 3, 1, 2).float(), torch.stack([gx, gy], -1), mode="bicubic",
        padding_mode=padding_mode, align_corners=False,
    )
    return out.to(dtype=img.dtype, memory_format=torch.channels_last).permute(0, 2, 3, 1)
