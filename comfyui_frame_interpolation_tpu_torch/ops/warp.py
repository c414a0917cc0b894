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

A row band: every warp takes ``row0`` (0 by default). The flow and the
output then have rows of their own, ``h`` of them, and output row ``y``
samples the source at row coordinate ``row0 + y + flow_y``; the border
clamp and the zeros test use the source's height. The ``space`` axis of
``parallel/`` warps each band of a frame so, by the whole source gathered
onto the band's device. With ``row0 = 0`` and the source's height it is the
whole-frame warp, bit for bit. A band takes the kernel that ``route``
names for its image, K1 or the wide kernel, as a whole frame does.

With a gradient: a CUDA warp whose image or flow needs one (grad mode on)
goes through ``ops.cuda.warp_kernel.WarpFunction``, whose forward is the
routed kernel and whose backward is the hand-written backward kernel; a CPU
warp differentiates the twin by autograd. :func:`warp_backward_torch` is the
backward kernel's plain version. The border clamp takes JAX's derivative at
an exact bound (0.5: ``jnp.clip`` is a ``max`` then a ``min``, each of which
splits a tie), where ``torch.clamp`` would give 1; zero flow on the first or
last row or column lands exactly on a bound.

One deliberate difference from the JAX ``warp_xla``: in zeros mode a
non-finite coordinate samples nothing (output 0), as the Pallas kernel does,
where ``warp_xla`` propagates NaN. Coordinates are also clamped to
``+-2w``/``+-2h`` in zeros mode, which moves no sample (both taps stay off
the frame) and keeps the float-to-int conversion defined.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["warp", "warp_torch", "warp_backward_torch", "bicubic_sample", "bilinear_sample", "grid_sample"]


def _clip(v: torch.Tensor, hi: float) -> torch.Tensor:
    """``v`` clamped to ``[0, hi]`` as JAX's ``jnp.clip`` is, a ``max`` then a
    ``min``: the same values as ``clamp`` (NaN stays NaN), and the derivative
    0.5 at an exact bound, where ``clamp``'s is 1."""
    return torch.minimum(torch.maximum(v, v.new_zeros(())), v.new_full((), hi))


def _compute_dtype(img: torch.Tensor) -> torch.dtype:
    """The twins' coordinate and sum type: f32, or f64 for an f64 image."""
    return torch.float64 if img.dtype == torch.float64 else torch.float32


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

    Coordinates and weights are f32 (f64 for an f64 image); the four taps
    are summed in that type in the order y0x0, y0x1, y1x0, y1x1 and cast
    once to the image dtype. ``border``
    clamps the coordinate (not only the index) before the weights; ``zeros``
    gives taps outside the frame weight 0."""
    n, h, w, c = img.shape
    ct = _compute_dtype(img)
    sx = sx.to(ct)
    sy = sy.to(ct)
    if padding_mode == "border":
        sx = _clip(sx, w - 1.0)
        sy = _clip(sy, h - 1.0)
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
        _gather_2d(img, ix0, iy0).to(ct) * w00[..., None]
        + _gather_2d(img, ix1, iy0).to(ct) * w01[..., None]
        + _gather_2d(img, ix0, iy1).to(ct) * w10[..., None]
        + _gather_2d(img, ix1, iy1).to(ct) * w11[..., None]
    )
    return out.to(img.dtype)


def warp_torch(img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border", row0: int = 0) -> torch.Tensor:
    """Plain PyTorch warp (the kernel's twin). The grid is built in f32 from an
    integer iota; bf16/f16 flows are not rounded into a low-precision grid
    (an f64 image takes an f64 grid). The flow's rows are the source's rows
    ``row0`` on (a row band)."""
    n, h, w, _ = flow.shape
    ct = _compute_dtype(img)
    gx = torch.arange(w, dtype=ct, device=flow.device).view(1, 1, w)
    gy = (torch.arange(h, dtype=ct, device=flow.device) + row0).view(1, h, 1)
    return bilinear_sample(img, gx + flow[..., 0].to(ct), gy + flow[..., 1].to(ct), padding_mode)


def warp_backward_torch(
    img: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor, padding_mode: str = "border", row0: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's plain version: ``(grad_img, grad_flow)`` of
    :func:`warp_torch` for the output's gradient ``grad_out`` (NHWC, shaped
    like the flow's rows with the image's channels), by
    ``torch.autograd.grad``. bf16/f16 inputs are taken to f32 first and the
    gradients cast once to the inputs' dtypes, as the kernel sums in f32 and
    rounds once (autograd through a bf16 twin would sum the image's gradient
    in bf16); f64 stays f64. For a row band (``row0``), ``grad_img`` covers
    the whole source: the band's part of the sum."""
    with torch.enable_grad():
        ct = _compute_dtype(img)
        x = img.detach().to(ct).requires_grad_()
        f = flow.detach().to(ct).requires_grad_()
        out = warp_torch(x, f, padding_mode, row0)
        gi, gf = torch.autograd.grad(out, (x, f), grad_out.to(ct))
    return gi.to(img.dtype), gf.to(flow.dtype)


def warp(
    img: torch.Tensor, flow: torch.Tensor, padding_mode: str = "border", prefer_wide: bool = False, row0: int = 0
) -> torch.Tensor:
    """Backward-warp ``img`` (NHWC) by ``flow`` (``[N, H, W, 2]``): the
    whole frame, or with ``row0`` the rows ``row0`` to ``row0 + H`` of a
    taller ``img`` (a row band).

    CUDA tensors launch the Hopper kernel that
    ``ops.cuda.warp_kernel.route`` names for their shape, strides, dtype and
    ``prefer_wide``; when grad mode is on and ``img`` or ``flow`` needs a
    gradient, through ``warp_kernel.WarpFunction``, whose backward is the
    backward kernel. CPU tensors take the plain twin (autograd differentiates
    it); any other device raises. There is no fallback from a kernel to the
    twin or to another kernel. A value held as row bands
    (``parallel.space.RowBands``) takes the row-band rule of ``parallel/``."""
    if has_torch_function((img, flow)):
        return handle_torch_function(
            warp, (img, flow), img, flow, padding_mode=padding_mode, prefer_wide=prefer_wide, row0=row0
        )
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode {padding_mode}")
    if not 0 <= row0 <= img.shape[1] - flow.shape[1]:
        raise ValueError(f"warp: a flow of {flow.shape[1]} rows from row {row0} does not lie within {img.shape[1]} source rows")
    if img.device.type == "cuda":
        from .cuda import warp_kernel

        planes, flow_planes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
        zeros = padding_mode == "zeros"
        if torch.is_grad_enabled() and (img.requires_grad or flow.requires_grad):
            return warp_kernel.WarpFunction.apply(planes, flow_planes, zeros, prefer_wide, row0).permute(0, 2, 3, 1)
        # no gradient is taken (grad mode off, or no input needs one): the
        # wrappers get detached views, as they refuse inputs that need one
        planes, flow_planes = planes.detach(), flow_planes.detach()
        if warp_kernel.route(planes.shape, planes.stride(), planes.dtype, prefer_wide) == "wide":
            out = warp_kernel.warp_bilinear_wide(planes, flow_planes, zeros, row0=row0)
        else:
            out = warp_kernel.warp_bilinear(planes, flow_planes, zeros, row0=row0)
        return out.permute(0, 2, 3, 1)
    if img.device.type == "cpu" and flow.device.type == "cpu":
        return warp_torch(img, flow, padding_mode, row0)
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
