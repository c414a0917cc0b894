"""Wrappers of the hand-written Hopper warp kernels (``csrc/warp.cu``).

:func:`warp_bilinear` (K1) replaces the JAX package's Pallas bulk and patch
warp kernels (``comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py``:
``_warp_kernel_diag_roll`` and ``_patch_kernel``) with a tiled kernel for any
strides: a thread per pixel of a 4x32 tile, every tap load of a pixel issued
at once, rows of 8- to 32-byte pixels written back from shared memory as
16-byte vectors. :func:`warp_bilinear_wide` replaces the rows/MXU kernel of
the same file (``_warp_kernel_rows_mxu``): each pixel's flow, taps and
weights computed once and staged in shared memory, then the lanes over the
(pixel, vector) pairs of a run of pixels, in vectors of the widest of 16, 8
and 4 bytes (or one element) on which every pixel starts. Both compute the
same function from the same coordinate/weight code, bit for bit. The plain
PyTorch version of it is ``ops.warp.warp_torch``; ``ops.warp.warp`` takes
the twin for CPU tensors and the kernel :func:`route` names for CUDA
tensors.

:func:`warp_bilinear_backward` is the warp's gradient (``grad_img``,
``grad_flow``) by a third kernel of ``csrc/warp.cu``, whichever kernel ran
the forward; :class:`WarpFunction` joins a forward kernel and it for
autograd, and ``ops.warp.warp`` takes it for every CUDA warp whose input
needs a gradient. No Pallas kernel has a backward: the kernel stands for
XLA's VJP of the gather in the JAX package's ``ops/warp.py:bilinear_sample``,
and its plain version is ``ops.warp.warp_backward_torch``. The image's
gradient is a splat of the output's gradient: a thread per output pixel of
a 32x8 tile merges the taps it shares with its neighbours (``csrc/scatter.cuh``,
shared with the splat kernel) and adds each tap left with ``float4`` atomics
into a zeroed f32 buffer ``[N, H, W, Cp]`` (:func:`padded_channels`); the
taps and the output's gradient are read 4 channels at a time, in the vectors
:func:`vector_bytes` picks.

All three kernels take a row band (``row0``): the flow, the output and
the output's gradient cover ``h`` rows from source row ``row0`` on, and
the image and its gradient the whole source (the ``space`` axis of
``parallel/``). A band goes to the kernel that :func:`route` names for its
image, K1 or the wide kernel, as a whole frame does.

``launches`` counts the launches of K1, ``wide_launches`` those of the
wide kernel and ``backward_launches`` those of the backward kernel, so that
a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from .build import DTYPE_CODES, check_planes_and_flow, load_library

__all__ = [
    "WIDE_MIN_BYTES",
    "WarpFunction",
    "backward_launches",
    "launches",
    "padded_channels",
    "route",
    "route_counts",
    "vector_bytes",
    "warp_bilinear",
    "warp_bilinear_backward",
    "warp_bilinear_wide",
    "wide_launches",
]

launches = 0
wide_launches = 0
backward_launches = 0

# what a direct call of a forward wrapper with an input that needs a
# gradient is told
_GRAD_HINT = "call ops.warp.warp, whose autograd Function (WarpFunction) has the backward kernel"

# a pixel of this many bytes or more, or of a whole number of 16-byte
# vectors, takes the wide kernel (placed on an H100 by
# utils/kernel_compare.py's threshold sweep: PERF.md)
WIDE_MIN_BYTES = 32


def route(shape: Sequence[int], strides: Sequence[int], dtype: torch.dtype, prefer_wide: bool = False) -> str:
    """The kernel that warps planes of ``shape`` ``[N, C, H, W]`` and element
    ``strides`` in ``dtype``: ``"wide"`` or ``"tiled"`` (K1).

    ``prefer_wide`` always gives ``"wide"``. Otherwise an input whose channels
    have stride 1 (a ``channels_last`` tensor, an NHWC tensor's permuted view)
    goes to the wide kernel when a pixel spans ``WIDE_MIN_BYTES`` or more
    (C >= 16 in bf16, C >= 8 in f32) or a whole number of 16-byte vectors
    (C = 8 in bf16, C = 4 in f32), which it reads as aligned vectors, and to
    K1 otherwise; any other layout (NCHW planes, channels that are rows of
    the storage) goes to K1, which takes any strides."""
    if prefer_wide:
        return "wide"
    c = shape[1]
    if c > 1 and strides[1] != 1:
        return "tiled"
    pixel_bytes = c * dtype.itemsize
    return "wide" if pixel_bytes >= WIDE_MIN_BYTES or pixel_bytes % 16 == 0 else "tiled"


def route_counts(channels: Sequence[int], dtype: torch.dtype) -> Dict[str, int]:
    """Launches per kernel, ``{"narrow": K1, "wide": the wide kernel}``, of
    one warp of a ``channels_last`` tensor of each width in ``channels``, as
    :func:`route` sends them: the models derive their launch counts from it."""
    counts = {"narrow": 0, "wide": 0}
    for c in channels:
        counts["wide" if route((1, c, 1, 1), (c, 1, c, c), dtype) == "wide" else "narrow"] += 1
    return counts


def _check_band(what: str, img: torch.Tensor, flow: torch.Tensor, row0: int, *grad_hint: str) -> None:
    """``check_planes_and_flow`` on the band's rows of ``img`` ``[N, C, Hs,
    W]`` (rows ``row0`` on, as many as the flow ``[N, 2, H, W]`` has), which
    must lie within ``img``."""
    both = img.dim() == 4 and flow.dim() == 4
    if both and not 0 <= row0 <= img.shape[2] - flow.shape[2]:
        raise ValueError(f"{what}: a flow of {flow.shape[2]} rows from row {row0} does not lie within {img.shape[2]} source rows")
    check_planes_and_flow(what, img.narrow(2, row0, flow.shape[2]) if both else img, flow, *grad_hint)


def padded_channels(c: int) -> int:
    """The channels of a pixel in the backward kernel's f32 image-gradient
    buffer ``[N, H, W, Cp]``: ``c`` rounded up to a multiple of 4, so that
    every pixel and every group of 4 channels starts on 16 bytes and takes
    one ``float4`` atomic (Cp = 8 for C = 7, 4 for C = 3)."""
    return -(-c // 4) * 4


def vector_bytes(c: int, strides: Sequence[int], itemsize: int, address: int) -> int:
    """The vector, in bytes, in which the backward kernel reads the channels
    of a tensor of ``c`` channels by element ``strides`` ``(N, C, H, W)``
    that starts at byte ``address``: 16 or 8 where the channels are
    contiguous and the vector divides the pixel's bytes, the batch, row and
    pixel strides' bytes and the address; else one element (``itemsize``).
    The kernel refuses a width that breaks this rule."""
    if c > 1 and strides[1] != 1:
        return itemsize
    bits = c * itemsize | strides[0] * itemsize | strides[2] * itemsize | strides[3] * itemsize | address
    for vec in (16, 8):
        if bits % vec == 0:
            return vec
    return itemsize


def _bind(name: str, n_int64: int, n_pointers: int = 3):
    fn = getattr(load_library("warp"), name)
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 3 + [ctypes.c_int64] * n_int64 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    return _bind("cfi_warp_bilinear", 18)


@functools.lru_cache(maxsize=None)
def _wide_kernel():
    return _bind("cfi_warp_bilinear_wide", 16)


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    return _bind("cfi_warp_bilinear_backward", 25, n_pointers=5)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor, zeros: bool = False, row0: int = 0) -> torch.Tensor:
    """Backward-warp ``img`` ``[N, C, H, W]`` by ``flow`` ``[N, 2, H, W]``
    (channel 0 = x, 1 = y) on the card, bilinear, with border or zeros padding.

    A row band: with ``row0``, ``flow`` ``[N, 2, Hb, W]`` covers the source's
    rows ``row0`` to ``row0 + Hb`` (within ``img``'s ``Hs``), and output row
    ``y`` samples source row coordinate ``row0 + y + flow_y``.

    Any strides; the output has the strides ``torch.empty_like`` gives the
    image's rows of the band (``img``'s own for a whole frame). The kernel
    launches on the current stream and nothing synchronises."""
    global launches
    _check_band("warp_bilinear", img, flow, row0, _GRAD_HINT)
    n, c, hs, w = img.shape
    h = flow.shape[2]
    out = torch.empty_like(img.narrow(2, row0, h))
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        rc = _kernel()(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype], int(bool(zeros)),
            n, c, h, w, hs, row0, *img.stride(), *flow.stride(), *out.stride(),
            _stream(img),
        )
    if rc != 0:
        raise RuntimeError(f"warp kernel launch failed: cfi_warp_bilinear returned {rc}")
    launches += 1
    return out


def warp_bilinear_wide(img: torch.Tensor, flow: torch.Tensor, zeros: bool = False, row0: int = 0) -> torch.Tensor:
    """:func:`warp_bilinear` by the wide-channel kernel, for ``channels_last``
    features (FILM's, C = 64 to 960; M2M's, C = 32 to 384; IFRNet's and
    AMT's, C = 20 to 54; RIFE 4.0's Contextnet, C = 16 to 128), with the
    same row band (``row0``: the flow's rows from source row ``row0`` of
    ``img``'s).

    The kernel reads each pixel's channels as contiguous vectors, so ``img``
    must have channel stride 1 (``img.stride(1) == 1``, as a
    ``channels_last`` tensor or an NHWC tensor's permuted view has). Given
    any other layout, the wrapper makes one ``channels_last`` copy of ``img``
    first. Batch, row and pixel strides are free: the vector width is the
    widest of 16, 8 and 4 bytes that divides the pixel's bytes, the strides
    and the base addresses, and a channel slice with an odd start is read an
    element at a time. The output is a new ``channels_last`` tensor of the
    band's rows. The kernel launches on the current stream and nothing
    synchronises."""
    global wide_launches
    _check_band("warp_bilinear_wide", img, flow, row0, _GRAD_HINT)
    n, c, hs, w = img.shape
    h = flow.shape[2]
    if c > 1 and img.stride(1) != 1:
        img = img.contiguous(memory_format=torch.channels_last)  # the one documented copy
    out = torch.empty((n, c, h, w), dtype=img.dtype, device=img.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    si, so = img.stride(), out.stride()
    with torch.cuda.device(img.device):
        rc = _wide_kernel()(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype], int(bool(zeros)),
            n, c, h, w, hs, row0, si[0], si[2], si[3], *flow.stride(), so[0], so[2], so[3],
            _stream(img),
        )
    if rc != 0:
        raise RuntimeError(f"wide warp kernel launch failed: cfi_warp_bilinear_wide returned {rc}")
    wide_launches += 1
    return out


def warp_bilinear_backward(
    img: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor, zeros: bool = False, img_grad: bool = True,
    row0: int = 0,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The gradient of the warp of ``img`` ``[N, C, H, W]`` by ``flow``
    ``[N, 2, H, W]`` for the output's gradient ``grad_out`` ``[N, C, H, W]``
    (``img``'s dtype): ``(grad_img, grad_flow)`` in the dtypes and shapes of
    ``img`` and ``flow``. With ``img_grad=False`` the image's gradient is not
    computed and ``grad_img`` is None.

    A row band (``row0``, as :func:`warp_bilinear`): ``flow`` and
    ``grad_out`` have the band's ``Hb`` rows, ``grad_flow`` covers the
    band, and ``grad_img`` the whole source: the band's part of the sum.

    Any strides for every input (an expanded ``grad_out`` too).
    ``grad_img`` is summed with ``float4`` atomics into a zeroed f32 buffer
    ``[N, H, W, Cp]`` (:func:`padded_channels`), the image's
    ``channels_last`` layout but for the padded channels. For an f32 image
    ``grad_img`` is that buffer's ``[..., :C]`` view, permuted to ``[N, C,
    H, W]`` (strides ``(H*W*Cp, 1, W*Cp, Cp)``); for bf16/f16 one cast
    writes it in ``img``'s layout. ``grad_flow`` is summed per pixel in
    f32. The kernel launches on the current stream and nothing
    synchronises."""
    global backward_launches
    _check_band("warp_bilinear_backward", img, flow, row0)
    n, c, hs, w = img.shape
    h = flow.shape[2]
    if grad_out.shape != (n, c, h, w) or grad_out.dtype != img.dtype or grad_out.device != img.device:
        raise ValueError(
            f"warp_bilinear_backward: grad_out must be {(n, c, h, w)} {img.dtype} on {img.device}, "
            f"got {tuple(grad_out.shape)} {grad_out.dtype} on {grad_out.device}"
        )
    cp = padded_channels(c)
    buf = torch.zeros((n, hs, w, cp), dtype=torch.float32, device=img.device) if img_grad else None
    gf = torch.empty_like(flow)
    if img.numel() == 0 or gf.numel() == 0:
        return (None if buf is None else torch.zeros_like(img)), gf.zero_()
    isz = img.element_size()
    with torch.cuda.device(img.device):
        rc = _backward_kernel()(
            img.data_ptr(), flow.data_ptr(), grad_out.data_ptr(), 0 if buf is None else buf.data_ptr(), gf.data_ptr(),
            DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype], int(bool(zeros)),
            n, c, h, w, hs, row0, *img.stride(), *flow.stride(), *grad_out.stride(), *gf.stride(), cp,
            vector_bytes(c, img.stride(), isz, img.data_ptr()), vector_bytes(c, grad_out.stride(), isz, grad_out.data_ptr()),
            _stream(img),
        )
    if rc != 0:
        raise RuntimeError(f"warp backward kernel launch failed: cfi_warp_bilinear_backward returned {rc}")
    backward_launches += 1
    if buf is None:
        return None, gf
    gi = buf[..., :c].permute(0, 3, 1, 2)
    if img.dtype != torch.float32:
        gi = torch.empty_like(img).copy_(gi)  # the one pass after the kernel: the cast
    return gi, gf


class WarpFunction(torch.autograd.Function):
    """The warp of ``[N, C, H, W]`` planes by ``[N, 2, H, W]`` flow planes
    (or a row band of them from source row ``row0``) with a gradient: the
    forward launches the kernel that :func:`route` names (K1 or the wide
    kernel), the backward
    :func:`warp_bilinear_backward`. Neither gives way to the plain twin: a
    kernel that does not build or launch raises."""

    @staticmethod
    def forward(ctx, img: torch.Tensor, flow: torch.Tensor, zeros: bool, prefer_wide: bool, row0: int = 0) -> torch.Tensor:
        ctx.save_for_backward(img, flow)
        ctx.zeros = zeros
        ctx.row0 = row0
        # the forward wrappers take no input that needs a gradient: this
        # Function is what differentiates them
        x, f = img.detach(), flow.detach()
        if route(x.shape, x.stride(), x.dtype, prefer_wide) == "wide":
            return warp_bilinear_wide(x, f, zeros, row0=row0)
        return warp_bilinear(x, f, zeros, row0=row0)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out: torch.Tensor):
        img, flow = (t.detach() for t in ctx.saved_tensors)
        grad_img, grad_flow = warp_bilinear_backward(
            img, flow, grad_out, ctx.zeros, ctx.needs_input_grad[0], row0=ctx.row0
        )
        return grad_img, (grad_flow if ctx.needs_input_grad[1] else None), None, None, None
