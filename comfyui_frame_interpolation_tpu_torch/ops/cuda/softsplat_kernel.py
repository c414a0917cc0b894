"""Wrappers of the hand-written Hopper splat kernels (``csrc/softsplat.cu``).

:func:`softsplat_bilinear` (K2) replaces the JAX package's Pallas splat
kernels (``comfyui_frame_interpolation_tpu/ops/pallas/softsplat_kernel.py``:
``_splat_kernel_stacked``, the banded splat, and ``_splat_kernel``, the
single-band splat) with one atomic scatter: vector (float4/float2) atomics
where the output's channels are contiguous and aligned, and, for up to 4
channels, the corners that neighbouring sources share summed in the block
before they are added. The plain PyTorch version of the
same function is ``ops.softsplat.softsplat_torch``; ``ops.softsplat.softsplat_func``
picks between the two by the tensor's device.

:func:`softsplat_bilinear_backward` is the splat's gradient (``grad_in``,
``grad_flow``) by a second kernel of ``csrc/softsplat.cu``, which shares K2's
corner and weight code; :class:`SplatFunction` joins the two for autograd,
and ``ops.softsplat.softsplat_func`` takes it for every CUDA splat whose
input or flow needs a gradient. No Pallas kernel has a backward: the kernel
stands for XLA's VJP of the scatter-add in the JAX package's
``ops/softsplat.py:_softsplat_xla``, and its plain version is
``ops.softsplat.softsplat_backward_torch``. The gradient is a gather (each
source reads the output's gradient at its own four corners and writes only
its own pixel), so it takes no atomics and no zeroed buffer, and two
launches give the same bits.

K2 takes a band of sources (``row0``, ``out_rows``; the ``space`` axis of
``parallel/``): the values and the flow cover ``h`` source rows from global
row ``row0``, the output is the whole frame's ``out_rows`` rows, the
band's partial sum. The drops and the clamp use the whole frame's height,
so the bands' partial sums add up to the whole-frame splat up to the order
of the f32 atomics. The backward takes the same band: a band's sources read
the whole frame's output gradient ``[N, C, out_rows, W]`` at their global
corners, so a band's launch gives the whole-frame launch's rows of its
sources bit for bit, and :class:`SplatFunction` carries ``row0`` and
``out_rows`` into both launches (the band's partial has a gradient).

``launches`` counts the launches of K2 and ``backward_launches`` those of the
backward kernel, so that a run can show that its main path went through
them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from .build import DTYPE_CODES, check_planes_and_flow, load_library

__all__ = ["SplatFunction", "backward_launches", "launches", "softsplat_bilinear", "softsplat_bilinear_backward"]

launches = 0
backward_launches = 0

# what a direct call of the forward wrapper with an input that needs a
# gradient is told
_GRAD_HINT = "call ops.softsplat.softsplat_func, whose autograd Function (SplatFunction) has the backward kernel"


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("softsplat").cfi_softsplat
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 18
        + [ctypes.c_void_p]
    )
    return fn


@functools.lru_cache(maxsize=None)
def _backward_kernel():
    fn = load_library("softsplat").cfi_softsplat_backward
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 26 + [ctypes.c_void_p]
    )
    return fn


def softsplat_bilinear(
    ten_in: torch.Tensor, flow: torch.Tensor, row0: int = 0, out_rows: Optional[int] = None
) -> torch.Tensor:
    """Forward-splat ``ten_in`` ``[N, C, H, W]`` by ``flow`` ``[N, 2, H, W]``
    (channel 0 = x, 1 = y) on the card, bilinear, dropping corners off the
    frame and sources with a non-finite target.

    A band of sources: with ``row0`` and ``out_rows``, ``ten_in`` and
    ``flow`` are the global rows ``row0`` to ``row0 + H`` of a frame of
    ``out_rows`` rows, source ``(x, y)`` lands at ``(x + fx, row0 + y +
    fy)``, and the result ``[N, C, out_rows, W]`` is the band's part of the
    whole frame's splat.

    Any strides are taken (NCHW-contiguous, ``channels_last``, permuted
    views). The result is float32, with the strides ``torch.zeros_like``
    gives ``ten_in`` (for a band, ``channels_last`` where ``ten_in``'s
    channels are contiguous); the kernel launches on the current stream and
    nothing synchronises."""
    global launches
    check_planes_and_flow("softsplat_bilinear", ten_in, flow, _GRAD_HINT)
    n, c, h, w = ten_in.shape
    ho = h if out_rows is None else out_rows
    if not 0 <= row0 <= ho - h:
        raise ValueError(f"softsplat_bilinear: a band of {h} rows from row {row0} does not lie within {ho} output rows")
    if ho == h:
        out = torch.zeros_like(ten_in, dtype=torch.float32)
    else:
        fmt = torch.channels_last if ten_in.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format
        out = torch.empty((n, c, ho, w), dtype=torch.float32, device=ten_in.device, memory_format=fmt).zero_()
    if ten_in.numel() == 0:
        return out
    with torch.cuda.device(ten_in.device):
        stream = torch.cuda.current_stream(ten_in.device).cuda_stream
        rc = _kernel()(
            ten_in.data_ptr(), flow.data_ptr(), out.data_ptr(),
            DTYPE_CODES[ten_in.dtype], DTYPE_CODES[flow.dtype],
            n, c, h, w, ho, row0, *ten_in.stride(), *flow.stride(), *out.stride(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"splat kernel launch failed: cfi_softsplat returned {rc}")
    launches += 1
    return out


def softsplat_bilinear_backward(
    ten_in: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor, in_grad: bool = True, row0: int = 0,
    out_rows: Optional[int] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The gradient of :func:`softsplat_bilinear` of ``ten_in`` ``[N, C, H,
    W]`` by ``flow`` ``[N, 2, H, W]`` for the output's gradient ``grad_out``
    (``[N, C, out_rows, W]`` float32, the forward's output dtype):
    ``(grad_in, grad_flow)`` in the dtypes and shapes of ``ten_in`` and
    ``flow``. With ``in_grad=False`` the input's gradient is not computed and
    ``grad_in`` is None. A band of sources as the forward takes it:
    ``row0`` and ``out_rows`` (``H`` by default) place the band's rows in
    the frame whose gradient ``grad_out`` is.

    Any strides for every input, an expanded ``grad_out`` (stride 0)
    included, which the kernel reads in place. The kernel writes every
    element of both gradients (no zero fill) and sums in f32; the
    gradients have the strides ``torch.empty_like`` gives their inputs. It
    launches on the current stream and nothing synchronises."""
    global backward_launches
    check_planes_and_flow("softsplat_bilinear_backward", ten_in, flow, _GRAD_HINT)
    n, c, h, w = ten_in.shape
    ho = h if out_rows is None else out_rows
    if not 0 <= row0 <= ho - h:
        raise ValueError(f"softsplat_bilinear_backward: a band of {h} rows from row {row0} does not lie within {ho} output rows")
    if grad_out.shape != (n, c, ho, w) or grad_out.dtype != torch.float32 or grad_out.device != ten_in.device:
        raise ValueError(
            f"softsplat_bilinear_backward: grad_out must be {(n, c, ho, w)} float32 on {ten_in.device}, "
            f"got {tuple(grad_out.shape)} {grad_out.dtype} on {grad_out.device}"
        )
    gi = torch.empty_like(ten_in) if in_grad else None
    gf = torch.empty_like(flow)
    with torch.cuda.device(ten_in.device):
        stream = torch.cuda.current_stream(ten_in.device).cuda_stream
        rc = _backward_kernel()(
            ten_in.data_ptr(), flow.data_ptr(), grad_out.data_ptr(),
            None if gi is None else gi.data_ptr(), gf.data_ptr(),
            DTYPE_CODES[ten_in.dtype], DTYPE_CODES[flow.dtype],
            n, c, h, w, ho, row0, *ten_in.stride(), *flow.stride(), *grad_out.stride(),
            *((0, 0, 0, 0) if gi is None else gi.stride()), *gf.stride(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"splat backward kernel launch failed: cfi_softsplat_backward returned {rc}")
    backward_launches += 1
    return gi, gf


class SplatFunction(torch.autograd.Function):
    """The splat of ``[N, C, H, W]`` planes by ``[N, 2, H, W]`` flow planes
    with a gradient: the forward launches K2 (:func:`softsplat_bilinear`,
    float32 out), the backward :func:`softsplat_bilinear_backward`; with
    ``row0`` and ``out_rows``, both on the band (the band's partial of the
    whole frame, ``[N, C, out_rows, W]``). Neither gives way to the plain
    twin: a kernel that does not build or launch raises."""

    @staticmethod
    def forward(ctx, ten_in: torch.Tensor, flow: torch.Tensor, row0: int = 0, out_rows: Optional[int] = None) -> torch.Tensor:
        ctx.save_for_backward(ten_in, flow)
        ctx.band = (row0, out_rows)
        # the wrappers take no input that needs a gradient: this Function is
        # what differentiates them
        return softsplat_bilinear(ten_in.detach(), flow.detach(), row0, out_rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out: torch.Tensor):
        ten_in, flow = (t.detach() for t in ctx.saved_tensors)
        row0, out_rows = ctx.band
        grad_in, grad_flow = softsplat_bilinear_backward(
            ten_in, flow, grad_out, ctx.needs_input_grad[0], row0=row0, out_rows=out_rows
        )
        return grad_in, (grad_flow if ctx.needs_input_grad[1] else None), None, None
