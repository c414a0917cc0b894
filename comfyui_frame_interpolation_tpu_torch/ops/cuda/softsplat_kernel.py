"""Wrapper of the hand-written Hopper forward-splat kernel (``csrc/softsplat.cu``).

It replaces the JAX package's Pallas splat kernels
(``comfyui_frame_interpolation_tpu/ops/pallas/softsplat_kernel.py``:
``_splat_kernel_stacked``, the banded splat, and ``_splat_kernel``, the
single-band splat) with one atomic scatter: vector (float4/float2) atomics
where the output's channels are contiguous and aligned, and, for up to 4
channels, the corners that neighbouring sources share summed in the block
before they are added. The plain PyTorch version of the
same function is ``ops.softsplat.softsplat_torch``; ``ops.softsplat.softsplat_func``
picks between the two by the tensor's device.

``launches`` counts the kernel launches made through :func:`softsplat_bilinear`,
so that a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import DTYPE_CODES, check_planes_and_flow, load_library

__all__ = ["launches", "softsplat_bilinear"]

launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("softsplat").cfi_softsplat
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 16
        + [ctypes.c_void_p]
    )
    return fn


def softsplat_bilinear(ten_in: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Forward-splat ``ten_in`` ``[N, C, H, W]`` by ``flow`` ``[N, 2, H, W]``
    (channel 0 = x, 1 = y) on the card, bilinear, dropping corners off the
    frame and sources with a non-finite target.

    Any strides are taken (NCHW-contiguous, ``channels_last``, permuted
    views). The result is float32, with the strides ``torch.zeros_like``
    gives ``ten_in``; the kernel launches on the current stream and nothing
    synchronises."""
    global launches
    check_planes_and_flow(
        "softsplat_bilinear", ten_in, flow, "the splat's backward (its input and flow gradients) is still to port"
    )
    n, c, h, w = ten_in.shape
    out = torch.zeros_like(ten_in, dtype=torch.float32)
    if out.numel() == 0:
        return out
    with torch.cuda.device(ten_in.device):
        stream = torch.cuda.current_stream(ten_in.device).cuda_stream
        rc = _kernel()(
            ten_in.data_ptr(), flow.data_ptr(), out.data_ptr(),
            DTYPE_CODES[ten_in.dtype], DTYPE_CODES[flow.dtype],
            n, c, h, w, *ten_in.stride(), *flow.stride(), *out.stride(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"splat kernel launch failed: cfi_softsplat returned {rc}")
    launches += 1
    return out
