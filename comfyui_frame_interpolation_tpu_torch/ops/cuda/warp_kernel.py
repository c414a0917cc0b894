"""Wrapper of the hand-written Hopper warp kernel (``csrc/warp.cu``).

It replaces the JAX package's Pallas bulk and patch warp kernels
(``comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py``:
``_warp_kernel_diag_roll`` and ``_patch_kernel``) with one direct gather. The
plain PyTorch version of the same function is ``ops.warp.warp_torch``;
``ops.warp.warp`` picks between the two by the tensor's device.

``launches`` counts the kernel launches made through :func:`warp_bilinear`,
so that a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import DTYPE_CODES, check_planes_and_flow, load_library

__all__ = ["launches", "warp_bilinear"]

launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library("warp").cfi_warp_bilinear
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 16
        + [ctypes.c_void_p]
    )
    return fn


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor, zeros: bool = False) -> torch.Tensor:
    """Backward-warp ``img`` ``[N, C, H, W]`` by ``flow`` ``[N, 2, H, W]``
    (channel 0 = x, 1 = y) on the card, bilinear, with border or zeros padding.

    Any strides are taken (NCHW-contiguous, ``channels_last``, permuted
    views); the output has the strides ``torch.empty_like`` gives ``img``. The
    kernel launches on the current stream and nothing synchronises."""
    global launches
    check_planes_and_flow("warp_bilinear", img, flow)
    n, c, h, w = img.shape
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = _kernel()(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype], int(bool(zeros)),
            n, c, h, w, *img.stride(), *flow.stride(), *out.stride(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"warp kernel launch failed: cfi_warp_bilinear returned {rc}")
    launches += 1
    return out
