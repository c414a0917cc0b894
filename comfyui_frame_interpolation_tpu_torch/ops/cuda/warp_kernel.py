"""Wrappers of the hand-written Hopper warp kernels (``csrc/warp.cu``).

:func:`warp_bilinear` (K1) replaces the JAX package's Pallas bulk and patch
warp kernels (``comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py``:
``_warp_kernel_diag_roll`` and ``_patch_kernel``) with a tiled kernel for any
strides: a thread per pixel of a 4x32 tile, every tap load of a pixel issued
at once, rows of 8- to 32-byte pixels written back from shared memory as
16-byte vectors. :func:`warp_bilinear_wide` replaces the rows/MXU kernel of
the same file (``_warp_kernel_rows_mxu``): a group of lanes per pixel,
16-byte channel vectors. Both compute the same function from the same
coordinate/weight code, bit for bit. The plain PyTorch version of it is
``ops.warp.warp_torch``; ``ops.warp.warp`` takes the twin for CPU tensors and
the kernel :func:`route` names for CUDA tensors.

``launches`` counts the launches of K1 and ``wide_launches`` those of the
wide kernel, so that a run can show which kernels its main path went
through.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch

from .build import DTYPE_CODES, check_planes_and_flow, load_library

__all__ = [
    "WIDE_MIN_BYTES",
    "launches",
    "route",
    "route_counts",
    "warp_bilinear",
    "warp_bilinear_wide",
    "wide_launches",
]

launches = 0
wide_launches = 0

# a pixel of this many bytes or more, or of a whole number of 16-byte
# vectors, takes the wide kernel (placed on an H100: PERF.md, the routing
# threshold)
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


def _bind(name: str, n_int64: int):
    fn = getattr(load_library("warp"), name)
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would cut them to 32 bits
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64] * n_int64 + [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _kernel():
    return _bind("cfi_warp_bilinear", 16)


@functools.lru_cache(maxsize=None)
def _wide_kernel():
    return _bind("cfi_warp_bilinear_wide", 14)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor, zeros: bool = False) -> torch.Tensor:
    """Backward-warp ``img`` ``[N, C, H, W]`` by ``flow`` ``[N, 2, H, W]``
    (channel 0 = x, 1 = y) on the card, bilinear, with border or zeros padding.

    Any strides; the output has the strides ``torch.empty_like`` gives
    ``img``. The kernel launches on the current stream and nothing
    synchronises."""
    global launches
    check_planes_and_flow("warp_bilinear", img, flow)
    n, c, h, w = img.shape
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        rc = _kernel()(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype], int(bool(zeros)),
            n, c, h, w, *img.stride(), *flow.stride(), *out.stride(),
            _stream(img),
        )
    if rc != 0:
        raise RuntimeError(f"warp kernel launch failed: cfi_warp_bilinear returned {rc}")
    launches += 1
    return out


def warp_bilinear_wide(img: torch.Tensor, flow: torch.Tensor, zeros: bool = False) -> torch.Tensor:
    """:func:`warp_bilinear` by the wide-channel kernel, for ``channels_last``
    images with many channels (FILM's features, C = 64 to 960; M2M's, C = 32
    to 384).

    The kernel reads channels as contiguous 16-byte vectors, so ``img`` must
    have channel stride 1 (``img.stride(1) == 1``, as a ``channels_last``
    tensor or an NHWC tensor's permuted view has). Given any other layout, the
    wrapper makes one ``channels_last`` copy of ``img`` first. Batch, row and
    pixel strides are free, and a channel slice with an unaligned start is
    taken as it is (the kernel reads it with scalar loads). The output is a
    new ``channels_last`` tensor. The kernel launches on the current stream
    and nothing synchronises."""
    global wide_launches
    check_planes_and_flow("warp_bilinear_wide", img, flow)
    n, c, h, w = img.shape
    if c > 1 and img.stride(1) != 1:
        img = img.contiguous(memory_format=torch.channels_last)  # the one documented copy
    out = torch.empty(img.shape, dtype=img.dtype, device=img.device, memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    si, so = img.stride(), out.stride()
    with torch.cuda.device(img.device):
        rc = _wide_kernel()(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(),
            DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype], int(bool(zeros)),
            n, c, h, w, si[0], si[2], si[3], *flow.stride(), so[0], so[2], so[3],
            _stream(img),
        )
    if rc != 0:
        raise RuntimeError(f"wide warp kernel launch failed: cfi_warp_bilinear_wide returned {rc}")
    wide_launches += 1
    return out
