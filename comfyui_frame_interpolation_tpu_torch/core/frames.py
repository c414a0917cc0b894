"""Frame tensor conventions and padding contracts (port of the JAX package's
``core/frames.py``).

The public IMAGE convention is ComfyUI's: ``[N, H, W, C]`` float32 in [0, 1],
kept NHWC at every public function. Frames may come in as numpy arrays or
torch tensors; ``preprocess_frames`` puts them on the given device.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "preprocess_frames",
    "postprocess_frames",
    "assert_batch_size",
    "pad_to_multiple",
    "unpad",
    "pad_size",
]


def preprocess_frames(
    frames: Union[torch.Tensor, np.ndarray], device: Union[str, torch.device] = "cpu"
) -> torch.Tensor:
    """NHWC in, NHWC on ``device`` out; drops alpha (reference keeps ``[..., :3]``)."""
    frames = torch.as_tensor(frames, device=device)
    if frames.dim() != 4:
        raise ValueError(f"expected [N,H,W,C] frames, got shape {tuple(frames.shape)}")
    return frames[..., :3]


def postprocess_frames(frames: torch.Tensor) -> torch.Tensor:
    """NHWC float32 RGB (reference ``vfi_utils.py:142-143``)."""
    return frames[..., :3].float()


def assert_batch_size(frames, batch_size: int = 2, vfi_name: str = None) -> None:
    """Reference ``vfi_utils.py:145-147``; raises ``ValueError``."""
    subject = "Most VFI models require" if vfi_name is None else f"VFI model {vfi_name} requires"
    n = frames.shape[0]
    if n < batch_size:
        raise ValueError(
            f"{subject} at least {batch_size} frames to work with, only found {n}. "
            "Please check the frame input."
        )


def pad_size(h: int, w: int, multiple: int) -> Tuple[int, int]:
    """Padded (H, W) rounded up to ``multiple`` (e.g. RIFE: ``rife_arch.py:479-482``)."""
    ph = ((h - 1) // multiple + 1) * multiple
    pw = ((w - 1) // multiple + 1) * multiple
    return ph, pw


def pad_to_multiple(
    x: torch.Tensor, multiple: int, mode: str = "constant"
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Pad NHWC frames on the bottom/right to a multiple (torch ``F.pad``
    convention of the reference archs). Returns (padded, (orig_h, orig_w))."""
    n, h, w, c = x.shape
    ph, pw = pad_size(h, w, multiple)
    if (ph, pw) == (h, w):
        return x, (h, w)
    if mode not in ("constant", "reflect", "replicate"):
        raise ValueError(f"unknown pad mode {mode}")
    padded = F.pad(x.permute(0, 3, 1, 2), (0, pw - w, 0, ph - h), mode=mode)
    return padded.permute(0, 2, 3, 1), (h, w)


def unpad(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    h, w = hw
    return x[:, :h, :w, :]
