"""81-channel L1 cost volume, PyTorch port of the JAX package's
``ops/costvol.py`` (reference ``cupy_ops/costvol.py`` kernel ``costvol_out``).

For displacement ``(dy, dx)`` in the +-4 window, output channel
``(dy+4)*9 + (dx+4)`` holds ``mean_c |one[c, y, x] - two[c, y+dy, x+dx]|``;
displaced pixels off the frame compare against zero.

Plain PyTorch, as the JAX package keeps it on XLA: zero-pad ``two``, then 81
shifted slices. A hand-written kernel waits until a trace on the card
attributes time to it (``ROADMAP.md`` Queue 1, the levers in ported modules).

Layout: NCHW tensors (the models hold them in ``channels_last`` memory); the
result is ``[N, 81, H, W]`` in ``channels_last`` memory. Used by M2M's
decoders (``M2M_arch.py:484-494``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["costvol_func"]

_R = 4  # +-4 window: 9 x 9 = 81 channels


def costvol_func(ten_one: torch.Tensor, ten_two: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` x2 -> ``[N, 81, H, W]`` mean-abs-difference volume."""
    n, c, h, w = ten_one.shape
    padded = F.pad(ten_two, (_R, _R, _R, _R))
    chans = []
    for dy in range(-_R, _R + 1):
        for dx in range(-_R, _R + 1):
            shifted = padded[:, :, _R + dy : _R + dy + h, _R + dx : _R + dx + w]
            chans.append((ten_one - shifted).abs_().mean(1))
    return torch.stack(chans, -1).permute(0, 3, 1, 2)
