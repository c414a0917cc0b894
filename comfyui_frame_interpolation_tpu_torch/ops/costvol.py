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
decoders (``M2M_arch.py:484-494``). Values held as row bands
(``parallel.space.RowBands``) take the row-band rule of ``parallel/``: each
band reads ``R`` = 4 rows of ``ten_two`` beyond its own (:func:`costvol_padded`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["R", "costvol_func", "costvol_padded"]

R = 4  # +-4 window: 9 x 9 = 81 channels


def costvol_func(ten_one: torch.Tensor, ten_two: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` x2 -> ``[N, 81, H, W]`` mean-abs-difference volume."""
    if has_torch_function((ten_one, ten_two)):
        return handle_torch_function(costvol_func, (ten_one, ten_two), ten_one, ten_two)
    return costvol_padded(ten_one, F.pad(ten_two, (R, R, R, R)))


def costvol_padded(ten_one: torch.Tensor, padded: torch.Tensor) -> torch.Tensor:
    """The volume of ``ten_one`` ``[N, C, H, W]`` against ``padded`` ``[N,
    C, H + 2R, W + 2R]``: the second tensor with the ``R`` rows and columns
    around it that the window reads (zeros off the frame)."""
    n, c, h, w = ten_one.shape
    chans = []
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            shifted = padded[:, :, R + dy : R + dy + h, R + dx : R + dx + w]
            chans.append((ten_one - shifted).abs_().mean(1))
    return torch.stack(chans, -1).permute(0, 3, 1, 2)
