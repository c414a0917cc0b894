"""PWC-style 81-channel correlation, PyTorch port of the JAX package's
``ops/correlation.py`` (reference ``cupy_ops/correlation.py``).

For each displacement ``(dy, dx)`` in the ±4 window, output channel
``(dy+4)*9 + (dx+4)`` is the channel mean of ``one[y, x] * two[y+dy, x+dx]``;
displaced pixels outside the frame contribute zero. The JAX version is XLA,
not a Pallas kernel, and so is this one plain PyTorch: 81 shifted products,
each summed over the channels in f32 and divided by C, cast once to the
input dtype. Used by STMFNet's PWCNet inside ``leaky_relu(0.1)``.

Without a gradient the 81 sums are written into one preallocated output
(``out=``); autograd cannot differentiate ``out=`` calls, so when grad mode
is on and an input needs a gradient the same 81 sums are stacked instead:
the same values, bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["correlation_func"]

_R = 4


def correlation_func(ten_one: torch.Tensor, ten_two: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C]`` x2 -> ``[N, H, W, 81]`` channel-mean products, NHWC
    (a ``channels_last`` tensor's permuted view is taken as it is)."""
    n, h, w, c = ten_one.shape
    one = ten_one.float()
    padded = F.pad(ten_two.float(), (0, 0, _R, _R, _R, _R))
    shifts = [(dy, dx) for dy in range(2 * _R + 1) for dx in range(2 * _R + 1)]
    if torch.is_grad_enabled() and (ten_one.requires_grad or ten_two.requires_grad):
        out = torch.stack([(one * padded[:, dy : dy + h, dx : dx + w]).sum(-1) for dy, dx in shifts], -1)
        return out.div(c).to(ten_one.dtype)
    out = torch.empty((n, h, w, len(shifts)), dtype=torch.float32, device=ten_one.device)
    for k, (dy, dx) in enumerate(shifts):
        torch.sum(one * padded[:, dy : dy + h, dx : dx + w], -1, out=out[..., k])
    return out.div_(c).to(ten_one.dtype)
