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

:func:`correlation_padded` takes the second tensor already padded by ``R``
rows and columns: ``parallel.space`` (to which :func:`correlation_func`
hands row bands over) passes each band the ``R`` rows around it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["R", "correlation_func", "correlation_padded"]

R = 4  # the displacement window's reach


def correlation_func(ten_one: torch.Tensor, ten_two: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C]`` x2 -> ``[N, H, W, 81]`` channel-mean products, NHWC
    (a ``channels_last`` tensor's permuted view is taken as it is)."""
    if has_torch_function((ten_one, ten_two)):
        return handle_torch_function(correlation_func, (ten_one, ten_two), ten_one, ten_two)
    return correlation_padded(ten_one, F.pad(ten_two.float(), (0, 0, R, R, R, R)))


def correlation_padded(ten_one: torch.Tensor, padded: torch.Tensor) -> torch.Tensor:
    """:func:`correlation_func` of ``ten_one`` and a second tensor given as
    ``padded``: ``[N, H + 2R, W + 2R, C]``, f32, zeros (or the rows of a
    neighbouring band) around it."""
    n, h, w, c = ten_one.shape
    one = ten_one.float()
    shifts = [(dy, dx) for dy in range(2 * R + 1) for dx in range(2 * R + 1)]
    if torch.is_grad_enabled() and (ten_one.requires_grad or padded.requires_grad):
        out = torch.stack([(one * padded[:, dy : dy + h, dx : dx + w]).sum(-1) for dy, dx in shifts], -1)
        return out.div(c).to(ten_one.dtype)
    out = torch.empty((n, h, w, len(shifts)), dtype=torch.float32, device=ten_one.device)
    for k, (dy, dx) in enumerate(shifts):
        torch.sum(one * padded[:, dy : dy + h, dx : dx + w], -1, out=out[..., k])
    return out.div_(c).to(ten_one.dtype)
