"""AdaCoF deformable adaptive convolution, PyTorch port of the JAX package's
``ops/adacof.py`` (reference ``cupy_ops/adacof.py``,
``kernel_AdaCoF_updateOutput``).

``out[n, i, j, c] = sum_{k,l} w[n, i, j, k*F+l] * bilin(in, i + k*d +
alpha_{kl}, j + l*d + beta_{kl})`` with the reference kernel's corner cases:

* ``A = (int) alpha`` truncates toward zero (not floor), so for a negative
  fractional offset the blend weights leave [0, 1];
* each of a tap's four corner coordinates is clamped to the frame on its
  own (``(clip(p), clip(p + 1))`` per axis).

Shape contract (reference ``adacof.py:274-279``): ``in_H - ((F-1)*d + 1) ==
out_H - 1``: the model pads the input first. Products and sums run in f32;
the result is cast once to the input dtype.

The JAX version is XLA (one gather of a 4-corner copy of the frame for all
taps at once, ``[N, H, W, F*F, 4, C]`` f32: ~10.6 GB for STMFNet's 2x stream
at 1080p). Here the output is built in bands of rows, each band's taps
gathered at once, so that no temporary exceeds about
:data:`BAND_ELEMENTS` elements. Plain PyTorch: no Pallas kernel stands
behind it in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["BAND_ELEMENTS", "adacof_func"]

# the largest gathered temporary of one band, in elements (f32: 128 MiB)
BAND_ELEMENTS = 1 << 25


def adacof_func(
    ten_in: torch.Tensor, weight: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor, dilation: int = 1
) -> torch.Tensor:
    """NHWC ``ten_in`` ``[N, Hp, Wp, C]``; ``weight``, ``alpha`` and ``beta``
    ``[N, H, W, F*F]`` (views of ``channels_last`` maps are taken as they
    are). Returns ``[N, H, W, C]`` in ``ten_in``'s dtype."""
    n, hp, wp, c = ten_in.shape
    _, h, w, ff = weight.shape
    f = int(round(ff**0.5))
    if f * f != ff:
        raise ValueError(f"adacof: {ff} weights per pixel is not a square")
    if hp - ((f - 1) * dilation + 1) != h - 1 or wp - ((f - 1) * dilation + 1) != w - 1:
        raise ValueError(f"adacof: input {tuple(ten_in.shape)} does not fit output {tuple(weight.shape)}")
    dev = ten_in.device
    flat = ten_in.reshape(n, hp * wp, c)
    taps = torch.arange(ff, device=dev)
    k_off = (taps // f * dilation).view(1, 1, 1, ff)
    l_off = (taps % f * dilation).view(1, 1, 1, ff)
    xs = torch.arange(w, device=dev).view(1, 1, w, 1) + l_off
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=dev)
    band = max(1, BAND_ELEMENTS // max(1, n * w * ff * c))
    for r0 in range(0, h, band):
        r1 = min(h, r0 + band)
        a, b = alpha[:, r0:r1].float(), beta[:, r0:r1].float()
        ai, bi = torch.trunc(a), torch.trunc(b)  # C's (int) cast
        fa, fb = a - ai, b - bi
        i0 = torch.arange(r0, r1, device=dev).view(1, -1, 1, 1) + k_off + ai.long()
        j0 = xs + bi.long()
        rows = (i0.clamp(0, hp - 1) * wp, (i0 + 1).clamp(0, hp - 1) * wp)
        cols = (j0.clamp(0, wp - 1), (j0 + 1).clamp(0, wp - 1))
        wf = weight[:, r0:r1].float()
        ya, yb = wf * (1.0 - fa), wf * fa
        acc = None
        for ri, wy in zip(rows, (ya, yb)):
            for ci, wx in zip(cols, (1.0 - fb, fb)):
                idx = (ri + ci).reshape(n, -1, 1).expand(-1, -1, c)
                term = torch.gather(flat, 1, idx).float() * (wy * wx).reshape(n, -1, 1)
                acc = term if acc is None else acc.add_(term)
        out[:, r0:r1] = acc.view(n, r1 - r0, w, ff, c).sum(3)
    return out.to(ten_in.dtype)
