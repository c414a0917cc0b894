"""Batched Euclidean distance transform, PyTorch port of the JAX package's
``ops/edt.py`` (reference ``cupy_ops/batch_edt.py``).

Input is a binary edge map (white lines on black); output is the Euclidean
distance to the nearest edge pixel, the image diameter for an empty image.
Each axis is one min-plus pass, ``out[..., i] = min_j (data[..., j] + (i -
j)^2)``, first along x, then along y, then ``sqrt``; a pass is computed in
chunks of output positions against a ``[chunk, W]`` squared-distance matrix,
so its temporary is ``[N, H, chunk, W]``. Every value is an integer squared
distance held in f32, exact below 2**24, so the result is bit for bit the
JAX package's. Plain PyTorch: the JAX package has no Pallas kernel for it.

The x pass is row-local; the y pass reads every row of the x pass's result
and makes any run of output rows from it (:func:`y_pass`), which is how a
map held as row bands (``parallel.space``) computes each band's rows.
"""

from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["batch_edt", "x_pass", "y_pass"]


def _dt_1d(data: torch.Tensor, chunk: int = 256, lo: int = 0, hi: int = -1) -> torch.Tensor:
    """``min_j (data[..., j] + (i - j)^2)`` along the last axis, for the
    outputs ``i`` from ``lo`` to ``hi`` (all of them by default)."""
    w = data.shape[-1]
    hi = w if hi < 0 else hi
    js = torch.arange(w, dtype=data.dtype, device=data.device)
    outs = []
    for start in range(lo, hi, chunk):
        i = torch.arange(start, min(start + chunk, hi), dtype=data.dtype, device=data.device)
        d2 = (i[:, None] - js[None, :]) ** 2  # [chunk, W]
        outs.append((data[..., None, :] + d2).amin(-1))
    return torch.cat(outs, -1)


def x_pass(imgs: torch.Tensor, diam2: float) -> torch.Tensor:
    """The x pass of ``[N, H, W]`` maps (of any rows): each pixel's least
    squared distance along its row to an edge, ``diam2`` where the row has
    none."""
    return _dt_1d((1.0 - imgs.float()) * diam2)


def y_pass(xs: torch.Tensor, row0: int, rows: int, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``row0`` to ``row0 + rows`` of the distances, from the whole
    frame's x pass ``xs`` (``[N, H, W]``): the y pass on the transposed
    intermediate, the root, cast to ``dtype``."""
    out = _dt_1d(xs.transpose(1, 2), lo=row0, hi=row0 + rows).transpose(1, 2)
    return torch.sqrt(out).to(dtype)


def batch_edt(img: torch.Tensor) -> torch.Tensor:
    """``[N, H, W]`` or ``[N, 1, H, W]`` binary map to distances of the same
    shape, in the input's dtype if it is floating, else f32. Row bands
    (``parallel.space``) go to their own rule."""
    if has_torch_function((img,)):
        return handle_torch_function(batch_edt, (img,), img)
    imgs = img[:, 0] if img.dim() == 4 else img
    if img.dim() == 4 and img.shape[1] != 1:
        raise ValueError(f"expected a single-channel map, got {tuple(img.shape)}")
    _, h, w = imgs.shape
    dtype = imgs.dtype if torch.is_floating_point(imgs) else torch.float32
    ans = y_pass(x_pass(imgs, float(h * h + w * w)), 0, h, dtype)
    return ans[:, None] if img.dim() == 4 else ans
