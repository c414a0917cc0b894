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
"""

from __future__ import annotations

import torch

__all__ = ["batch_edt"]


def _dt_1d(data: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """``min_j (data[..., j] + (i - j)^2)`` along the last axis."""
    w = data.shape[-1]
    js = torch.arange(w, dtype=data.dtype, device=data.device)
    outs = []
    for start in range(0, w, chunk):
        i = torch.arange(start, min(start + chunk, w), dtype=data.dtype, device=data.device)
        d2 = (i[:, None] - js[None, :]) ** 2  # [chunk, W]
        outs.append((data[..., None, :] + d2).amin(-1))
    return torch.cat(outs, -1)


def batch_edt(img: torch.Tensor) -> torch.Tensor:
    """``[N, H, W]`` or ``[N, 1, H, W]`` binary map to distances of the same
    shape, in the input's dtype if it is floating, else f32."""
    imgs = img[:, 0] if img.dim() == 4 else img
    if img.dim() == 4 and img.shape[1] != 1:
        raise ValueError(f"expected a single-channel map, got {tuple(img.shape)}")
    _, h, w = imgs.shape
    diam2 = float(h * h + w * w)
    data = (1.0 - imgs.float()) * diam2
    # the x pass, then the y pass on the transposed intermediate
    out = _dt_1d(_dt_1d(data).transpose(1, 2)).transpose(1, 2)
    ans = torch.sqrt(out)
    if torch.is_floating_point(imgs):
        ans = ans.to(imgs.dtype)
    return ans[:, None] if img.dim() == 4 else ans
