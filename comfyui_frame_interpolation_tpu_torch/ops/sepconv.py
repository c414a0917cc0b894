"""Adaptive separable convolution, PyTorch port of the JAX package's
``ops/sepconv.py`` (reference ``cupy_ops/sepconv.py``, kernel
``sepconv_out``).

``out[n, y, x, c] = sum_fy sum_fx in[n, y+fy, x+fx, c] * ver[n, y, x, fy] *
hor[n, y, x, fx]``: a K x K filter per pixel, factored into a vertical and a
horizontal K-tap filter per pixel. The caller pads the input by K - 1 (the
model pads each side by 25 for K = 51), so the output has ``ver``'s and
``hor``'s H and W. Products and sums run in f32 in every dtype (the
reference sums with Kahan compensation at K = 51); the result is cast once to
the input's dtype.

Plain PyTorch, as the JAX version is XLA (no Pallas kernel stands behind it).
Unfolding every window at once would hold K * K * C values per pixel (at
C = 4, K = 51: 10,404 floats, about 86 GB at 1080p), so the output is built
in bands of rows: for each vertical tap ``fy``, the band's K-wide rows of
the input are a strided view, multiplied by the horizontal taps and reduced
over them in one pass, then weighted by that tap of the vertical filter. The
horizontal taps stay in their ``[N, H, W, K]`` layout (one pixel's K taps
side by side); the vertical filter is laid out ``[K, N, H, W]`` once, so one
tap of it is contiguous. No temporary exceeds about :data:`BAND_ELEMENTS`
elements.
"""

from __future__ import annotations

import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = ["BAND_ELEMENTS", "sepconv_func"]

# the largest temporary of one band (the products of one vertical tap), in
# elements (f32: 64 MiB)
BAND_ELEMENTS = 1 << 24


def sepconv_func(ten_in: torch.Tensor, ten_ver: torch.Tensor, ten_hor: torch.Tensor) -> torch.Tensor:
    """NHWC ``ten_in`` ``[N, H+K-1, W+K-1, C]``, ``ten_ver`` and ``ten_hor``
    ``[N, H, W, K]`` (views of ``channels_last`` maps are taken as they
    are). Returns ``[N, H, W, C]`` in ``ten_in``'s dtype. Row bands
    (``parallel.space``) go to their own rule."""
    if has_torch_function((ten_in, ten_ver, ten_hor)):
        return handle_torch_function(sepconv_func, (ten_in, ten_ver, ten_hor), ten_in, ten_ver, ten_hor)
    n, hp, wp, c = ten_in.shape
    _, h, w, k = ten_ver.shape
    assert ten_hor.shape == (n, h, w, k), (ten_hor.shape, (n, h, w, k))
    assert hp == h + k - 1 and wp == w + k - 1, (ten_in.shape, ten_ver.shape)
    in32 = ten_in.float()
    hor = ten_hor.float().contiguous()
    ver = ten_ver.float().permute(3, 0, 1, 2).contiguous()  # [K, N, H, W]: one tap contiguous
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=ten_in.device)
    band = max(1, BAND_ELEMENTS // max(1, n * w * c * k))
    for r0 in range(0, h, band):
        r1 = min(h, r0 + band)
        hor_b = hor[:, r0:r1, :, None, :]  # [N, b, W, 1, K]
        acc = torch.zeros((n, r1 - r0, w, c), dtype=torch.float32, device=ten_in.device)
        for fy in range(k):
            rows = in32[:, r0 + fy : r1 + fy].unfold(2, k, 1)  # [N, b, W, C, K] view: rows[.., x, c, fx] = in[.., x+fx, c]
            acc.addcmul_((rows * hor_b).sum(-1), ver[fy, :, r0:r1, :, None])
        out[:, r0:r1] = acc
    return out.to(ten_in.dtype)
