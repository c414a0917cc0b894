"""AMT's bidirectional correlation lookup, PyTorch port of the JAX package's
``models/amt.py:_BidirCorr`` (reference ``amt_arch.py:1076-1151``,
``BidirCorrBlock``).

The reference builds the all-pairs volume ``<f0_i, f1_j> / sqrt(C)`` at 1/8
resolution, avg-pools it into a 4-level pyramid over the target axes and
samples a ``(2r+1)^2`` window of each level bilinearly (zeros padding)
around each query's coordinates. The volume is linear in the target
features, so, as in the JAX package, only the two feature pyramids are kept
(3 avg-pools each) and each lookup dots the query's feature with pooled
target features gathered around it. The window's offsets are integers, so
its taps share one fractional part per axis: one ``(2r+2)^2`` integer patch
around ``floor(coords / 2^l)`` is gathered and dotted with the query, and
the window is the lerp of its four integer-shifted ``(2r+1)^2`` sub-windows.
A window that lies wholly outside the pooled map gives zeros; one that
overlaps it reads zeros from the padding. The tap order is the reference's:
the outer index is the x offset (``amt_arch.py:1119-1121``).

Coordinates, the gathered features and the dots are f32 in every dtype (the
JAX package builds the coordinates in the images' dtype, which in bf16 keeps
no fraction from 128 up: 1080p has W/8 = 240); the result is cast once to
the features' dtype. The padded pyramid is held as its runs of ``2r+2`` consecutive
pixels, so that each patch row is one gathered ``[2r+2, C]`` block. The
patches are gathered and dotted in bands of queries, all four levels at
once, so that the gathered ``[queries, levels, (2r+2)^2, C]`` transient
stays under :data:`BAND_ELEMENTS` elements; the index arithmetic before the
bands and the lerp after them run once over all queries (a band is two
launches: the host, at ~0.03 ms a launch, would otherwise set the pace). Plain PyTorch: the JAX version is XLA,
no Pallas kernel.

Without a gradient the bands' dots are written into one preallocated buffer
(``out=``). Autograd cannot differentiate ``out=`` calls, so when grad mode
is on and the query, the pyramid or the coordinates need a gradient, each
band's dots are a new tensor and one ``cat`` joins them (the same values,
bit for bit). Autograd then keeps each band's gathered patch for the
query's gradient, C times the dots' size: at AMT-S's training crop, b8 x
256x256 (32x32 queries a frame at 1/8, C = 84), 8192 queries x 4 levels x
8x8 taps x 84 channels x 4 bytes = 705 MB a direction and lookup, 4.2 GB for
the three lookups of both directions in one forward.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["BAND_ELEMENTS", "BidirCorr"]

# the largest gathered temporary of one band, in elements (f32: 256 MiB)
BAND_ELEMENTS = 1 << 26


class _Pyramid:
    """One feature map's 4-level avg-pool pyramid, f32, each level NHWC and
    zero-padded by ``2r+2`` on every side, all levels in one flat buffer of
    pixels, held as its overlapping runs of ``2r+2`` pixels (``rows``)."""

    def __init__(self, fmap: torch.Tensor, levels: int, pp: int):
        x = fmap.float()
        b, c = x.shape[:2]
        flats, sizes, offsets, off = [], [], [], 0
        for lvl in range(levels):
            if lvl:  # a map under 2 pixels pools to an empty level, which reads as zeros (as in JAX)
                x = F.avg_pool2d(x, 2, 2) if min(x.shape[2:]) >= 2 else x[:, :, : x.shape[2] // 2, : x.shape[3] // 2]
            hl, wl = x.shape[2:]
            padded = F.pad(x.permute(0, 2, 3, 1), (0, 0, pp, pp, pp, pp))
            flats.append(padded.reshape(-1, c))
            sizes.append((hl, wl))
            offsets.append(off)
            off += flats[-1].shape[0]
        flat = torch.cat(flats)
        # every run of pp pixels along a padded row, as one [pp, C] block:
        # a patch row is then one gathered block
        self.rows = flat.unfold(0, pp, 1).permute(0, 2, 1).contiguous()  # [rows - pp + 1, pp, C]
        dev = fmap.device
        self.hw = torch.tensor(sizes, dtype=torch.int64, device=dev)  # [levels, 2]
        self.offsets = torch.tensor(offsets, dtype=torch.int64, device=dev)
        self.levels = levels


class BidirCorr:
    """``BidirCorrBlock`` on NCHW feature maps ``f0``, ``f1`` ``[B, C, H,
    W]`` (1/8 resolution): :meth:`lookup` gives both directions' windows."""

    def __init__(self, f0: torch.Tensor, f1: torch.Tensor, levels: int = 4, radius: int = 3):
        self.radius, self.levels = radius, levels
        pp = 2 * radius + 2
        self.f0, self.f1 = f0, f1
        self.pyr0, self.pyr1 = _Pyramid(f0, levels, pp), _Pyramid(f1, levels, pp)

    def lookup(self, coords0: torch.Tensor, coords1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``coords*`` ``[B, H, W, 2]`` f32 pixel coordinates (x, y) at 1/8
        resolution: ``f0``'s queries in ``f1``'s pyramid at ``coords0`` and
        ``f1``'s in ``f0``'s at ``coords1``, each ``[B, levels*(2r+1)^2, H,
        W]`` in the features' dtype, level-major."""
        return self.windowed(self.f0, self.pyr1, coords0), self.windowed(self.f1, self.pyr0, coords1)

    def windowed(self, query: torch.Tensor, pyr: _Pyramid, coords: torch.Tensor) -> torch.Tensor:
        b, c, h, w = query.shape
        r, lv = self.radius, pyr.levels
        n, pp = 2 * r + 1, 2 * r + 2
        nq = b * h * w
        dev = query.device
        q_all = query.permute(0, 2, 3, 1).reshape(nq, c).float()
        inv = torch.tensor([2.0**-k for k in range(lv)], device=dev).view(1, lv, 1)
        cl = coords.reshape(nq, 1, 2).float() * inv  # [Q, levels, 2]
        fl = torch.floor(cl)
        t = cl - fl
        bx = fl[..., 0].long() - r
        by = fl[..., 1].long() - r
        hl, wl = pyr.hw[:, 0], pyr.hw[:, 1]
        ok = (bx + n >= 0) & (bx <= wl - 1) & (by + n >= 0) & (by <= hl - 1)
        bx = torch.minimum((bx + pp).clamp_min(0), wl + pp)
        by = torch.minimum((by + pp).clamp_min(0), hl + pp)
        hpad, wpad = hl + 2 * pp, wl + 2 * pp
        bi = (torch.arange(nq, device=dev) // (h * w)).view(-1, 1)
        base = pyr.offsets + (bi * hpad + by) * wpad + bx  # [Q, levels]
        # each patch row's first pixel, [Q * levels * pp]
        idx = (base[..., None] + torch.arange(pp, device=dev).view(1, 1, pp) * wpad.view(1, lv, 1)).view(-1)
        # the dots, band by band (the gathered patches are C times the dots' size)
        band = max(1, BAND_ELEMENTS // (lv * pp * pp * c))
        bands = [(q0, min(nq, q0 + band)) for q0 in range(0, nq, band)]

        def dots(q0, q1, out=None):
            patch = pyr.rows.index_select(0, idx[q0 * lv * pp : q1 * lv * pp]).view(q1 - q0, lv * pp * pp, c)
            return torch.bmm(patch, q_all[q0:q1, :, None], out=out)

        if torch.is_grad_enabled() and (query.requires_grad or pyr.rows.requires_grad or coords.requires_grad):
            d = torch.cat([dots(q0, q1) for q0, q1 in bands])
        else:
            d = torch.empty((nq, lv * pp * pp, 1), dtype=torch.float32, device=dev)
            for q0, q1 in bands:
                dots(q0, q1, out=d[q0:q1])
        d = d.view(nq, lv, pp, pp) * ok[..., None, None]
        tx, ty = t[..., 0, None, None], t[..., 1, None, None]
        dy = (1.0 - ty) * d[:, :, :n, :] + ty * d[:, :, 1:, :]
        dxy = (1.0 - tx) * dy[..., :n] + tx * dy[..., 1:]  # [Q, levels, y offset, x offset]
        out = dxy.transpose(-1, -2).reshape(nq, lv * n * n) * (1.0 / math.sqrt(c))
        return out.view(b, h, w, -1).permute(0, 3, 1, 2).to(query.dtype)
