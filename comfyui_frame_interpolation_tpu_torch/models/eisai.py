"""EISAI, the anime interpolation model, PyTorch port of the JAX package's
``models/eisai.py`` (reference ``vfi_models/eisai/eisai_arch.py``).

Three networks, one checkpoint each:

* ``raft``: the RAFT-style RFR flow net (``eisai_arch.py:772-953``): a
  residual encoder shared by the feature and context paths, an all-pairs
  correlation pyramid, 12 iterations of a motion encoder and separable
  ConvGRU, convex x8 upsampling. Run once per direction and pair.
* ``ssl``: SoftsplatLite (``eisai_arch.py:2456-2538``): the frames with
  their NEDT edge-distance channel and three ResNet-50 feature levels are
  forward-splatted to time t in ``"soft"`` mode (``ops.softsplat``, K2 on
  the card) with a Lab-colour consistency metric (two border-mode backward
  warps, ``ops.warp``, K1 on the card), fused by a GridNet and a synthesizer.
* ``dtm``: the distance-transform refinement module (``eisai_arch.py:2539-2559``).

Flow conventions follow the reference: the RFR core makes (x, y) flows, the
RAFT wrapper flips them, and everything after it takes (y, x) flows
(``flow_backwarp`` normalises channel 0 by H). Images, features and flows
are NCHW tensors in ``channels_last`` memory inside; frames and the reuse
cache's flows are NHWC at the API, as in the JAX package; the splat and warp
ops take NHWC views.

Kernels on the card, per timestep batch: 8 splats (:data:`SPLAT_CHANNELS_PER_INFER`,
C = 6, 66, 258 and 514, f32 as in the JAX package) and 2 warps of the 3-channel
Lab images (:func:`warps_per_infer`); the RAFT passes (reuse) launch none.

Deliberate differences from the JAX package, none of which changes an fp32
result beyond rounding: both directions' RAFT passes run as one batch, with
one encoder call on both frames (the encoder's feature and context outputs
are the same call in the reference); the dead ``flow_init`` branch of RFR is
not ported (its ``attention2`` weights stay in the state dict, so the real
checkpoint loads). In bf16 the pixel-domain paths run in f32: the Lab metric,
the DoG/NEDT edge maps (a threshold at 0.5 that bf16 rounding would flip,
which the EDT would spread), the NEDT-extended frames, the splats, and the
logit skips of the synthesizer and DTM; RAFT's update block runs in f32 on
its f32 correlation features. JAX reaches the same through type promotion,
which also runs its ResNet, GridNet and synthesizer in f32 there; here they
run in bf16, judged against fp32.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ..ops.cuda.warp_kernel import route_counts
from ..ops.edt import batch_edt
from ..ops.softsplat import function_softsplat
from ..ops.warp import warp
from .common import (
    PRELU_INIT, avg_pool2d, batch_norm, cast_params, device_const, init_state_dict, max_pool2d, prelu, resize_bilinear,
)

__all__ = [
    "CKPT_NAMES",
    "EISAI",
    "PRELU_INIT",
    "SPLAT_CHANNELS_PER_INFER",
    "apply",
    "batch_dog",
    "dtm_forward",
    "flow_backwarp",
    "gaussian_blur",
    "infer",
    "init_params",
    "make_model_fn",
    "make_pair_fns",
    "nedt",
    "pixel_logit",
    "raft_flow",
    "raft_pair",
    "reuse",
    "rfr_flow",
    "rgb_to_grayscale",
    "rgb_to_lab",
    "splats_per_infer",
    "ssl_forward",
    "warps_per_infer",
]

CKPT_NAMES = ["eisai"]
# the channels of each splat per timestep batch: both frames (RGB + NEDT,
# the ones channel, exp(metric)), then the ResNet levels (64, 256 and 512 +
# 2), both directions each
SPLAT_CHANNELS_PER_INFER = (6, 6, 66, 66, 258, 258, 514, 514)
# the Lab images of the consistency metric, one warp per direction
WARP_CHANNELS_PER_INFER = (3, 3)
_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)
_CORR_LEVELS, _CORR_RADIUS = 4, 4
_GRID_C = (32, 64, 128)  # GridNet's channels per level


def _bn(x: torch.Tensor, m: nn.BatchNorm2d) -> torch.Tensor:
    return batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias)


# ---- image utilities (JAX eisai.py:60-210) --------------------------------------


def pixel_logit(x: torch.Tensor, pixel_margin: float = 1.0) -> torch.Tensor:
    """eisai_arch.py:98-101."""
    x = (x * (255.0 - 2.0 * pixel_margin) + pixel_margin) / 255.0
    return torch.log(x / (1.0 - x))


def _gauss_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """kornia ``get_gaussian_kernel1d``: a discrete gaussian over
    ``arange(ksize) - (ksize-1)/2``, normalised to sum 1 (float64, then f32)."""
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """kornia ``gaussian_blur2d(..., border_type="replicate")`` on NCHW: a
    separable depthwise gaussian, rows then columns, on the edge-replicated
    frame."""
    c = x.shape[1]
    k = torch.from_numpy(_gauss_kernel1d(ksize, sigma)).to(device=x.device, dtype=x.dtype)
    pad = ksize // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    out = F.conv2d(xp, k.view(1, 1, ksize, 1).repeat(c, 1, 1, 1), groups=c)
    return F.conv2d(out, k.view(1, 1, 1, ksize).repeat(c, 1, 1, 1), groups=c)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """kornia ``rgb_to_grayscale`` weights, NCHW."""
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def rgb_to_lab(x: torch.Tensor) -> torch.Tensor:
    """kornia ``rgb_to_lab``: sRGB to linear, to XYZ (D65), to CIELAB; NCHW."""
    lin = torch.where(x > 0.04045, torch.pow((x + 0.055) / 1.055, 2.4), x / 12.92)
    r, g, b = lin[:, 0], lin[:, 1], lin[:, 2]
    xx = 0.412453 * r + 0.357580 * g + 0.180423 * b
    yy = 0.212671 * r + 0.715160 * g + 0.072169 * b
    zz = 0.019334 * r + 0.119193 * g + 0.950227 * b
    xyz = torch.stack([xx / 0.950456, yy, zz / 1.088754], 1)
    f = torch.where(xyz > 0.008856, torch.pow(xyz, 1.0 / 3.0), 7.787 * xyz + 4.0 / 29.0)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], 1)


def batch_dog(
    x: torch.Tensor, t: float = 1.0, sigma: float = 1.0, k: float = 1.6, epsilon: float = 0.01,
    kernel_factor: float = 4.0, clip: bool = True,
) -> torch.Tensor:
    """Difference of gaussians on the grayscale image (eisai_arch.py:1541-1576), NCHW."""
    if x.shape[1] in (3, 4):
        x = rgb_to_grayscale(x[:, :3])
    kern0 = max(2 * int(sigma * kernel_factor) + 1, 3)
    kern1 = max(2 * int(sigma * k * kernel_factor) + 1, 3)
    ans = 0.5 + t * (gaussian_blur(x, kern1, sigma * k) - gaussian_blur(x, kern0, sigma)) - epsilon
    return ans.clamp(0.0, 1.0) if clip else ans


def nedt(
    img: torch.Tensor, t: float = 2.0, sigma_factor: float = 1.0 / 540.0, k: float = 1.6, epsilon: float = 0.01,
    kernel_factor: float = 4.0, exp_factor: float = 540.0 / 15.0,
) -> torch.Tensor:
    """NEDT (eisai_arch.py:2235-2263): the normalised Euclidean distance
    transform of the thresholded DoG edge map; ``[N, 1, H, W]`` f32 from NCHW
    images of any dtype (computed in f32)."""
    h, w = img.shape[2], img.shape[3]
    dog = batch_dog(
        img.float(), t=t, sigma=h * sigma_factor, k=k, epsilon=epsilon, kernel_factor=kernel_factor, clip=False
    )
    edt = batch_edt((dog > 0.5).float())
    return 1.0 - torch.exp(-edt * exp_factor / max(h, w))


def _offsets_np(h: int, w: int) -> np.ndarray:
    """``[1, H, W, 2]`` (x, y) offsets that turn an align_corners=False
    ``grid_sample`` of a size-normalised flow into a pixel-offset warp."""
    jj = np.arange(w, dtype=np.float32)
    ii = np.arange(h, dtype=np.float32)
    off_x = jj * np.float32(w / max(w - 1, 1)) - jj - np.float32(0.5)
    off_y = ii * np.float32(h / max(h - 1, 1)) - ii - np.float32(0.5)
    return np.stack(np.broadcast_arrays(off_x[None, :], off_y[:, None]), -1)[None]


@functools.lru_cache(maxsize=None)
def _offsets(h: int, w: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_offsets_np(h, w)).to(device)


def flow_backwarp(img: torch.Tensor, flow_yx: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """eisai_arch.py:954-994: backward-warp NCHW ``img`` by an NCHW (y, x)
    flow with ``grid_sample(align_corners=False)`` semantics, as a pixel-offset
    warp (``ops.warp.warp``, K1 on the card) by the flow plus fixed offsets
    (JAX eisai.py:164-180)."""
    n, _, h, w = img.shape
    adj = flow_yx.flip(1).permute(0, 2, 3, 1).float() + _offsets(h, w, img.device)
    return warp(img.permute(0, 2, 3, 1), adj, padding_mode).permute(0, 3, 1, 2)


def _morph_open(x: torch.Tensor, k: int) -> torch.Tensor:
    """kornia ``morphology.opening`` with a ``k x k`` ones element and
    geodesic borders: erosion with +inf padding, dilation with -inf, the pads
    ``(k // 2, k - 1 - k // 2)`` on each axis."""
    if k == 0:
        return x
    pad = (k // 2, k - 1 - k // 2, k // 2, k - 1 - k // 2)
    er = -max_pool2d(F.pad(-x, pad, value=-math.inf), k, 1)
    return max_pool2d(F.pad(er, pad, value=-math.inf), k, 1)


def _resize(x: torch.Tensor, out_hw: Tuple[int, int], is_flow: bool = False) -> torch.Tensor:
    """``Interpolator`` (eisai_arch.py:1438-1478): bilinear, align_corners=False;
    (y, x) flows are rescaled by the size ratio."""
    h, w = x.shape[2], x.shape[3]
    x = resize_bilinear(x, tuple(out_hw))
    if is_flow:
        x = x * device_const((out_hw[0] / h, out_hw[1] / w), (1, 2, 1, 1), x.device, x.dtype)
    return x


# ---- the RFR flow net (JAX eisai.py:218-424) ----------------------------------------


class _ResBlock(nn.Module):
    """``ResidualBlock`` with ``norm_fn='none'`` (eisai_arch.py:381-434)."""

    def __init__(self, i: int, o: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(i, o, 3, stride, 1)
        self.conv2 = nn.Conv2d(o, o, 3, 1, 1)
        self.downsample = nn.Sequential(nn.Conv2d(i, o, 1, stride)) if stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv2(F.relu(self.conv1(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class _BasicEncoder(nn.Module):
    """``BasicEncoder(output_dim=256, norm_fn='none')`` (eisai_arch.py:497-571)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.layer1 = nn.Sequential(_ResBlock(64, 64, 1), _ResBlock(64, 64, 1))
        self.layer2 = nn.Sequential(_ResBlock(64, 96, 2), _ResBlock(96, 96, 1))
        self.layer3 = nn.Sequential(_ResBlock(96, 128, 2), _ResBlock(128, 128, 1))
        self.conv2 = nn.Conv2d(128, 256, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.layer3(self.layer2(self.layer1(F.relu(self.conv1(x))))))


class _MotionEncoder(nn.Module):
    """``BasicMotionEncoder`` (eisai_arch.py:318-337)."""

    def __init__(self):
        super().__init__()
        self.convc1 = nn.Conv2d(_CORR_LEVELS * (2 * _CORR_RADIUS + 1) ** 2, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, 1, 1)
        self.convf1 = nn.Conv2d(2, 128, 7, 1, 3)
        self.convf2 = nn.Conv2d(128, 64, 3, 1, 1)
        self.conv = nn.Conv2d(256, 126, 3, 1, 1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([cor, flo], 1))), flow], 1)


class _SepConvGRU(nn.Module):
    """``SepConvGRU`` (eisai_arch.py:259-298): a 1x5 then a 5x1 GRU step."""

    def __init__(self, hidden: int = 128, inp: int = 256):
        super().__init__()
        for a, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}{a}", nn.Conv2d(hidden + inp, hidden, k, 1, p))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for a in ("1", "2"):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{a}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{a}")(hx))
            q = torch.tanh(getattr(self, f"convq{a}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class _FlowHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(128, 256, 3, 1, 1)
        self.conv2 = nn.Conv2d(256, 2, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class _UpdateBlock(nn.Module):
    """``BasicUpdateBlock`` (eisai_arch.py:355-379)."""

    def __init__(self):
        super().__init__()
        self.encoder = _MotionEncoder()
        self.gru = _SepConvGRU()
        self.flow_head = _FlowHead()
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, 1, 1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], 1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class _Attention2(nn.Module):
    """The weights of RFR's ``flow_init`` branch, which the node never runs
    (it calls RAFT without an initial flow): kept so the checkpoint loads."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(6, 32, 5, 1, 2)
        self.conv2 = nn.Conv2d(32, 32, 3, 1, 1)
        self.conv3 = nn.Conv2d(38, 1, 3, 1, 1)
        self.prelu1 = nn.PReLU(1)
        self.prelu2 = nn.PReLU(1)


class _RFR(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = _BasicEncoder()
        self.update_block = _UpdateBlock()
        self.attention2 = _Attention2()


def _corr_pyramid(f1: torch.Tensor, f2: torch.Tensor) -> List[torch.Tensor]:
    """``CorrBlock.__init__`` (eisai_arch.py:179-195): all-pairs correlation
    of NCHW features as one batched f32 product, and its average-pooled
    pyramid over the target axes; each level ``[B*H*W, h2, w2]``. ``f1``,
    the queries, may hold some rows of the frame that ``f2`` holds whole (a
    row band's). Row bands of both (``parallel.space``) go to their own
    rule."""
    if has_torch_function((f1, f2)):
        return handle_torch_function(_corr_pyramid, (f1, f2), f1, f2)
    b, c, h, w = f1.shape
    a = f1.float().flatten(2).transpose(1, 2)  # [B, HW, C]
    corr = torch.bmm(a, f2.float().flatten(2)) / math.sqrt(c)  # [B, HW, H2 W2]
    corr = corr.reshape(b * h * w, 1, f2.shape[2], f2.shape[3])
    pyr = [corr[:, 0]]
    for _ in range(_CORR_LEVELS - 1):
        corr = avg_pool2d(corr, 2)
        pyr.append(corr[:, 0])
    return pyr


def _tent(s: torch.Tensor, size: int) -> torch.Tensor:
    """``[N, taps, size]`` bilinear weights of the sample points ``s`` ``[N,
    taps]`` over ``size`` cells, zero outside the frame."""
    g = torch.arange(size, dtype=torch.float32, device=s.device)
    return (1.0 - (s[..., None] - g).abs()).clamp_min(0.0)


def _corr_lookup(pyr: Sequence[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """``CorrBlock.__call__`` (eisai_arch.py:196-217): the ``(2r+1)^2`` window
    around each correspondence at every level, bilinear with zero padding.
    The window is separable, so each level is two batched products with tent
    weights (JAX eisai.py:261-296): tap ``(i, j)`` samples at ``x + d[i]``,
    ``y + d[j]``. ``coords`` is NCHW (x, y) at 1/8 resolution; returns NCHW
    ``[B, levels * (2r+1)^2, H, W]``. A pyramid of row bands
    (``parallel.space``) goes to its own rule."""
    if has_torch_function((pyr, coords)):
        return handle_torch_function(_corr_lookup, (pyr, coords), pyr, coords)
    b, _, h, w = coords.shape
    r = _CORR_RADIUS
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=coords.device)
    cen = coords.permute(0, 2, 3, 1).reshape(-1, 2)
    out = []
    for i, corr in enumerate(pyr):
        c = cen / 2**i
        wy = _tent(c[:, 1:2] + d, corr.shape[1])  # [N, taps, h2]
        wx = _tent(c[:, 0:1] + d, corr.shape[2])  # [N, taps, w2]
        taps = torch.bmm(wx, torch.bmm(wy, corr).transpose(1, 2))  # [N, i, j]
        out.append(taps.reshape(b, h, w, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2)


def _convex_upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``RFR.upsample_flow`` (eisai_arch.py:803-815): each 8x8 block of the
    upsampled NCHW flow is a softmax-convex combination of the 3x3
    neighbourhood of 8 * the flow. Row bands (``parallel.space``) go to
    their own rule."""
    if has_torch_function((flow, mask)):
        return handle_torch_function(_convex_upsample_flow, (flow, mask), flow, mask)
    return convex_upsample_flow_rows(F.pad(flow, (0, 0, 1, 1)), mask)


def convex_upsample_flow_rows(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`_convex_upsample_flow` of the rows of ``mask``: ``flow`` holds
    them and one more above and below (zeros beyond the frame)."""
    b, h, w = mask.shape[0], mask.shape[2], mask.shape[3]
    m = torch.softmax(mask.reshape(b, 9, 8, 8, h, w), 1)
    fp = F.pad(8.0 * flow, (1, 1))
    taps = torch.stack([fp[:, :, di : di + h, dj : dj + w] for di in range(3) for dj in range(3)], 1)
    up = torch.einsum("bkuvhw,bkchw->bchuwv", m, taps)
    return up.reshape(b, 2, 8 * h, 8 * w)


def _coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([gx, gy], 0)[None].expand(b, 2, h, w)


def _rfr_from_features(rfr: _RFR, e1: torch.Tensor, e2: torch.Tensor, hw, hw8, iters: int) -> torch.Tensor:
    """RFR's flow from the encoder outputs of its two images (NCHW ``[B, 256,
    H/8, W/8]``): the correlation pyramid of both, the context of the first,
    ``iters`` update steps, the convex upsampling, the rescale to ``hw``."""
    (h, w), (h8, w8) = hw, hw8
    pyr = _corr_pyramid(e1, e2)
    # the update block runs in f32 (see _load): its correlation features are
    # f32, and so is the GRU state
    net = torch.tanh(e1[:, :128]).float()
    inp = F.relu(e1[:, 128:]).float()
    b, _, gh, gw = e1.shape
    coords0 = _coords_grid(b, gh, gw, e1.device)
    coords1 = coords0
    for _ in range(iters):
        net, up_mask, delta = rfr.update_block(net, inp, _corr_lookup(pyr, coords1), coords1 - coords0)
        coords1 = coords1 + delta
    f12 = _convex_upsample_flow(coords1 - coords0, up_mask)
    f12 = f12 * device_const((w / w8, h / h8), (1, 2, 1, 1), f12.device, torch.float32)
    return resize_bilinear(f12, (h, w))


def _prep8(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int], Tuple[int, int]]:
    h, w = x.shape[2], x.shape[3]
    h8, w8 = h // 8 * 8, w // 8 * 8
    return resize_bilinear(x, (h8, w8)), (h, w), (h8, w8)


def rfr_flow(rfr: _RFR, image1: torch.Tensor, image2: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """``RFR.forward`` without an initial flow: NCHW images to the NCHW (x, y)
    flow from ``image1`` to ``image2``, f32, at the images' size. One encoder
    call on both images (its first half is also the context)."""
    b = image1.shape[0]
    x, hw, hw8 = _prep8(torch.cat([image1, image2], 0))
    e = rfr.fnet(x)
    return _rfr_from_features(rfr, e[:b], e[b:], hw, hw8, iters)


def raft_flow(rfr: _RFR, img0: torch.Tensor, img1: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """The ``RAFT`` wrapper (eisai_arch.py:2561-2586): ``RFR(img1, img0)``
    with its channels flipped to (y, x)."""
    return rfr_flow(rfr, img1, img0, iters).flip(1)


def raft_pair(rfr: _RFR, img0: torch.Tensor, img1: torch.Tensor, iters: int = 12):
    """``(raft_flow(img0, img1), raft_flow(img1, img0))`` as one batch: one
    encoder call on both frames, both directions' correlation and updates
    stacked along the batch (every step is per sample, so this is exact)."""
    b = img0.shape[0]
    x, hw, hw8 = _prep8(torch.cat([img0, img1], 0))
    e = rfr.fnet(x)
    e0, e1 = e[:b], e[b:]
    f = _rfr_from_features(rfr, torch.cat([e1, e0], 0), torch.cat([e0, e1], 0), hw, hw8, iters).flip(1)
    return f[:b], f[b:]


# ---- SoftsplatLite (JAX eisai.py:432-683) -----------------------------------------


def _flow_z_metric(img0, img1, flow0, flow1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FlowZMetric`` (eisai_arch.py:2217-2232), on f32 Lab images."""
    lab0, lab1 = rgb_to_lab(img0[:, :3].float()), rgb_to_lab(img1[:, :3].float())
    z0 = -0.1 * torch.linalg.vector_norm(lab1 - flow_backwarp(lab0, flow0), dim=1, keepdim=True)
    z1 = -0.1 * torch.linalg.vector_norm(lab0 - flow_backwarp(lab1, flow1), dim=1, keepdim=True)
    return z0, z1


def _forewarp_soft(img: torch.Tensor, flow_yx: torch.Tensor, metric: torch.Tensor) -> torch.Tensor:
    """``flow_forewarp(mode='sm', mask=True)`` (eisai_arch.py:1003-1056): a
    ones channel appended, the flow flipped to (x, y), all cast to f32 and
    softmax-splatted (``function_softsplat``, K2 on the card). NCHW in and
    out, f32."""
    n, _, h, w = img.shape
    inp = torch.cat([img.float(), torch.ones((n, 1, h, w), dtype=torch.float32, device=img.device)], 1)
    out = function_softsplat(
        inp.permute(0, 2, 3, 1), flow_yx.flip(1).permute(0, 2, 3, 1).float(),
        metric.permute(0, 2, 3, 1).float(), "soft",
    )
    return out.permute(0, 3, 1, 2)


def _half_warper(img0, img1, flow0, flow1, z0, z1, k: int, t):
    """``HalfWarper`` (eisai_arch.py:2266-2309)."""
    flow0_ = (1.0 - t) * flow0
    flow1_ = t * flow1
    f01 = _forewarp_soft(img0, flow1_, z1)
    f10 = _forewarp_soft(img1, flow0_, z0)
    f01i, f01m = f01[:, :-1], _morph_open(f01[:, -1:], k)
    f10i, f10m = f10[:, :-1], _morph_open(f10[:, -1:], k)
    base0 = f01m * f01i + (1 - f01m) * f10i
    base1 = f10m * f10i + (1 - f10m) * f01i
    return [base0, base1, f01i, f10i], [flow0_, flow1_], [f01m, f10m]


class _Bottleneck(nn.Module):
    """torchvision ``Bottleneck`` (eisai_arch.py:2312-2384)."""

    def __init__(self, i: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(i, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, 4 * width, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * width)
        self.downsample = (
            nn.Sequential(nn.Conv2d(i, 4 * width, 1, stride, bias=False), nn.BatchNorm2d(4 * width))
            if stride != 1 or i != 4 * width else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(self.conv1(x), self.bn1))
        y = F.relu(_bn(self.conv2(y), self.bn2))
        y = _bn(self.conv3(y), self.bn3)
        if self.downsample is not None:
            x = _bn(self.downsample[0](x), self.downsample[1])
        return F.relu(x + y)


class _ResnetTrunk(nn.Module):
    """ResNet-50 up to ``layer2`` (``ResnetFeatureExtractor``)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(_Bottleneck(64, 64), _Bottleneck(256, 64), _Bottleneck(256, 64))
        self.layer2 = nn.Sequential(_Bottleneck(256, 128, 2), *[_Bottleneck(512, 128) for _ in range(3)])


def _resize_smaller_edge(x: torch.Tensor, target: int = 256) -> torch.Tensor:
    """torchvision ``T.Resize(256)`` on tensors before 0.17: the smaller edge
    to 256, bilinear, no antialias."""
    h, w = x.shape[2], x.shape[3]
    out = (target, int(round(w * target / h))) if h <= w else (int(round(h * target / w)), target)
    return resize_bilinear(x, out)


def _resnet_features(p: _ResnetTrunk, x: torch.Tensor) -> List[torch.Tensor]:
    """``ResnetFeatureExtractor.forward`` (eisai_arch.py:2364-2382): resize,
    ImageNet-normalise, return the ``[conv1, layer1, layer2]`` activations
    (64, 256 and 512 channels)."""
    x = _resize_smaller_edge(x[:, :3])
    mean = device_const(_RESNET_MEAN, (1, 3, 1, 1), x.device, x.dtype)
    std = device_const(_RESNET_STD, (1, 3, 1, 1), x.device, x.dtype)
    x = F.relu(_bn(p.conv1((x - mean) / std), p.bn1))
    ans = [x]
    x = max_pool2d(x, 3, 2, 1)
    ans.append(p.layer1(x))
    ans.append(p.layer2(ans[-1]))
    return ans


def _pconv_bn(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """``Sequential(PReLU, Conv2d, BatchNorm2d)`` (torch indices 0/1/2)."""
    return _bn(seq[1](prelu(x, seq[0].weight)), seq[2])


def _prelu_conv_bn(c_in: int, c_out: int, k: int = 3, stride: int = 1) -> List[nn.Module]:
    return [nn.PReLU(c_in), nn.Conv2d(c_in, c_out, k, stride, k // 2), nn.BatchNorm2d(c_out)]


class _Residual(nn.Module):
    """GridNet's and the synthesizer's residual unit: ``x + net(x)``, ``net``
    two PReLU/conv/BN triples."""

    def __init__(self, c: int):
        super().__init__()
        self.net = nn.Sequential(*_prelu_conv_bn(c, c), *_prelu_conv_bn(c, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _pconv_bn(self.net[3:], _pconv_bn(self.net[:3], x))


class _Down(nn.Module):
    """GridNet's downsampling unit: a stride-2 then a stride-1 triple."""

    def __init__(self, i: int, o: int):
        super().__init__()
        self.net = nn.Sequential(*_prelu_conv_bn(i, i, stride=2), *_prelu_conv_bn(i, o))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pconv_bn(self.net[3:], _pconv_bn(self.net[:3], x))


class _Up(nn.Module):
    """GridNet's upsampling unit: nearest 2x, then two triples."""

    def __init__(self, i: int, o: int):
        super().__init__()
        self.net = nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"), *_prelu_conv_bn(i, o), *_prelu_conv_bn(o, o))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pconv_bn(self.net[4:], _pconv_bn(self.net[1:4], self.net[0](x)))


class _GridEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        for i, c in enumerate(_GRID_C):
            self.add_module(f"resnet_{i}", _Residual(c))
        self.downsample_01 = _Down(_GRID_C[0], _GRID_C[1])
        self.downsample_12 = _Down(_GRID_C[1], _GRID_C[2])


class _GridDecoder(nn.Module):
    def __init__(self):
        super().__init__()
        for i, c in enumerate(_GRID_C):
            self.add_module(f"resnet_{i}", _Residual(c))
        self.upsample_21 = _Up(_GRID_C[2], _GRID_C[1])
        self.upsample_10 = _Up(_GRID_C[1], _GRID_C[0])


class _GridNet(nn.Module):
    """``Gridnet`` (eisai_arch.py:1261-1331), depth 1, eval mode."""

    def __init__(self):
        super().__init__()
        self.encoders = nn.ModuleList([_GridEncoder()])
        self.decoders = nn.ModuleList([_GridDecoder()])

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        t = xs
        for enc in self.encoders:
            o0 = enc.resnet_0(t[0])
            o1 = enc.resnet_1(t[1]) + enc.downsample_01(o0)
            o2 = enc.resnet_2(t[2]) + enc.downsample_12(o1)
            t = [o0, o1, o2]
        for dec in self.decoders:
            o2 = dec.resnet_2(t[2])
            o1 = dec.resnet_1(t[1]) + dec.upsample_21(o2)
            o0 = dec.resnet_0(t[0]) + dec.upsample_10(o1)
            t = [o0, o1, o2]
        return t


class _Converter(nn.Module):
    """``gridnet_converter``: a PReLU/1x1 conv/BN triple per ResNet level."""

    def __init__(self):
        super().__init__()
        self.nets = nn.ModuleList(
            [nn.Sequential(*_prelu_conv_bn(i, o, k=1)) for i, o in ((64, 32), (256, 64), (512, 128))]
        )


class _Synthesizer(nn.Module):
    """``Synthesizer`` (eisai_arch.py:2161-2215)."""

    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(51, 64, 1),
            _Residual(64),
            nn.Sequential(*_prelu_conv_bn(64, 32)),
            _Residual(32),
            nn.Sequential(*_prelu_conv_bn(32, 16)),
            _Residual(16),
            nn.Sequential(nn.PReLU(16), nn.Conv2d(16, 3, 3, 1, 1)),
        )

    def forward(self, size, images, flows, masks, features) -> torch.Tensor:
        dia = math.sqrt(size[0] ** 2 + size[1] ** 2)
        images = [(images[0] + images[1]) / 2.0] + list(images)
        logimgs = [_resize(pixel_logit(i[:, :3]), size) for i in images]
        cat = torch.cat(
            logimgs
            + [torch.linalg.vector_norm(_resize(f, size), dim=1, keepdim=True) / dia for f in flows]
            + [_resize(m, size) for m in masks]
            + [_resize(f.float(), size) for f in features],
            1,
        )
        net = self.net
        x = net[0](cat.to(net[0].weight.dtype))
        x = _pconv_bn(net[4], net[3](_pconv_bn(net[2], net[1](x))))
        x = net[5](x)
        residual = net[6][1](prelu(x, net[6][0].weight))
        return torch.sigmoid(logimgs[0] + 0.5 * residual.float())


class _SoftsplatLite(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature_extractor = _ResnetTrunk()
        self.gridnet_converter = _Converter()
        self.gridnet = _GridNet()
        self.synthesizer = _Synthesizer()


def ssl_forward(p: _SoftsplatLite, img0, img1, flow0, flow1, t=0.5, k: int = 5):
    """``SoftsplatLite.forward`` (eisai_arch.py:2485-2538) on NCHW frames in
    the model's dtype and NCHW (y, x) flows. Returns the f32 prediction and
    the intermediates DTM reads (``hw_imgs``, ``hw_masks``). The synthesis
    size follows the frames, as in the JAX package (the reference hard-codes
    540x960, the model's native size)."""
    size = (img0.shape[2], img0.shape[3])
    z0, z1 = _flow_z_metric(img0, img1, flow0, flow1)
    e0 = torch.cat([img0.float(), nedt(img0)], 1)
    e1 = torch.cat([img1.float(), nedt(img1)], 1)
    hw_imgs, hw_flows, hw_masks = _half_warper(e0, e1, flow0, flow1, z0, z1, k, t)
    n = img0.shape[0]
    feats = _resnet_features(p.feature_extractor, torch.cat([img0, img1], 0))
    conv_feats = []
    for net, ft in zip(p.gridnet_converter.nets, feats):
        fsz = (ft.shape[2], ft.shape[3])
        w_, _, _ = _half_warper(
            ft[:n], ft[n:], _resize(flow0, fsz, is_flow=True), _resize(flow1, fsz, is_flow=True),
            _resize(z0, fsz), _resize(z1, fsz), k, t,
        )
        conv_feats.append(_pconv_bn(net, ((w_[0] + w_[1]) / 2.0).to(ft.dtype)))
    grid = p.gridnet(conv_feats)
    pred = p.synthesizer(size, hw_imgs, hw_flows, hw_masks, [grid[0]])
    return pred, {"hw_imgs": hw_imgs, "hw_masks": hw_masks}


# ---- DTM (JAX eisai.py:691-734) ------------------------------------------------------


class _NetNedt(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(*_prelu_conv_bn(14, 16), *_prelu_conv_bn(16, 16), nn.PReLU(16), nn.Conv2d(16, 1, 3, 1, 1))


class _NetTail(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = nn.Sequential(
            *_prelu_conv_bn(5, 16), *_prelu_conv_bn(16, 16), *_prelu_conv_bn(16, 16), nn.PReLU(16),
            nn.Conv2d(16, 3, 3, 1, 1),
        )


class _DTM(nn.Module):
    def __init__(self):
        super().__init__()
        self.net_nedt = _NetNedt()
        self.net_tail = _NetTail()


def _triples(net: nn.Sequential, x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` PReLU/conv/BN triples of ``net``, then its last PReLU and conv."""
    x = x.to(net[1].weight.dtype)
    for i in range(n):
        x = _pconv_bn(net[3 * i : 3 * i + 3], x)
    return net[3 * n + 1](prelu(x, net[3 * n].weight))


def dtm_forward(p: _DTM, out_base: torch.Tensor, locs: dict) -> torch.Tensor:
    """``DTM.forward`` (eisai_arch.py:2546-2559) on the NCHW f32 SoftsplatLite
    prediction: ``cat([pred, pred_nedt])``, f32."""
    out_base_nedt = nedt(out_base)
    hw_imgs, hw_masks = locs["hw_imgs"], locs["hw_masks"]
    cat = torch.cat([out_base, out_base_nedt, hw_imgs[0], hw_imgs[1], hw_masks[0], hw_masks[1]], 1)
    pred_nedt = torch.sigmoid(_triples(p.net_nedt.net, pixel_logit(cat.clamp(0.0, 1.0)), 2).float())
    log = pixel_logit(torch.cat([out_base, out_base_nedt, pred_nedt], 1).clamp(0.0, 1.0))
    pred = torch.sigmoid(log[:, :3] + _triples(p.net_tail.net, log, 3).float())
    return torch.cat([pred, pred_nedt], 1)


# ---- the model -------------------------------------------------------------------------


class EISAI(nn.Module):
    """Parameter tree of the node's three checkpoints, each under its prefix:
    ``raft.`` (the RFR weights of ``eisai_anime_interp_full.ckpt``), ``ssl.``
    (``eisai_ssl.pt``) and ``dtm.`` (``eisai_dtm.pt``)."""

    def __init__(self):
        super().__init__()
        self.raft = _RFR()
        self.ssl = _SoftsplatLite()
        self.dtm = _DTM()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC frames as the NCHW ``channels_last`` tensor the model takes."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _timestep(t, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1)


def infer(net: EISAI, img0: torch.Tensor, img1: torch.Tensor, flows, t) -> torch.Tensor:
    """SoftsplatLite and DTM at ``t`` (a scalar or a ``[B]`` vector) on NHWC
    frames and the NHWC (y, x) flows of :func:`raft_pair`: the NHWC f32 frame."""
    flow0, flow1 = (f.permute(0, 3, 1, 2) for f in flows)
    out_ssl, locs = ssl_forward(net.ssl, _nchw(img0), _nchw(img1), flow0, flow1, t=_timestep(t, img0.device))
    return dtm_forward(net.dtm, out_ssl, locs)[:, :3].permute(0, 2, 3, 1)


def reuse(net: EISAI, img0: torch.Tensor, img1: torch.Tensor, iters: int = 12):
    """Both RAFT flows of NHWC frames, NHWC (y, x) f32: the pair's cache."""
    flow0, flow1 = raft_pair(net.raft, _nchw(img0), _nchw(img1), iters)
    return flow0.permute(0, 2, 3, 1), flow1.permute(0, 2, 3, 1)


def apply(net: EISAI, img0: torch.Tensor, img1: torch.Tensor, t=0.5, iters: int = 12) -> torch.Tensor:
    """``EISAI.forward`` (vfi_models/eisai/__init__.py:30-40): the RAFT flows
    in both directions, SoftsplatLite and DTM; NHWC frames to the NHWC
    3-channel prediction."""
    return infer(net, img0, img1, reuse(net, img0, img1, iters), t)


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> EISAI:
    """``params`` cast to ``dtype``, loaded with ``strict=True`` into a
    ``channels_last`` module on ``device``; RAFT's update block in f32 (it
    runs on f32 correlation features and keeps an f32 state)."""
    with torch.device("meta"):
        net = EISAI()
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    net = net.to(device=device, memory_format=torch.channels_last).eval()
    net.raft.update_block.float()
    return net


def make_model_fn(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda", iters: int = 12):
    """``model_fn(f0, f1, t) -> mid``: NHWC frames in, float32 NHWC out,
    reuse and inference in one call."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        f0, f1 = (f.to(device=device, dtype=dtype) for f in (f0, f1))
        return apply(net, f0, f1, t, iters)

    return model_fn


def make_pair_fns(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda", iters: int = 12):
    """``(reuse_fn, infer_fn)`` for ``core.loop.run_plan_pair_cached``: the two
    RAFT passes once per pair batch (``reuse_fn(f0, f1) -> (flow0, flow1)``),
    SoftsplatLite and DTM once per timestep (``infer_fn(f0, f1, cache, t) ->
    mid``, float32 NHWC, ``t`` a ``[B]`` vector). The reference recomputes
    the flows for every timestep; they do not read it, so sharing them is
    exact."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def reuse_fn(f0: torch.Tensor, f1: torch.Tensor):
        return reuse(net, f0.to(device=device, dtype=dtype), f1.to(device=device, dtype=dtype), iters)

    @torch.inference_mode()
    def infer_fn(f0: torch.Tensor, f1: torch.Tensor, cache, t: torch.Tensor) -> torch.Tensor:
        return infer(net, f0.to(device=device, dtype=dtype), f1.to(device=device, dtype=dtype), cache, t)

    return reuse_fn, infer_fn


def warps_per_infer() -> Dict[str, int]:
    """Warp launches per timestep batch on the card by kernel, ``{"narrow":
    K1, "wide": the wide-channel kernel}``, as ``warp_kernel.route`` sends
    the Lab images of :data:`WARP_CHANNELS_PER_INFER` (f32 in every model
    dtype). The reuse (RAFT) makes none."""
    return route_counts(WARP_CHANNELS_PER_INFER, torch.float32)


def splats_per_infer() -> int:
    """Splat (K2) launches per timestep batch: one per ``function_softsplat`` call."""
    return len(SPLAT_CHANNELS_PER_INFER)


# ---- random weights ----------------------------------------------------------------------


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict with the keys and shapes of the three checkpoints'
    manifests (``eisai_anime_interp_full.ckpt``'s RFR under ``raft.``,
    ``eisai_ssl.pt`` under ``ssl.``, ``eisai_dtm.pt`` under ``dtm.``; 513
    tensors; ``common.init_state_dict``: batch norms at the identity)."""
    with torch.device("meta"):
        net = EISAI()
    return init_state_dict(net, seed)
