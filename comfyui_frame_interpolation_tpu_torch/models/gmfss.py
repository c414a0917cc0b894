"""GMFSS Fortuna, the anime-specialist VFI model (base and union variants),
PyTorch port of the JAX package's ``models/gmfss.py`` (reference
``vfi_models/gmfss_fortuna/GMFSS_Fortuna_arch.py`` and its ``_union_arch``).

Four sub-networks:

* ``flownet`` (GMFlow): a CNN encoder of instance-normed residual blocks whose
  last convolution is a trident conv (one weight, strides 1 and 2), a 6-layer
  Swin-window transformer shared by both frames (shifted windows on the odd
  layers, cross-attention by swapping the batch halves), global then local
  correlation softmax, feature-flow attention and convex x4 upsampling; run
  once per direction at half resolution.
* ``metricnet``: occlusion metrics from the photometric error, the
  forward/backward consistency and the normalised flows.
* ``feat_ext``: a 3-scale feature pyramid of each full-resolution frame.
* ``fusionnet``: the images and the three feature scales splatted to time t
  (``ops.softsplat.softsplat``, mode ``"soft"``), fused by a GridNet with a
  PixelShuffle tail. The union variant also runs a RIFE 4.6 IFNet
  (``ifnet``) on the half-resolution pair and feeds its frame to a 9-channel
  head (``residual_model_head0``).

Kernels on the card: the backward warps are ``ops.warp.warp`` in zeros mode,
6 per pair batch (:data:`WARP_CHANNELS_PER_REUSE`: GMFlow's 128-channel
feature warp per direction on the wide-channel kernel, the metric net's two
image and two flow warps on K1); the union's RIFE 4.6 adds 4 border-mode K1
warps per timestep; the splat runs K2 8 times per timestep
(:data:`SPLAT_CHANNELS_PER_INFER`).

:class:`GMFSS` holds the parameters with the checkpoints' keys, each
sub-network's prefixed by its name (``flownet.``, ``feat_ext.``,
``metricnet.``, ``fusionnet.`` and, for union, ``ifnet.``). :func:`reuse`
computes the flows, metrics and features of a pair once, :func:`inference`
the splat and fusion per timestep; :func:`apply` is both. Frames, flows and
the reuse cache are NHWC at these functions, as in the JAX package; inside,
convolutions take NCHW tensors in ``channels_last`` memory and the
transformer and the correlations take token layout (``[B, L, C]``, a view of
the same memory).

Deliberate differences from the JAX package, none of which changes an fp32
result beyond rounding: coordinate grids are f32 (JAX builds them in the
features' dtype); the correlation and flow-attention softmaxes over
coordinates and flows run in f32 and their results are cast once to the
model dtype; in bf16 the position embedding is added in bf16, so the
transformer runs in bf16 where JAX's type promotion runs it in f32; the
feature pyramid runs once on both frames stacked along the batch (JAX runs
it per frame); the window position embedding is added as one tiled tensor
instead of per split window (the same sums).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.warp_kernel import route_counts
from ..ops.softsplat import softsplat
from ..ops.warp import warp
from . import rife as rife_model
from .common import PRELU_INIT, cast_params, device_const, instance_norm, resize_by_scale

__all__ = [
    "CKPT_NAMES",
    "GMFSS",
    "PRELU_INIT",
    "SPLAT_CHANNELS_PER_INFER",
    "WARP_CHANNELS_PER_REUSE",
    "apply",
    "inference",
    "init_params",
    "make_model_fn",
    "make_pair_fns",
    "reuse",
    "splats_per_infer",
    "warps_per_infer",
    "warps_per_reuse",
]

CKPT_NAMES = ["GMFSS_fortuna", "GMFSS_fortuna_union"]
# the channels of each warp per pair batch, in call order: GMFlow's scale-1
# feature warp of each direction, the metric net's two image warps and the
# two flow warps of its consistency check
WARP_CHANNELS_PER_REUSE = (128, 128, 3, 3, 2, 2)
# the union's RIFE 4.6: one 3-channel warp of both frames per stage
UNION_WARP_CHANNELS_PER_INFER = (3, 3, 3, 3)
# the channels of each splat per timestep batch: both images (3 + the
# metric's exp), then each feature scale (64, 128, 192 + 1), both directions
SPLAT_CHANNELS_PER_INFER = (4, 4, 65, 65, 129, 129, 193, 193)

_ATTN_SPLITS = (2, 8)
_CORR_RADIUS = (-1, 4)
_PROP_RADIUS = (-1, 1)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


# ---- constants on the device, made once per shape ----------------------------


@functools.lru_cache(maxsize=None)
def _array_const(make, args: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device=device, dtype=dtype)


def _coords(h: int, w: int, device) -> torch.Tensor:
    """``[1, H, W, 2]`` f32 pixel coordinates (x, y)."""
    return _array_const(_coords_np, (h, w), torch.device(device), torch.float32)


def _coords_np(h: int, w: int) -> np.ndarray:
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([gx, gy], -1)[None]


# ---- a. normalisations -------------------------------------------------------


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """``LayerNorm`` over the last axis: population variance, eps 1e-5."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, 1e-5)


# ---- b. CNN encoder ------------------------------------------------------------


class _ResidualBlock(nn.Module):
    """GMFlow ``ResidualBlock`` with instance norms (no parameters)."""

    def __init__(self, i: int, o: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(i, o, 3, stride, 1, bias=False)
        self.conv2 = nn.Conv2d(o, o, 3, 1, 1, bias=False)
        self.downsample = nn.Sequential(nn.Conv2d(i, o, 1, stride)) if stride != 1 or i != o else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class _CNNEncoder(nn.Module):
    """GMFlow ``CNNEncoder`` with two scales: the trident conv applies one
    weight at strides 1 and 2; the outputs are returned low to high
    resolution."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.layer1 = nn.Sequential(_ResidualBlock(64, 64, 1), _ResidualBlock(64, 64, 1))
        self.layer2 = nn.Sequential(_ResidualBlock(64, 96, 2), _ResidualBlock(96, 96, 1))
        self.layer3 = nn.Sequential(_ResidualBlock(96, 128, 1), _ResidualBlock(128, 128, 1))
        self.conv2 = nn.Conv2d(128, 128, 1)
        self.trident_conv = nn.Conv2d(128, 128, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(instance_norm(self.conv1(x)))
        x = self.conv2(self.layer3(self.layer2(self.layer1(x))))
        w = self.trident_conv.weight
        return [F.conv2d(x, w, None, stride=s, padding=1) for s in (2, 1)]


# ---- c. windows and attention ----------------------------------------------------


def _split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B*k*k, H/k, W/k, C]`` (reference split_feature)."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def _merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b // (k * k), k, k, h, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b // (k * k), k * h, k * w, c)


def _shift_window_mask(h: int, w: int, k: int) -> np.ndarray:
    """``generate_shift_window_attn_mask``: ``[k*k, L, L]`` with -100 between
    tokens of different regions of a shifted window (a copy of the JAX
    package's numpy function)."""
    wh, ww = h // k, w // k
    sh, sw = wh // 2, ww // 2
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(k, wh, k, ww).transpose(0, 2, 1, 3).reshape(k * k, wh * ww)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_attention(q, k_, v, h: int, w: int, splits: int, with_shift: bool, mask: Optional[torch.Tensor]):
    """``single_head_split_window_attention`` on ``[B, L, C]`` tokens in
    ``splits x splits`` windows (GMFSS always splits: 2 and 8); the ``[k*k,
    L', L']`` shift mask is broadcast over the batch."""
    b, L, c = q.shape
    q, k_, v = (x.reshape(b, h, w, c) for x in (q, k_, v))
    sh, sw = (h // splits) // 2, (w // splits) // 2
    if with_shift:
        q, k_, v = (torch.roll(x, (-sh, -sw), (1, 2)) for x in (q, k_, v))
    nw = splits * splits
    qs, ks, vs = (_split_windows(x, splits).reshape(b * nw, -1, c) for x in (q, k_, v))
    scores = torch.matmul(qs, ks.transpose(1, 2)) / math.sqrt(c)
    if with_shift:
        scores = (scores.unflatten(0, (b, nw)) + mask).flatten(0, 1)
    out = torch.matmul(torch.softmax(scores, -1), vs)
    out = _merge_windows(out.reshape(b * nw, h // splits, w // splits, c), splits)
    if with_shift:
        out = torch.roll(out, (sh, sw), (1, 2))
    return out.reshape(b, L, c)


# ---- d. transformer ----------------------------------------------------------------


class _TransformerLayer(nn.Module):
    def __init__(self, c: int = 128, ffn: bool = False, expansion: int = 4):
        super().__init__()
        self.q_proj = nn.Linear(c, c, bias=False)
        self.k_proj = nn.Linear(c, c, bias=False)
        self.v_proj = nn.Linear(c, c, bias=False)
        self.merge = nn.Linear(c, c, bias=False)
        self.norm1 = nn.LayerNorm(c)
        if ffn:
            self.mlp = nn.Sequential(
                nn.Linear(2 * c, 2 * c * expansion, bias=False), nn.GELU(), nn.Linear(2 * c * expansion, c, bias=False)
            )
            self.norm2 = nn.LayerNorm(c)
        else:
            self.mlp = None

    def forward(self, source, target, h, w, splits, with_shift, mask):
        msg = _window_attention(
            self.q_proj(source), self.k_proj(target), self.v_proj(target), h, w, splits, with_shift, mask
        )
        msg = _layer_norm(self.merge(msg), self.norm1)
        if self.mlp is not None:
            msg = _layer_norm(self.mlp(torch.cat([source, msg], -1)), self.norm2)
        return source + msg


class _TransformerBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.self_attn = _TransformerLayer(ffn=False)
        self.cross_attn_ffn = _TransformerLayer(ffn=True)


class _Transformer(nn.Module):
    def __init__(self, num_layers: int = 6):
        super().__init__()
        self.layers = nn.ModuleList([_TransformerBlock() for _ in range(num_layers)])


def _transformer(p: _Transformer, f0: torch.Tensor, f1: torch.Tensor, splits: int):
    """``FeatureTransformer.forward`` on NHWC features: both frames in one
    batch, the cross-attention's other frame by swapping the halves."""
    b, h, w, c = f0.shape
    mask = _array_const(_shift_window_mask, (h, w, splits), f0.device, f0.dtype)
    concat0 = torch.cat([f0.reshape(b, -1, c), f1.reshape(b, -1, c)], 0)
    concat1 = torch.cat([f1.reshape(b, -1, c), f0.reshape(b, -1, c)], 0)
    for i, layer in enumerate(p.layers):
        with_shift = i % 2 == 1
        concat0 = layer.self_attn(concat0, concat0, h, w, splits, with_shift, mask)
        concat0 = layer.cross_attn_ffn(concat0, concat1, h, w, splits, with_shift, mask)
        concat1 = torch.cat([concat0[b:], concat0[:b]], 0)
    return concat0[:b].reshape(b, h, w, c), concat0[b:].reshape(b, h, w, c)


# ---- e. position embedding -------------------------------------------------------


def _position_embedding(h: int, w: int, num_feats: int = 64) -> np.ndarray:
    """``PositionEmbeddingSine`` (normalised, scale 2 pi), NHWC ``[H, W, 2F]``
    (a copy of the JAX package's numpy function)."""
    scale = 2 * math.pi
    eps = 1e-6
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None]
    y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
    x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_feats, dtype=np.float32)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)


def _tiled_position(h: int, w: int, c: int, splits: int) -> np.ndarray:
    """The embedding of one ``H/k x W/k`` window, tiled over the ``k x k``
    windows: adding it equals the reference's add per split window."""
    return np.tile(_position_embedding(h // splits, w // splits, c // 2), (splits, splits, 1))


def _add_position(f0: torch.Tensor, f1: torch.Tensor, splits: int):
    _, h, w, c = f0.shape
    pos = _array_const(_tiled_position, (h, w, c, splits), f0.device, f0.dtype)
    return f0 + pos, f1 + pos


# ---- f. correlation softmax ----------------------------------------------------------


def _global_corr_softmax(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Flow as the softmax-expected correspondence over the whole frame; the
    softmax and the expectation in f32."""
    b, h, w, c = f0.shape
    corr = torch.matmul(f0.reshape(b, -1, c), f1.reshape(b, -1, c).transpose(1, 2)) / math.sqrt(c)
    prob = torch.softmax(corr, -1, dtype=torch.float32)
    coords = _coords(h, w, f0.device)
    corresp = torch.matmul(prob, coords.reshape(-1, 2)).reshape(b, h, w, 2)
    return (corresp - coords).to(f0.dtype)


def _local_offsets(r: int) -> np.ndarray:
    """``[(2r+1)^2, 2]`` (dx, dy), row-major over (dy, dx)."""
    dx, dy = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1))
    return np.stack([dx, dy], -1).reshape(-1, 2)


def _local_samples(h: int, w: int, r: int) -> np.ndarray:
    """``[H, W, (2r+1)^2, 2]`` f32 sample points: pixel plus offset."""
    return _coords_np(h, w)[0][:, :, None, :] + _local_offsets(r).astype(np.float32)[None, None]


def _local_corr_softmax(f0: torch.Tensor, f1: torch.Tensor, r: int) -> torch.Tensor:
    """``local_correlation_softmax``: the (2r+1)^2 integer shifts of ``f1``
    (zero-padded), out-of-frame samples at -1e9, softmax and the expected
    sample point in f32."""
    b, h, w, c = f0.shape
    f1p = F.pad(f1, (0, 0, r, r, r, r))
    corr = torch.stack(
        [(f0 * f1p[:, r + oy : r + oy + h, r + ox : r + ox + w]).sum(-1) for ox, oy in _local_offsets(r)], -1
    ) / math.sqrt(c)
    sample = _array_const(_local_samples, (h, w, r), f0.device, torch.float32)
    valid = (sample[..., 0] >= 0) & (sample[..., 0] < w) & (sample[..., 1] >= 0) & (sample[..., 1] < h)
    corr = corr.masked_fill(~valid, -1e9)
    prob = torch.softmax(corr, -1, dtype=torch.float32)
    corresp = torch.einsum("bhwk,hwkd->bhwd", prob, sample)
    return (corresp - _coords(h, w, f0.device)).to(f0.dtype)


# ---- g. flow attention ---------------------------------------------------------------


def _neighborhood9(x: torch.Tensor) -> torch.Tensor:
    """``[N, H, W, C]`` -> ``[N, H, W, 9, C]``: the zero-padded 3x3
    neighbourhood, row-major over (dy, dx)."""
    _, h, w, _ = x.shape
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.stack([padded[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] for dy in (-1, 0, 1) for dx in (-1, 0, 1)], 3)


class _FlowAttention(nn.Module):
    def __init__(self, c: int = 128):
        super().__init__()
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)


def _flow_attn(p: _FlowAttention, feat: torch.Tensor, flow: torch.Tensor, local: bool) -> torch.Tensor:
    """``FeatureFlowAttention``. Global path: keep the reference's quirk, the
    key projects the *query projection*; softmax and product in f32. Local
    path (radius 1): keys project the features, over each 3x3 neighbourhood."""
    b, h, w, c = feat.shape
    q = p.q_proj(feat.reshape(b, -1, c))
    if not local:
        k_ = p.k_proj(q)
        scores = torch.matmul(q, k_.transpose(1, 2)) / math.sqrt(c)
        prob = torch.softmax(scores, -1, dtype=torch.float32)
        return torch.matmul(prob, flow.reshape(b, -1, 2).float()).reshape(b, h, w, 2).to(feat.dtype)
    k_ = p.k_proj(feat.reshape(b, -1, c)).reshape(b, h, w, c)
    scores = torch.einsum("bhwc,bhwkc->bhwk", q.reshape(b, h, w, c), _neighborhood9(k_)) / math.sqrt(c)
    prob = torch.softmax(scores, -1, dtype=torch.float32)
    return torch.einsum("bhwk,bhwkd->bhwd", prob, _neighborhood9(flow).float()).to(feat.dtype)


# ---- h, i. convex upsampling and GMFlow ------------------------------------------------


def _convex_upsample4(p: nn.Sequential, flow: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """``GMFlow.upsample_flow``'s convex path, factor 4: a softmax over the 9
    neighbours of each of the 16 sub-pixels."""
    k = 4
    n, h, w, _ = flow.shape
    m = p(torch.cat([flow, feat], -1).permute(0, 3, 1, 2))  # [n, 9*16, h, w]
    mask = torch.softmax(m.permute(0, 2, 3, 1).reshape(n, h, w, 9, k * k), 3)
    up = torch.einsum("nhwkc,nhwkp->nhwpc", _neighborhood9(k * flow), mask)
    up = up.reshape(n, h, w, k, k, 2).permute(0, 1, 3, 2, 4, 5)
    return up.reshape(n, h * k, w * k, 2)


class _GMFlow(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = _CNNEncoder()
        self.transformer = _Transformer()
        self.feature_flow_attn = _FlowAttention()
        self.upsampler = nn.Sequential(nn.Conv2d(2 + 128, 256, 3, 1, 1), nn.ReLU(), nn.Conv2d(256, 16 * 9, 1))


def _nhwc_resize(x: torch.Tensor, scale: float, align_corners: bool = False) -> torch.Tensor:
    """:func:`resize_by_scale` of an NHWC tensor (through its NCHW view)."""
    return resize_by_scale(x.permute(0, 3, 1, 2), scale, align_corners).permute(0, 2, 3, 1)


def _gmflow(p: _GMFlow, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """``GMFlow.forward``, two scales, one direction: NCHW images in [0, 1]
    to the NHWC flow ``[B, H, W, 2]`` from ``img0`` to ``img1``."""
    mean = device_const(_IMAGENET_MEAN, (1, 3, 1, 1), img0.device, img0.dtype)
    std = device_const(_IMAGENET_STD, (1, 3, 1, 1), img0.device, img0.dtype)
    b = img0.shape[0]
    feats = p.backbone(torch.cat([(img0 - mean) / std, (img1 - mean) / std], 0))
    flow = None
    for scale_idx, f in enumerate(feats):
        f = f.permute(0, 2, 3, 1)
        f0, f1 = f[:b], f[b:]
        if flow is not None:
            flow = 2.0 * _nhwc_resize(flow, 2.0, align_corners=True)
            f1 = warp(f1, flow, "zeros")
        splits = _ATTN_SPLITS[scale_idx]
        f0, f1 = _transformer(p.transformer, *_add_position(f0, f1, splits), splits)
        if _CORR_RADIUS[scale_idx] == -1:
            flow_pred = _global_corr_softmax(f0, f1)
        else:
            flow_pred = _local_corr_softmax(f0, f1, _CORR_RADIUS[scale_idx])
        flow = flow_pred if flow is None else flow + flow_pred
        flow = _flow_attn(p.feature_flow_attn, f0, flow, local=_PROP_RADIUS[scale_idx] > 0)
    return _convex_upsample4(p.upsampler, flow, f0)


# ---- j, k. metric and feature nets -------------------------------------------------


def _prelu_conv(i: int, o: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.PReLU(1), nn.Conv2d(i, o, 3, stride, 1))


class _MetricNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.metric_in = nn.Conv2d(14, 64, 3, 1, 1)
        self.metric_net1 = _prelu_conv(64, 64)
        self.metric_net2 = _prelu_conv(64, 64)
        self.metric_net3 = _prelu_conv(64, 64)
        self.metric_out = _prelu_conv(64, 2)


def _fb_consistency(fwd: torch.Tensor, bwd: torch.Tensor, alpha: float = 0.01, beta: float = 0.5):
    """Forward/backward occlusion masks of NHWC flows (zeros-mode warps)."""
    mag = torch.linalg.vector_norm(fwd, dim=-1) + torch.linalg.vector_norm(bwd, dim=-1)
    diff_fwd = torch.linalg.vector_norm(fwd + warp(bwd, fwd, "zeros"), dim=-1)
    diff_bwd = torch.linalg.vector_norm(bwd + warp(fwd, bwd, "zeros"), dim=-1)
    thr = alpha * mag + beta
    return (diff_fwd > thr).to(fwd.dtype), (diff_bwd > thr).to(fwd.dtype)


def _metricnet(p: _MetricNet, img0, img1, flow01, flow10):
    """``MetricNet.forward`` on NHWC half-resolution images and flows; the
    14-channel input in the reference's order; returns NHWC metrics."""
    metric0 = (img0 - warp(img1, flow01, "zeros")).abs().mean(-1, keepdim=True)
    metric1 = (img1 - warp(img0, flow10, "zeros")).abs().mean(-1, keepdim=True)
    fwd_occ, bwd_occ = _fb_consistency(flow01, flow10)
    h, w = img0.shape[1], img0.shape[2]
    norm = device_const(((w - 1.0) / 2.0, (h - 1.0) / 2.0), (2,), img0.device, img0.dtype)
    x = torch.cat(
        [img0, img1, -metric0, -metric1, flow01 / norm, flow10 / norm, fwd_occ[..., None], bwd_occ[..., None]], -1
    ).permute(0, 3, 1, 2)
    feat = p.metric_in(x)
    for net in (p.metric_net1, p.metric_net2, p.metric_net3):
        feat = net(feat) + feat
    metric = (torch.tanh(p.metric_out(feat)) * 10.0).permute(0, 2, 3, 1)
    return metric[..., :1], metric[..., 1:2]


class _FeatureNet(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (a, b) in enumerate(((3, 64), (64, 128), (128, 192)), start=1):
            self.add_module(f"block{i}", nn.Sequential(*_prelu_conv(a, b, 2), *_prelu_conv(b, b)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for block in (self.block1, self.block2, self.block3):
            x = block(x)
            feats.append(x)
        return feats


# ---- l. GridNet ---------------------------------------------------------------------


def _residual(i: int, o: int, stride: int = 1) -> nn.Sequential:
    """PReLU, conv (``stride``), PReLU, conv: the reference's residual and
    downsampling pairs (their skips are added by :func:`_gridnet`)."""
    return nn.Sequential(*_prelu_conv(i, o, stride), *_prelu_conv(o, o))


def _upsample(i: int, o: int) -> nn.Sequential:
    return nn.Sequential(nn.PReLU(1), nn.ConvTranspose2d(i, o, 4, 2, 1), *_prelu_conv(o, o))


class _PixelShuffleTail(nn.Module):
    def __init__(self, c: int = 64):
        super().__init__()
        self.conv_before_upsample = nn.Sequential(nn.Conv2d(c, c, 3, 1, 1), nn.PReLU(1))
        self.upsample = nn.Sequential(nn.Conv2d(c, 4 * c, 3, 1, 1), nn.PixelShuffle(2))
        self.conv_last = nn.Conv2d(c, 3, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_last(self.upsample(self.conv_before_upsample(x)))


class _GridNet(nn.Module):
    def __init__(self, union: bool = False):
        super().__init__()
        self.head_key = "residual_model_head0" if union else "residual_model_head"
        self.add_module(self.head_key, _residual(9 if union else 12, 64))
        self.residual_model_head1 = _residual(128, 64)
        self.residual_model_head2 = _residual(256, 128)
        self.residual_model_head3 = _residual(384, 192)
        for name in ("01", "04", "05"):
            self.add_module(f"residual_model_{name}", _residual(64, 64))
        for name in ("11", "14", "15"):
            self.add_module(f"residual_model_{name}", _residual(128, 128))
        for name in ("21", "24", "25"):
            self.add_module(f"residual_model_{name}", _residual(192, 192))
        self.downsample_model_10 = _residual(64, 128, 2)
        self.downsample_model_11 = _residual(64, 128, 2)
        self.downsample_model_20 = _residual(128, 192, 2)
        self.downsample_model_21 = _residual(128, 192, 2)
        self.upsample_model_14 = _upsample(192, 128)
        self.upsample_model_15 = _upsample(192, 128)
        self.upsample_model_04 = _upsample(128, 64)
        self.upsample_model_05 = _upsample(128, 64)
        self.residual_model_tail = _PixelShuffleTail()

    def forward(self, x, x1, x2, x3):
        """``GridNet.forward`` (NCHW)."""
        x00 = getattr(self, self.head_key)(x) + self.residual_model_head1(x1)
        x01 = self.residual_model_01(x00) + x00
        x10 = self.downsample_model_10(x00) + self.residual_model_head2(x2)
        x20 = self.downsample_model_20(x10) + self.residual_model_head3(x3)
        x11 = self.residual_model_11(x10) + x10 + self.downsample_model_11(x01)
        x21 = self.residual_model_21(x20) + x20 + self.downsample_model_21(x11)
        x24 = self.residual_model_24(x21) + x21
        x25 = self.residual_model_25(x24) + x24
        x14 = self.upsample_model_14(x24) + (self.residual_model_14(x11) + x11)
        x04 = self.upsample_model_04(x14) + (self.residual_model_04(x01) + x01)
        x15 = self.upsample_model_15(x25) + (self.residual_model_15(x14) + x14)
        x05 = self.upsample_model_05(x15) + (self.residual_model_05(x04) + x04)
        return self.residual_model_tail(x05)


# ---- m. the model ---------------------------------------------------------------


class GMFSS(nn.Module):
    """Parameter tree of ``Model`` (base) or its union variant: the keys of
    the checkpoint set, each file's under its prefix."""

    def __init__(self, union: bool = False):
        super().__init__()
        self.union = union
        self.flownet = _GMFlow()
        self.metricnet = _MetricNet()
        self.feat_ext = _FeatureNet()
        self.fusionnet = _GridNet(union)
        if union:
            self.ifnet = rife_model.IFNet("4.6")


def warps_per_reuse(dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """Warp launches per pair batch on the card by kernel, ``{"narrow": K1,
    "wide": the wide-channel kernel}``, as ``warp_kernel.route`` sends the
    NHWC tensors of :data:`WARP_CHANNELS_PER_REUSE`."""
    return route_counts(WARP_CHANNELS_PER_REUSE, dtype)


def warps_per_infer(union: bool, dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """Warp launches per timestep batch: none for the base model, the RIFE
    4.6 image warps for the union variant."""
    return route_counts(UNION_WARP_CHANNELS_PER_INFER if union else (), dtype)


def splats_per_infer() -> int:
    """Splat (K2) launches per timestep batch: one per ``softsplat`` call."""
    return len(SPLAT_CHANNELS_PER_INFER)


def reuse(net: GMFSS, img0: torch.Tensor, img1: torch.Tensor, scale: float = 1.0):
    """``Model.reuse``: the flows, metrics and features of a pair of NHWC
    frames ``[n, H, W, 3]`` (H, W multiples of 64 / scale), as the JAX
    package returns them: ``(flow01, flow10, metric0, metric1, feat1,
    feat2)``, NHWC, the flows and metrics at half resolution, each ``feat`` a
    list of the three pyramid levels."""
    n = img0.shape[0]
    x = torch.cat([img0, img1], 0).permute(0, 3, 1, 2)
    feats = net.feat_ext(x)
    xh = resize_by_scale(x, 0.5)
    img0h, img1h = xh[:n], xh[n:]
    f0, f1 = (resize_by_scale(img0h, scale), resize_by_scale(img1h, scale)) if scale != 1.0 else (img0h, img1h)
    flow01 = _gmflow(net.flownet, f0, f1)
    flow10 = _gmflow(net.flownet, f1, f0)
    if scale != 1.0:
        flow01 = _nhwc_resize(flow01, 1.0 / scale) / scale
        flow10 = _nhwc_resize(flow10, 1.0 / scale) / scale
    nhwc = [f.permute(0, 2, 3, 1) for f in feats]
    metric0, metric1 = _metricnet(net.metricnet, img0h.permute(0, 2, 3, 1), img1h.permute(0, 2, 3, 1), flow01, flow10)
    return flow01, flow10, metric0, metric1, [f[:n] for f in nhwc], [f[n:] for f in nhwc]


def _splat_head(net: GMFSS, img0, img1, reuse_out, timestep):
    """The splat half of ``Model.inference`` on NHWC tensors: the images and
    the three feature scales splatted to time t, assembled into the GridNet's
    NCHW inputs."""
    flow01, flow10, metric0, metric1, feat1, feat2 = reuse_out
    t = torch.as_tensor(timestep, dtype=img0.dtype, device=img0.device).reshape(-1, 1, 1, 1)
    f1t, f2t = t * flow01, (1 - t) * flow10
    z1t, z2t = t * metric0, (1 - t) * metric1
    img0h, img1h = _nhwc_resize(img0, 0.5), _nhwc_resize(img1, 0.5)
    i1t = softsplat(img0h, f1t, z1t, "soft")
    i2t = softsplat(img1h, f2t, z2t, "soft")
    levels = []
    for lvl, s in enumerate((1.0, 0.5, 0.25)):
        f1d, f2d = (f1t, f2t) if s == 1.0 else (_nhwc_resize(f1t, s) * s, _nhwc_resize(f2t, s) * s)
        z1d, z2d = (z1t, z2t) if s == 1.0 else (_nhwc_resize(z1t, s), _nhwc_resize(z2t, s))
        a = softsplat(feat1[lvl], f1d, z1d, "soft")
        b = softsplat(feat2[lvl], f2d, z2d, "soft")
        levels.append(torch.cat([a, b], -1).permute(0, 3, 1, 2))
    if net.union:
        mid = rife_model.apply(net.ifnet, img0h, img1h, t.reshape(-1), [8, 4, 2, 1])
        head = torch.cat([i1t, mid, i2t], -1)
    else:
        head = torch.cat([img0h, i1t, i2t, img1h], -1)
    return head.permute(0, 3, 1, 2), levels


def inference(net: GMFSS, img0: torch.Tensor, img1: torch.Tensor, reuse_out, timestep) -> torch.Tensor:
    """``Model.inference`` (union head for a union net): NHWC frames and the
    :func:`reuse` cache to the NHWC frame at ``timestep`` (a scalar or an
    ``[n]`` vector), clamped to [0, 1]."""
    head, (x1, x2, x3) = _splat_head(net, img0, img1, reuse_out, timestep)
    return net.fusionnet(head, x1, x2, x3).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def _pad(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Zero-pad NHWC frames to multiples of ``max(64, 64 / scale)``."""
    _, h, w, _ = img.shape
    tmp = max(64, int(64 / scale))
    ph = ((h - 1) // tmp + 1) * tmp
    pw = ((w - 1) // tmp + 1) * tmp
    return F.pad(img, (0, 0, 0, pw - w, 0, ph - h))


def apply(net: GMFSS, img0: torch.Tensor, img1: torch.Tensor, timestep, scale: float = 1.0) -> torch.Tensor:
    """``CommonModelInference.forward``: pad to 64 / scale, :func:`reuse`,
    :func:`inference`, crop. NHWC in and out."""
    h, w = img0.shape[1], img0.shape[2]
    img0, img1 = _pad(img0, scale), _pad(img1, scale)
    out = inference(net, img0, img1, reuse(net, img0, img1, scale), timestep)
    return out[:, :h, :w, :]


def _load(params: Dict[str, torch.Tensor], union: bool, dtype: torch.dtype, device) -> GMFSS:
    """``params`` cast to ``dtype``, loaded with ``strict=True`` into a module
    on ``device`` in ``channels_last`` memory."""
    with torch.device("meta"):
        net = GMFSS(union)
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return net.to(device=device, memory_format=torch.channels_last).eval()


def make_model_fn(
    params: Dict[str, torch.Tensor], union: bool = False, scale: float = 1.0, dtype: torch.dtype = torch.float32,
    device="cuda",
):
    """``model_fn(f0, f1, t) -> mid``: NHWC frames in, float32 NHWC out,
    reuse and inference in one call (the configuration ``bench.py:bench_gmfss``
    times)."""
    net = _load(params, union, dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        f0, f1 = (f.to(device=device, dtype=dtype) for f in (f0, f1))
        return apply(net, f0, f1, t.to(device=device, dtype=dtype), scale).float()

    return model_fn


def make_pair_fns(
    params: Dict[str, torch.Tensor], union: bool = False, scale: float = 1.0, dtype: torch.dtype = torch.float32,
    device="cuda",
):
    """``(reuse_fn, infer_fn)`` for ``core.loop.run_plan_pair_cached``: the
    flows, metrics and features once per pair batch (``reuse_fn(f0, f1) ->
    cache``), the splat and fusion once per timestep (``infer_fn(f0, f1,
    cache, t) -> mid``, float32 NHWC). The reference recomputes ``reuse``
    for every timestep; it does not read the timestep, so sharing it is
    exact."""
    net = _load(params, union, dtype, device)

    def prep(f):
        return _pad(f.to(device=device, dtype=dtype), scale)

    @torch.inference_mode()
    def reuse_fn(f0: torch.Tensor, f1: torch.Tensor):
        return reuse(net, prep(f0), prep(f1), scale)

    @torch.inference_mode()
    def infer_fn(f0: torch.Tensor, f1: torch.Tensor, cache, t: torch.Tensor) -> torch.Tensor:
        h, w = f0.shape[1], f0.shape[2]
        out = inference(net, prep(f0), prep(f1), cache, t.to(device=device, dtype=dtype))
        return out[:, :h, :w, :].float()

    return reuse_fn, infer_fn


# ---- n. random weights ---------------------------------------------------------------


def init_params(seed: int = 0, union: bool = False) -> Dict[str, torch.Tensor]:
    """Random state dict with the checkpoint set's keys and shapes, drawn from
    ``numpy.random.default_rng(seed)`` in ``state_dict`` key order: conv,
    transposed-conv and linear weights and biases uniform in
    ``+-1/sqrt(fan_in)`` (fan_in from every weight dim after the first, torch's
    default init); every PReLU weight (shape ``[1]``) the constant
    :data:`PRELU_INIT` = 0.25; LayerNorm weights 1 and biases 0; the RIFE
    ``beta`` scales 1.

    Base: the 289 tensors of the four ``GMFSS_fortuna_*.pkl`` files. Union:
    the same, with the fusion head ``residual_model_head`` (12 input
    channels) replaced by ``residual_model_head0`` (9), plus ``ifnet.*``, a
    RIFE 4.6 IFNet. The union layout is what the JAX package's code reads;
    no manifest of the union files (``rife46.pth``,
    ``GMFSS_fortuna_union_*.pkl``) is in the repository to check it against."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        net = GMFSS(union)
    prelu = {f"{name}.weight" for name, m in net.named_modules() if isinstance(m, nn.PReLU)}
    norms = {name for name, m in net.named_modules() if isinstance(m, nn.LayerNorm)}
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    params = {}
    for key, shape in shapes.items():
        module, name = key.rsplit(".", 1)
        if key in prelu:
            params[key] = torch.full(shape, PRELU_INIT)
        elif name == "beta" or (module in norms and name == "weight"):
            params[key] = torch.ones(shape)
        elif module in norms:
            params[key] = torch.zeros(shape)
        else:
            wshape = shapes[module + ".weight"]
            bound = 1.0 / np.sqrt(int(np.prod(wshape[1:])))
            params[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return params
