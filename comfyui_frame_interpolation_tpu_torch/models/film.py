"""FILM (Frame Interpolation for Large Motion), PyTorch port of the JAX
package's ``models/film.py`` (reference ``vfi_models/film/film_arch.py``, the
pure-PyTorch form of the TorchScript ``film_net_fp32.pt``).

1. A cascaded feature pyramid: one shared ``SubTreeExtractor`` applied at
   each of the 7 image-pyramid levels, its outputs concatenated along the
   cascade diagonals (``film_arch.py:83-162``): 64, 192, 448 and then 960
   channels at levels 0, 1, 2 and 3+.
2. A residual flow pyramid: coarse-to-fine refinement with a predictor shared
   by the coarse levels and one per level for the finest three
   (``film_arch.py:500-617``), synthesised into bidirectional flows scaled by
   the fixed mid time 0.5 (``film_arch.py:418-429``: FILM always interpolates
   t = 0.5; fractional times come from the node's bisection schedule).
3. Fusion: a U-Net decoder over the warped image, feature and flow pyramid,
   with nearest 2x upsampling and 2x2 convolutions (``film_arch.py:219-292``).

Both images ride one batch through the pyramid and the extractor, and both
flow directions ride one batch through the flow pyramid and the warps, as in
JAX (``film.py:262-264,300-305``). Per forward that gives 6 feature warps in
the flow pyramid and 5 in :func:`stage_warp` on the wide-channel kernel
(``prefer_wide``, C >= 32), and 5 image warps (C = 3) on K1:
:data:`WARPS_PER_CALL`.

:func:`stage_warp` concatenates each aligned level as the reference does
(``[img0, feat0, img1, feat1, bwd_flow, fwd_flow]``, 138/394/906/1930
channels), and the fusion convolves it with the checkpoint's weights as they
are; JAX splits it into two weight-sliced groups against the TPU's lane
padding, which is the same sum in another order. The concats that feed the
flow estimators and the fusion's ``[level, upsampled]`` convolutions stay
virtual (:func:`~.common.conv2d_concat`), and every exact 2x upsample of the
fusion takes :func:`~.common.conv2x2_up2x`, as in JAX.

:class:`FILMNet` holds the parameters, with ``state_dict`` keys and shapes
equal to ``film_net_fp32.pt`` (82 tensors, 34.4 M parameters). The
``stage_*`` functions are the JAX stage split (``film.py:237-343``), so chip
runs can time each stage. Frames are NHWC at :func:`stage_pyramid` and
:func:`apply`; every stage's outputs are NCHW tensors in ``channels_last``
memory.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.warp import warp
from .common import (
    avg_pool2d,
    cast_params,
    conv2d,
    conv2d_concat,
    conv2x2_up2x,
    leaky_relu,
    resize_bilinear,
    resize_nearest,
)

__all__ = [
    "CKPT_NAMES",
    "FILMNet",
    "FUSION_PYRAMID_LEVELS",
    "PYRAMID_LEVELS",
    "SUB_LEVELS",
    "WARPS_PER_CALL",
    "apply",
    "init_params",
    "make_model_fn",
    "stage_features",
    "stage_flow",
    "stage_fuse",
    "stage_pyramid",
    "stage_warp",
]

CKPT_NAMES = ["film_net_fp32.pt"]
PYRAMID_LEVELS = 7
FUSION_PYRAMID_LEVELS = 5
SUB_LEVELS = 4
WIDE_MIN_CHANNELS = 32  # the JAX prefer_mxu threshold (film.py:125,134,304)
# warp launches per forward: 6 in the flow pyramid + 5 feature warps (wide
# kernel), 5 image warps (K1)
WARPS_PER_CALL = {"wide": 11, "narrow": 5}
_FLOW_CONVS = (3, 3, 3, 3)
_FILTERS = 64
_FLOW_FILTERS = (32, 64, 128, 256)


# ---- parameter tree (keys of film_net_fp32.pt) -------------------------------


def _conv_act(i: int, o: int, k: int) -> nn.Sequential:
    """reference ``conv()`` with activation: ``Sequential(Conv2d('same'),
    LeakyReLU(0.2))``, keys ``0.weight``/``0.bias``."""
    return nn.Sequential(nn.Conv2d(i, o, k, padding="same"), nn.LeakyReLU(0.2))


class _SubTreeExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        convs = []
        c_in = 3
        for i in range(SUB_LEVELS):
            c = _FILTERS << i
            convs.append(nn.Sequential(_conv_act(c_in, c, 3), _conv_act(c, c, 3)))
            c_in = c
        self.convs = nn.ModuleList(convs)


class _FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.extract_sublevels = _SubTreeExtractor()


class _FlowEstimator(nn.Module):
    def __init__(self, in_ch: int, num_convs: int, filters: int):
        super().__init__()
        convs: List[nn.Module] = [_conv_act(in_ch, filters, 3)]
        convs += [_conv_act(filters, filters, 3) for _ in range(1, num_convs)]
        convs.append(_conv_act(filters, filters // 2, 1))
        convs.append(nn.Conv2d(filters // 2, 2, 1))
        self._convs = nn.ModuleList(convs)


def _level_channels(level: int) -> int:
    """Feature channels of the cascaded pyramid at ``level``: 64, 192, 448,
    then 960."""
    return sum(_FILTERS << j for j in range(min(level, SUB_LEVELS - 1) + 1))


class _PyramidFlowEstimator(nn.Module):
    def __init__(self):
        super().__init__()
        # per-level predictors for the finest three levels, stored coarse
        # first (k = 0 serves level 2), and the shared coarse predictor
        self._predictors = nn.ModuleList(
            _FlowEstimator(2 * _level_channels(i), _FLOW_CONVS[i], _FLOW_FILTERS[i])
            for i in reversed(range(len(_FLOW_CONVS) - 1))
        )
        self._predictor = _FlowEstimator(2 * _level_channels(SUB_LEVELS - 1), _FLOW_CONVS[-1], _FLOW_FILTERS[-1])


class _Fusion(nn.Module):
    def __init__(self):
        super().__init__()
        n = FUSION_PYRAMID_LEVELS - 1
        convs = []
        for k in range(n):
            i = n - 1 - k  # the level this block writes
            c_out = _FILTERS << i
            c_net = 10 + 2 * _level_channels(n) if k == 0 else c_out * 2
            c_lvl = 10 + 2 * _level_channels(i)
            convs.append(nn.ModuleList([
                nn.Conv2d(c_net, c_out, 2, padding="same"),
                _conv_act(c_lvl + c_out, c_out, 3),
                _conv_act(c_out, c_out, 3),
            ]))
        self.convs = nn.ModuleList(convs)
        self.output_conv = nn.Conv2d(_FILTERS, 3, 1)


class FILMNet(nn.Module):
    """Parameter tree of the reference ``Interpolator`` (``state_dict`` keys
    of ``film_net_fp32.pt``); the ``stage_*`` functions run it."""

    def __init__(self):
        super().__init__()
        self.extract = _FeatureExtractor()
        self.predict_flow = _PyramidFlowEstimator()
        self.fuse = _Fusion()


# ---- forward -----------------------------------------------------------------


def _warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Border-mode ``ops.warp.warp`` of NCHW tensors (the permutes are views);
    features of C >= 32 take the wide-channel kernel, as JAX's
    ``prefer_mxu=C >= 32``."""
    wide = x.shape[1] >= WIDE_MIN_CHANNELS
    return warp(x.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), prefer_wide=wide).permute(0, 3, 1, 2)


def _extract_features(p: _FeatureExtractor, pyr: List[torch.Tensor]) -> List[torch.Tensor]:
    """``FeatureExtractor.forward`` (film_arch.py:102-162)."""
    n_levels = len(pyr)
    convs = p.extract_sublevels.convs
    subs = []
    for i in range(n_levels):
        head = pyr[i]
        levels = []
        depth = min(n_levels - i, SUB_LEVELS)
        for j in range(depth):
            head = convs[j](head)
            levels.append(head)
            if j < depth - 1:
                head = avg_pool2d(head, 2, 2)
        subs.append(levels)
    feats = []
    for i in range(n_levels):
        parts = [subs[i][0]] + [subs[i - j][j] for j in range(1, min(i, SUB_LEVELS - 1) + 1)]
        feats.append(parts[0] if len(parts) == 1 else torch.cat(parts, 1))
    return feats


def _flow_estimator(p: _FlowEstimator, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
    """``FlowEstimator.forward`` (film_arch.py:530-543), its input concat
    virtual."""
    first = p._convs[0][0]
    net = leaky_relu(conv2d_concat([fa, fb], first.weight, first.bias, padding="same"), 0.2)
    for layer in p._convs[1:]:
        net = layer(net)
    return net


def _predict_flow(p: _PyramidFlowEstimator, pyr_a: List[torch.Tensor], pyr_b: List[torch.Tensor]) -> List[torch.Tensor]:
    """``PyramidFlowEstimator.forward`` (film_arch.py:567-617)."""
    levels = len(pyr_a)
    n_fine = len(_FLOW_CONVS) - 1
    v = _flow_estimator(p._predictor, pyr_a[-1], pyr_b[-1])
    residuals = [v]
    for i in range(levels - 2, -1, -1):
        predictor = p._predictor if i >= n_fine else p._predictors[n_fine - 1 - i]
        v = resize_bilinear(2.0 * v, pyr_a[i].shape[-2:])
        v_res = _flow_estimator(predictor, pyr_a[i], _warp(pyr_b[i], v))
        residuals.insert(0, v_res)
        v = v_res + v
    return residuals


def _flow_pyramid_synthesis(residuals: List[torch.Tensor]) -> List[torch.Tensor]:
    """film_arch.py:745-755."""
    flow = residuals[-1]
    pyramid = [flow]
    for res in residuals[-2::-1]:
        flow = res + resize_bilinear(2.0 * flow, res.shape[-2:])
        pyramid.insert(0, flow)
    return pyramid


def stage_pyramid(x0: torch.Tensor, x1: torch.Tensor) -> List[torch.Tensor]:
    """Image pyramid of NHWC frames ``x0`` and ``x1`` ``[n, H, W, 3]`` as one
    batch ``[2n, 3, ...]`` (film_arch.py:404-409), 7 levels of 2x2 average
    pooling."""
    pyr = [torch.cat([x0, x1], 0).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)]
    for _ in range(PYRAMID_LEVELS - 1):
        pyr.append(avg_pool2d(pyr[-1], 2, 2))
    return pyr


def stage_features(net: FILMNet, pyr_both: List[torch.Tensor]) -> List[torch.Tensor]:
    """Cascaded feature pyramid over the batched image pyramid."""
    return _extract_features(net.extract, pyr_both)


def stage_flow(net: FILMNet, feat_both: List[torch.Tensor], n: int) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Forward and backward flow pyramids (``FUSION_PYRAMID_LEVELS`` levels),
    scaled to the mid time (film_arch.py:418-429). Both directions ride one
    batch: features ``[f0; f1]`` against ``[f1; f0]``."""
    pb = [torch.cat([f[n:], f[:n]], 0) for f in feat_both]
    res_both = _predict_flow(net.predict_flow, feat_both, pb)
    fwd = _flow_pyramid_synthesis([r[:n] for r in res_both])[:FUSION_PYRAMID_LEVELS]
    bwd = _flow_pyramid_synthesis([r[n:] for r in res_both])[:FUSION_PYRAMID_LEVELS]
    mid = 0.5
    return [f * (1.0 - mid) for f in fwd], [f * mid for f in bwd]


def stage_warp(
    pyr_both: List[torch.Tensor],
    feat_both: List[torch.Tensor],
    fwd_flow: List[torch.Tensor],
    bwd_flow: List[torch.Tensor],
    n: int,
) -> List[torch.Tensor]:
    """Warp the image and feature pyramids of both endpoints (image 0 by the
    backward flow, image 1 by the forward flow, one batched call per tensor)
    and concatenate each fusion level in the reference's order
    ``[img0, feat0, img1, feat1, bwd_flow, fwd_flow]`` (film_arch.py:430-446)."""
    aligned = []
    for i in range(FUSION_PYRAMID_LEVELS):
        bf, ff = bwd_flow[i], fwd_flow[i]
        flow_both = torch.cat([bf, ff], 0)
        img_w = _warp(pyr_both[i], flow_both)
        feat_w = _warp(feat_both[i], flow_both)
        aligned.append(torch.cat([img_w[:n], feat_w[:n], img_w[n:], feat_w[n:], bf, ff], 1))
    return aligned


def stage_fuse(net: FILMNet, aligned: List[torch.Tensor]) -> torch.Tensor:
    """``Fusion.forward`` (film_arch.py:258-292): from the coarsest level up,
    nearest upsampling to the next level and a 2x2 convolution (fused as
    :func:`~.common.conv2x2_up2x` when the step is exactly 2x), then two 3x3
    convolutions, the first over ``[level, upsampled]`` (a virtual concat);
    a 1x1 output convolution. Returns NCHW ``[n, 3, H, W]``."""
    p = net.fuse
    x = aligned[-1]
    n_layers = len(aligned) - 1
    for k in range(n_layers):
        i = n_layers - 1 - k
        up_conv, conv1, conv2 = p.convs[k]
        th, tw = aligned[i].shape[-2:]
        if (th, tw) == (2 * x.shape[-2], 2 * x.shape[-1]):
            x = conv2x2_up2x(x, up_conv.weight, up_conv.bias)
        else:
            x = up_conv(resize_nearest(x, (th, tw)))
        x = leaky_relu(conv2d_concat([aligned[i], x], conv1[0].weight, conv1[0].bias, padding="same"), 0.2)
        x = conv2(x)
    return conv2d(x, p.output_conv.weight, p.output_conv.bias)


def apply(net: FILMNet, x0: torch.Tensor, x1: torch.Tensor, timestep=0.5) -> torch.Tensor:
    """``Interpolator.forward`` (film_arch.py:401-459) on NHWC frames
    ``[n, H, W, 3]`` of any size; returns the NHWC midpoint. ``timestep`` is
    accepted for the executor's signature and ignored, as in the reference
    (``mid_time = 0.5``)."""
    del timestep
    n = x0.shape[0]
    pyr_both = stage_pyramid(x0, x1)
    feat_both = stage_features(net, pyr_both)
    fwd_flow, bwd_flow = stage_flow(net, feat_both, n)
    aligned = stage_warp(pyr_both, feat_both, fwd_flow, bwd_flow, n)
    return stage_fuse(net, aligned).permute(0, 2, 3, 1)


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> FILMNet:
    """``params`` cast to ``dtype``, loaded with ``strict=True`` into a module
    on ``device`` in ``channels_last`` memory."""
    with torch.device("meta"):
        net = FILMNet()
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return net.to(device=device, memory_format=torch.channels_last).eval()


def make_model_fn(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda"):
    """``model_fn(f0, f1, t) -> mid`` for the plan executor: NHWC frames in,
    the midpoint clamped to [0, 1] (reference ``film/__init__.py:39``) as
    float32 NHWC out; ``t`` is ignored (bisection gives every call t = 0.5)."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        f0 = f0.to(device=device, dtype=dtype)
        f1 = f1.to(device=device, dtype=dtype)
        return apply(net, f0, f1).clamp(0.0, 1.0).float()

    return model_fn


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict with the shapes of ``film_net_fp32.pt``, drawn from
    ``numpy.random.default_rng(seed)`` in ``state_dict`` key order: every
    weight and bias uniform in ``+-1/sqrt(fan_in)`` (fan_in from dims 1..3 of
    the weight, torch's default init)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in FILMNet().state_dict().items()}
    params = {}
    for key, shape in shapes.items():
        wshape = shapes[key.rsplit(".", 1)[0] + ".weight"]
        bound = 1.0 / np.sqrt(wshape[1] * wshape[2] * wshape[3])
        params[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return params
