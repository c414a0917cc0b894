"""XVFI (X4K1000FPS), PyTorch port of the JAX package's ``models/xvfi.py``
(reference ``vfi_models/xvfi/xvfi_arch.py``: ``XVFInet`` 12-80, ``VFInet``
82-244, ``RefineUNet`` 415-446).

A shared-weight recursive feature pyramid (``rec_ext_ds`` downsamples
``log2(scale)`` times, ``rec_ctx_ds`` once per coarser level) feeds a
coarse-to-fine bidirectional flow estimator; level 0 turns the flows into
flows from the middle by Complementary Flow Reversal (a gaussian
z-weighted forward splat), refines them, backwarps features and frames and
blends them through a RefineUNet.

Every 3-D convolution of the reference has temporal extent 1 over the two
frames, so it runs as a 2-D convolution on the folded ``[2B, C, H, W]``
batch (frame 0's batch first), with the ``[O, I, 1, kh, kw]`` weight's
middle axis dropped. ``rec_ext_ds`` and ``rec_ctx_ds`` are single modules
appended again and again in the reference; the port registers the same
module at each index, so the ``state_dict`` keys are the reference's and
aliased keys load into one tensor. Images and features are NCHW in
``channels_last`` memory, frames NHWC at the API.

Warps: the masked backwarp :func:`_bwarp` warps the tensor in zeros mode
(``ops.warp.warp``: the 64-channel features on the wide kernel, the frames
on K1) and, apart from it, an f32 ones plane by the f32 flow (K1), masking
where the warped ones fall below 0.999. The JAX version appends the ones
channel to the tensor and so compares the ones in the model's dtype: in
bf16 0.999 rounds to 1.0 and it masks every pixel whose ones fall below
1.0 in bf16 (a known difference, ``ROADMAP.md`` Queue 3). CFR splats both
directions as one batch (``ops.softsplat.softsplat_func``, K2 on the card),
where JAX makes one splat per direction; the splat's f32 sums stay f32
through the normalisation, and ``norm > 0`` is taken on them
(:func:`warps_per_reuse`, :func:`warps_per_infer`, :func:`splats_per_infer`).

Inputs are zero-padded at the bottom and right to multiples of
``2 ** S_tst * scale * 4`` (:func:`make_model_fn`, :func:`make_pair_fns`).
Vimeo's ``state_dict`` equals ``XVFInet_Vimeo_exp1_latest.pt``'s manifest
(72 tensors, under ``state_dict_Model``); X4K has the reference's keys at
scale 4 (no manifest of it is in the repository).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.warp_kernel import route_counts
from ..ops.softsplat import softsplat_func
from ..ops.warp import warp
from .common import cast_params, channels_last_params, init_state_dict, pixel_shuffle, resize_bilinear

__all__ = [
    "CKPT_CONFIGS", "XVFInet", "apply", "feat_pyramid", "init_params", "make_model_fn", "make_pair_fns",
    "splats_per_infer", "warps_per_infer", "warps_per_reuse",
]

CKPT_CONFIGS = {
    "XVFInet_X4K1000FPS_exp1_latest.pt": {"module_scale_factor": 4, "S_tst": 5},
    "XVFInet_Vimeo_exp1_latest.pt": {"module_scale_factor": 2, "S_tst": 1},
}
NF = 64
IMG_CH = 3


def _conv3d(cin: int, cout: int, stride: int = 1) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, (1, 3, 3), (1, stride, stride), (0, 1, 1))


def _conv_t1(m: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A ``[1, 3, 3]`` Conv3d on the folded ``[2B, C, H, W]`` batch."""
    return F.conv2d(x, m.weight[:, :, 0], m.bias, m.stride[1:], m.padding[1:])


class ResBlock2D3D(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.conv3x3_1 = _conv3d(nf, nf)
        self.conv3x3_2 = _conv3d(nf, nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + _conv_t1(self.conv3x3_2, F.relu(_conv_t1(self.conv3x3_1, x)))


class RResBlock2D3D(nn.Module):
    """T_reduce_flag=False (xvfi_arch.py:470-490)."""

    def __init__(self, nf: int):
        super().__init__()
        self.resblock1 = ResBlock2D3D(nf)
        self.resblock2 = ResBlock2D3D(nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resblock2(self.resblock1(x)) + x


def _seq(*layers) -> nn.Sequential:
    """A reference ``nn.Sequential`` of convolutions (4x4 ones stride 2, 3x3
    and 1x1 ones stride 1), ``"relu"`` and ``"up"`` (nearest x2) steps, at
    the reference's indices."""
    mods = []
    for layer in layers:
        if layer == "relu":
            mods.append(nn.ReLU())
        elif layer == "up":
            mods.append(nn.Upsample(scale_factor=2, mode="nearest"))
        else:
            cin, cout, k = layer
            mods.append(nn.Conv2d(cin, cout, k, 2 if k == 4 else 1, 1 if k in (3, 4) else 0))
    return nn.Sequential(*mods)


def _flow_seq(cin: int, nf: int) -> nn.Sequential:
    """conv_flow_bottom / conv_flow2 (xvfi_arch.py:92-120)."""
    return _seq((cin, 2 * nf, 4), "relu", (2 * nf, 4 * nf, 4), "relu", "up", (4 * nf, 2 * nf, 3), "relu", "up",
                (2 * nf, nf, 3), "relu", (nf, 6, 3))


class RefineUNet(nn.Module):
    """xvfi_arch.py:415-446 (``conv1``/``conv2`` are in the checkpoint and
    unused by the forward)."""

    def __init__(self, nf: int, scale: int):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.conv2 = nn.Conv2d(nf, nf, 3, 1, 1)
        self.enc1 = nn.Conv2d(4 * nf // scale**2 + 4 * IMG_CH + 4, nf, 4, 2, 1)
        self.enc2 = nn.Conv2d(nf, 2 * nf, 4, 2, 1)
        self.enc3 = nn.Conv2d(2 * nf, 4 * nf, 4, 2, 1)
        self.dec0 = nn.Conv2d(4 * nf, 4 * nf, 3, 1, 1)
        self.dec1 = nn.Conv2d(6 * nf, 2 * nf, 3, 1, 1)
        self.dec2 = nn.Conv2d(3 * nf, nf, 3, 1, 1)
        self.dec3 = nn.Conv2d(nf, 1 + IMG_CH, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def up(t):
            return F.interpolate(t, scale_factor=2, mode="nearest")

        enc1 = F.relu(self.enc1(x))
        enc2 = F.relu(self.enc2(enc1))
        out = F.relu(self.dec0(F.relu(self.enc3(enc2))))
        out = F.relu(self.dec1(torch.cat([up(out), enc2], 1)))
        out = F.relu(self.dec2(torch.cat([up(out), enc1], 1)))
        return self.dec3(up(out))


class VFInet(nn.Module):
    def __init__(self, nf: int, scale: int):
        super().__init__()
        self.conv_flow_bottom = _flow_seq(2 * nf, nf)
        self.conv_flow1 = nn.Conv2d(2 * nf, nf, 3, 1, 1)
        self.conv_flow2 = _flow_seq(2 * nf + 4, nf)
        self.conv_flow3 = _seq((4 * nf + 4, nf, 1), "relu", (nf, 2 * nf, 4), "relu", (2 * nf, 4 * nf, 4), "relu", "up",
                               (4 * nf, 2 * nf, 3), "relu", "up", (2 * nf, nf, 3), "relu", (nf, 4, 3))
        self.refine_unet = RefineUNet(nf, scale)


class XVFInet(nn.Module):
    """xvfi_arch.py:12-80: the parameter tree (``module_scale_factor`` =
    ``scale``); :func:`apply` runs it."""

    def __init__(self, scale: int = 4, nf: int = NF):
        super().__init__()
        self.scale = scale
        self.channel_converter = nn.Sequential(_conv3d(IMG_CH, nf), nn.ReLU())
        self.rec_ext_ds = _conv3d(nf, nf, 2)
        mods = [self.channel_converter]
        for _ in range(int(math.log2(scale))):
            mods += [self.rec_ext_ds, nn.ReLU()]
        mods += [_conv3d(nf, nf), RResBlock2D3D(nf)]
        self.rec_ext_ds_module = nn.Sequential(*mods)
        self.rec_ctx_ds = _conv3d(nf, nf, 2)
        self.vfinet = VFInet(nf, scale)


def feat_pyramid(net: XVFInet, x01: torch.Tensor, s_tst: int) -> List[torch.Tensor]:
    """The feature pyramid (xvfi_arch.py:23-36, 52-58) of the folded frames
    ``[2B, 3, H, W]``: level 0 at ``1 / scale``, then ``s_tst`` levels each
    halved by the shared ``rec_ctx_ds`` (no activation)."""
    ext = net.rec_ext_ds_module
    n = int(math.log2(net.scale))
    x = F.relu(_conv_t1(ext[0][0], x01))
    for i in range(n):
        x = F.relu(_conv_t1(ext[2 * i + 1], x))
    x = ext[2 * n + 2](_conv_t1(ext[2 * n + 1], x))
    feats = [x]
    for _ in range(s_tst):
        x = _conv_t1(net.rec_ctx_ds, x)
        feats.append(x)
    return feats


def _bwarp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """VFInet.bwarp (xvfi_arch.py:246-268) of NCHW ``x`` by an NCHW (x, y)
    flow: a zeros-mode backwarp, masked where an f32 ones plane warped by the
    f32 flow falls below 0.999."""
    n, _, h, w = x.shape
    fl = flow.permute(0, 2, 3, 1).float()
    out = warp(x.permute(0, 2, 3, 1), fl, "zeros")
    ones = torch.ones((n, h, w, 1), dtype=torch.float32, device=x.device)
    mask = warp(ones, fl, "zeros") >= 0.999
    return (out * mask.to(x.dtype)).permute(0, 3, 1, 2)


def _z_fwarp(img: torch.Tensor, flow: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """VFInet.z_fwarp (xvfi_arch.py:320-417) on f32 NCHW ``img``, flow and
    metric ``z``: the 4-tap gaussian-weighted forward scatter, returning the
    f32 sums and their normalisation.

    The reference's tap weight ``z * exp(-(frac - dx)^2 - (frac - dy)^2)`` is
    separable; per axis the taps at floor and floor + 1 carry ``(g0, g1) =
    (exp(-t^2), exp(-(1 - t)^2))`` where a bilinear splat puts ``(1 - t',
    t')``. So it is one bilinear splat with fraction ``t' = g1 / (g0 + g1)``
    and the value scaled by ``(g0 + g1)_x (g0 + g1)_y z``, the value and the
    scale packed as one ``[N, H, W, C + 1]`` f32 input."""
    c = img.shape[1]
    fx, fy = flow[:, 0], flow[:, 1]
    x1, y1 = torch.floor(fx), torch.floor(fy)
    tx, ty = fx - x1, fy - y1
    gx0, gx1 = torch.exp(-tx.square()), torch.exp(-(1.0 - tx).square())
    gy0, gy1 = torch.exp(-ty.square()), torch.exp(-(1.0 - ty).square())
    sx, sy = gx0 + gx1, gy0 + gy1
    flow_adj = torch.stack([x1 + gx1 / sx, y1 + gy1 / sy], -1)
    scale = ((z[:, 0] + 1e-5) * (sx * sy))[..., None]
    out = softsplat_func(torch.cat([img.permute(0, 2, 3, 1) * scale, scale], -1), flow_adj)
    return out[..., :c].permute(0, 3, 1, 2), out[..., c:].permute(0, 3, 1, 2)


def _level_flow(v: VFInet, feat01: torch.Tensor, flow_prev: Optional[torch.Tensor]):
    """The t-independent flow half of a VFInet level (xvfi_arch.py:139-185):
    both flows (0 -> 1, 1 -> 0) and the raw output whose channels 4 and 5
    are the CFR metrics."""
    b = feat01.shape[0] // 2
    feat0, feat1 = feat01[:b], feat01[b:]
    if flow_prev is None:
        flow_tmp = v.conv_flow_bottom(torch.cat([feat0, feat1], 1))
        return flow_tmp[:, :4], flow_tmp
    up = 2.0 * resize_bilinear(flow_prev, feat0.shape[2:], align_corners=False)
    wf1 = _bwarp(feat1, up[:, :2])
    wf0 = _bwarp(feat0, up[:, 2:4])
    a = v.conv_flow1(torch.cat([feat0, wf1], 1))
    bb = v.conv_flow1(torch.cat([feat1, wf0], 1))
    flow_tmp = v.conv_flow2(torch.cat([a, bb, up], 1))
    return flow_tmp[:, :4] + up, flow_tmp


def _flow_stage(net: XVFInet, img0: torch.Tensor, img1: torch.Tensor, s_tst: int):
    """Everything t-independent (xvfi_arch.py:41-80, 139-185): the pyramid
    and the flow half of every level, coarsest first. Returns level 0's
    features and its flows."""
    feats = feat_pyramid(net, torch.cat([img0, img1]), s_tst)
    flow = None
    for level in range(s_tst, 0, -1):
        flow, _ = _level_flow(net.vfinet, feats[level], flow)
    flow, flow_tmp = _level_flow(net.vfinet, feats[0], flow)
    return feats[0], flow, flow_tmp


def _level0_synth(v: VFInet, img0, img1, feat01, flow, flow_tmp, t: torch.Tensor, scale: int) -> torch.Tensor:
    """The t-dependent tail of level 0 (xvfi_arch.py:186-244): CFR, two
    rounds of feature backwarps around ``conv_flow3``, the frames' backwarps
    by the upsampled flows, the RefineUNet and the occlusion blend. ``t`` is
    f32 ``[B, 1, 1, 1]``; flows and the blend are f32, the networks run in
    the features' dtype. Returns f32 NCHW."""
    b = feat01.shape[0] // 2
    dt = feat01.dtype
    feat0, feat1 = feat01[:b], feat01[b:]
    flow01, flow10 = flow[:, :2].float(), flow[:, 2:4].float()
    z = torch.sigmoid(flow_tmp[:, 4:6].float())

    # Complementary Flow Reversal (xvfi_arch.py:195-207), both directions as one splat
    sums, norms = _z_fwarp(torch.cat([flow01, flow10]), torch.cat([t * flow01, (1.0 - t) * flow10]),
                           torch.cat([z[:, :1], z[:, 1:]]))
    flow_fwd, flow_bwd = sums[:b], sums[b:]
    flow_t0 = -(1.0 - t) * (t * flow_fwd) + t * (t * flow_bwd)
    flow_t1 = (1.0 - t) * ((1.0 - t) * flow_fwd) - t * ((1.0 - t) * flow_bwd)
    norm = (1.0 - t) * norms[:b] + t * norms[b:]
    mask = (norm > 0).float()
    flow_t0 = (1 - mask) * flow_t0 + mask * (flow_t0 / (norm + (1 - mask)))
    flow_t1 = (1 - mask) * flow_t1 + mask * (flow_t1 / (norm + (1 - mask)))

    warped0, warped1 = _bwarp(feat0, flow_t0), _bwarp(feat1, flow_t1)
    refine = v.conv_flow3(torch.cat([feat0, warped0, warped1, feat1, flow_t0.to(dt), flow_t1.to(dt)], 1)).float()
    flow_t0, flow_t1 = refine[:, :2] + flow_t0, refine[:, 2:4] + flow_t1
    warped0, warped1 = _bwarp(feat0, flow_t0), _bwarp(feat1, flow_t1)

    h2, w2 = flow_t0.shape[2:]
    up0 = scale * resize_bilinear(flow_t0, (h2 * scale, w2 * scale), align_corners=False)
    up1 = scale * resize_bilinear(flow_t1, (h2 * scale, w2 * scale), align_corners=False)
    wimg0, wimg1 = _bwarp(img0, up0), _bwarp(img1, up1)
    shuffled = pixel_shuffle(torch.cat([feat0, feat1, warped0, warped1], 1), scale)
    refine_out = v.refine_unet(
        torch.cat([shuffled, img0, img1, wimg0, wimg1, up0.to(dt), up1.to(dt)], 1).contiguous(memory_format=torch.channels_last)
    ).float()
    occ0 = torch.sigmoid(refine_out[:, :1])
    occ1 = 1.0 - occ0
    out = (1.0 - t) * occ0 * wimg0.float() + t * occ1 * wimg1.float()
    return out / ((1.0 - t) * occ0 + t * occ1) + refine_out[:, 1:4]


def _planes(f: torch.Tensor) -> torch.Tensor:
    """NHWC frames as NCHW ``channels_last`` planes."""
    return f.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _timestep(t, n: int, device) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1, 1, 1, 1).expand(n, 1, 1, 1)


def apply(net: XVFInet, img0: torch.Tensor, img1: torch.Tensor, t, s_tst: int) -> torch.Tensor:
    """XVFInet.forward, inference path (xvfi_arch.py:41-80), on NHWC frames
    padded so H and W divide ``2 ** s_tst * scale * 4``; ``t`` a scalar or
    one per sample. f32 NHWC out."""
    x0, x1 = _planes(img0), _planes(img1)
    feat01, flow, flow_tmp = _flow_stage(net, x0, x1, s_tst)
    out = _level0_synth(net.vfinet, x0, x1, feat01, flow, flow_tmp, _timestep(t, x0.shape[0], x0.device), net.scale)
    return out.permute(0, 2, 3, 1)


def _divide(cfg) -> int:
    return 2 ** cfg["S_tst"] * cfg["module_scale_factor"] * 4


def _pad(f: torch.Tensor, divide: int) -> torch.Tensor:
    """NHWC ``f`` zero-padded at the bottom and right to multiples of ``divide``."""
    h, w = f.shape[1], f.shape[2]
    ph, pw = (-h) % divide, (-w) % divide
    return F.pad(f, (0, 0, 0, pw, 0, ph)) if ph or pw else f


def _load(params: Dict[str, torch.Tensor], scale: int, dtype: torch.dtype, device) -> XVFInet:
    with torch.device("meta"):
        net = XVFInet(scale)
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(params: Dict[str, torch.Tensor], ckpt_name: str, dtype: torch.dtype = torch.float32, device="cuda"):
    """``model_fn(f0, f1, t) -> mid``: NHWC frames, padded per call, f32 NHWC
    out at the frames' size."""
    cfg = CKPT_CONFIGS[ckpt_name]
    net = _load(params, cfg["module_scale_factor"], dtype, device)
    divide = _divide(cfg)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t) -> torch.Tensor:
        h, w = f0.shape[1], f0.shape[2]
        x0, x1 = (_pad(f.to(device=device, dtype=dtype), divide) for f in (f0, f1))
        return apply(net, x0, x1, t, cfg["S_tst"])[:, :h, :w]

    return model_fn


def make_pair_fns(params: Dict[str, torch.Tensor], ckpt_name: str, dtype: torch.dtype = torch.float32, device="cuda"):
    """``(reuse_fn, infer_fn)`` for ``core.loop.run_plan_pair_cached``: the
    pyramid and every flow level once per pair batch (``reuse_fn(f0, f1) ->
    cache``), level 0's synthesis once per timestep (``infer_fn(f0, f1,
    cache, t) -> mid``, f32 NHWC); the reference recomputes all of it per
    timestep."""
    cfg = CKPT_CONFIGS[ckpt_name]
    net = _load(params, cfg["module_scale_factor"], dtype, device)
    divide = _divide(cfg)

    def planes(f):
        return _planes(_pad(f.to(device=device, dtype=dtype), divide))

    @torch.inference_mode()
    def reuse_fn(f0: torch.Tensor, f1: torch.Tensor):
        return _flow_stage(net, planes(f0), planes(f1), cfg["S_tst"])

    @torch.inference_mode()
    def infer_fn(f0: torch.Tensor, f1: torch.Tensor, cache, t: torch.Tensor) -> torch.Tensor:
        h, w = f0.shape[1], f0.shape[2]
        x0, x1 = planes(f0), planes(f1)
        out = _level0_synth(net.vfinet, x0, x1, *cache, _timestep(t, x0.shape[0], x0.device), net.scale)
        return out.permute(0, 2, 3, 1)[:, :h, :w]

    return reuse_fn, infer_fn


def warps_per_reuse(ckpt_name: str, dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Warp launches of one ``reuse_fn`` by kernel, as ``warp_kernel.route``
    sends them: at every level but the coarsest, both frames' features (C =
    64), each with its f32 ones plane."""
    levels = CKPT_CONFIGS[ckpt_name]["S_tst"]
    return _masked_warps([NF] * 2 * levels, dtype)


def warps_per_infer(dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Warp launches of one ``infer_fn``: four feature backwarps (C = 64) and
    the two frames' (C = 3), each with its f32 ones plane."""
    return _masked_warps([NF] * 4 + [IMG_CH] * 2, dtype)


def splats_per_infer() -> int:
    """Splat launches of one ``infer_fn``: CFR's, both directions as one batch."""
    return 1


def _masked_warps(channels, dtype: torch.dtype) -> Dict[str, int]:
    counts = route_counts(channels, dtype)
    ones = route_counts([1] * len(channels), torch.float32)
    return {k: counts[k] + ones[k] for k in counts}


def init_params(ckpt_name: str = "XVFInet_Vimeo_exp1_latest.pt", seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict of the checkpoint's configuration
    (``common.init_state_dict``), every aliased key (``rec_ext_ds`` under
    its indices in ``rec_ext_ds_module``, ``channel_converter`` under index
    0) holding the one tensor of the first key it is reached by."""
    with torch.device("meta"):
        net = XVFInet(CKPT_CONFIGS[ckpt_name]["module_scale_factor"])
    params = init_state_dict(net, seed)
    first = {}
    for name, p in net.named_parameters(remove_duplicate=False):
        params[name] = params[first.setdefault(id(p), name)]
    return params
