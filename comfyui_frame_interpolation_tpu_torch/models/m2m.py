"""M2M (Many-to-Many splatting) VFI, PyTorch port of the JAX package's
``models/m2m.py`` (reference ``vfi_models/m2m/M2M_arch.py``).

1. ``netFlow``: a PWC-like pyramid flow net at ``2/ratio`` resolution, three
   strided extractor blocks and two average pools, then five decoders, each
   taking its features, a PReLU'd 81-channel cost volume against the
   backward-warped other image (``ops.costvol``) and the upsampled flow
   (``M2M_arch.py:414-541``). Both directions run.
2. ``MRN`` (MotionRefineNet): both flows upsampled by ``ratio``, an image
   pyramid, and an encoder-decoder with channel/row/column attention that
   gives ``BRANCH = 4`` residual flows and a reliability mask
   (``M2M_arch.py:649-892``).
3. The multi-branch forward splat (``M2M_arch.py:551-581``): every branch and
   direction splats ``img * t * exp(metric)`` and ``t * exp(metric)`` with its
   flow, all eight in one ``softsplat_func`` call (the Hopper kernel on the
   card); the sums are normalised jointly and holes filled with the
   time-blended inputs (``M2M_arch.py:966-1037``).

The backward warps are ``ops.warp`` in zeros mode (the Hopper kernels on the
card): 20 per pair batch, 8 in the flow net, 10 in the encoder-decoder and 2
for the photometric metrics (:data:`WARP_CHANNELS_PER_REUSE`). The 16 feature
warps (C = 32 to 384) take the wide-channel kernel and the 4 image warps K1
(:func:`warps_per_reuse`). The splat is one call per timestep batch.

:class:`M2M_PWC` holds the parameters, with ``state_dict`` keys and shapes
equal to the released ``M2M.pth`` (188 tensors). :func:`pair_reuse` computes
everything that does not read the timestep, once per pair batch, and
:func:`pair_infer` the splat and merge per timestep; :func:`apply` is both.
Frames are NHWC at these functions, as in the JAX package, and so is the
cache :func:`pair_reuse` returns (same keys and shapes as the JAX one); inside,
tensors are NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ..ops.costvol import costvol_func
from ..ops.cuda.warp_kernel import route_counts
from ..ops.softsplat import softsplat_func
from ..ops.warp import warp
from .common import PRELU_INIT, avg_pool2d, cast_params, resize_by_scale

__all__ = [
    "BRANCH",
    "CKPT_NAMES",
    "M2M_PWC",
    "PRELU_INIT",
    "PARAM_ALPHA_INIT",
    "WARPS_PER_REUSE",
    "WARP_CHANNELS_PER_REUSE",
    "apply",
    "init_params",
    "make_model_fn",
    "make_pair_fns",
    "pair_infer",
    "pair_reuse",
    "warps_per_reuse",
]

CKPT_NAMES = ["M2M.pth"]
BRANCH = 4
# the channels of each warp per pair batch, in call order: 8 flow-net feature
# warps, 2 image warps and 8 feature warps in _encdec, 2 image warps for the
# metrics
WARP_CHANNELS_PER_REUSE = (32,) * 8 + (3, 3) + (48, 48, 96, 96, 192, 192, 384, 384) + (3, 3)
WARPS_PER_REUSE = len(WARP_CHANNELS_PER_REUSE)  # 20
PARAM_ALPHA_INIT = 10.0


# ---- parameter tree (keys of M2M_arch.py) ------------------------------------


def _conv_repl(i: int, o: int) -> nn.Conv2d:
    """3x3 conv with replicate padding (``M2M_arch.py`` ``padding_mode='replicate'``)."""
    return nn.Conv2d(i, o, 3, 1, 1, padding_mode="replicate")


class _ExtractorBlock(nn.Module):
    """``Basic("evenize-sconv(2)-prelu-conv(3)-prelu-conv(3)-prelu")``."""

    def __init__(self, i: int, o: int = 32):
        super().__init__()
        self.netMain = nn.Sequential(
            nn.Conv2d(i, o, 2, 2, 0), nn.PReLU(1),
            _conv_repl(o, o), nn.PReLU(1),
            _conv_repl(o, o), nn.PReLU(1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        if h % 2 or w % 2:  # evenize: replicate-pad odd H/W
            x = F.pad(x, (0, w % 2, 0, h % 2), mode="replicate")
        return self.netMain(x)


class _Extractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.netOne = _ExtractorBlock(3)
        self.netTwo = _ExtractorBlock(32)
        self.netThr = _ExtractorBlock(32)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        one = self.netOne(x)
        two = self.netTwo(one)
        thr = self.netThr(two)
        fou = avg_pool2d(thr, 2, 2)
        fiv = avg_pool2d(fou, 2, 2)
        return [one, two, thr, fou, fiv]


class _Wrap(nn.Module):
    """One more level of nesting, for the checkpoint's ``netMain.netMain``."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.netMain = body


class _Decoder(nn.Module):
    """``Decoder`` (M2M_arch.py:457-504): conv-prelu x5 and a 2-channel conv."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.netCostacti = nn.PReLU(1)
        layers: List[nn.Module] = []
        for i, o in ((in_ch, 128), (128, 128), (128, 96), (96, 64), (64, 32)):
            layers += [_conv_repl(i, o), nn.PReLU(1)]
        layers.append(_conv_repl(32, 2))
        self.netMain = _Wrap(nn.Sequential(*layers))

    def forward(self, one, two, flow: Optional[torch.Tensor]) -> torch.Tensor:
        if flow is not None:
            flow = 2.0 * resize_by_scale(flow, 2.0)
            cost = self.netCostacti(costvol_func(one, _backwarp(two, flow)))
            x = self.netMain.netMain(torch.cat([one, cost, flow], 1))
            return flow + x
        cost = self.netCostacti(costvol_func(one, two))
        return self.netMain.netMain(torch.cat([one, cost], 1))


class _FlowNet(nn.Module):
    """``Network`` (M2M_arch.py:414-541), the bidirectional PWC flow."""

    def __init__(self):
        super().__init__()
        self.netExtractor = _Extractor()
        self.netTwo = _Decoder(32 + 81 + 2)
        self.netThr = _Decoder(32 + 81 + 2)
        self.netFou = _Decoder(32 + 81 + 2)
        self.netFiv = _Decoder(32 + 81)
        self.netOne = _Decoder(32 + 81 + 2)

    def forward(self, one: torch.Tensor, two: torch.Tensor):
        n = one.shape[0]
        feats = self.netExtractor(torch.cat([one, two], 0))
        f_one = [f[:n] for f in feats]
        f_two = [f[n:] for f in feats]

        def run(a, b):
            flow = None
            for dec, lvl in (
                (self.netFiv, 4), (self.netFou, 3), (self.netThr, 2), (self.netTwo, 1), (self.netOne, 0)
            ):
                flow = dec(a[lvl], b[lvl], flow)
            return flow

        return run(f_one, f_two), run(f_two, f_one)


class _Conv2(nn.Module):
    """Two conv-PReLU pairs, the first strided (``Conv2`` of MotionRefineNet)."""

    def __init__(self, i: int, o: int, stride: int = 2):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(i, o, 3, stride, 1), nn.PReLU(o))
        self.conv2 = nn.Sequential(nn.Conv2d(o, o, 3, 1, 1), nn.PReLU(o))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


def _deconv(i: int, o: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(i, o, 4, 2, 1), nn.PReLU(o))


def _attention(i: int, o: int) -> nn.Sequential:
    # index 0 is the reference's parameter-free pooling; the pooling is done
    # by _attention_cube
    return nn.Sequential(nn.Identity(), nn.Conv2d(i, o, 1))


class _ImgPyramid(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _Conv2(3, 16)
        self.conv2 = _Conv2(16, 32)
        self.conv3 = _Conv2(32, 64)
        self.conv4 = _Conv2(64, 128)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        x3 = self.conv3(x2)
        x4 = self.conv4(x3)
        return [x1, x2, x3, x4]


class _EncDec(nn.Module):
    """``EncDec`` (M2M_arch.py:717-849)."""

    def __init__(self):
        super().__init__()
        self.down0 = _Conv2(8, 32)
        self.down1 = _Conv2(96, 64)
        self.down2 = _Conv2(192, 128)
        self.down3 = _Conv2(384, 256)
        self.conv_C = _attention(256, 16 * 256)
        self.conv_H = _attention(256, 16)
        self.conv_W = _attention(256, 16)
        self.up0 = _deconv(768, 128)
        self.up1 = _deconv(256, 64)
        self.up2 = _deconv(128, 32)
        self.up3 = _deconv(64, 16)
        self.conv_m = nn.Conv2d(16, 1, 3, 1, 1)
        self.conv = nn.Conv2d(16, 2 * BRANCH, 3, 1, 1)


class _MotionRefineNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.img_pyramid = _ImgPyramid()
        self.motion_encdec = _EncDec()


class M2M_PWC(nn.Module):
    """Parameter tree of ``M2M_PWC`` (``state_dict`` keys of ``M2M.pth``);
    :func:`pair_reuse` and :func:`pair_infer` run it."""

    def __init__(self):
        super().__init__()
        self.netFlow = _FlowNet()
        self.MRN = _MotionRefineNet()
        self.paramAlpha = nn.Parameter(torch.full((1, 1, 1, 1), PARAM_ALPHA_INIT))


def warps_per_reuse(dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    """Warp launches per pair batch on the card by kernel, ``{"narrow": K1,
    "wide": the wide-channel kernel}``, as ``warp_kernel.route`` sends the
    ``channels_last`` tensors of :data:`WARP_CHANNELS_PER_REUSE`."""
    return route_counts(WARP_CHANNELS_PER_REUSE, dtype)


# ---- forward -----------------------------------------------------------------


def _backwarp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``backwarp`` (M2M_arch.py:24-92): NCHW ``ops.warp.warp`` in zeros
    mode; the permutes are views and the kernel takes the strides as they are."""
    return warp(x.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), "zeros").permute(0, 3, 1, 2)


def _attention_cube(p: _EncDec, s: torch.Tensor) -> torch.Tensor:
    """conv_C/H/W attention (M2M_arch.py:786-812)."""
    n, c, h, w = s.shape
    cc = torch.sigmoid(p.conv_C[1](s.mean((2, 3), keepdim=True))).reshape(n, 16, c)
    ch = torch.sigmoid(p.conv_H[1](s.mean(3, keepdim=True)))[:, :, :, 0]  # [n,16,h]
    cw = torch.sigmoid(p.conv_W[1](s.mean(2, keepdim=True)))[:, :, 0, :]  # [n,16,w]
    cube = torch.einsum("nic,nih,niw->nchw", cc, ch, cw) / 16.0
    return s * cube


def _encdec(p: _EncDec, flow0, flow1, im0, im1, c0, c1):
    """``EncDec.forward`` (M2M_arch.py:717-849)."""
    wim1 = _backwarp(im1, flow0)
    wim0 = _backwarp(im0, flow1)
    s0_levels = [p.down0(torch.cat([flow0, im0, wim1], 1))]
    s1_levels = [p.down0(torch.cat([flow1, im1, wim0], 1))]

    for i, down in enumerate((p.down1, p.down2, p.down3)):
        flow0 = resize_by_scale(flow0, 0.5) * 0.5
        flow1 = resize_by_scale(flow1, 0.5) * 0.5
        a0 = torch.cat([s0_levels[-1], c0[i]], 1)
        a1 = torch.cat([s1_levels[-1], c1[i]], 1)
        wf0 = _backwarp(a0, flow1)
        wf1 = _backwarp(a1, flow0)
        s0_levels.append(down(torch.cat([a0, wf1], 1)))
        s1_levels.append(down(torch.cat([a1, wf0], 1)))

    s0_levels[3] = _attention_cube(p, s0_levels[3])
    s1_levels[3] = _attention_cube(p, s1_levels[3])

    flow0 = resize_by_scale(flow0, 0.5) * 0.5
    flow1 = resize_by_scale(flow1, 0.5) * 0.5
    a0 = torch.cat([s0_levels[3], c0[3]], 1)
    a1 = torch.cat([s1_levels[3], c1[3]], 1)
    wf0 = _backwarp(a0, flow1)
    wf1 = _backwarp(a1, flow0)
    x0 = p.up0(torch.cat([a0, wf1], 1))
    x1 = p.up0(torch.cat([a1, wf0], 1))
    for lvl, up in ((2, p.up1), (1, p.up2), (0, p.up3)):
        x0 = up(torch.cat([s0_levels[lvl], x0], 1))
        x1 = up(torch.cat([s1_levels[lvl], x1], 1))

    m0 = torch.sigmoid(p.conv_m(x0)) * 0.8 + 0.1
    m1 = torch.sigmoid(p.conv_m(x1)) * 0.8 + 0.1
    return p.conv(x0), p.conv(x1), m0.repeat(1, BRANCH, 1, 1), m1.repeat(1, BRANCH, 1, 1)


def _split_branch(x: torch.Tensor) -> torch.Tensor:
    """``[n, BRANCH*ch, h, w]`` -> ``[n*BRANCH, ch, h, w]``, branch-minor (the
    JAX ``reshape(n, hp, wp, BRANCH, ch)``, branch axis next to the batch)."""
    n, bc, h, w = x.shape
    return x.reshape(n * BRANCH, bc // BRANCH, h, w)


def _repeat_branches(x: torch.Tensor) -> torch.Tensor:
    """``x.repeat_interleave(BRANCH, 0)`` written in one pass into
    ``channels_last`` memory, where ``repeat_interleave`` would return
    NCHW-contiguous memory: the metrics' image warps then take K1's tiled
    body and their NHWC consumers read contiguous pixels. A value held as
    row bands (``parallel.space.RowBands``) takes the row-band rule of
    ``parallel/``, which repeats each band so."""
    if has_torch_function((x,)):
        return handle_torch_function(_repeat_branches, (x,), x)
    out = torch.empty(
        (x.shape[0] * BRANCH, *x.shape[1:]), dtype=x.dtype, device=x.device, memory_format=torch.channels_last
    )
    out.unflatten(0, (x.shape[0], BRANCH)).copy_(x.unsqueeze(1))
    return out


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def pair_reuse(net: M2M_PWC, im0: torch.Tensor, im1: torch.Tensor, ratio: int = 4) -> Dict[str, torch.Tensor]:
    """Timestep-independent per-pair state (flow pyramid, MotionRefineNet
    branches, photometric metrics) of NHWC frames ``[n, H, W, 3]``: everything
    in ``M2M_PWC.forward`` before the per-timestep splat. The reference
    recomputes all of it for every timestep (M2M_arch.py:939-1027); sharing it
    across a pair's timesteps is exact since none of it reads t.

    Returns the JAX package's cache: the same keys and shapes, NHWC."""
    n, h, w, _ = im0.shape
    align = ratio * 16
    padr = (-w) % align
    padb = (-h) % align
    im0 = im0.permute(0, 3, 1, 2)
    im1 = im1.permute(0, 3, 1, 2)
    if padr or padb:
        im0 = F.pad(im0, (0, padr, 0, padb), mode="replicate")
        im1 = F.pad(im1, (0, padr, 0, padb), mode="replicate")

    # joint mean/std normalisation (M2M_arch.py:915-935); biased variance
    m0 = im0.mean((1, 2, 3), keepdim=True)
    m1 = im1.mean((1, 2, 3), keepdim=True)
    mean_ = (m0 + m1) / 2
    var0 = im0.var((1, 2, 3), keepdim=True, unbiased=False) + (mean_ - m0) ** 2
    var1 = im1.var((1, 2, 3), keepdim=True, unbiased=False) + (mean_ - m1) ** 2
    std_ = torch.sqrt((var0 + var1) / 2)
    cl = torch.channels_last
    im0_o = ((im0 - mean_) / (std_ + 1e-7)).contiguous(memory_format=cl)
    im1_o = ((im1 - mean_) / (std_ + 1e-7)).contiguous(memory_format=cl)

    fwd, bwd = net.netFlow(resize_by_scale(im0_o, 2.0 / ratio), resize_by_scale(im1_o, 2.0 / ratio))

    # MotionRefineNet (M2M_arch.py:860-892)
    mrn = net.MRN
    fwd = ratio * resize_by_scale(fwd, float(ratio))
    bwd = ratio * resize_by_scale(bwd, float(ratio))
    c0 = mrn.img_pyramid(im0_o)
    c1 = mrn.img_pyramid(im1_o)
    r0, r1, wei_f, wei_b = _encdec(mrn.motion_encdec, fwd, bwd, im0_o, im1_o, c0, c1)
    fwd_b = _split_branch(fwd.repeat(1, BRANCH, 1, 1) + r0)
    bwd_b = _split_branch(bwd.repeat(1, BRANCH, 1, 1) + r1)
    wf_b = _split_branch(wei_f)
    wb_b = _split_branch(wei_b)
    im0_b = _repeat_branches(im0_o)
    im1_b = _repeat_branches(im1_o)

    def photo(wt, a, b, flow):
        diff = (a - _backwarp(b, flow)).abs().mean(1, keepdim=True)
        return (1.0 - wt * diff).clamp(min=0.001).square()

    alpha = net.paramAlpha.reshape(1, 1, 1, 1)
    metric0 = alpha * photo(wf_b, im0_b, im1_b, fwd_b)
    metric1 = alpha * photo(wb_b, im1_b, im0_b, bwd_b)
    return {
        "im0_o": _nhwc(im0_o), "im1_o": _nhwc(im1_o), "im0_b": _nhwc(im0_b), "im1_b": _nhwc(im1_b),
        "fwd_b": _nhwc(fwd_b), "bwd_b": _nhwc(bwd_b),
        "metric0": _nhwc(metric0), "metric1": _nhwc(metric1),
        "mean": _nhwc(mean_), "std": _nhwc(std_),
    }


def pair_infer(net: M2M_PWC, cache: Dict[str, torch.Tensor], timestep, orig_hw, ratio: int = 4) -> torch.Tensor:
    """Per-timestep splat and merge (M2M_arch.py:551-581,1029-1035) from the
    cached pair state; ``timestep`` is a scalar or an ``[n]`` vector. Returns
    NHWC ``[n, *orig_hw, 3]``. All of it is elementwise except the one splat,
    so it stays NHWC."""
    h, w = orig_hw
    im0_o, im1_o = cache["im0_o"], cache["im1_o"]
    im0_b, im1_b = cache["im0_b"], cache["im1_b"]
    fwd_b, bwd_b = cache["fwd_b"], cache["bwd_b"]
    metric0, metric1 = cache["metric0"], cache["metric1"]
    mean_, std_ = cache["mean"], cache["std"]
    n, hp, wp, _ = im0_o.shape

    t = torch.as_tensor(timestep, dtype=im0_o.dtype, device=im0_o.device)
    t_b = t.reshape(-1, 1, 1, 1).expand(n, 1, 1, 1).repeat_interleave(BRANCH, 0)
    flow0 = fwd_b * t_b
    flow1 = bwd_b * (1.0 - t_b)
    t0w = 1.0 - t_b  # td of the forward direction (t1 in the reference)
    t1w = t_b

    # the batched multi-branch splat: one splat over the 2*BRANCH*n stacked
    # fields, then the sum over each pixel's (direction, branch) group
    def aug(img, td, metric):
        e = torch.exp(metric.clamp(-20.0, 20.0))
        return torch.cat([img * td * e, td * e], -1)

    splat_in = torch.cat([aug(im0_b, t0w, metric0), aug(im1_b, t1w, metric1)], 0)
    out = softsplat_func(splat_in, torch.cat([flow0, flow1], 0))
    out = out.unflatten(0, (2, n, BRANCH)).sum((0, 2))

    ten_out = out[..., :-1]
    # each of the 2*BRANCH one_fdir calls adds 1e-7 to its normaliser before
    # the sum (M2M_arch.py:566,576-579); the hole mask compares the
    # epsilon-inclusive total against 1e-5
    norm = out[..., -1:] + 2 * BRANCH * 1e-7
    mask = (norm < 0.00001).to(ten_out.dtype)
    ten_out = ten_out / norm
    fill = t0w.reshape(n, BRANCH, 1, 1, 1).mean(1) * im0_o + t1w.reshape(n, BRANCH, 1, 1, 1).mean(1) * im1_o
    ten_out = ten_out + mask * fill

    result = ten_out * (std_ + 1e-7) + mean_
    return result[:, :h, :w, :]


def apply(net: M2M_PWC, im0: torch.Tensor, im1: torch.Tensor, timestep, ratio: int = 4) -> torch.Tensor:
    """``M2M_PWC.forward`` (M2M_arch.py:894-1037) for one timestep (a scalar
    or an ``[n]`` vector), NHWC in and out."""
    h, w = im0.shape[1], im0.shape[2]
    return pair_infer(net, pair_reuse(net, im0, im1, ratio), timestep, (h, w), ratio)


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> M2M_PWC:
    """``params`` cast to ``dtype``, loaded with ``strict=True`` into a module
    on ``device`` in ``channels_last`` memory."""
    with torch.device("meta"):
        net = M2M_PWC()
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return net.to(device=device, memory_format=torch.channels_last).eval()


def make_model_fn(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda"):
    """``model_fn(f0, f1, t) -> mid``: NHWC frames in, float32 NHWC out,
    reuse and infer in one call (the configuration ``bench.py:bench_m2m``
    times)."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        f0 = f0.to(device=device, dtype=dtype)
        f1 = f1.to(device=device, dtype=dtype)
        return apply(net, f0, f1, t.to(device=device, dtype=dtype)).float()

    return model_fn


def make_pair_fns(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda"):
    """``(reuse_fn, infer_fn)`` for ``core.loop.run_plan_pair_cached``: the
    flow pyramid, MotionRefineNet and photometric metrics run once per pair
    batch (``reuse_fn(f0, f1) -> cache``), the splat once per timestep
    (``infer_fn(f0, f1, cache, t) -> mid``, float32 NHWC)."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def reuse_fn(f0: torch.Tensor, f1: torch.Tensor) -> Dict[str, torch.Tensor]:
        return pair_reuse(net, f0.to(device=device, dtype=dtype), f1.to(device=device, dtype=dtype))

    @torch.inference_mode()
    def infer_fn(f0: torch.Tensor, f1: torch.Tensor, cache, t: torch.Tensor) -> torch.Tensor:
        h, w = f0.shape[1], f0.shape[2]
        return pair_infer(net, cache, t.to(device=device, dtype=dtype), (h, w)).float()

    return reuse_fn, infer_fn


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict with the shapes of ``M2M.pth``, drawn from
    ``numpy.random.default_rng(seed)`` in ``state_dict`` key order: conv and
    transposed-conv weights and biases uniform in ``+-1/sqrt(fan_in)`` (fan_in
    from dims 1..3 of the weight, torch's default init); every PReLU weight
    (shape ``[1]`` in the flow net, ``[C]`` in MotionRefineNet) the constant
    :data:`PRELU_INIT` = 0.25, and ``paramAlpha`` the constant
    :data:`PARAM_ALPHA_INIT` = 10.0."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        net = M2M_PWC()
    prelu = {f"{name}.weight" for name, m in net.named_modules() if isinstance(m, nn.PReLU)}
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    params = {}
    for key, shape in shapes.items():
        if key in prelu:
            params[key] = torch.full(shape, PRELU_INIT)
        elif key == "paramAlpha":
            params[key] = torch.full(shape, PARAM_ALPHA_INIT)
        else:
            wshape = shapes[key.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / np.sqrt(wshape[1] * wshape[2] * wshape[3])
            params[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return params
