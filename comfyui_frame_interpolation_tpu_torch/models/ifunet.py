"""IFUnet, PyTorch port of the JAX package's ``models/ifunet.py``
(reference ``vfi_models/ifunet/IFUNet_arch.py``), three stages
(``IFUNetModel.forward``, lines 746-765):

1. the flow net: a ``FeatureNet`` U-Net with CBAM attention feeds three
   ``IFBlock``s, whose flows are convex-upsampled x16, x8 and x4 by learned
   masks (:func:`convex_upsample`); both frames are warped after each
   (K1, C = 3). The ensemble averages a second pass with the frames and
   ``1 - t`` swapped, without swapping the flow's channels (lines 692-737,
   literal);
2. ``RRDBNet`` fusion: ESRGAN residual-dense blocks at quarter resolution
   make the blend mask;
3. ``ResynNet`` refinement, per frame: a 3-block flow pyramid towards the
   blend (K1, C = 3, after each block), a context warp at quarter
   resolution (the wide kernel, C = 32) and a decoded residual; the frames'
   results and the blend itself are mixed by a softmax over their clipped
   masks.

Inputs are padded with zeros to multiples of 64 at the bottom and right.
Batch norms run on their stored statistics. Modules hold the parameters,
with ``state_dict`` keys equal to ``IFUNet.pth``'s manifest (608 tensors,
``refinenet.degrad`` included, which the forward never reads, as in the
reference and the JAX package); :func:`apply` is the forward, NHWC frames in
and out, NCHW ``channels_last`` inside.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.warp_kernel import route_counts
from .common import cast_params, channels_last_params, init_state_dict, leaky_relu, resize_by_scale
from .ifrnet import warp_nchw

__all__ = ["CKPT_NAMES", "IFUNetModel", "apply", "convex_upsample", "init_params", "make_model_fn", "warps_per_forward"]

CKPT_NAMES = ["IFUNet.pth"]
_LEVELS = (16, 8, 4)  # each flow block's upsampling factor
_REFINE_SCALES = (4, 2, 1)


def _conv_p(cin: int, cout: int, k: int = 3, stride: int = 1, padding: int = 1) -> nn.Sequential:
    """reference ``conv``: Conv2d + PReLU(cout)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, padding), nn.PReLU(cout))


def _conv_bn(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    """reference ``conv_bn``: Conv2d(3x3, no bias) + BatchNorm2d + PReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1, bias=False), nn.BatchNorm2d(cout), nn.PReLU(cout))


def _holder(**children: nn.Module) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


# ---- CBAM -------------------------------------------------------------------------


class CBAM(nn.Module):
    """``CBAM`` (reduction 16): the channel gate's MLP on the global mean and
    max, then the spatial gate's 7x7 conv and batch norm on the channel max
    and mean."""

    def __init__(self, c: int):
        super().__init__()
        self.ChannelGate = _holder(
            mlp=nn.Sequential(nn.Flatten(), nn.Linear(c, c // 16), nn.ReLU(), nn.Linear(c // 16, c))
        )
        self.SpatialGate = _holder(spatial=_holder(conv=nn.Conv2d(2, 1, 7, 1, 3, bias=False), bn=nn.BatchNorm2d(1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mlp = self.ChannelGate.mlp
        gate = mlp(x.mean((2, 3), keepdim=True)) + mlp(x.amax((2, 3), keepdim=True))
        x = x * torch.sigmoid(gate)[:, :, None, None]
        sp = self.SpatialGate.spatial
        pooled = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return x * torch.sigmoid(sp.bn(sp.conv(pooled)))


# ---- the flow net -------------------------------------------------------------------


class UNetConv(nn.Module):
    def __init__(self, cin: int, cout: int, att: bool):
        super().__init__()
        self.conv1 = _conv_p(cin, cout, stride=2)
        self.conv2 = _conv_p(cout, cout)
        self.cbam = CBAM(cout) if att else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2(self.conv1(x))
        return x if self.cbam is None else self.cbam(x)


class UpConv(nn.Module):
    def __init__(self, cin: int, cout: int, att: bool):
        super().__init__()
        self.deconv = nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1), nn.PReLU(cout))
        self.conv1 = _conv_p(2 * cout, cout)
        self.conv2 = _conv_p(cout, cout)
        self.cbam = CBAM(cout) if att else None

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(torch.cat([self.deconv(x1), x2], 1)))
        return y if self.cbam is None else self.cbam(y)


class FeatureNet(nn.Module):
    """The U-Net with early exits: level 0 stops at 1/16 resolution (C =
    256), level 1 at 1/8 (128), level 2 at 1/4 (64)."""

    def __init__(self):
        super().__init__()
        self.conv0 = _conv_p(7, 17, 1, 1, 0)
        self.conv1 = UNetConv(17, 32, False)
        self.conv2 = UNetConv(32, 64, True)
        self.conv3 = UNetConv(64, 128, True)
        self.conv4 = UNetConv(128, 256, True)
        self.conv5 = UNetConv(256, 512, True)
        self.deconv5 = UpConv(512, 256, True)
        self.deconv4 = UpConv(256, 128, False)
        self.deconv3 = UpConv(128, 64, False)

    def forward(self, x: torch.Tensor, level: int) -> torch.Tensor:
        if x.shape[1] != 17:  # the first block's 7 channels; the later ones bring 17
            x = self.conv0(x)
        x2 = self.conv1(x)
        x4 = self.conv2(x2)
        x8 = self.conv3(x4)
        x16 = self.conv4(x8)
        y = self.deconv5(self.conv5(x16), x16)
        if level != 0:
            y = self.deconv4(y, x8)
            if level == 2:
                y = self.deconv3(y, x4)
        return y


class IFBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.convblock = nn.Sequential(*[_conv_p(c, c) for _ in range(6)])
        self.flowconv = nn.Conv2d(c, 4, 3, 1, 1)
        for lv in _LEVELS:
            self.add_module(f"maskconvx{lv}", nn.Conv2d(c, 9 * lv * lv, 1))

    def forward(self, x: torch.Tensor, level: int, scale: float) -> torch.Tensor:
        x = self.convblock(x) + x
        up = convex_upsample(self.flowconv(x), getattr(self, f"maskconvx{level}")(x), level)
        return up if scale == 1.0 else resize_by_scale(up, scale) * scale


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, level: int) -> torch.Tensor:
    """RAFT-style convex upsampling (IFUNet_arch.py:627-638, JAX
    ``ifunet.py:_if_block``): ``level * flow`` ``[N, 4, H, W]`` at the 9
    zero-padded 3x3 neighbours (tap ``k = (dy+1)*3 + (dx+1)``), weighted per
    output pixel by a softmax over the 9 taps of ``mask`` ``[N, 9*l*l, H,
    W]`` (channel ``k*l*l + p``, ``p = i*l + j`` the pixel's offset in its
    l x l cell), as one batched product per pixel in the mask's layout; the
    result ``[N, 4, H*l, W*l]``, ``channels_last``."""
    n, _, h, w = flow.shape
    l2 = level * level
    taps = F.unfold(level * flow, 3, padding=1)  # [N, 4*9, H*W], channel c*9 + k
    taps = taps.view(n, 4, 9, h * w).permute(0, 3, 1, 2).reshape(n * h * w, 4, 9)
    m = mask.permute(0, 2, 3, 1).reshape(n * h * w, 9, l2).softmax(1)
    up = torch.bmm(taps, m)  # [N*H*W, 4, l*l]
    up = up.view(n, h, w, 4, level, level).permute(0, 1, 4, 2, 5, 3).reshape(n, h * level, w * level, 4)
    return up.permute(0, 3, 1, 2)


class IFUNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fmap = FeatureNet()
        self.block0 = IFBlock(256)
        self.block1 = IFBlock(128)
        self.block2 = IFBlock(64)


def _flow_pass(net: IFUNet, x: torch.Tensor, flow: Optional[torch.Tensor], i: int, scale: float) -> torch.Tensor:
    """One flow block on ``x`` (and the current flow, for blocks 1 and 2),
    resized by ``scale``: its flow update at full resolution."""
    if scale != 1:
        x = resize_by_scale(x, scale)
    if flow is not None:
        x = torch.cat([x, flow if scale == 1 else resize_by_scale(flow, scale) * scale], 1)
    return getattr(net, f"block{i}")(net.fmap(x, i), _LEVELS[i], 1.0 / scale)


def flow_net(net: IFUNet, img0, img1, tmap, scale: float, ensemble: bool):
    """``IFUNet.forward`` (JAX ``_ifunet_flow``): the flow and both warped
    frames."""
    warped0, warped1 = img0, img1
    flow = None
    for i in range(3):
        if flow is None:
            flow = _flow_pass(net, torch.cat([img0, img1, tmap], 1), None, i, scale)
            if ensemble:
                flow2 = _flow_pass(net, torch.cat([img1, img0, 1 - tmap], 1), None, i, scale)
                flow = (flow + flow2) / 2
        else:
            flow = flow + _flow_pass(net, torch.cat([img0, img1, tmap, warped0, warped1], 1), flow, i, scale)
            if ensemble:
                flow2 = flow + _flow_pass(net, torch.cat([img1, img0, 1 - tmap, warped0, warped1], 1), flow, i, scale)
                flow = (flow + flow2) / 2
        warped0 = warp_nchw(img0, flow[:, :2])
        warped1 = warp_nchw(img1, flow[:, 2:4])
    return flow, warped0, warped1


# ---- RRDB fusion ------------------------------------------------------------------


class RDB(nn.Module):
    def __init__(self, c: int = 64, g: int = 32):
        super().__init__()
        for k in range(1, 5):
            self.add_module(f"conv{k}", nn.Conv2d(c + (k - 1) * g, g, 3, 1, 1))
        self.conv5 = nn.Conv2d(c + 4 * g, c, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for k in range(1, 5):
            feats.append(leaky_relu(getattr(self, f"conv{k}")(torch.cat(feats, 1)), 0.2))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    def __init__(self):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = RDB(), RDB(), RDB()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv_first = nn.Conv2d(16, 64, 3, 1, 1)
        self.body = nn.Sequential(*[RRDB() for _ in range(6)])
        self.conv_body = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_hr = nn.Conv2d(64, 64, 3, 1, 1)
        self.conv_last = nn.Conv2d(64, 1, 3, 1, 1)

    def forward(self, img0, img1, w0, w1, flow) -> torch.Tensor:
        """The blend mask, at full resolution, from the frames, their warps
        and the flow at quarter resolution."""
        x = resize_by_scale(torch.cat([img0, img1, w0, w1], 1), 0.25)
        feat = self.conv_first(torch.cat([x, resize_by_scale(flow, 0.25) * 0.25], 1))
        feat = feat + self.conv_body(self.body(feat))
        feat = leaky_relu(self.conv_up1(resize_by_scale(feat, 2.0, mode="nearest")), 0.2)
        feat = leaky_relu(self.conv_up2(resize_by_scale(feat, 2.0, mode="nearest")), 0.2)
        return torch.sigmoid(self.conv_last(leaky_relu(self.conv_hr(feat), 0.2)))


# ---- ResynNet ---------------------------------------------------------------------


class FlowBlock(nn.Module):
    """ResynNet's flow block: three stride-2 conv-BN-PReLU, six more at 1/8,
    a transposed conv to 1/4 of the block's input."""

    def __init__(self, cin: int, c: int = 256):
        super().__init__()
        self.conv0 = nn.Sequential(_conv_bn(cin, c // 4, 2), _conv_bn(c // 4, c // 2, 2), _conv_bn(c // 2, c, 2))
        self.convblock = nn.Sequential(*[_conv_bn(c, c) for _ in range(6)])
        self.lastconv = nn.ConvTranspose2d(c, 4, 4, 2, 1)

    def forward(self, x: torch.Tensor, flow: Optional[torch.Tensor], scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
        x = resize_by_scale(x, 1.0 / scale)
        if flow is not None:
            x = torch.cat([x, resize_by_scale(flow, 1.0 / scale) * (1.0 / scale)], 1)
        f = self.conv0(x)
        f = self.convblock(f) + f
        tmp = resize_by_scale(self.lastconv(f), scale * 4)
        return tmp[:, :2] * (scale * 4), tmp[:, 2:3]


class ResynNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.block0 = FlowBlock(6)
        self.block1 = FlowBlock(12)
        self.block2 = FlowBlock(12)
        self.context0 = nn.Sequential(_conv_p(3, 16, stride=2), _conv_p(16, 32, stride=2))
        self.context1 = nn.Sequential(_conv_p(3, 16, stride=2), _conv_p(16, 32, stride=2))
        self.decode = nn.Sequential(nn.ConvTranspose2d(64, 32, 4, 2, 1), nn.ConvTranspose2d(32, 3, 4, 2, 1))
        # in the checkpoint, never read by the forward
        self.degrad = _holder(
            conv0=_conv_p(3, 32), conv1=_conv_p(32, 32), conv2=_conv_p(32, 32), conv3=_conv_p(32, 32),
            deconv=nn.Sequential(nn.Identity(), nn.ConvTranspose2d(128, 32, 4, 2, 1), nn.PReLU(32), nn.Conv2d(32, 3, 3, 1, 1)),
        )

    def calflow(self, img: torch.Tensor, lowres: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One frame's mask and refined warp towards ``lowres`` (the blend)."""
        flow = mask = warped = None
        for i, scale in enumerate(_REFINE_SCALES):
            block = getattr(self, f"block{i}")
            if flow is None:
                flow, mask = block(torch.cat([img, lowres], 1), None, scale)
            else:
                fd, md = block(torch.cat([img, lowres, warped, mask], 1), flow, scale)
                flow, mask = flow + fd, mask + md
            warped = warp_nchw(img, flow)
        c0 = warp_nchw(self.context0(img), resize_by_scale(flow, 0.25) * 0.25)
        dec = self.decode(torch.cat([c0, self.context1(warped)], 1))
        return mask, (warped + torch.tanh(dec)).clamp(0.0, 1.0)

    def forward(self, imgs: List[torch.Tensor], deg: torch.Tensor) -> torch.Tensor:
        masks, warped = [], []
        for img in imgs:
            m, w = self.calflow(img, deg)
            masks.append(m)
            warped.append(w)
        masks.append(masks[-1] * 0)
        warped.append(deg)
        weights = torch.cat(masks, 1).clamp(-4.0, 4.0).softmax(1)
        return sum(w * weights[:, i : i + 1] for i, w in enumerate(warped))


class IFUNetModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.flownet = IFUNet()
        self.fusionnet = RRDBNet()
        self.refinenet = ResynNet()


def apply(net: IFUNetModel, img0: torch.Tensor, img1: torch.Tensor, timestep, scale: float = 1.0, ensemble: bool = False):
    """``IFUNetModel.forward`` (IFUNet_arch.py:753-765) on NHWC frames
    ``[N, H, W, 3]``; ``timestep`` is a scalar or an ``[N]`` vector."""
    n, h, w, _ = img0.shape
    ph, pw = ((h - 1) // 64 + 1) * 64, ((w - 1) // 64 + 1) * 64
    x0, x1 = (
        F.pad(f.permute(0, 3, 1, 2), (0, pw - w, 0, ph - h)).contiguous(memory_format=torch.channels_last)
        for f in (img0, img1)
    )
    t = torch.as_tensor(timestep, dtype=x0.dtype, device=x0.device).reshape(-1, 1, 1, 1)
    tmap = t.expand(n, 1, ph, pw).contiguous(memory_format=torch.channels_last)
    flow, w0, w1 = flow_net(net.flownet, x0, x1, tmap, scale, ensemble)
    mask = net.fusionnet(x0, x1, w0, w1, flow)
    merged = net.refinenet([x0, x1], w0 * mask + w1 * (1 - mask))
    return merged[:, :, :h, :w].permute(0, 2, 3, 1)


def warps_per_forward(dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Warp launches of one :func:`apply` on the card by kernel, ``{"narrow":
    K1, "wide": the wide kernel}``, as ``warp_kernel.route`` sends them: both
    frames after each of the 3 flow blocks (C = 3), and per frame in the
    refinement 3 frame warps and the context warp (C = 32). The ensemble
    adds none."""
    per_frame_refine = [3, 3, 3, 32]
    return route_counts([3] * 6 + per_frame_refine * 2, dtype)


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> IFUNetModel:
    with torch.device("meta"):
        net = IFUNetModel()
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(
    params: Dict[str, torch.Tensor], scale: float = 1.0, ensemble: bool = False, dtype: torch.dtype = torch.float32,
    device="cuda",
):
    """The batched model callable for the plan executor:
    ``model_fn(f0, f1, t) -> mid``, NHWC frames in, float32 NHWC out."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return apply(
            net, f0.to(device=device, dtype=dtype), f1.to(device=device, dtype=dtype), t.to(device=device, dtype=dtype),
            scale=scale, ensemble=ensemble,
        ).float()

    return model_fn


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict with ``IFUNet.pth``'s keys and shapes
    (``common.init_state_dict``; batch norms at the identity)."""
    with torch.device("meta"):
        net = IFUNetModel()
    return init_state_dict(net, seed)
