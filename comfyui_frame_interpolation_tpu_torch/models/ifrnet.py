"""IFRNet (S and L), PyTorch port of the JAX package's ``models/ifrnet.py``
(reference ``vfi_models/ifrnet/IFRNet_S_arch.py`` / ``IFRNet_L_arch.py``).

An encoder pyramid (4 levels of stride-2 conv + PReLU pairs) feeds four
cascaded decoders that refine bidirectional flows and an intermediate
feature, each upsampling by a transposed conv; the last one's sigmoid mask
blends two backward warps of the frames, plus a residual. Both frames are
centred by their joint mean, taken in f32 and cast once, and padded to
multiples of 64 at the bottom and right (``IFRNet_S_arch.py:232-254``).

As in the JAX package, the timestep drives ``embt`` and ``scale_factor``
the resize: the reference node passes them swapped (see the JAX module's
docstring), which neither package copies.

Warps (``ops.warp.warp``, border mode): each decoder level's features of
both frames, C = 54, 36, 24 for S (144, 96, 64 for L), ``channels_last``,
so the wide kernel; then the two frames, C = 3, on K1
(:func:`warps_per_forward`).

Modules hold the parameters, with ``state_dict`` keys equal to the
reference checkpoints' (``IFRNet_S_Vimeo90K.pth``'s manifest, 104
tensors); :func:`apply` is the forward, NHWC frames in and out, NCHW
``channels_last`` inside.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.warp_kernel import route_counts
from ..ops.warp import warp
from .common import cast_params, channels_last_params, init_state_dict, resize_by_scale

__all__ = ["CKPT_NAMES", "IFRNet", "apply", "init_params", "make_model_fn", "variant_for_ckpt", "warps_per_forward"]

# (pyramid channels, side channels, stem kernel)
_CFG = {
    "S": ((24, 36, 54, 72), 24, 3),
    "L": ((64, 96, 144, 192), 64, 7),
}

CKPT_NAMES = [
    "IFRNet_S_Vimeo90K.pth",
    "IFRNet_L_Vimeo90K.pth",
    "IFRNet_S_GoPro.pth",
    "IFRNet_L_GoPro.pth",
]


def variant_for_ckpt(ckpt_name: str) -> str:
    return "S" if "S" in ckpt_name else "L"


def convrelu(cin: int, cout: int, k: int = 3, stride: int = 1, padding: int = 1) -> nn.Sequential:
    """reference ``convrelu``: Conv2d + PReLU(cout)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, padding), nn.PReLU(cout))


class ResBlock(nn.Module):
    """``ResBlock`` (IFRNet_S_arch.py:69-122; AMT's is the same): conv2 and
    conv4 transform the last ``side`` channels, in place without a gradient.
    Autograd cannot differentiate through a write into a tensor that a
    convolution's backward still reads, so with one the side channels are
    joined to the others by ``cat``."""

    def __init__(self, c: int, side: int):
        super().__init__()
        self.side = side
        self.conv1 = convrelu(c, c)
        self.conv2 = convrelu(side, side)
        self.conv3 = convrelu(c, c)
        self.conv4 = convrelu(side, side)
        self.conv5 = nn.Conv2d(c, c, 3, 1, 1)
        self.prelu = nn.PReLU(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.side
        out = self.conv1(x)
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in self.parameters())):
            out = torch.cat([out[:, :-s], self.conv2(out[:, -s:])], 1)
            out = self.conv3(out)
            out = torch.cat([out[:, :-s], self.conv4(out[:, -s:])], 1)
        else:
            out[:, -s:] = self.conv2(out[:, -s:])
            out = self.conv3(out)
            out[:, -s:] = self.conv4(out[:, -s:])
        return self.prelu(x + self.conv5(out))


def decoder(cin: int, c: int, cout: int, side: int) -> nn.Module:
    """A decoder: ``convblock`` = convrelu(cin, c), ResBlock(c, side),
    ConvTranspose2d(c, cout, 4, 2, 1)."""
    m = nn.Module()
    m.convblock = nn.Sequential(convrelu(cin, c), ResBlock(c, side), nn.ConvTranspose2d(c, cout, 4, 2, 1))
    return m


def pyramid_encoder(chans: Sequence[int], stem_k: int) -> nn.Module:
    """The 4-level ``Encoder``: ``pyramid{i}`` = a stride-2 convrelu (the
    first one ``stem_k`` wide), then a stride-1 one."""
    m = nn.Module()
    cin = 3
    for i, c in enumerate(chans, 1):
        k = stem_k if i == 1 else 3
        m.add_module(f"pyramid{i}", nn.Sequential(convrelu(cin, c, k, 2, k // 2), convrelu(c, c)))
        cin = c
    return m


def encode(enc: nn.Module, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    for i in range(1, 5):
        x = getattr(enc, f"pyramid{i}")(x)
        feats.append(x)
    return feats


class IFRNet(nn.Module):
    """``IRFNet_S`` / ``IRFNet_L``: the parameter tree; :func:`apply` runs it."""

    def __init__(self, variant: str = "S"):
        super().__init__()
        chans, side, stem_k = _CFG[variant]
        self.variant = variant
        self.encoder = pyramid_encoder(chans, stem_k)
        self.decoder4 = decoder(2 * chans[3] + 1, 2 * chans[3], chans[2] + 4, side)
        self.decoder3 = decoder(3 * chans[2] + 4, 3 * chans[2], chans[1] + 4, side)
        self.decoder2 = decoder(3 * chans[1] + 4, 3 * chans[1], chans[0] + 4, side)
        self.decoder1 = decoder(3 * chans[0] + 4, 3 * chans[0], 8, side)


def warp_nchw(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Border-mode ``ops.warp.warp`` of NCHW ``x`` by an NCHW (x, y) flow:
    the permutes are views, and the kernels take the strides as they are."""
    return warp(x.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def centre_and_embed(img0: torch.Tensor, img1: torch.Tensor, timestep, h: int, w: int):
    """NHWC frames to NCHW ``channels_last``, padded with zeros to ``h`` x
    ``w`` (bottom and right), minus their joint mean (taken in f32 and cast
    once to the frames' dtype, which ``mean`` is returned in); and
    ``timestep`` as ``[N, 1, 1, 1]``."""
    x0, x1 = (
        F.pad(f.permute(0, 3, 1, 2), (0, w - f.shape[2], 0, h - f.shape[1])).contiguous(memory_format=torch.channels_last)
        for f in (img0, img1)
    )
    mean = torch.cat([x0, x1], 2).float().mean((1, 2, 3), keepdim=True).to(x0.dtype)
    t = torch.as_tensor(timestep, dtype=x0.dtype, device=x0.device).reshape(-1, 1, 1, 1).expand(x0.shape[0], 1, 1, 1)
    return x0 - mean, x1 - mean, mean, t


def apply(net: IFRNet, img0: torch.Tensor, img1: torch.Tensor, timestep, scale_factor: float = 1.0) -> torch.Tensor:
    """``IRFNet_S.forward`` (IFRNet_S_arch.py:217-293) on NHWC frames
    ``[N, H, W, 3]``; ``timestep`` is a scalar or an ``[N]`` vector."""
    n, h, w, _ = img0.shape
    ph, pw = ((h - 1) // 64 + 1) * 64, ((w - 1) // 64 + 1) * 64
    img0, img1, mean, embt = centre_and_embed(img0, img1, timestep, ph, pw)
    f0 = encode(net.encoder, resize_by_scale(img0, scale_factor))
    f1 = encode(net.encoder, resize_by_scale(img1, scale_factor))

    h4, w4 = f0[3].shape[2:]
    embt_map = embt.expand(n, 1, h4, w4).contiguous(memory_format=torch.channels_last)
    out = net.decoder4.convblock(torch.cat([f0[3], f1[3], embt_map], 1))
    up_flow0, up_flow1, ft_ = out[:, 0:2], out[:, 2:4], out[:, 4:]
    for lvl, dec in ((2, net.decoder3), (1, net.decoder2), (0, net.decoder1)):
        f_in = torch.cat([ft_, warp_nchw(f0[lvl], up_flow0), warp_nchw(f1[lvl], up_flow1), up_flow0, up_flow1], 1)
        out = dec.convblock(f_in)
        up_flow0 = out[:, 0:2] + 2.0 * resize_by_scale(up_flow0, 2.0)
        up_flow1 = out[:, 2:4] + 2.0 * resize_by_scale(up_flow1, 2.0)
        ft_ = out[:, 4:]

    inv = 1.0 / scale_factor
    up_flow0 = resize_by_scale(up_flow0, inv) * inv
    up_flow1 = resize_by_scale(up_flow1, inv) * inv
    up_mask = resize_by_scale(torch.sigmoid(out[:, 4:5]), inv)
    up_res = resize_by_scale(out[:, 5:], inv)
    merged = up_mask * warp_nchw(img0, up_flow0) + (1 - up_mask) * warp_nchw(img1, up_flow1) + mean
    return (merged + up_res).clamp(0.0, 1.0)[:, :, :h, :w].permute(0, 2, 3, 1)


def warps_per_forward(variant: str = "S", dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Warp launches of one :func:`apply` on the card by kernel, ``{"narrow":
    K1, "wide": the wide kernel}``, as ``warp_kernel.route`` sends them:
    both frames' features at three levels (C = 54, 36, 24 for S), then both
    frames (C = 3)."""
    chans = _CFG[variant][0]
    return route_counts([chans[2], chans[2], chans[1], chans[1], chans[0], chans[0], 3, 3], dtype)


def make_model_fn(
    params: Dict[str, torch.Tensor], variant: str, scale_factor: float = 1.0, dtype: torch.dtype = torch.float32, device="cuda"
):
    """The batched model callable for the plan executor:
    ``model_fn(f0, f1, t) -> mid``, NHWC frames in, float32 NHWC out."""
    with torch.device("meta"):
        net = IFRNet(variant)
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    net = channels_last_params(net.to(device=device)).eval()

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return apply(
            net, f0.to(device=device, dtype=dtype), f1.to(device=device, dtype=dtype), t.to(device=device, dtype=dtype),
            scale_factor=scale_factor,
        ).float()

    return model_fn


def init_params(variant: str = "S", seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict of ``variant`` (``common.init_state_dict``): S's
    keys and shapes are ``IFRNet_S_Vimeo90K.pth``'s, L's the same keys at
    L's widths."""
    with torch.device("meta"):
        net = IFRNet(variant)
    return init_state_dict(net, seed)
