"""AMT (S, L and G), PyTorch port of the JAX package's ``models/amt.py``
(reference ``vfi_models/amt/amt_arch.py``: ``AMT_S`` 1153, ``AMT_L`` 1297,
``AMT_G`` 1441).

A RAFT-style feature encoder (instance norms; bottleneck blocks for S,
residual blocks for L and G, with ``layer3_2`` for G) feeds the
bidirectional correlation (``ops.bidir_corr.BidirCorr``: two 4-level
feature pyramids, a 7x7 window per level looked up around each query's
time-scaled flow end point). A pyramid encoder feeds cascaded decoders
(init, two intermediate, multi-flow; IFRNet's with AMT's widths) whose flows
the update blocks refine from the correlation; G refines twice per level,
first at a lower resolution (``update*_low``) and then with the correlation
resized x2 / x4 (``update*_high``). The last decoder gives ``num_flows``
flow pairs, masks and residuals; each pair warps both frames, flattened into
the batch, and ``comb_block`` combines the blends (``multi_flow_combine``,
``amt_arch.py:869-903``).

Warps (``ops.warp.warp``, border mode): both frames' pyramid features at
three levels (C = 44, 32, 20 for S), ``channels_last``, on the wide kernel;
then both frames over ``[N * num_flows, H, W, 3]`` on K1
(:func:`warps_per_forward`). The frames are centred by their joint mean
(f32, cast once). Coordinates and the correlation lookup are f32 in every
dtype. ``1 / t`` and ``1 / (1 - t)`` scale the flows as in the reference:
the schedule never gives t = 0 or 1.

Inputs must be padded to multiples of 16 (the node pads the whole clip
once). Modules hold the parameters, with ``state_dict`` keys equal to
``amt-s.pth``'s manifest (213 tensors) for S; L and G have the keys that
the JAX ``apply`` reads, at the upstream widths (no manifest of theirs is in
the repository). :func:`apply` is the forward, NHWC frames in and out, NCHW
``channels_last`` inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bidir_corr import BidirCorr
from ..ops.cuda.warp_kernel import route_counts
from .common import cast_params, channels_last_params, init_state_dict, instance_norm, leaky_relu, resize_by_scale
from .ifrnet import centre_and_embed, decoder, encode, pyramid_encoder, warp_nchw

__all__ = ["AMT", "CKPT_CONFIGS", "apply", "init_params", "make_model_fn", "warps_per_forward"]

CKPT_CONFIGS = {
    "amt-s.pth": {"variant": "S", "num_flows": 3},
    "amt-l.pth": {"variant": "L", "num_flows": 5},
    "amt-g.pth": {"variant": "G", "num_flows": 5},
    "gopro_amt-s.pth": {"variant": "S", "num_flows": 3},
}

_RADIUS = 3
_LEVELS = 4
_CORR_PLANES = 2 * _LEVELS * (2 * _RADIUS + 1) ** 2

# per variant: pyramid channels, skip channels, the feature encoder (block,
# layer widths, output width, with layer3_2), the update blocks' (hidden,
# flow, corr, corr2 or None, fc) widths, comb_block's kernel
_VARIANTS = {
    "S": ((20, 32, 44, 56), 20, ("bottleneck", (32, 64, 96), 84, False), (76, 20, 64, None, 68), 3),
    "L": ((48, 64, 72, 128), 48, ("residual", (64, 72, 128), 128, False), (128, 48, 256, 160, 124), 7),
    "G": ((84, 96, 112, 128), 84, ("residual", (64, 112, 160), 128, True), (192, 64, 256, 192, 188), 7),
}


# ---- the feature encoder ----------------------------------------------------------


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c, 3, stride, 1)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1)
        self.downsample = nn.Sequential(nn.Conv2d(cin, c, 1, stride)) if stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c // 4, 1)
        self.conv2 = nn.Conv2d(c // 4, c // 4, 3, stride, 1)
        self.conv3 = nn.Conv2d(c // 4, c, 1)
        self.downsample = nn.Sequential(nn.Conv2d(cin, c, 1, stride)) if stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        y = F.relu(instance_norm(self.conv3(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class FeatEncoder(nn.Module):
    """Small/Basic/LargeEncoder with ``norm_fn='instance'``
    (amt_arch.py:515-744): a 7x7 stride-2 stem, three layers of two blocks
    (strides 1, 2, 2), G's ``layer3_2``, a 1x1 output conv."""

    def __init__(self, block: str, widths, out: int, layer3_2: bool):
        super().__init__()
        cls = BottleneckBlock if block == "bottleneck" else ResidualBlock
        self.conv1 = nn.Conv2d(3, widths[0], 7, 2, 3)
        cin = widths[0]
        names = ["layer1", "layer2", "layer3"] + (["layer3_2"] if layer3_2 else [])
        for name, c, stride in zip(names, (*widths, widths[-1]), (1, 2, 2, 1)):
            self.add_module(name, nn.Sequential(cls(cin, c, stride), cls(c, c, 1)))
            cin = c
        self.layers = names
        self.conv2 = nn.Conv2d(cin, out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(instance_norm(self.conv1(x)))
        for name in self.layers:
            x = getattr(self, name)(x)
        return self.conv2(x)


# ---- the update blocks --------------------------------------------------------------


def _conv_seq3(cin: int, c: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, c, 3, 1, 1), nn.LeakyReLU(0.1), nn.Conv2d(c, cout, 3, 1, 1))


class UpdateBlock(nn.Module):
    """Small/BasicUpdateBlock (amt_arch.py:969-1074): ``convc2`` for L and
    G. ``scale_factor`` runs the block at ``1/scale_factor`` resolution."""

    def __init__(self, cdim: int, hidden: int, flow_dim: int, corr_dim: int, corr_dim2: Optional[int], fc_dim: int,
                 scale_factor: Optional[float]):
        super().__init__()
        self.scale_factor = scale_factor
        self.convc1 = nn.Conv2d(_CORR_PLANES, corr_dim, 1)
        if corr_dim2 is not None:
            self.convc2 = nn.Conv2d(corr_dim, corr_dim2, 3, 1, 1)
        self.convf1 = nn.Conv2d(4, 2 * flow_dim, 7, 1, 3)
        self.convf2 = nn.Conv2d(2 * flow_dim, flow_dim, 3, 1, 1)
        self.conv = nn.Conv2d((corr_dim2 or corr_dim) + flow_dim, fc_dim, 3, 1, 1)
        self.gru = _conv_seq3(fc_dim + 4 + cdim, hidden, hidden)
        self.feat_head = _conv_seq3(hidden, hidden, cdim)
        self.flow_head = _conv_seq3(hidden, hidden, 4)

    def forward(self, net: torch.Tensor, flow: torch.Tensor, corr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        sf = self.scale_factor
        if sf is not None:
            net = resize_by_scale(net, 1.0 / sf)
        cor = leaky_relu(self.convc1(corr), 0.1)
        if hasattr(self, "convc2"):
            cor = leaky_relu(self.convc2(cor), 0.1)
        flo = leaky_relu(self.convf2(leaky_relu(self.convf1(flow), 0.1)), 0.1)
        inp = leaky_relu(self.conv(torch.cat([cor, flo], 1)), 0.1)
        out = self.gru(torch.cat([inp, flow, net], 1))
        delta_net, delta_flow = self.feat_head(out), self.flow_head(out)
        if sf is not None:
            delta_net = resize_by_scale(delta_net, sf)
            delta_flow = sf * resize_by_scale(delta_flow, sf)
        return delta_net, delta_flow


# ---- the model ------------------------------------------------------------------------


class AMT(nn.Module):
    """``AMT_S`` / ``AMT_L`` / ``AMT_G``: the parameter tree; :func:`apply`
    runs it."""

    def __init__(self, variant: str = "S", num_flows: int = 3):
        super().__init__()
        (c0, c1, c2, c3), skip, enc, upd, comb_k = _VARIANTS[variant]
        self.variant, self.num_flows = variant, num_flows
        self.feat_encoder = FeatEncoder(*enc)
        self.encoder = pyramid_encoder((c0, c1, c2, c3), 3 if variant == "S" else 7)
        self.decoder4 = decoder(2 * c3 + 1, 2 * c3, c2 + 4, skip)
        self.decoder3 = decoder(3 * c2 + 4, 3 * c2, c1 + 4, skip)
        self.decoder2 = decoder(3 * c1 + 4, 3 * c1, c0 + 4, skip)
        self.decoder1 = decoder(3 * c0 + 4, 3 * c0, 8 * num_flows, skip)
        self.update4 = UpdateBlock(c2, *upd, None)
        if variant == "G":
            self.update3_low = UpdateBlock(c1, *upd, 2.0)
            self.update2_low = UpdateBlock(c0, *upd, 4.0)
            self.update3_high = UpdateBlock(c1, *upd, None)
            self.update2_high = UpdateBlock(c0, *upd, None)
        else:
            self.update3 = UpdateBlock(c1, *upd, 2.0)
            self.update2 = UpdateBlock(c0, *upd, 4.0)
        pad = comb_k // 2
        self.comb_block = nn.Sequential(
            nn.Conv2d(3 * num_flows, 6 * num_flows, comb_k, 1, pad), nn.PReLU(6 * num_flows),
            nn.Conv2d(6 * num_flows, 3, comb_k, 1, pad),
        )


def _lookup(corr: BidirCorr, coord, flow0, flow1, t1_scale, t0_scale, downsample: int):
    """``_corr_scale_lookup``: the flows resized to 1/8 resolution, their
    end points' windows and the 4-channel flow."""
    if downsample != 1:
        inv = 1.0 / downsample
        flow0 = inv * resize_by_scale(flow0, inv)
        flow1 = inv * resize_by_scale(flow1, inv)
    c0, c1 = corr.lookup(
        coord + flow1.permute(0, 2, 3, 1).float() * t1_scale, coord + flow0.permute(0, 2, 3, 1).float() * t0_scale
    )
    return torch.cat([c0, c1], 1), torch.cat([flow0, flow1], 1)


def apply(net: AMT, img0: torch.Tensor, img1: torch.Tensor, timestep) -> torch.Tensor:
    """``AMT_{S,L,G}.forward`` (amt_arch.py:1206-1289, 1352-1441,
    1495-1589), eval path, ``scale_factor`` 1, on NHWC frames ``[N, H, W,
    3]`` padded to multiples of 16; ``timestep`` is a scalar or an ``[N]``
    vector."""
    n, h, w, _ = img0.shape
    nf = net.num_flows
    img0, img1, mean, embt = centre_and_embed(img0, img1, timestep, h, w)
    t = embt.float().view(n, 1, 1, 1)
    t1_scale, t0_scale = 1.0 / t, 1.0 / (1.0 - t)
    gy, gx = torch.meshgrid(
        torch.arange(h // 8, dtype=torch.float32, device=img0.device),
        torch.arange(w // 8, dtype=torch.float32, device=img0.device), indexing="ij",
    )
    coord = torch.stack([gx, gy], -1).expand(n, h // 8, w // 8, 2)

    both = net.feat_encoder(torch.cat([img0, img1], 0))
    corr = BidirCorr(both[:n], both[n:], _LEVELS, _RADIUS)
    f0 = encode(net.encoder, img0)
    f1 = encode(net.encoder, img1)

    def residue(upd: UpdateBlock, ft_, flow0, flow1, downsample):
        c, flow = _lookup(corr, coord, flow0, flow1, t1_scale, t0_scale, downsample)
        d_ft, d_flow = upd(ft_, flow, c)
        return ft_ + d_ft, flow0 + d_flow[:, 0:2], flow1 + d_flow[:, 2:4], c

    def refine_high(upd: UpdateBlock, ft_, flow0, flow1, c):
        d_ft, d_flow = upd(ft_, torch.cat([flow0, flow1], 1), c)
        return ft_ + d_ft, flow0 + d_flow[:, 0:2], flow1 + d_flow[:, 2:4]

    def intermediate(dec, ft_, lvl, flow0, flow1):
        out = dec.convblock(torch.cat([ft_, warp_nchw(f0[lvl], flow0), warp_nchw(f1[lvl], flow1), flow0, flow1], 1))
        return out[:, :2] + 2.0 * resize_by_scale(flow0, 2.0), out[:, 2:4] + 2.0 * resize_by_scale(flow1, 2.0), out[:, 4:]

    h4, w4 = f0[3].shape[2:]
    embt_map = embt.expand(n, 1, h4, w4).contiguous(memory_format=torch.channels_last)
    out4 = net.decoder4.convblock(torch.cat([f0[3], f1[3], embt_map], 1))
    flow0, flow1, ft_ = out4[:, :2], out4[:, 2:4], out4[:, 4:]
    ft_, flow0, flow1, _ = residue(net.update4, ft_, flow0, flow1, 1)
    for dec, lvl, key, down in ((net.decoder3, 2, "3", 2), (net.decoder2, 1, "2", 4)):
        flow0, flow1, ft_ = intermediate(dec, ft_, lvl, flow0, flow1)
        if net.variant == "G":
            ft_, flow0, flow1, c = residue(getattr(net, f"update{key}_low"), ft_, flow0, flow1, down)
            ft_, flow0, flow1 = refine_high(getattr(net, f"update{key}_high"), ft_, flow0, flow1, resize_by_scale(c, float(down)))
        else:
            ft_, flow0, flow1, _ = residue(getattr(net, f"update{key}"), ft_, flow0, flow1, down)

    out = net.decoder1.convblock(torch.cat([ft_, warp_nchw(f0[0], flow0), warp_nchw(f1[0], flow1), flow0, flow1], 1))
    flow0 = out[:, : 2 * nf] + (2.0 * resize_by_scale(flow0, 2.0)).repeat(1, nf, 1, 1)
    flow1 = out[:, 2 * nf : 4 * nf] + (2.0 * resize_by_scale(flow1, 2.0)).repeat(1, nf, 1, 1)
    mask = torch.sigmoid(out[:, 4 * nf : 5 * nf])
    img_res = out[:, 5 * nf :]

    # multi_flow_combine: the flows flattened into the batch, flow-major
    def flat(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(n * nf, -1, h, w)

    def tiled(x: torch.Tensor) -> torch.Tensor:
        return x[:, None].expand(n, nf, *x.shape[1:]).reshape(n * nf, *x.shape[1:])

    m = flat(mask)
    w0 = warp_nchw(tiled(img0), flat(flow0))
    w1 = warp_nchw(tiled(img1), flat(flow1))
    img_warps = m * w0 + (1 - m) * w1 + tiled(mean) + flat(img_res)
    stacked = img_warps.reshape(n, nf * 3, h, w).contiguous(memory_format=torch.channels_last)
    pred = img_warps.view(n, nf, 3, h, w).mean(1) + net.comb_block(stacked)
    return pred.clamp(0.0, 1.0).permute(0, 2, 3, 1)


def warps_per_forward(variant: str = "S", dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Warp launches of one :func:`apply` on the card by kernel, ``{"narrow":
    K1, "wide": the wide kernel}``, as ``warp_kernel.route`` sends them: both
    frames' pyramid features at three levels (C = 44, 32, 20 for S), then
    both frames over all flows (C = 3)."""
    c0, c1, c2, _ = _VARIANTS[variant][0]
    return route_counts([c2, c2, c1, c1, c0, c0, 3, 3], dtype)


def _load(params: Dict[str, torch.Tensor], variant: str, num_flows: int, dtype: torch.dtype, device) -> AMT:
    with torch.device("meta"):
        net = AMT(variant, num_flows)
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(params: Dict[str, torch.Tensor], ckpt_name: str, dtype: torch.dtype = torch.float32, device="cuda"):
    """The batched model callable for the plan executor:
    ``model_fn(f0, f1, t) -> mid``, NHWC frames (padded to multiples of 16)
    in, float32 NHWC out."""
    cfg = CKPT_CONFIGS[ckpt_name]
    net = _load(params, cfg["variant"], cfg["num_flows"], dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return apply(net, f0.to(device=device, dtype=dtype), f1.to(device=device, dtype=dtype), t.to(device=device, dtype=dtype)).float()

    return model_fn


def init_params(variant: str = "S", seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict of ``variant`` (``common.init_state_dict``) with its
    checkpoints' ``num_flows`` (3 for S, 5 for L and G)."""
    with torch.device("meta"):
        net = AMT(variant, 3 if variant == "S" else 5)
    return init_state_dict(net, seed)
