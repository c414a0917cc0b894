"""ST-MFNet, the 4-frame 2x interpolation model, PyTorch port of the JAX
package's ``models/stmfnet.py`` (reference ``vfi_models/stmfnet/stmfnet_arch.py``).

Per window (I0, I1, I2, I3), frames reflect-padded to multiples of 128:

1. ``stage_feats``: the MS-ResNeXt feature extractor over (I1, I2): grouped
   (32) convolutions and grouped transposed convolutions in a small- and a
   large-kernel branch, squeeze-excitation, BatchNorm;
2. ``stage_stream`` for each of three scales: six kernel-estimation subnets
   (AdaCoF weights, softmax over 25, and offsets) and two AdaCoF
   applications (``ops.adacof``, plain PyTorch) on I1 and I2 at 1/2 (after a
   gaussian blur), 1 and 2 (the fixed 8-tap upsampler) times the frame size;
3. ``stage_flowsplat``: an internal PWCNet (81-channel correlation,
   ``ops.correlation``, plain; masked zeros-mode backward warps,
   ``ops.warp``, K1 and the wide kernel on the card) gives both flows; a
   photometric metric weighs the ``"softmax"`` forward splat of both frames
   to the midpoint (``function_softsplat``, K2 on the card);
4. ``stage_synth``: the MIMO GridNet fuses the three scales;
5. ``stage_dyntex``: a UNet3d (R3D-18 with BatchNorm3d) over ``[I0, I1,
   tilde, I2, I3]`` adds a dynamic-texture residual.

Images and features are NCHW tensors in ``channels_last`` memory (the 3-D
net's clips NCDHW in ``channels_last_3d``); frames are NHWC at the API.

Deliberate differences from the JAX package, none of which changes an fp32
result beyond rounding: both flow directions run as one batch (the PWCNet's
extractor and decoders, the image backwarps, the metric and the splat), so
a forward makes one splat and one warp per backwarp level where JAX makes
two; the masked backwarp warps the ones channel apart from the image or
features, in f32 (:func:`_backwarp_masked`), so that its ``> 0.999`` test is
taken in f32 in every model dtype and the features keep whole 16-byte
vectors for the wide kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.adacof import adacof_func
from ..ops.correlation import correlation_func
from ..ops.cuda.warp_kernel import route_counts
from ..ops.softsplat import function_softsplat
from ..ops.warp import warp
from .common import (
    PRELU_INIT, batch_norm, cast_params, channels_last_params, conv2d, conv3d, conv_transpose3d, device_const,
    init_state_dict, leaky_relu, prelu, reflect_pad, resize_bilinear, resize_by_scale,
)

__all__ = [
    "CKPT_NAMES",
    "STMFNet",
    "apply",
    "init_params",
    "make_model_fn",
    "pwc_flows",
    "splats_per_forward",
    "stage_dyntex",
    "stage_feats",
    "stage_flowsplat",
    "stage_stream",
    "stage_synth",
    "warps_per_forward",
]

CKPT_NAMES = ["stmfnet.pth"]
DILATION = 1  # AdaCoF's, with 5x5 taps
_RGB_MEAN = (0.4631, 0.4352, 0.3990)
# flow scale of each PWC level's backwarp (reference stmfnet_arch.py:426)
_PWC_BACKWARP = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
# the channels each backwarp of one forward warps: the PWC features the
# decoders of levels 5 to 2 warp, then the frames the metric compares; each
# warps its ones channel too, in f32
WARP_CHANNELS_PER_FORWARD = (128, 96, 64, 32, 3)
_STREAMS = ("", "_ds", "_us")


def _bn(x: torch.Tensor, m: nn.Module) -> torch.Tensor:
    return batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias)


# ---- the masked backwarp (JAX stmfnet.py:62-74) ---------------------------------


def _backwarp_masked(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """stmfnet_arch.py:38-96 on NCHW ``x`` and an NCHW (x, y) flow: a
    zeros-mode backward warp by the flow scaled by ``W/(W-1)`` and
    ``H/(H-1)`` of ``x`` (the reference's half-pixel grid with
    align_corners=False), masked where the warped ones channel is not above
    0.999. The ones channel is warped apart from ``x``, in f32 (each
    channel's sum is independent, so this is the same function; the test
    then sees f32 sums in a bf16 model, and ``x`` keeps its width)."""
    n, _, h, w = x.shape
    fl = flow.permute(0, 2, 3, 1) * device_const((w / (w - 1.0), h / (h - 1.0)), (2,), flow.device, flow.dtype)
    out = warp(x.permute(0, 2, 3, 1), fl, "zeros")
    ones = torch.ones((n, h, w, 1), dtype=torch.float32, device=x.device)
    mask = warp(ones, fl, "zeros") > 0.999
    return (out * mask.to(x.dtype)).permute(0, 3, 1, 2)


# ---- PWCNet (JAX stmfnet.py:80-138) -------------------------------------------------


def _conv_lr(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride, dilation, dilation), nn.LeakyReLU(0.1)]


class _Extractor(nn.Module):
    """The six-level feature pyramid, 16 to 196 channels."""

    def __init__(self):
        super().__init__()
        chans = (3, 16, 32, 64, 96, 128, 196)
        for name, cin, cout in zip(("netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix"), chans, chans[1:]):
            self.add_module(name, nn.Sequential(*_conv_lr(cin, cout, 2), *_conv_lr(cout, cout), *_conv_lr(cout, cout)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for m in self.children():
            x = m(x)
            feats.append(x)
        return feats


# decoder input channels per level: the correlation's 81, then the first
# frame's features, the upsampled flow and the upsampled features (2 each)
_DEC_IN = {6: 81, 5: 81 + 128 + 4, 4: 81 + 96 + 4, 3: 81 + 64 + 4, 2: 81 + 32 + 4}
_DEC_GROWTH = (128, 128, 96, 64, 32)


class _Decoder(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        c = _DEC_IN[level]
        if level < 6:
            self.netUpflow = nn.ConvTranspose2d(2, 2, 4, 2, 1)
            self.netUpfeat = nn.ConvTranspose2d(_DEC_IN[level + 1] + sum(_DEC_GROWTH), 2, 4, 2, 1)
        for name, g in zip(("netOne", "netTwo", "netThr", "netFou", "netFiv"), _DEC_GROWTH):
            self.add_module(name, nn.Sequential(*_conv_lr(c, g)))
            c += g
        self.netSix = nn.Sequential(nn.Conv2d(c, 2, 3, 1, 1))
        self.level = level

    def forward(self, f1: torch.Tensor, f2: torch.Tensor, prev) -> Dict[str, torch.Tensor]:
        if prev is None:
            feat = leaky_relu(_corr(f1, f2), 0.1)
        else:
            flow = self.netUpflow(prev["flow"])
            up_feat = self.netUpfeat(prev["feat"])
            warped = _backwarp_masked(f2, flow * _PWC_BACKWARP[self.level])
            vol = leaky_relu(_corr(f1, warped), 0.1)
            feat = torch.cat([vol, f1, flow, up_feat], 1)
        for name in ("netOne", "netTwo", "netThr", "netFou", "netFiv"):
            feat = torch.cat([getattr(self, name)(feat), feat], 1)
        return {"flow": self.netSix(feat), "feat": feat}


def _corr(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """``ops.correlation`` on NCHW features; NCHW ``channels_last`` out."""
    return correlation_func(f1.permute(0, 2, 3, 1), f2.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _Refiner(nn.Module):
    def __init__(self):
        super().__init__()
        layers = []
        for cin, cout, d in ((565, 128, 1), (128, 128, 2), (128, 128, 4), (128, 96, 8), (96, 64, 16), (64, 32, 1)):
            layers += _conv_lr(cin, cout, dilation=d)
        self.netMain = nn.Sequential(*layers, nn.Conv2d(32, 2, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.netMain(x)


class _PWCNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.netExtractor = _Extractor()
        for name, level in (("netTwo", 2), ("netThr", 3), ("netFou", 4), ("netFiv", 5), ("netSix", 6)):
            self.add_module(name, _Decoder(level))
        self.netRefiner = _Refiner()

    def flow(self, pyr1: Sequence[torch.Tensor], pyr2: Sequence[torch.Tensor]) -> torch.Tensor:
        """``_pwc_flow``: the decoders from level 6 down to 2, then the refiner."""
        est = None
        for name, i in (("netSix", -1), ("netFiv", -2), ("netFou", -3), ("netThr", -4), ("netTwo", -5)):
            est = getattr(self, name)(pyr1[i], pyr2[i], est)
        return est["flow"] + self.netRefiner(est["feat"])


def pwc_flows(pwc: _PWCNet, i1: torch.Tensor, i2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``20 *`` the PWC flows ``i1 -> i2`` and ``i2 -> i1``, resized to the
    frames (JAX ``stage_flowsplat``'s first half), as one batch: one
    extractor call on both frames, both directions' decoders stacked along
    the batch."""
    b = i1.shape[0]
    h, w = i1.shape[2], i1.shape[3]
    pyr = pwc.netExtractor(torch.cat([i1, i2], 0))
    pyr1 = [p for p in pyr]
    pyr2 = [torch.cat([p[b:], p[:b]], 0) for p in pyr]
    flow = resize_bilinear(20.0 * pwc.flow(pyr1, pyr2), (h, w))
    return flow[:b], flow[b:]


# ---- the MS-ResNeXt feature extractor (JAX stmfnet.py:144-192) --------------------------


class _SE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // 16), nn.ReLU(), nn.Linear(c // 16, c), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean((2, 3))).view(x.shape[0], -1, 1, 1)


class _ResNeXt(nn.Module):
    """A ResNeXt block, groups 32: a down block (strided convolution, pad
    ``(ks-1)//2``) or an up block (transposed, pad ``(ks-stride)//2``)."""

    def __init__(self, cin: int, cout: int, ks: int, stride: int, down: bool):
        super().__init__()
        mid = 2 * cout
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        if down:
            self.conv2 = nn.Conv2d(mid, mid, ks, stride, (ks - 1) // 2, groups=32, bias=False)
            skip = nn.Conv2d(cin, cout, 1, stride, bias=False)
        else:
            self.conv2 = nn.ConvTranspose2d(mid, mid, ks, stride, (ks - stride) // 2, groups=32, bias=False)
            skip = nn.ConvTranspose2d(cin, cout, 2, stride, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = nn.Sequential(skip, nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_bn(self.conv1(x), self.bn1))
        out = F.relu(_bn(self.conv2(out), self.bn2))
        out = _bn(self.conv3(out), self.bn3)
        return F.relu(out + _bn(self.downsample[0](x), self.downsample[1]))


class _MSResNeXt(nn.Module):
    def __init__(self, cin: int, cout: int, ks_small: int, ks_large: int, stride: int, down: bool):
        super().__init__()
        self.resnext_small = _ResNeXt(cin, cout, ks_small, stride, down)
        self.resnext_large = _ResNeXt(cin, cout, ks_large, stride, down)
        self.attention = _SE(2 * cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attention(torch.cat([self.resnext_small(x), self.resnext_large(x)], 1))


# name, input channels, channels per branch, small and large kernel, stride, down
_FEATURE_BLOCKS = (
    ("conv1", 6, 32, 3, 7, 2, True),
    ("conv2", 64, 64, 3, 7, 2, True),
    ("conv3", 128, 128, 3, 5, 2, True),
    ("conv4", 256, 256, 3, 5, 2, True),
    ("deconv4", 512, 256, 3, 5, 1, True),
    ("deconv3", 512, 128, 4, 6, 2, False),
    ("deconv2", 256, 64, 4, 8, 2, False),
    ("deconv1", 128, 32, 4, 8, 2, False),
)


class _FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        for name, *args in _FEATURE_BLOCKS:
            self.add_module(name, _MSResNeXt(*args))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.conv1(x)
        c2 = self.conv2(c1)
        c3 = self.conv3(c2)
        c4 = self.conv4(c3)
        d4 = self.deconv4(c4)
        d3 = self.deconv3(d4 + c4)
        d2 = self.deconv2(d3 + c3)
        return self.deconv1(d2 + c2)


# ---- kernel estimation (JAX stmfnet.py:198-214) ---------------------------------------


def _subnet(kind: str) -> nn.Sequential:
    """Kernel-estimation subnet (stmfnet_arch.py:2496-2612): three 3x3
    convolutions (64, 64, 25 channels), and for the 1x and 2x streams a ReLU,
    a bilinear upsampling by 2 or 4 and a 25-channel convolution."""
    layers = [nn.Conv2d(64, 64, 3, 1, 1), nn.ReLU(), nn.Conv2d(64, 64, 3, 1, 1), nn.ReLU(), nn.Conv2d(64, 25, 3, 1, 1)]
    if not kind.endswith("_ds"):
        layers += [nn.ReLU(), nn.Identity(), nn.Conv2d(25, 25, 3, 1, 1)]
    return nn.Sequential(*layers)


def _run_subnet(seq: nn.Sequential, x: torch.Tensor, suffix: str, weight: bool) -> torch.Tensor:
    x = F.relu(seq[0](x))
    x = F.relu(seq[2](x))
    x = seq[4](x)
    if suffix != "_ds":
        x = resize_by_scale(F.relu(x), 4.0 if suffix == "_us" else 2.0, align_corners=True)
        x = seq[7](x)
    return torch.softmax(x, 1) if weight else x


class _KernelEstimation(nn.Module):
    def __init__(self):
        super().__init__()
        for sfx in _STREAMS:
            for name in ("Weight1", "Alpha1", "Beta1", "Weight2", "Alpha2", "Beta2"):
                self.add_module(f"module{name}{sfx}", _subnet(sfx))


# ---- GridNet (JAX stmfnet.py:246-286) ----------------------------------------------------


def _prelu_conv(cin: int, cout: int, stride: int = 1) -> List[nn.Module]:
    return [nn.PReLU(), nn.Conv2d(cin, cout, 3, stride, 1)]


class _Lateral(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.f = nn.Sequential(*_prelu_conv(cin, cout), *_prelu_conv(cout, cout))
        self.conv = nn.Conv2d(cin, cout, 3, 1, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fx = _pconv_pair(self.f, x, 0)
        return fx + (x if self.conv is None else self.conv(x))


def _pconv_pair(seq: nn.Sequential, x: torch.Tensor, first: int) -> torch.Tensor:
    """PReLU, convolution, PReLU, convolution from ``seq[first]`` on."""
    x = seq[first + 1](prelu(x, seq[first].weight))
    return seq[first + 3](prelu(x, seq[first + 2].weight))


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.f = nn.Sequential(*_prelu_conv(cin, cout, 2), *_prelu_conv(cout, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pconv_pair(self.f, x, 0)


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.f = nn.Sequential(nn.Identity(), *_prelu_conv(cin, cout), *_prelu_conv(cout, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pconv_pair(self.f, resize_by_scale(x, 2.0), 1)


_GRID_IN, _GRID_C = (6, 12, 6), (32, 64, 96)


class _MIMOGridNet(nn.Module):
    """``MIMOGridNet`` (stmfnet_arch.py:1636-1695): 3 rows (2x, 1x and 1/2
    scale), 4 columns, output row 1."""

    def __init__(self):
        super().__init__()
        for r in range(3):
            for c in range(4):
                self.add_module(f"lateral_{r}_{c}", _Lateral(_GRID_IN[r] if c == 0 else _GRID_C[r], _GRID_C[r]))
        for r in range(2):
            for c in range(2):
                self.add_module(f"down_{r}_{c}", _Down(_GRID_C[r], _GRID_C[r + 1]))
                self.add_module(f"up_{r}_{c}", _Up(_GRID_C[r + 1], _GRID_C[r]))
        self.lateral_final_1 = _Lateral(_GRID_C[1], 3)

    def forward(self, rows: List[torch.Tensor]) -> torch.Tensor:
        cur = list(rows)
        for c in range(2):
            for r in range(3):
                cur[r] = getattr(self, f"lateral_{r}_{c}")(cur[r])
                if r:
                    cur[r] = cur[r] + getattr(self, f"down_{r - 1}_{c}")(cur[r - 1])
        for c in range(2, 4):
            for r in range(2, -1, -1):
                cur[r] = getattr(self, f"lateral_{r}_{c}")(cur[r])
                if r != 2:
                    cur[r] = cur[r] + getattr(self, f"up_{r}_{c - 2}")(cur[r + 1])
        return self.lateral_final_1(cur[1])


# ---- UNet3d (JAX stmfnet.py:292-358) -------------------------------------------------------


class _SE3(nn.Module):
    """SEGating: a global pool, a 1x1x1 convolution and a sigmoid gate."""

    def __init__(self, c: int):
        super().__init__()
        self.attn_layer = nn.Sequential(nn.Conv3d(c, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.attn_layer(x.mean((2, 3, 4), keepdim=True)))


def _conv_bn3(cin: int, cout: int, k: int, stride, padding) -> nn.Sequential:
    return nn.Sequential(nn.Conv3d(cin, cout, k, stride, padding, bias=False), nn.BatchNorm3d(cout))


def _run_conv_bn3(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    m = seq[0]
    return _bn(conv3d(x, m.weight, None, m.stride, m.padding), seq[1])


class _R3DBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride):
        super().__init__()
        self.conv1 = _conv_bn3(cin, cout, 3, stride, 1)
        self.conv2 = _conv_bn3(cout, cout, 3, 1, 1)
        self.fg = _SE3(cout)
        self.downsample = _conv_bn3(cin, cout, 1, stride, 0) if cin != cout or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.fg(_run_conv_bn3(self.conv2, F.relu(_run_conv_bn3(self.conv1, x))))
        if self.downsample is not None:
            x = _run_conv_bn3(self.downsample, x)
        return F.relu(out + x)


class _Encoder3d(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = _conv_bn3(3, 32, (3, 7, 7), (1, 2, 2), (1, 3, 3))
        for i, (cin, cout, stride) in enumerate(((32, 32, 1), (32, 64, (1, 2, 2)), (64, 96, (1, 2, 2)), (96, 128, 1))):
            self.add_module(f"layer{i + 1}", nn.Sequential(_R3DBlock(cin, cout, stride), _R3DBlock(cout, cout, 1)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(_run_conv_bn3(self.stem, x))
        feats = [x]
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class _Conv3dSE(nn.Module):
    """``Conv_3d`` with STMFNet's BatchNorm3d after the gate."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv3d(cin, cout, 3, 1, 1), _SE3(cout), nn.BatchNorm3d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _bn(self.conv[1](self.conv[0](x)), self.conv[2])


class _UpConv3dSE(nn.Module):
    """``upConv3D`` (transposed, kernel (3, 4, 4), stride (1, 2, 2)) with
    STMFNet's BatchNorm3d after the gate."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.upconv = nn.Sequential(nn.ConvTranspose3d(cin, cout, (3, 4, 4), (1, 2, 2), 1), _SE3(cout), nn.BatchNorm3d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.upconv[0]
        return _bn(self.upconv[1](conv_transpose3d(x, m.weight, m.bias, m.stride, m.padding)), self.upconv[2])


class _UNet3d(nn.Module):
    """``UNet3d_18`` (stmfnet_arch.py:2391-2487)."""

    def __init__(self):
        super().__init__()
        self.encoder = _Encoder3d()
        self.decoder = nn.Sequential(
            _Conv3dSE(128, 96), _UpConv3dSE(192, 64), _UpConv3dSE(128, 32), _Conv3dSE(64, 32), _UpConv3dSE(64, 32)
        )
        self.feature_fuse = nn.Sequential(nn.Conv2d(5 * 32, 32, 1, bias=False), nn.BatchNorm2d(32))
        self.outconv = nn.Sequential(nn.Identity(), nn.Conv2d(32, 3, 7))

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        x0, x1, x2, x3, x4 = self.encoder(clip)
        dec = self.decoder
        lr = functools.partial(leaky_relu, negative_slope=0.2)
        d3 = torch.cat([lr(dec[0](x4)), x3], 1)
        d2 = torch.cat([lr(dec[1](d3)), x2], 1)
        d1 = torch.cat([lr(dec[2](d2)), x1], 1)
        d0 = torch.cat([lr(dec[3](d1)), x0], 1)
        dout = lr(dec[4](d0))
        # the temporal unbind + concat: channel t*C + c (time-major), one
        # copy into a channels_last tensor
        b, c, t, h, w = dout.shape
        fused = dout.permute(0, 3, 4, 2, 1).reshape(b, h, w, t * c).permute(0, 3, 1, 2)
        out = lr(_bn(self.feature_fuse[0](fused), self.feature_fuse[1]))
        return self.outconv[1](F.pad(out, (3, 3, 3, 3), mode="reflect"))


# ---- the model ---------------------------------------------------------------------------


class _Metric(nn.Module):
    def __init__(self):
        super().__init__()
        self.paramScale = nn.Parameter(torch.empty(1, 1, 1, 1))


class _Upsampler(nn.Module):
    def __init__(self):
        super().__init__()
        self.filter = nn.Parameter(torch.empty(3, 1, 1, 8))


class STMFNet(nn.Module):
    """``STMFNet_Model`` with the state dict of ``stmfnet.pth`` (1000 tensors)."""

    def __init__(self):
        super().__init__()
        self.gauss_kernel = nn.Parameter(torch.empty(3, 1, 5, 5))
        self.feature_extractor = _FeatureExtractor()
        self.get_kernel = _KernelEstimation()
        self.upsampler = _Upsampler()
        self.scale_synthesis = _MIMOGridNet()
        self.flow_estimator = _PWCNet()
        self.metric = _Metric()
        self.dyntex_generator = _UNet3d()


def _upsampler_8tap(filt: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``Upsampler_8tap`` (stmfnet_arch.py:638-676; JAX stmfnet.py:220-240):
    polyphase 2x of NCHW ``im`` with the fixed 8-tap filter ``(C, 1, 1, 8)``,
    reflect-padded (3 before, 4 after): even rows and columns are the
    frame, odd columns its row pass, odd rows its column pass, and the odd
    rows' odd columns the row pass of the column pass."""
    n, c, h, w = im.shape

    def hconv(x):
        return conv2d(F.pad(x, (3, 4, 0, 0), mode="reflect"), filt, groups=c)

    def vconv(x):
        return conv2d(F.pad(x, (0, 0, 3, 4), mode="reflect"), filt.transpose(2, 3), groups=c)

    col = vconv(im)
    up = torch.empty((n, c, 2 * h, 2 * w), dtype=im.dtype, device=im.device, memory_format=torch.channels_last)
    up[:, :, 0::2, 0::2] = im
    up[:, :, 0::2, 1::2] = hconv(im)
    up[:, :, 1::2, 0::2] = col
    up[:, :, 1::2, 1::2] = hconv(col)
    return up


def _gauss_blur(gk: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return conv2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), gk, groups=3)


def stage_feats(net: STMFNet, i1: torch.Tensor, i2: torch.Tensor) -> torch.Tensor:
    """The shared MS-ResNeXt features of the mean-subtracted middle frames
    (stmfnet_arch.py:2752-2760), NCHW at half the frame size, 64 channels."""
    mean = device_const(_RGB_MEAN, (1, 3, 1, 1), i1.device, i1.dtype)
    return net.feature_extractor(torch.cat([i1 - mean, i2 - mean], 1))


def stage_stream(net: STMFNet, feats: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor, suffix: str):
    """One scale stream (``""``, ``"_ds"`` or ``"_us"``): its six subnets and
    the two AdaCoF applications (stmfnet_arch.py:2761-2824), each frame
    edge-padded by 2 first; NCHW out at 1, 1/2 or 2 times the frame size."""
    h, w = i1.shape[2], i1.shape[3]
    ke = net.get_kernel
    if suffix == "_ds":
        i1, i2 = (resize_bilinear(_gauss_blur(net.gauss_kernel, x), (h // 2, w // 2)) for x in (i1, i2))
    elif suffix == "_us":
        i1, i2 = (_upsampler_8tap(net.upsampler.filter, x) for x in (i1, i2))

    def ada(img, k):
        maps = [
            _run_subnet(getattr(ke, f"module{name}{k}{suffix}"), feats, suffix, name == "Weight").permute(0, 2, 3, 1)
            for name in ("Weight", "Alpha", "Beta")
        ]
        padded = F.pad(img, (2, 2, 2, 2), mode="replicate").permute(0, 2, 3, 1)
        return adacof_func(padded, *maps, DILATION).permute(0, 3, 1, 2)

    return ada(i1, 1), ada(i2, 2)


def stage_flowsplat(net: STMFNet, i1: torch.Tensor, i2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both PWC flows, the photometric metrics and the ``"softmax"`` splats of
    both frames to the midpoint at half flow (stmfnet_arch.py:2824-2840),
    both directions as one batch. NCHW out."""
    b = i1.shape[0]
    flow_12, flow_21 = pwc_flows(net.flow_estimator, i1, i2)
    src, dst, flow = torch.cat([i1, i2], 0), torch.cat([i2, i1], 0), torch.cat([flow_12, flow_21], 0)
    metric = net.metric.paramScale * (src - _backwarp_masked(dst, flow)).abs().mean(1, keepdim=True)
    splat = function_softsplat(
        src.permute(0, 2, 3, 1), (0.5 * flow).permute(0, 2, 3, 1), metric.permute(0, 2, 3, 1), "softmax"
    ).permute(0, 3, 1, 2)
    return splat[:b], splat[b:]


def stage_synth(net: STMFNet, adas: Sequence[torch.Tensor], splats: Sequence[torch.Tensor]) -> torch.Tensor:
    """The MIMO GridNet over the three scales (stmfnet_arch.py:2841-2848)."""
    ada1, ada2, ada1_ds, ada2_ds, ada1_us, ada2_us = adas
    rows = [torch.cat([ada1_us, ada2_us], 1), torch.cat([ada1, ada2, *splats], 1), torch.cat([ada1_ds, ada2_ds], 1)]
    return net.scale_synthesis(rows)


def stage_dyntex(net: STMFNet, i0, i1, i2, i3, tilde) -> torch.Tensor:
    """The UNet3d residual over ``[i0, i1, tilde, i2, i3]`` on the time axis,
    added to ``tilde`` (stmfnet_arch.py:2849-2856)."""
    clip = torch.stack([i0, i1, tilde, i2, i3], 2).contiguous(memory_format=torch.channels_last_3d)
    return tilde + net.dyntex_generator(clip)


def apply(net: STMFNet, i0, i1, i2, i3) -> torch.Tensor:
    """``STMFNet_Model.forward`` (stmfnet_arch.py:2733-2856) on NCHW frames:
    reflect-padded to multiples of 128 (bottom and right), the prediction
    cropped back."""
    h0, w0 = i1.shape[2], i1.shape[3]
    ph, pw = (-h0) % 128, (-w0) % 128
    i0, i1, i2, i3 = (reflect_pad(x, (0, pw, 0, ph)) for x in (i0, i1, i2, i3))
    feats = stage_feats(net, i1, i2)
    adas = [a for sfx in _STREAMS for a in stage_stream(net, feats, i1, i2, sfx)]
    tilde = stage_synth(net, adas, stage_flowsplat(net, i1, i2))
    return stage_dyntex(net, i0, i1, i2, i3, tilde)[:, :, :h0, :w0]


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> STMFNet:
    with torch.device("meta"):
        net = STMFNet()
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def make_model_fn(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda"):
    """Window-4 model callable ``model_fn(f0, f1, f2, f3) -> mid(f1, f2)``:
    NHWC frames in, float32 NHWC out (``core.loop.run_plan_window4``)."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0, f1, f2, f3):
        frames = [_nchw(f.to(device=device, dtype=dtype)) for f in (f0, f1, f2, f3)]
        return apply(net, *frames).permute(0, 2, 3, 1).float()

    return model_fn


def warps_per_forward(dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Warp launches per forward on the card by kernel, ``{"narrow": K1,
    "wide": the wide kernel}``: each of :data:`WARP_CHANNELS_PER_FORWARD`
    warped in the model's dtype, and its ones channel in f32, as
    ``warp_kernel.route`` sends them."""
    counts = route_counts(WARP_CHANNELS_PER_FORWARD, dtype)
    ones = route_counts((1,) * len(WARP_CHANNELS_PER_FORWARD), torch.float32)
    return {k: counts[k] + ones[k] for k in counts}


def splats_per_forward() -> int:
    """Splat (K2) launches per forward: both frames' ``"softmax"`` splats in one."""
    return 1


# ---- random weights ----------------------------------------------------------------------


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict with the keys and shapes of ``stmfnet.pth`` (1000
    tensors; ``common.init_state_dict``: a lone parameter, ``gauss_kernel``,
    ``upsampler.filter`` and ``metric.paramScale``, drawn from its own
    shape; batch norms, 2-D and 3-D, at the identity)."""
    with torch.device("meta"):
        net = STMFNet()
    return init_state_dict(net, seed)
