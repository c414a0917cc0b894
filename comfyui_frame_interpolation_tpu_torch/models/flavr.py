"""FLAVR, flow-free 4-frame interpolation with 3-D convolutions, PyTorch port
of the JAX package's ``models/flavr.py`` (reference ``vfi_models/flavr/
{flavr_arch.py, resnet_3D.py}``).

``UNet_3D_3D``: an R3D-18 encoder (3x3x3 convolutions, SEGating channel
attention, no BatchNorm in the shipped weights) over the 4-frame clip, a
decoder of 3-D (transposed) convolutions with SEGating, the temporal
unbind+concat (channel ``t*C + c``), a bias-free 1x1 fuse and a
reflection-padded 7x7 head producing ``3 * n_outputs`` channels; the per
(batch, channel) mean of the clip is taken off first and added back to each
output (``flavr_arch.py:168-198``).

Clips are NCDHW ``[B, 3, 4, H, W]`` in ``channels_last_3d`` memory; frames
are NHWC at the API, and H and W multiples of 16 (the node pads the clip
once). ``n_outputs`` comes from the checkpoint's ``outconv.1.weight``; the
node uses the first output (2x). No hand kernel runs here: every layer is a
cuDNN convolution or plain PyTorch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import cast_params, channels_last_params, conv2d, conv3d, conv_transpose3d, leaky_relu

__all__ = ["CKPT_NAMES", "FLAVR", "apply", "infer_n_outputs", "init_params", "make_model_fn"]

CKPT_NAMES = ["FLAVR_2x.pth", "FLAVR_4x.pth", "FLAVR_8x.pth"]
_CHANNELS = (64, 128, 256, 512)


class _SEGating(nn.Module):
    """SEGating (flavr_arch.py:13-29): a global pool, a 1x1x1 convolution and
    a sigmoid gate."""

    def __init__(self, c: int):
        super().__init__()
        self.attn_layer = nn.Sequential(nn.Conv3d(c, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.attn_layer[0]
        return x * torch.sigmoid(conv3d(x.mean((2, 3, 4), keepdim=True), m.weight, m.bias))


class _BasicBlock(nn.Module):
    """``resnet_3D.BasicBlock`` with SEGating and identity batch norms."""

    def __init__(self, cin: int, cout: int, stride):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv3d(cin, cout, 3, stride, 1, bias=False))
        self.conv2 = nn.Sequential(nn.Conv3d(cout, cout, 3, 1, 1, bias=False))
        self.fg = _SEGating(cout)
        self.downsample = nn.Sequential(nn.Conv3d(cin, cout, 1, stride, bias=False)) if cin != cout or stride != 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2 = self.conv1[0], self.conv2[0]
        out = F.relu(conv3d(x, c1.weight, None, c1.stride, 1))
        out = self.fg(conv3d(out, c2.weight, None, 1, 1))
        if self.downsample is not None:
            d = self.downsample[0]
            x = conv3d(x, d.weight, None, d.stride, 0)
        return F.relu(out + x)


class _Encoder(nn.Module):
    """R3D-18 (``unet_18``): a stem and four layers of two blocks."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv3d(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), bias=False))
        cin = _CHANNELS[0]
        for i, (cout, stride) in enumerate(zip(_CHANNELS, (1, (1, 2, 2), (1, 2, 2), 1))):
            self.add_module(f"layer{i + 1}", nn.Sequential(_BasicBlock(cin, cout, stride), _BasicBlock(cout, cout, 1)))
            cin = cout

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        s = self.stem[0]
        x = F.relu(conv3d(x, s.weight, None, s.stride, s.padding))
        feats = [x]
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        return feats


class _Conv3d(nn.Module):
    """``Conv_3d``: a 3x3x3 convolution and SEGating."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv3d(cin, cout, 3, 1, 1), _SEGating(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.conv[0]
        return self.conv[1](conv3d(x, m.weight, m.bias, 1, 1))


class _UpConv3d(nn.Module):
    """``upConv3D``, transpose mode: kernel (3, 4, 4), stride (1, 2, 2), pad
    1, and SEGating."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.upconv = nn.Sequential(nn.ConvTranspose3d(cin, cout, (3, 4, 4), (1, 2, 2), 1), _SEGating(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.upconv[0]
        return self.upconv[1](conv_transpose3d(x, m.weight, m.bias, (1, 2, 2), 1))


class _FeatureFuse(nn.Module):
    def __init__(self, n_inputs: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(_CHANNELS[0] * n_inputs, _CHANNELS[0], 1, bias=False))


class FLAVR(nn.Module):
    """``UNet_3D_3D('unet_18', n_inputs=4, n_outputs, joinType='concat',
    upmode='transpose')``: the state dict of ``FLAVR_*.pth`` without its
    ``module.`` prefix (59 tensors for ``FLAVR_2x.pth``)."""

    def __init__(self, n_outputs: int = 1, n_inputs: int = 4):
        super().__init__()
        c = _CHANNELS
        self.encoder = _Encoder()
        self.decoder = nn.Sequential(
            _Conv3d(c[3], c[2]), _UpConv3d(2 * c[2], c[1]), _UpConv3d(2 * c[1], c[0]), _Conv3d(2 * c[0], c[0]),
            _UpConv3d(2 * c[0], c[0]),
        )
        self.feature_fuse = _FeatureFuse(n_inputs)
        self.outconv = nn.Sequential(nn.Identity(), nn.Conv2d(c[0], 3 * n_outputs, 7))


def apply(net: FLAVR, clip: torch.Tensor) -> List[torch.Tensor]:
    """``UNet_3D_3D.forward`` (flavr_arch.py:168-198) on an NCDHW clip
    ``[B, 3, 4, H, W]`` (H, W multiples of 16): the ``n_outputs`` NCHW
    frames."""
    mean_ = clip.mean((2, 3, 4), keepdim=True)  # per (B, C)
    x0, x1, x2, x3, x4 = net.encoder(clip - mean_)
    dec = net.decoder
    dx3 = torch.cat([leaky_relu(dec[0](x4), 0.2), x3], 1)
    dx2 = torch.cat([leaky_relu(dec[1](dx3), 0.2), x2], 1)
    dx1 = torch.cat([leaky_relu(dec[2](dx2), 0.2), x1], 1)
    dx0 = torch.cat([leaky_relu(dec[3](dx1), 0.2), x0], 1)
    dx_out = leaky_relu(dec[4](dx0), 0.2)
    # torch.cat(torch.unbind(dx_out, 2), 1): channel t*C + c (time-major),
    # one copy into a channels_last tensor
    b, c, t, h, w = dx_out.shape
    fused = dx_out.permute(0, 3, 4, 2, 1).reshape(b, h, w, t * c).permute(0, 3, 1, 2)
    out = leaky_relu(conv2d(fused, net.feature_fuse.conv[0].weight), 0.2)
    head = net.outconv[1]
    out = conv2d(F.pad(out, (3, 3, 3, 3), mode="reflect"), head.weight, head.bias)
    mean2d = mean_[:, :, 0]  # [B, C, 1, 1]
    return [out[:, 3 * i : 3 * (i + 1)] + mean2d for i in range(out.shape[1] // 3)]


def infer_n_outputs(params: Dict[str, torch.Tensor]) -> int:
    return params["outconv.1.weight"].shape[0] // 3


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> FLAVR:
    with torch.device("meta"):
        net = FLAVR(infer_n_outputs(params))
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda"):
    """Window-4 model callable ``model_fn(f0, f1, f2, f3) -> mid(f1, f2)``:
    NHWC frames in, float32 NHWC out (the first output: 2x)."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0, f1, f2, f3):
        clip = torch.stack([f.to(device=device, dtype=dtype) for f in (f0, f1, f2, f3)], 1)  # [B, T, H, W, C]
        clip = clip.permute(0, 4, 1, 2, 3)  # NCDHW view of channels_last_3d memory
        return apply(net, clip)[0].permute(0, 2, 3, 1).float()

    return model_fn


def init_params(seed: int = 0, n_outputs: int = 1) -> Dict[str, torch.Tensor]:
    """Random state dict with the keys and shapes of ``FLAVR_2x.pth``
    (``n_outputs=1``, 59 tensors) without ``module.``, drawn from
    ``numpy.random.default_rng(seed)`` in ``state_dict`` key order: weights
    and biases uniform in ``+-1/sqrt(fan_in)`` (fan_in from every dim of the
    module's weight after the first), as ``eisai.init_params`` draws them."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in FLAVR(n_outputs).state_dict().items()}
    params = {}
    for key, shape in shapes.items():
        module = key.rsplit(".", 1)[0]
        bound = 1.0 / np.sqrt(int(np.prod(shapes[f"{module}.weight"][1:])))
        params[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return params
