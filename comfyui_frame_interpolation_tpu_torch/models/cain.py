"""CAIN, Channel Attention Is All You Need for video frame interpolation,
PyTorch port of the JAX package's ``models/cain.py`` (reference
``vfi_models/cain/{cain_arch.py, common.py}``).

Flow-free: the per-channel mean of each frame is taken off
(``common.py:7-10``), both frames are reflect-padded to multiples of 128,
centred (``InOutPaddings``, ``common.py:12-23``, through
:func:`~.common.reflect_pad`, which reflects again where a pad is longer
than the side), space-to-depth by 8 in channel-major order
(``PixelShuffle(1/8)``: ``F.pixel_unshuffle``, channel ``c*64 + by*8 +
bx``), fused by a trunk of 5 residual groups of 12 channel-attention RCABs
over 192 features (``common.py:252-284,160-186``), depth-to-space by 8,
cropped, and the mean of the two frames' means added back. The model takes
no timestep: the node drives it with the recursive-midpoint schedule.

Tensors are NCHW in ``channels_last`` memory; frames are NHWC at the API.
No hand kernel runs here: every layer is a cuDNN convolution or plain
PyTorch.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from .common import cast_params, channels_last_params, conv2d, init_state_dict, leaky_relu, reflect_pad

__all__ = ["CAIN", "CKPT_NAMES", "apply", "init_params", "make_model_fn"]

CKPT_NAMES = ["pretrained_cain.pth"]

DEPTH = 3  # space-to-depth factor 2**3 = 8
FEATURES = 192
N_GROUPS = 5
N_BLOCKS = 12
PAD_MULTIPLE = 128


def _reflect_pad1(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` reflect-padded by one pixel on each side, written into a
    ``channels_last`` tensor (on the card ``F.pad(mode="reflect")`` returns
    NCHW memory, and the convolution then copies it back: two passes more
    than this one, at each of the trunk's 125 convolutions). Row bands
    (``parallel.space``) go to their own rule."""
    if has_torch_function((x,)):
        return handle_torch_function(_reflect_pad1, (x,), x)
    n, c, h, w = x.shape
    out = torch.empty((n, c, h + 2, w + 2), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    out[:, :, 1 : h + 1, 1 : w + 1] = x
    out[:, :, 0, 1 : w + 1] = x[:, :, 1]
    out[:, :, h + 1, 1 : w + 1] = x[:, :, h - 2]
    out[:, :, :, 0] = out[:, :, :, 2]
    out[:, :, :, w + 1] = out[:, :, :, w - 1]
    return out


class _ConvNorm(nn.Module):
    """``ConvNorm`` (common.py:27-47): a reflection pad of 1, then an unpadded
    3x3 convolution."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(_reflect_pad1(x), self.conv.weight, self.conv.bias)


class _CALayer(nn.Module):
    """``CALayer`` (common.py:136-153): a gate per channel from the global
    average pool (1x1 convolutions 192 -> 12 -> 192, ReLU, sigmoid)."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.conv_du = nn.Sequential(nn.Conv2d(c, c // reduction, 1), nn.ReLU(), nn.Conv2d(c // reduction, c, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        down, up = self.conv_du[0], self.conv_du[2]
        y = F.relu(conv2d(x.mean((2, 3), keepdim=True), down.weight, down.bias))
        return x * torch.sigmoid(conv2d(y, up.weight, up.bias))


class _RCAB(nn.Module):
    """``RCAB`` (common.py:157-186): ConvNorm, LeakyReLU(0.2), ConvNorm, the
    channel gate, and the skip."""

    def __init__(self, c: int):
        super().__init__()
        self.body = nn.Sequential(_ConvNorm(c), nn.LeakyReLU(0.2), _ConvNorm(c), _CALayer(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.body
        return b[3](b[2](leaky_relu(b[0](x), 0.2))) + x


class _ResidualGroup(nn.Module):
    """12 RCABs and a ConvNorm, with the group's skip (common.py:190-205)."""

    def __init__(self, c: int):
        super().__init__()
        self.body = nn.Sequential(*[_RCAB(c) for _ in range(N_BLOCKS)], _ConvNorm(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class _Interpolation(nn.Module):
    """``Interpolation`` (common.py:252-284): the head convolution over both
    frames' features, 5 residual groups with the trunk's skip, the tail."""

    def __init__(self, c: int = FEATURES):
        super().__init__()
        self.headConv = nn.Conv2d(2 * c, c, 3, padding=1)
        self.body = nn.Sequential(*[_ResidualGroup(c) for _ in range(N_GROUPS)])
        self.tailConv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        x = conv2d(torch.cat([f0, f1], 1), self.headConv.weight, self.headConv.bias, padding=1)
        res = self.body(x) + x
        return conv2d(res, self.tailConv.weight, self.tailConv.bias, padding=1)


class _Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.interpolate = _Interpolation()


class CAIN(nn.Module):
    """The checkpoint's module tree (``encoder.interpolate.*``, 494 tensors)."""

    def __init__(self):
        super().__init__()
        self.encoder = _Encoder()


def apply(net: CAIN, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``CAIN.forward`` (cain_arch.py:56-71), inference path, on NCHW frames."""
    m1 = x1.mean((2, 3), keepdim=True)
    m2 = x2.mean((2, 3), keepdim=True)
    x1, x2 = x1 - m1, x2 - m2
    h, w = x1.shape[2:]
    pad_h, pad_w = (-h) % PAD_MULTIPLE, (-w) % PAD_MULTIPLE
    top, left = pad_h // 2, pad_w // 2
    pad = (left, pad_w - left, top, pad_h - top)
    if pad_h or pad_w:
        x1, x2 = reflect_pad(x1, pad), reflect_pad(x2, pad)
    b = 2**DEPTH
    f1, f2 = (F.pixel_unshuffle(x, b).contiguous(memory_format=torch.channels_last) for x in (x1, x2))
    out = F.pixel_shuffle(net.encoder.interpolate(f1, f2), b)
    return out[:, :, top : top + h, left : left + w] + (m1 + m2) / 2


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> CAIN:
    with torch.device("meta"):
        net = CAIN()
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda"):
    """Batched model callable ``model_fn(f0, f1, t) -> mid`` for the executor:
    NHWC frames in, float32 NHWC out; ``t`` is ignored (CAIN has no timestep
    input)."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0, f1, t=None):
        x0, x1 = (f.to(device=device, dtype=dtype).permute(0, 3, 1, 2) for f in (f0, f1))
        return apply(net, x0, x1).permute(0, 2, 3, 1).float()

    return model_fn


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict with the keys and shapes of ``pretrained_cain.pth``
    (494 tensors, without the ``module.`` of its ``state_dict`` container;
    ``common.init_state_dict``)."""
    with torch.device("meta"):
        net = CAIN()
    return init_state_dict(net, seed)
