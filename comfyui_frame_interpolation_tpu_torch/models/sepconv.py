"""Revisiting-SepConv, adaptive separable convolution synthesis, PyTorch port
of the JAX package's ``models/sepconv.py`` (reference
``vfi_models/sepconv/sepconv_enhanced.py``).

A grid encoder/decoder of 5 rows (32 to 512 channels): row 0 is both frames'
input convolutions side by side, the encode pass seeds each coarser row from
the one above with a strided block, the decode pass refines each row and
cascades the upsampled coarser row back down, trimming the overshoot of the
2x upsampling on odd level sizes (``sepconv_enhanced.py:314-525``; the
decoder's lists run coarse to fine, so row ``r`` takes list index
``n_rows - 1 - r``). Four kernel heads turn the half-resolution decode row
into four 51-tap 1-D filter fields at full resolution; each frame, padded by
25 (replicate) with a ones channel appended, is filtered by
:func:`~..ops.sepconv.sepconv_func`, the two results summed and divided by
the filtered ones channel (a normaliser under 0.01 in magnitude is taken as
1, ``sepconv_enhanced.py:689-695``). The frames are padded to even sizes
(edge) and normalised by one mean and unbiased standard deviation over both
frames per sample (``:623-639``).

Tensors are NCHW in ``channels_last`` memory; frames are NHWC at the API,
and the filter fields' ``[N, H, W, 51]`` NHWC views are what
``sepconv_func`` takes. No hand kernel runs here: ``sepconv_func`` is plain
PyTorch, every other layer a cuDNN convolution or plain PyTorch. The model
takes no timestep: the node drives it with the recursive-midpoint schedule.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sepconv import sepconv_func
from .common import cast_params, channels_last_params, conv2d, init_state_dict, prelu, resize_by_scale

__all__ = ["CKPT_NAMES", "Network", "apply", "init_params", "make_model_fn"]

CKPT_NAMES = ["sepconv.pth"]

CHANNELS = [32, 64, 128, 256, 512]
K = 51
N_ROWS = len(CHANNELS)


def _conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv2d(x, m.weight, m.bias, stride=m.stride, padding=1)


class _Basic(nn.Module):
    """``Basic`` blocks (sepconv_enhanced.py:226-312) as the checkpoint names
    their layers, ``netMain.<i>``: ``"enc"`` prelu-sconv-prelu-conv (stride 2),
    ``"hor"`` prelu-conv-prelu-conv with the identity skip, ``"ver"``
    prelu-up-conv-prelu-conv, ``"head"`` up-conv-prelu-conv(51). The
    upsampling (bilinear 2x) holds no weights; it keeps its index as an
    ``nn.Identity``."""

    def __init__(self, kind: str, cin: int, cout: int):
        super().__init__()
        self.kind = kind
        if kind == "enc":
            layers = [nn.PReLU(), nn.Conv2d(cin, cout, 3, 2, 1), nn.PReLU(), nn.Conv2d(cout, cout, 3, 1, 1)]
        elif kind == "hor":
            layers = [nn.PReLU(), nn.Conv2d(cin, cout, 3, 1, 1), nn.PReLU(), nn.Conv2d(cout, cout, 3, 1, 1)]
        elif kind == "ver":
            layers = [nn.PReLU(), nn.Identity(), nn.Conv2d(cin, cout, 3, 1, 1), nn.PReLU(), nn.Conv2d(cout, cout, 3, 1, 1)]
        else:
            layers = [nn.Identity(), nn.Conv2d(cin, cin, 3, 1, 1), nn.PReLU(), nn.Conv2d(cin, cout, 3, 1, 1)]
        self.netMain = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.netMain
        if self.kind == "enc":
            return _conv(m[3], prelu(_conv(m[1], prelu(x, m[0].weight)), m[2].weight))
        if self.kind == "hor":
            return _conv(m[3], prelu(_conv(m[1], prelu(x, m[0].weight)), m[2].weight)) + x
        if self.kind == "ver":
            up = resize_by_scale(prelu(x, m[0].weight), 2.0)
            return _conv(m[4], prelu(_conv(m[2], up), m[3].weight))
        return _conv(m[3], prelu(_conv(m[1], resize_by_scale(x, 2.0)), m[2].weight))


class _Encode(nn.Module):
    def __init__(self):
        super().__init__()
        self.netVer = nn.ModuleList(
            [nn.Identity()] + [_Basic("enc", CHANNELS[r - 1], CHANNELS[r]) for r in range(1, N_ROWS)]
        )


class _Decode(nn.Module):
    def __init__(self):
        super().__init__()
        # list index i is row N_ROWS - 1 - i (coarse to fine)
        self.netHor = nn.ModuleList([_Basic("hor", CHANNELS[N_ROWS - 1 - i], CHANNELS[N_ROWS - 1 - i]) for i in range(N_ROWS - 1)])
        self.netVer = nn.ModuleList(
            [nn.Identity()] + [_Basic("ver", CHANNELS[N_ROWS - i], CHANNELS[N_ROWS - 1 - i]) for i in range(1, N_ROWS - 1)]
        )


class Network(nn.Module):
    """The checkpoint's module tree (88 tensors)."""

    def __init__(self):
        super().__init__()
        self.netInput = nn.Conv2d(3, CHANNELS[0] // 2, 3, 1, 1)
        self.netEncode = nn.ModuleList([_Encode()])
        self.netDecode = nn.ModuleList([_Decode()])
        for name in ("netVerone", "netVertwo", "netHorone", "netHortwo"):
            self.add_module(name, _Basic("head", CHANNELS[1], K))


def _taps(field: torch.Tensor) -> torch.Tensor:
    """A ``[N, 51, H, W]`` filter field as the ``[N, H, W, 51]`` NHWC view."""
    return field.permute(0, 2, 3, 1)


def apply(net: Network, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``Network.forward`` (sepconv_enhanced.py:605-698) on NCHW frames."""
    n, _, h, w = x1.shape
    padr, padb = (-w) % 2, (-h) % 2
    if padr or padb:
        x1, x2 = (F.pad(x, (0, padr, 0, padb), mode="replicate") for x in (x1, x2))
    std, mean = torch.std_mean(torch.stack([x1, x2], 1).reshape(n, -1), dim=1, correction=1)
    std, mean = std.view(n, 1, 1, 1), mean.view(n, 1, 1, 1)
    s1, s2 = (x1 - mean) / (std + 1e-7), (x2 - mean) / (std + 1e-7)

    rows: List[torch.Tensor] = [torch.cat([_conv(net.netInput, s1), _conv(net.netInput, s2)], 1)]
    enc = net.netEncode[0]
    for r in range(1, N_ROWS):
        rows.append(enc.netVer[r](rows[r - 1]))
    dec = net.netDecode[0]
    for r in range(N_ROWS - 1, 0, -1):
        rows[r] = dec.netHor[N_ROWS - 1 - r](rows[r])
    for r in range(N_ROWS - 2, 0, -1):
        v = dec.netVer[N_ROWS - 1 - r](rows[r + 1])
        rows[r] = rows[r] + v[:, :, : rows[r].shape[2], : rows[r].shape[3]]  # trim the overshoot of odd sizes
    ten_out = rows[1]

    def padded(x):
        x = F.pad(x, (25, 25, 25, 25), mode="replicate")
        return torch.cat([x, torch.ones_like(x[:, :1])], 1).contiguous(memory_format=torch.channels_last)

    one_p, two_p = padded(x1), padded(x2)
    ver1, ver2, hor1, hor2 = (_taps(head(ten_out)) for head in (net.netVerone, net.netVertwo, net.netHorone, net.netHortwo))
    out = sepconv_func(one_p.permute(0, 2, 3, 1), ver1, hor1) + sepconv_func(two_p.permute(0, 2, 3, 1), ver2, hor2)
    norm = out[..., -1:]
    norm = torch.where(norm.abs() < 0.01, torch.ones_like(norm), norm)
    return (out[..., :-1] / norm)[:, :h, :w].permute(0, 3, 1, 2)


def _load(params: Dict[str, torch.Tensor], dtype: torch.dtype, device) -> Network:
    with torch.device("meta"):
        net = Network()
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(params: Dict[str, torch.Tensor], dtype: torch.dtype = torch.float32, device="cuda"):
    """Batched model callable ``model_fn(f0, f1, t) -> mid`` for the executor:
    NHWC frames in, float32 NHWC out; ``t`` is ignored (Sepconv has no
    timestep input)."""
    net = _load(params, dtype, device)

    @torch.inference_mode()
    def model_fn(f0, f1, t=None):
        x0, x1 = (f.to(device=device, dtype=dtype).permute(0, 3, 1, 2) for f in (f0, f1))
        return apply(net, x0, x1).permute(0, 2, 3, 1).float()

    return model_fn


def init_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict with the keys and shapes of ``sepconv.pth`` (88
    tensors; ``common.init_state_dict``: each PReLU's one slope at 0.25)."""
    with torch.device("meta"):
        net = Network()
    return init_state_dict(net, seed)
