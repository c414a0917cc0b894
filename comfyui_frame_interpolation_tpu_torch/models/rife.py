"""RIFE IFNet, PyTorch port of the JAX package's ``models/rife.py``
(reference ``vfi_models/rife/rife_arch.py``) for every arch the JAX package
has: 4.0 (``sudo_rife4_269.662_testV1_scale1.pth``), 4.2, 4.3, 4.5, 4.6
(``rife46``, which GMFSS Fortuna's union variant runs inside its fusion
head), 4.7 (``rife47``, ``rife49``), 4.10, 4.17 (``rife417``) and 4.26
(``rife426``).

Coarse-to-fine intermediate-flow estimation: 4 (5 for 4.26) ``IFBlock`` stages
on a static scale pyramid, each refining a 4-channel bidirectional flow and a
blend mask with stride-4 conv encoders, 8 convs and a transposed-conv head
(``rife_arch.py:177-276``); both frames (and, from 4.7 on, their encoder
features) are backward-warped at every stage (``ops.warp``, the Hopper kernel
on the card) and blended by the sigmoid mask (``rife_arch.py:707-723``).

The archs differ in three places:

* the block: 4.0-4.3 have 8 plain conv layers (PReLU for 4.0, LeakyReLU
  otherwise; 4.0 adds the residual ``h + feat``) and a bare 5-channel
  ``lastconv`` resized by ``scale * 2``; 4.5 on have 8 ``ResConv`` layers and
  a pixel-shuffled ``lastconv`` resized by ``scale``;
* the encoder: none up to 4.6, whose blocks see the images, the timestep
  and (after stage 0) the mask and flow; the ensemble averages flow and mask
  at every stage, and the mask accumulates (:func:`_forward_noenc`); 4.7,
  4.10, 4.17 and 4.26 encode both frames and warp the features too;
* 4.0-4.3 with ``fastmode=False`` refine the blend with ``Contextnet``
  features of both frames and a ``Unet`` that takes the pre-sigmoid mask
  (``rife_arch.py:279-342,725-730``); 4.0 has a data-dependent rescue that
  restarts with doubled scales when stage 1's flow update exceeds 32 pixels
  (``rife_arch.py:598-626``). JAX takes it as a ``lax.cond`` on one flag
  reduced over the whole batch; here one host-side branch takes the same
  batch-wide flag (:func:`_needs_rescue`), never a decision per sample.

Modules hold the parameters, with ``state_dict`` keys equal to the reference
checkpoints' and to the JAX parameter tree flattened with ``.``
(``block0.conv0.0.0.weight``, ``block0.convblock.3.beta``, ``encode.1.weight``,
``contextnet.conv1.conv1.1.weight``). The layout of ``rife47.pth`` is checked
against its manifest; no manifest of ``sudo_rife4_*.pth`` or of the 4.2-4.10
checkpoints is in the repository, so their layout is the one that the JAX
code's reads imply. :func:`apply` is the forward, with NHWC frames in and out
as in the JAX package; inside, tensors are NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.warp_kernel import route_counts
from ..ops.warp import warp
from .common import PRELU_INIT, cast_params, leaky_relu, pixel_shuffle, resize_by_scale, sigmoid

__all__ = [
    "ARCH_VERSIONS",
    "CKPT_NAME_VER_DICT",
    "Contextnet",
    "IFBlock",
    "IFNet",
    "PRELU_INIT",
    "Unet",
    "apply",
    "default_scale_list",
    "init_params",
    "make_model_fn",
    "warps_per_forward",
]

ARCH_VERSIONS = ("4.0", "4.2", "4.3", "4.5", "4.6", "4.7", "4.10", "4.17", "4.26")

# ckpt -> arch version (reference rife/__init__.py:10-20)
CKPT_NAME_VER_DICT = {
    "rife47.pth": "4.7",
    "rife49.pth": "4.7",
    "rife417.pth": "4.17",
    "rife426.pth": "4.26",
    "sudo_rife4_269.662_testV1_scale1.pth": "4.0",
}

_PLAIN = ("4.0", "4.2", "4.3")  # plain-conv blocks; Contextnet and Unet
_NO_ENCODER = ("4.0", "4.2", "4.3", "4.5", "4.6")
_BLOCKS_NOENC = ((7, 192), (12, 128), (12, 96), (12, 64))
_CONTEXT_C = 16  # the reference's ``c`` of Contextnet and Unet

# per arch: (in_planes, width) of each IFBlock, the ResConv head's output
# multiple (None: the plain block's 5-channel head), and the encoder: None,
# "4.7" or "4.10" (their Sequentials) or the (hidden, output) widths of a
# ``Head``
_ARCH = {
    "4.0": (_BLOCKS_NOENC, None, None),
    "4.2": (_BLOCKS_NOENC, None, None),
    "4.3": (_BLOCKS_NOENC, None, None),
    "4.5": (_BLOCKS_NOENC, 6, None),
    "4.6": (_BLOCKS_NOENC, 6, None),
    "4.7": (((15, 192), (20, 128), (20, 96), (20, 64)), 6, "4.7"),
    "4.10": (((23, 192), (28, 128), (28, 96), (28, 64)), 6, "4.10"),
    "4.17": (((23, 192), (28, 128), (28, 96), (28, 64)), 6, (32, 8)),
    "4.26": (((15, 192), (28, 128), (28, 96), (28, 64), (28, 32)), 13, (16, 4)),
}
# the encoder features' channels, which the encoder archs warp with the image
_FEATURE_C = {"4.7": 4, "4.10": 8, "4.17": 8, "4.26": 4}


def _check_arch(arch_ver: str) -> None:
    if arch_ver not in ARCH_VERSIONS:
        raise ValueError(f"unknown RIFE arch {arch_ver} (known: {', '.join(ARCH_VERSIONS)})")


def _act(o: int, arch: str) -> nn.Module:
    """The reference ``conv()``/``deconv()`` activation: PReLU(o) for 4.0,
    LeakyReLU(0.2) otherwise."""
    return nn.PReLU(o, PRELU_INIT) if arch == "4.0" else nn.LeakyReLU(0.2)


def _conv(i: int, o: int, stride: int, arch: str) -> nn.Sequential:
    """reference ``conv()``: Conv2d(3x3) + the arch's activation."""
    return nn.Sequential(nn.Conv2d(i, o, 3, stride, 1), _act(o, arch))


def _deconv(i: int, o: int, arch: str) -> nn.Sequential:
    """reference ``deconv()``: ConvTranspose2d(4x4, stride 2) + the arch's activation."""
    return nn.Sequential(nn.ConvTranspose2d(i, o, 4, 2, 1), _act(o, arch))


class ResConv(nn.Module):
    """``ResConv`` (rife_arch.py:20-28): lrelu(conv(x) * beta + x)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)
        self.beta = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.conv(x) * self.beta + x, 0.2)


class IFBlock(nn.Module):
    """``IFBlock`` (rife_arch.py:177-276); ``forward`` runs the convolutions
    at the block's working resolution, :func:`_if_block` the resizes around
    them. ``up`` is the factor of the head's output resolution over the
    working one: 2 for the pixel-shuffled ResConv head, 1 for the plain
    head, which :func:`_if_block` makes up in its resize."""

    def __init__(self, in_planes: int, c: int, out_mult: Optional[int], arch: str):
        super().__init__()
        self.conv0 = nn.Sequential(_conv(in_planes, c // 2, 2, arch), _conv(c // 2, c, 2, arch))
        self.residual = arch == "4.0"
        if out_mult is None:  # 4.0-4.3 (JAX rife.py:99-106)
            self.convblock = nn.Sequential(*[_conv(c, c, 1, arch) for _ in range(8)])
            self.lastconv = nn.ConvTranspose2d(c, 5, 4, 2, 1)
            self.up = 1
        else:
            self.convblock = nn.Sequential(*[ResConv(c) for _ in range(8)])
            self.lastconv = nn.Sequential(nn.ConvTranspose2d(c, 4 * out_mult, 4, 2, 1))
            self.up = 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv0(x)
        h = self.convblock(feat)
        if self.residual:
            h = h + feat
        out = self.lastconv(h)
        return pixel_shuffle(out, 2) if self.up == 2 else out


class Head(nn.Module):
    """Feature encoder of 4.17 (``Head_417``) and 4.26 (``Head``)
    (rife_arch.py:414-433,457): cnn0..cnn3 with LeakyReLU between."""

    def __init__(self, c: int, out: int):
        super().__init__()
        self.cnn0 = nn.Conv2d(3, c, 3, 2, 1)
        self.cnn1 = nn.Conv2d(c, c, 3, 1, 1)
        self.cnn2 = nn.Conv2d(c, c, 3, 1, 1)
        self.cnn3 = nn.ConvTranspose2d(c, out, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = leaky_relu(self.cnn0(x), 0.2)
        h = leaky_relu(self.cnn1(h), 0.2)
        h = leaky_relu(self.cnn2(h), 0.2)
        return self.cnn3(h)


class _Conv2(nn.Module):
    """reference ``Conv2``: a stride-2 then a stride-1 conv block."""

    def __init__(self, i: int, o: int, arch: str):
        super().__init__()
        self.conv1 = _conv(i, o, 2, arch)
        self.conv2 = _conv(o, o, 1, arch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class Contextnet(nn.Module):
    """``Contextnet`` (rife_arch.py:279-313, JAX rife.py:140-149): four
    ``Conv2`` levels, each output warped by the flow halved to its size."""

    def __init__(self, arch: str):
        super().__init__()
        c = _CONTEXT_C
        self.conv1 = _Conv2(3, c, arch)
        self.conv2 = _Conv2(c, 2 * c, arch)
        self.conv3 = _Conv2(2 * c, 4 * c, arch)
        self.conv4 = _Conv2(4 * c, 8 * c, arch)

    def forward(self, x: torch.Tensor, flow: torch.Tensor) -> List[torch.Tensor]:
        """``x`` ``[N, 3, H, W]`` and its ``[N, 2, H, W]`` flow to the four
        warped levels (C = 16, 32, 64, 128, border mode)."""
        feats = []
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            x = conv(x)
            flow = resize_by_scale(flow, 0.5) * 0.5
            feats.append(_warp(x, flow))
        return feats


class Unet(nn.Module):
    """``Unet`` (rife_arch.py:316-342, JAX rife.py:152-168)."""

    def __init__(self, arch: str):
        super().__init__()
        c = _CONTEXT_C
        self.down0 = _Conv2(17, 2 * c, arch)
        self.down1 = _Conv2(4 * c, 4 * c, arch)
        self.down2 = _Conv2(8 * c, 8 * c, arch)
        self.down3 = _Conv2(16 * c, 16 * c, arch)
        self.up0 = _deconv(32 * c, 8 * c, arch)
        self.up1 = _deconv(16 * c, 4 * c, arch)
        self.up2 = _deconv(8 * c, 2 * c, arch)
        self.up3 = _deconv(4 * c, c, arch)
        self.conv = nn.Conv2d(c, 3, 3, 1, 1)

    def forward(self, img0, img1, warped0, warped1, mask, flow, c0, c1) -> torch.Tensor:
        s0 = self.down0(torch.cat([img0, img1, warped0, warped1, mask, flow], 1))
        s1 = self.down1(torch.cat([s0, c0[0], c1[0]], 1))
        s2 = self.down2(torch.cat([s1, c0[1], c1[1]], 1))
        s3 = self.down3(torch.cat([s2, c0[2], c1[2]], 1))
        x = self.up0(torch.cat([s3, c0[3], c1[3]], 1))
        x = self.up1(torch.cat([x, s2], 1))
        x = self.up2(torch.cat([x, s1], 1))
        x = self.up3(torch.cat([x, s0], 1))
        return sigmoid(self.conv(x))


class IFNet(nn.Module):
    """Parameter tree of one arch version; :func:`apply` runs it."""

    def __init__(self, arch_ver: str = "4.7"):
        super().__init__()
        _check_arch(arch_ver)
        self.arch_ver = arch_ver
        blocks, out_mult, head = _ARCH[arch_ver]
        for i, (in_planes, c) in enumerate(blocks):
            self.add_module(f"block{i}", IFBlock(in_planes, c, out_mult, arch_ver))
        self.num_blocks = len(blocks)
        if head == "4.7":  # rife_arch.py:356-360
            self.encode = nn.Sequential(
                nn.Conv2d(3, 16, 3, 2, 1), nn.ConvTranspose2d(16, 4, 4, 2, 1)
            )
        elif head == "4.10":  # JAX rife.py:128-132: layers 0, 2, 4, 6
            self.encode = nn.Sequential(
                nn.Conv2d(3, 32, 3, 2, 1), nn.LeakyReLU(0.2),
                nn.Conv2d(32, 32, 3, 1, 1), nn.LeakyReLU(0.2),
                nn.Conv2d(32, 32, 3, 1, 1), nn.LeakyReLU(0.2),
                nn.ConvTranspose2d(32, 8, 4, 2, 1),
            )
        elif head is not None:
            self.encode = Head(*head)
        if arch_ver in _PLAIN:
            self.contextnet = Contextnet(arch_ver)
            self.unet = Unet(arch_ver)

    def blocks(self) -> List[IFBlock]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]


def _if_block(
    block: IFBlock, x: Sequence[torch.Tensor], flow: Optional[torch.Tensor], scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``IFBlock.forward`` (rife_arch.py:237-276). Returns (flow, mask, rest),
    ``rest`` being the channels after the mask (4.26's feature output).

    The input planes are resized one by one and concatenated at the block's
    working resolution (bilinear resizing is per channel, so this equals
    resizing the concatenation)."""
    x = [resize_by_scale(q, 1.0 / scale) for q in x]
    if flow is not None:
        x.append(resize_by_scale(flow, 1.0 / scale) * (1.0 / scale))
    s = scale * 2 / block.up
    tmp = resize_by_scale(block(torch.cat(x, 1)), s)
    return tmp[:, :4] * s, tmp[:, 4:5], tmp[:, 5:]


def _swap_flow(f: torch.Tensor) -> torch.Tensor:
    return torch.cat([f[:, 2:4], f[:, :2]], 1)


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """NCHW ``ops.warp.warp``: the permutes are views, and the kernel takes
    the strides as they are."""
    return warp(img.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def _warp_both(img0, img1, flow) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp img0 by flow[:, :2] and img1 by flow[:, 2:4] in one call, stacked
    along the batch (images are independent, so this is exact)."""
    n = img0.shape[0]
    both = _warp(torch.cat([img0, img1], 0), torch.cat([flow[:, :2], flow[:, 2:4]], 0))
    return both[:n], both[n:]


def _warp_both_pairs(img0, f0, img1, f1, flow):
    """Both directions' image and encoder-feature warps in one call (warping
    is per channel, so concatenating the planes is exact)."""
    n = img0.shape[0]
    both = _warp(
        torch.cat([torch.cat([img0[:, :3], f0], 1), torch.cat([img1[:, :3], f1], 1)], 0),
        torch.cat([flow[:, :2], flow[:, 2:4]], 0),
    )
    w0, w1 = both[:n], both[n:]
    return w0[:, :3], w0[:, 3:], w1[:, :3], w1[:, 3:]


def apply(
    net: IFNet,
    img0: torch.Tensor,
    img1: torch.Tensor,
    timestep,
    scale_list: Sequence[float],
    ensemble: bool = False,
    fastmode: bool = True,
) -> torch.Tensor:
    """``IFNet.forward`` (rife_arch.py:465-732), inference semantics, on NHWC
    frames ``[N, H, W, 3]``; ``timestep`` is a scalar or an ``[N]`` vector.
    ``fastmode=False`` adds the Contextnet/Unet refinement of arch 4.0-4.3;
    the other archs have none and ignore it, as the reference does."""
    arch = net.arch_ver
    n, h, w, _ = img0.shape
    ph = ((h - 1) // 64 + 1) * 64
    pw = ((w - 1) // 64 + 1) * 64
    img0 = F.pad(img0.permute(0, 3, 1, 2).clamp(0.0, 1.0), (0, pw - w, 0, ph - h))
    img1 = F.pad(img1.permute(0, 3, 1, 2).clamp(0.0, 1.0), (0, pw - w, 0, ph - h))
    timestep = torch.as_tensor(timestep, dtype=img0.dtype, device=img0.device)
    tmap = timestep.reshape(-1, 1, 1, 1).expand(n, 1, ph, pw)
    blocks = net.blocks()
    scale_list = list(scale_list)
    if arch in _NO_ENCODER:
        flow, mask, warped0, warped1 = _forward_noenc(net, img0, img1, tmap, scale_list, ensemble)
        merged = _merge(warped0, warped1, mask)
        if not fastmode and arch in _PLAIN:
            merged = _refine(net, img0, img1, warped0, warped1, mask, flow, merged)
        return merged[:, :, :h, :w].permute(0, 2, 3, 1)

    # one batched encoder call for both frames
    both = net.encode(torch.cat([img0[:, :3], img1[:, :3]], 0))
    f0, f1 = both[:n], both[n:]
    if arch == "4.26":
        return _forward_426(blocks, img0, img1, f0, f1, tmap, scale_list, h, w)

    # ---- stage 0 -----------------------------------------------------------
    flow, mask, _ = _if_block(blocks[0], [img0[:, :3], img1[:, :3], f0, f1, tmap], None, scale_list[0])
    if ensemble:
        fr, mr, _ = _if_block(
            blocks[0], [img1[:, :3], img0[:, :3], f1, f0, 1 - tmap], None, scale_list[0]
        )
        flow = (flow + _swap_flow(fr)) / 2
        mask = (mask + (-mr)) / 2
    # stage 1's feature warp uses this same flow: fused into the image warp
    warped0, wf0, warped1, wf1 = _warp_both_pairs(img0, f0, img1, f1, flow)

    # ---- stages 1..3 -------------------------------------------------------
    for i in range(1, 4):
        x = [warped0[:, :3], warped1[:, :3], wf0, wf1, tmap, mask]
        fd, m0, _ = _if_block(blocks[i], x, flow, scale_list[i])
        # reference quirk (rife_arch.py:645,672-692): the flow is updated with
        # the un-averaged fd BEFORE the ensemble pass, which then warps and
        # receives the updated flow; only the mask is ensemble-averaged.
        new_flow = flow + fd
        if ensemble or i < 3:
            new_w0, wf0n, new_w1, wf1n = _warp_both_pairs(img0, f0, img1, f1, new_flow)
        else:  # last stage, no ensemble: the features are not used again
            new_w0, new_w1 = _warp_both(img0, img1, new_flow)
            wf0n = wf1n = None
        if ensemble:
            xr = [warped1[:, :3], warped0[:, :3], wf1n, wf0n, 1 - tmap, -mask]
            _, mr, _ = _if_block(blocks[i], xr, _swap_flow(new_flow), scale_list[i])
            mask = (m0 + (-mr)) / 2
        else:
            mask = m0
        flow, warped0, warped1, wf0, wf1 = new_flow, new_w0, new_w1, wf0n, wf1n

    return _merge(warped0, warped1, mask)[:, :, :h, :w].permute(0, 2, 3, 1)


def _merge(warped0, warped1, mask) -> torch.Tensor:
    mask = sigmoid(mask)
    return warped0 * mask + warped1 * (1 - mask)


def _needs_rescue(fd1: torch.Tensor) -> bool:
    """Arch 4.0's rescue flag (rife_arch.py:598-626): stage 1's flow update
    exceeds 32 pixels in both directions, each reduced over the whole batch,
    as the JAX ``lax.cond`` predicate is. One host sync per forward."""
    big = (fd1[:, :2].abs().amax() > 32) & (fd1[:, 2:4].abs().amax() > 32)
    return bool(big.item())


def _forward_noenc(net: IFNet, img0, img1, tmap, scale_list, ensemble):
    """The archs without an encoder (4.0-4.6; the JAX ``apply``'s branches for
    them, its ``rife.py:262-302,337-380``): the ensemble pass averages both
    the flow update and the mask update at every stage, and the mask
    accumulates. Arch 4.0 restarts from block 0 with doubled scales when
    :func:`_needs_rescue` says so: the restart runs stage 0 and block 1
    without the ensemble pass, and stage 1's ensemble averaging then runs on
    the restarted state. Returns (flow, pre-sigmoid mask, warped0, warped1)."""
    blocks = net.blocks()

    def head(scales, ens):
        flow, mask, _ = _if_block(blocks[0], [img0, img1, tmap], None, scales[0])
        if ens:
            fr, mr, _ = _if_block(blocks[0], [img1, img0, 1 - tmap], None, scales[0])
            flow = (flow + _swap_flow(fr)) / 2
            mask = (mask + (-mr)) / 2
        w0, w1 = _warp_both(img0, img1, flow)
        fd, m0, _ = _if_block(blocks[1], [w0, w1, tmap, mask], flow, scales[1])
        return flow, mask, w0, w1, fd, m0

    scales = list(scale_list)
    flow, mask, w0, w1, fd, m0 = head(scales, ensemble)
    if net.arch_ver == "4.0" and _needs_rescue(fd):
        scales = [s * 2 for s in scales]
        flow, mask, w0, w1, fd, m0 = head(scales, False)
    for i in range(1, 4):
        if i > 1:
            fd, m0, _ = _if_block(blocks[i], [w0, w1, tmap, mask], flow, scales[i])
        if ensemble:
            fr, mr, _ = _if_block(blocks[i], [w1, w0, 1 - tmap, -mask], _swap_flow(flow), scales[i])
            fd = (fd + _swap_flow(fr)) / 2
            m0 = (m0 + (-mr)) / 2
        flow = flow + fd
        mask = mask + m0
        w0, w1 = _warp_both(img0, img1, flow)
    return flow, mask, w0, w1


def _refine(net: IFNet, img0, img1, warped0, warped1, raw_mask, flow, merged) -> torch.Tensor:
    """The ``fastmode=False`` refinement of 4.0-4.3 (rife_arch.py:725-730):
    both frames' Contextnet features in one batch (one warp per level for
    both), the Unet on the pre-sigmoid mask, its residual added and clamped."""
    n = img0.shape[0]
    x = torch.cat([img0, img1], 0).contiguous(memory_format=torch.channels_last)
    ctx = net.contextnet(x, torch.cat([flow[:, :2], flow[:, 2:4]], 0))
    c0, c1 = [c[:n] for c in ctx], [c[n:] for c in ctx]
    tmp = net.unet(img0, img1, warped0, warped1, raw_mask, flow, c0, c1)
    return (merged + (tmp[:, :3] * 2 - 1)).clamp(0.0, 1.0)


def _forward_426(blocks, img0, img1, f0, f1, tmap, scale_list, h, w) -> torch.Tensor:
    """4.26 path (rife_arch.py:512-587,708-711): 5 blocks, feature threading."""
    flow, mask, feat = _if_block(blocks[0], [img0[:, :3], img1[:, :3], f0, f1, tmap], None, scale_list[0])
    warped0, wf0, warped1, wf1 = _warp_both_pairs(img0, f0, img1, f1, flow)
    for i in range(1, 5):
        x = [warped0[:, :3], warped1[:, :3], wf0, wf1, tmap, mask, feat]
        fd, mask, feat = _if_block(blocks[i], x, flow, scale_list[i])
        flow = flow + fd
        if i < 4:
            warped0, wf0, warped1, wf1 = _warp_both_pairs(img0, f0, img1, f1, flow)
        else:
            warped0, warped1 = _warp_both(img0, img1, flow)
    return _merge(warped0, warped1, mask)[:, :, :h, :w].permute(0, 2, 3, 1)


def default_scale_list(arch_ver: str, scale_factor: float = 1.0) -> List[float]:
    """reference rife/__init__.py:156-160."""
    if arch_ver == "4.26":
        return [s / scale_factor for s in (16, 8, 4, 2, 1)]
    return [s / scale_factor for s in (8, 4, 2, 1)]


def warps_per_forward(
    arch_ver: str, fastmode: bool = True, ensemble: bool = False, rescued: bool = False,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, int]:
    """Warp launches of one :func:`apply` on the card by kernel, ``{"narrow":
    K1, "wide": the wide-channel kernel}``, as ``warp_kernel.route`` sends
    each warp's ``channels_last`` tensor: one warp of both frames per stage
    (with the encoder features from 4.7 on, but for the last stage's without
    ensemble), one more for 4.0's restart when ``rescued``, and for 4.0-4.3
    with ``fastmode=False`` one per Contextnet level (C = 16 to 128)."""
    _check_arch(arch_ver)
    if arch_ver == "4.26":
        ensemble = False  # as make_model_fn
    if arch_ver in _NO_ENCODER:
        channels = [3] * (5 if rescued and arch_ver == "4.0" else 4)
        if not fastmode and arch_ver in _PLAIN:
            channels += [_CONTEXT_C * 2**k for k in range(4)]
    else:
        stages = 5 if arch_ver == "4.26" else 4
        pair = 3 + _FEATURE_C[arch_ver]
        channels = [pair] * (stages - 1) + [pair if ensemble else 3]
    return route_counts(channels, dtype)


def make_model_fn(
    params: Dict[str, torch.Tensor],
    arch_ver: str,
    scale_factor: float = 1.0,
    fastmode: bool = True,
    ensemble: bool = False,
    dtype: torch.dtype = torch.float32,
    device="cuda",
):
    """The batched model callable for the plan executor:
    ``model_fn(f0, f1, t) -> mid``, NHWC frames in, float32 NHWC out.

    ``params`` is a state dict with the reference's keys; it is cast to
    ``dtype`` and moved to ``device`` once, loaded with ``strict=True``.
    ``fastmode=False`` selects the Contextnet/Unet refinement of arch 4.0-4.3;
    the other archs ignore it, as the reference does."""
    _check_arch(arch_ver)
    if arch_ver == "4.26":
        ensemble = False  # reference rife/__init__.py:123-125
    scale_list = default_scale_list(arch_ver, scale_factor)
    with torch.device("meta"):
        net = IFNet(arch_ver)
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    net = net.to(device=device, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        out = apply(
            net,
            f0.to(device=device, dtype=dtype),
            f1.to(device=device, dtype=dtype),
            t.to(device=device, dtype=dtype),
            scale_list,
            ensemble=ensemble,
            fastmode=fastmode,
        )
        return out.clamp(0.0, 1.0).float()

    return model_fn


def init_params(seed: int = 0, arch_ver: str = "4.7") -> Dict[str, torch.Tensor]:
    """Random state dict with the reference's shapes, drawn from
    ``numpy.random.default_rng(seed)`` in ``state_dict`` key order: conv and
    transposed-conv weights and biases uniform in ``+-1/sqrt(fan_in)`` (as the
    JAX ``init_params``; fan_in from every weight dim after the first),
    ``beta`` ones, PReLU weights (4.0) the constant :data:`PRELU_INIT`. JAX's
    ``init_params`` draws only 4.7, 4.17 and 4.26; this one draws every arch."""
    _check_arch(arch_ver)
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        net = IFNet(arch_ver)
    prelu = {f"{name}.weight" for name, m in net.named_modules() if isinstance(m, nn.PReLU)}
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    params = {}
    for key, shape in shapes.items():
        if key.endswith(".beta"):
            params[key] = torch.ones(shape)
        elif key in prelu:
            params[key] = torch.full(shape, PRELU_INIT)
        else:
            wshape = shapes[key.rsplit(".", 1)[0] + ".weight"]
            bound = 1.0 / np.sqrt(int(np.prod(wshape[1:])))
            params[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return params
