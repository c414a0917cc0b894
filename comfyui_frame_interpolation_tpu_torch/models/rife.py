"""RIFE IFNet, PyTorch port of the JAX package's ``models/rife.py``
(reference ``vfi_models/rife/rife_arch.py``) for arch 4.6 (``rife46``, which
GMFSS Fortuna's union variant runs inside its fusion head), 4.7 (``rife47``,
``rife49``), 4.17 (``rife417``) and 4.26 (``rife426``).

Coarse-to-fine intermediate-flow estimation: 4 (5 for 4.26) ``IFBlock`` stages
on a static scale pyramid, each refining a 4-channel bidirectional flow and a
blend mask with stride-4 conv encoders, 8 residual convs and a transposed-conv
+ pixel-shuffle head (``rife_arch.py:177-276``); both frames and their encoder
features are backward-warped at every stage (``ops.warp``, the Hopper kernel on
the card) and blended by the sigmoid mask (``rife_arch.py:707-723``). Arch
4.6 has no encoder: its blocks see the images, the timestep and (after stage
0) the mask and flow, the ensemble averages flow and mask at every stage, and
the mask accumulates across stages (:func:`_forward_46`).

Modules hold the parameters, with ``state_dict`` keys equal to the reference
checkpoints' and to the JAX parameter tree flattened with ``.``
(``block0.conv0.0.0.weight``, ``block0.convblock.3.beta``, ``encode.1.weight``).
:func:`apply` is the forward, with NHWC frames in and out as in the JAX
package; inside, tensors are NCHW in ``channels_last`` memory.

Arch 4.0-4.5 and 4.10 (PReLU, ContextNet/UNet refinement and the 4.0
scale-doubling rescue) are not ported yet: ``ROADMAP.md`` Queue 1, item 6.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.warp import warp
from .common import cast_params, leaky_relu, pixel_shuffle, resize_by_scale, sigmoid

__all__ = [
    "ARCH_VERSIONS",
    "CKPT_NAME_VER_DICT",
    "IFBlock",
    "IFNet",
    "apply",
    "default_scale_list",
    "init_params",
    "make_model_fn",
]

ARCH_VERSIONS = ("4.6", "4.7", "4.17", "4.26")

# ckpt -> arch version (reference rife/__init__.py:10-20)
CKPT_NAME_VER_DICT = {
    "rife47.pth": "4.7",
    "rife49.pth": "4.7",
    "rife417.pth": "4.17",
    "rife426.pth": "4.26",
    "sudo_rife4_269.662_testV1_scale1.pth": "4.0",
}

# per arch: (in_planes, width) of each IFBlock, the head's output multiple,
# and the encoder: None (4.6 has none), "4.7" (its two-layer encoder) or the
# (hidden, output) widths of a ``Head``
_ARCH = {
    "4.6": (((7, 192), (12, 128), (12, 96), (12, 64)), 6, None),
    "4.7": (((15, 192), (20, 128), (20, 96), (20, 64)), 6, "4.7"),
    "4.17": (((23, 192), (28, 128), (28, 96), (28, 64)), 6, (32, 8)),
    "4.26": (((15, 192), (28, 128), (28, 96), (28, 64), (28, 32)), 13, (16, 4)),
}


def _check_arch(arch_ver: str) -> None:
    if arch_ver not in ARCH_VERSIONS:
        raise NotImplementedError(
            f"RIFE arch {arch_ver} is not ported yet (ported: {', '.join(ARCH_VERSIONS)}); "
            "see ROADMAP.md Queue 1, item 6"
        )


def _conv(i: int, o: int, stride: int) -> nn.Sequential:
    """reference ``conv()``: Conv2d(3x3) + LeakyReLU(0.2)."""
    return nn.Sequential(nn.Conv2d(i, o, 3, stride, 1), nn.LeakyReLU(0.2))


class ResConv(nn.Module):
    """``ResConv`` (rife_arch.py:20-28): lrelu(conv(x) * beta + x)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, 1, 1)
        self.beta = nn.Parameter(torch.ones(1, c, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.conv(x) * self.beta + x, 0.2)


class IFBlock(nn.Module):
    """``IFBlock`` (rife_arch.py:177-276) of arch >= 4.5; ``forward`` runs the
    convolutions at the block's working resolution, :func:`_if_block` the
    resizes around them."""

    def __init__(self, in_planes: int, c: int, out_mult: int):
        super().__init__()
        self.conv0 = nn.Sequential(_conv(in_planes, c // 2, 2), _conv(c // 2, c, 2))
        self.convblock = nn.Sequential(*[ResConv(c) for _ in range(8)])
        self.lastconv = nn.Sequential(nn.ConvTranspose2d(c, 4 * out_mult, 4, 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.convblock(self.conv0(x))
        return pixel_shuffle(self.lastconv(feat), 2)


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


class IFNet(nn.Module):
    """Parameter tree of one arch version; :func:`apply` runs it."""

    def __init__(self, arch_ver: str = "4.7"):
        super().__init__()
        _check_arch(arch_ver)
        self.arch_ver = arch_ver
        blocks, out_mult, head = _ARCH[arch_ver]
        for i, (in_planes, c) in enumerate(blocks):
            self.add_module(f"block{i}", IFBlock(in_planes, c, out_mult))
        self.num_blocks = len(blocks)
        if head == "4.7":  # rife_arch.py:356-360
            self.encode = nn.Sequential(
                nn.Conv2d(3, 16, 3, 2, 1), nn.ConvTranspose2d(16, 4, 4, 2, 1)
            )
        elif head is not None:
            self.encode = Head(*head)

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
    tmp = resize_by_scale(block(torch.cat(x, 1)), scale)
    return tmp[:, :4] * scale, tmp[:, 4:5], tmp[:, 5:]


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
    """Both directions' image and encoder-feature warps in one 7-channel call
    (warping is per channel, so concatenating the planes is exact)."""
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
) -> torch.Tensor:
    """``IFNet.forward`` (rife_arch.py:465-732), inference semantics, on NHWC
    frames ``[N, H, W, 3]``; ``timestep`` is a scalar or an ``[N]`` vector."""
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
    if arch == "4.6":
        return _forward_46(blocks, img0, img1, tmap, scale_list, ensemble, h, w)

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

    mask = sigmoid(mask)
    merged = warped0 * mask + warped1 * (1 - mask)
    return merged[:, :, :h, :w].permute(0, 2, 3, 1)


def _forward_46(blocks, img0, img1, tmap, scale_list, ensemble, h, w) -> torch.Tensor:
    """4.6 path (the JAX ``apply``'s branch for arch <= 4.6, its
    ``rife.py:262-302``): no encoder; the ensemble pass averages both the flow
    update and the mask update at every stage, and the mask accumulates."""
    flow, mask, _ = _if_block(blocks[0], [img0, img1, tmap], None, scale_list[0])
    if ensemble:
        fr, mr, _ = _if_block(blocks[0], [img1, img0, 1 - tmap], None, scale_list[0])
        flow = (flow + _swap_flow(fr)) / 2
        mask = (mask + (-mr)) / 2
    warped0, warped1 = _warp_both(img0, img1, flow)
    for i in range(1, 4):
        fd, m0, _ = _if_block(blocks[i], [warped0, warped1, tmap, mask], flow, scale_list[i])
        if ensemble:
            fr, mr, _ = _if_block(blocks[i], [warped1, warped0, 1 - tmap, -mask], _swap_flow(flow), scale_list[i])
            fd = (fd + _swap_flow(fr)) / 2
            m0 = (m0 + (-mr)) / 2
        flow = flow + fd
        mask = mask + m0
        warped0, warped1 = _warp_both(img0, img1, flow)
    mask = sigmoid(mask)
    merged = warped0 * mask + warped1 * (1 - mask)
    return merged[:, :, :h, :w].permute(0, 2, 3, 1)


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
    mask = sigmoid(mask)
    merged = warped0 * mask + warped1 * (1 - mask)
    return merged[:, :, :h, :w].permute(0, 2, 3, 1)


def default_scale_list(arch_ver: str, scale_factor: float = 1.0) -> List[float]:
    """reference rife/__init__.py:156-160."""
    if arch_ver == "4.26":
        return [s / scale_factor for s in (16, 8, 4, 2, 1)]
    return [s / scale_factor for s in (8, 4, 2, 1)]


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
    ``fastmode`` selects the ContextNet/UNet refinement of arch <= 4.3 only,
    which is not ported; the ported archs (4.6 included) ignore it, as the
    reference does."""
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
        )
        return out.clamp(0.0, 1.0).float()

    return model_fn


def init_params(seed: int = 0, arch_ver: str = "4.7") -> Dict[str, torch.Tensor]:
    """Random state dict with the reference's shapes, drawn from
    ``numpy.random.default_rng(seed)`` in ``state_dict`` key order: conv and
    transposed-conv weights and biases uniform in ``+-1/sqrt(fan_in)`` (as the
    JAX ``init_params``), ``beta`` ones."""
    _check_arch(arch_ver)
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in IFNet(arch_ver).state_dict().items()}
    params = {}
    for key, shape in shapes.items():
        if key.endswith(".beta"):
            params[key] = torch.ones(shape)
            continue
        # OIHW conv and IOHW transposed-conv weights: fan_in = dims 1..3
        wshape = shapes[key.rsplit(".", 1)[0] + ".weight"]
        bound = 1.0 / np.sqrt(wshape[1] * wshape[2] * wshape[3])
        params[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return params
