"""MoMo, diffusion-based motion modeling for video frame interpolation,
PyTorch port of the JAX package's ``models/momo.py`` (reference
``vfi_models/momo/{momo.py, unet.py, synthesis.py, flow.py}``).

A ``ConvexUpUNet2DModel`` (8x8 patch stems for the frames and the flow
latent, a first block, a nested diffusers ``UNet2DModel`` core and a mask
head driving RAFT-style x8 convex upsampling, ``unet.py:130-386``) denoises
a 4-channel bidirectional-flow latent under a DDPM scheduler (sample
prediction, trailing spacing, linear betas, clip to +-1, ``momo.py:53-60``;
the scheduler's arithmetic in float64 on the host, as in JAX). The
``SynthesisNet`` renders the frame from the flows: a coarse-to-fine loop of
bicubic backward warps (zeros padding at ``x + u - 0.5``, ``flow.py:64-94``),
a small UNet blender and a sigmoid blend with a residual
(``synthesis.py:89-129``). Every resize is torch bicubic, antialiased on the
pyramid.

Precision: under bf16 the latents, the scheduler's arithmetic, the convex
upsampling, the flows (``latents * FLOW_SCALER``), the frames' mean and std
and every sampling grid stay f32; the UNets and the synthesis convolutions
run in the model dtype. Each GroupNorm (with the SiLU after it) takes its
statistics and its affine in f32 on the ``channels_last`` memory.

Noise: ``apply`` draws the initial latent and then one noise per step, f32
at the latent shape of the whole batch, ``[total, 4, h, w]``, from the
``generator`` it is given (``make_model_fn``:
``torch.Generator(device).manual_seed(seed)`` at every call), and keeps its
own samples (``batch_slice``: a data shard of ``parallel``'s split holds
samples ``start`` to ``start + b`` of ``total``), so that a seed gives one
device's frames on any mesh; ``init_latents``/``step_noises`` replace the
draws, so that the port and JAX run on the same noise. Torch cannot draw
JAX's bits: for one seed the port's frames differ from the JAX node's.

Row bands (``parallel.space``) go through the functions that need more rows
than their own by handing them over (``handle_torch_function``): the
GroupNorm, the replicate pad, the x8 convex upsampling, the frames' mean and
std, the bicubic backwarp, ``common.resize_bicubic`` and the noise, drawn
whole and cut into the frames' bands (:func:`_as_frame`).

Tensors are NCHW in ``channels_last`` memory; frames are NHWC at the API.
No hand kernel runs here: every layer is a cuDNN convolution or plain
PyTorch, and the sampler is ``grid_sample`` (``ops.warp.bicubic_sample``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ..ops.warp import bicubic_sample
from .common import cast_params, channels_last_params, conv2d, init_state_dict, linear, resize_bicubic, resize_by_scale

__all__ = ["CKPT_NAMES", "DDPM", "MoMo", "apply", "init_params", "make_model_fn"]

CKPT_NAMES = ["momo-base.pth", "momo-lite.pth"]

DIMS = {"momo-base.pth": (256, 256, 512), "momo-lite.pth": (96, 160)}
FLOW_SCALER = 128.0
T_TRAIN = 1000
LATENT_DIM = 32  # SynthesisNet's
PAD_MULTIPLE = 64
GROUPS = 32


def _group_norm_silu(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """SiLU of GroupNorm(32) of NCHW ``channels_last`` ``x`` (JAX ``_silu``
    of ``_group_norm``), on the NHWC view of its memory: the statistics and
    the affine in f32, rounded once to ``x``'s dtype; the result is
    ``channels_last``. (``F.group_norm`` copies such input to NCHW and back
    on the card, and reduces it with one block per sample and group: 32
    blocks at batch 1.) Row bands go to their own rule (the statistics from
    the bands' partial sums, then :func:`group_affine_silu` band by band)."""
    if has_torch_function((x,)):
        return handle_torch_function(_group_norm_silu, (x,), x, gn)
    var, mean = torch.var_mean(group_view(x).float(), dim=(1, 3), correction=0, keepdim=True)
    return group_affine_silu(x, gn, mean, var)


def group_view(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``channels_last`` ``x`` as ``[n, h * w, GROUPS, c / GROUPS]``."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, GROUPS, c // GROUPS)


def group_affine_silu(x: torch.Tensor, gn: nn.GroupNorm, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """:func:`_group_norm_silu` of ``x`` by the f32 statistics ``mean`` and
    ``var`` (``[n, 1, GROUPS, 1]``), which may be those of a whole frame
    that ``x`` is a band of."""
    n, c, h, w = x.shape
    scale = gn.weight.float().view(GROUPS, -1) * torch.rsqrt(var + gn.eps)
    y = torch.addcmul(gn.bias.float().view(GROUPS, -1) - mean * scale, group_view(x), scale)
    return F.silu(y, inplace=True).to(x.dtype).reshape(n, h, w, c).permute(0, 3, 1, 2)


def _replicate_pad1(x: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` edge-padded by one pixel on each side, written into a
    ``channels_last`` tensor, so that the convolution after it reads it
    without a layout copy (as ``cain._reflect_pad1`` does for its pad). Row
    bands go to their own rule (a halo row from each neighbour, the edge
    replicated at the frame's top and bottom only)."""
    if has_torch_function((x,)):
        return handle_torch_function(_replicate_pad1, (x,), x)
    n, c, h, w = x.shape
    out = torch.empty((n, c, h + 2, w + 2), dtype=x.dtype, device=x.device, memory_format=torch.channels_last)
    out[:, :, 1 : h + 1, 1 : w + 1] = x
    out[:, :, 0, 1 : w + 1] = x[:, :, 0]
    out[:, :, h + 1, 1 : w + 1] = x[:, :, h - 1]
    out[:, :, :, 0] = out[:, :, :, 1]
    out[:, :, :, w + 1] = out[:, :, :, w]
    return out


def _conv_repl(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``Conv2d(padding=1, padding_mode="replicate")`` (JAX ``_conv_repl``)."""
    return conv2d(_replicate_pad1(x), conv.weight, conv.bias, stride=stride)


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    return conv2d(x, conv.weight, conv.bias, stride=stride, padding=padding)



# ------------------------------------------------------------------ scheduler


class DDPM:
    """diffusers ``DDPMScheduler`` (linear betas, sample prediction, trailing
    spacing, fixed_small variance, clip_sample range 1): the coefficients in
    float64 numpy on the host (JAX ``momo.py:87-123``), the update in the
    latents' dtype."""

    def __init__(self, num_train_timesteps: int = T_TRAIN, beta_start: float = 1e-4, beta_end: float = 0.02):
        self.T = num_train_timesteps
        betas = np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        step_ratio = self.T / num_inference_steps
        return np.round(np.arange(self.T, 0, -step_ratio)).astype(np.int64) - 1

    def step(self, model_output: torch.Tensor, t: int, sample: torch.Tensor, num_inference_steps: int,
             noise: torch.Tensor) -> torch.Tensor:
        prev_t = t - self.T // num_inference_steps
        acp_t = self.alphas_cumprod[t]
        acp_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else 1.0
        beta_prod_t = 1.0 - acp_t
        beta_prod_prev = 1.0 - acp_prev
        current_alpha = acp_t / acp_prev
        current_beta = 1.0 - current_alpha
        coeff_x0 = float(acp_prev**0.5 * current_beta / beta_prod_t)
        coeff_xt = float(current_alpha**0.5 * beta_prod_prev / beta_prod_t)
        prev = coeff_x0 * model_output.clamp(-1.0, 1.0) + coeff_xt * sample
        if t > 0:
            var = max(beta_prod_prev / beta_prod_t * current_beta, 1e-20)
            prev = prev + float(var**0.5) * noise
        return prev


# ------------------------------------------------------------------ denoiser


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` (flip_sin_to_cos, shift 0): cos
    first, then sin, in f32."""
    half = dim // 2
    freqs = torch.from_numpy(np.exp(-math.log(10000.0) * np.arange(half, dtype=np.float64) / half).astype(np.float32))
    args = t.float()[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class _TimeEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(dim, 4 * dim)
        self.linear_2 = nn.Linear(4 * dim, 4 * dim)
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = _timestep_embedding(t, self.dim).to(self.linear_1.weight.dtype)
        return linear(F.silu(linear(emb, self.linear_1.weight, self.linear_1.bias)), self.linear_2.weight, self.linear_2.bias)


class _Resnet(nn.Module):
    """diffusers ``ResnetBlock2D`` (pre-norm, the time embedding added after
    the first convolution; JAX ``_resnet_block``)."""

    def __init__(self, cin: int, cout: int, temb: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(GROUPS, cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(GROUPS, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv1, _group_norm_silu(x, self.norm1))
        h = h + linear(F.silu(temb), self.time_emb_proj.weight, self.time_emb_proj.bias)[:, :, None, None]
        h = _conv(self.conv2, _group_norm_silu(h, self.norm2))
        if hasattr(self, "conv_shortcut"):
            x = _conv(self.conv_shortcut, x, padding=0)
        return x + h


class _Resnets(nn.Module):
    def __init__(self, specs: Sequence[tuple]):
        super().__init__()
        self.resnets = nn.ModuleList(_Resnet(*s) for s in specs)


class _ConvHolder(nn.Module):
    """A module that holds one ``conv`` (diffusers' ``Downsample2D`` /
    ``Upsample2D``)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)


class _UNet2DCore(nn.Module):
    """diffusers ``UNet2DModel`` with ``DownBlock2D``/``UpBlock2D`` only, two
    layers a block (JAX ``_unet2d_core``)."""

    def __init__(self, cin: int, cout: int, boc: Sequence[int]):
        super().__init__()
        temb = 4 * boc[0]
        n = len(boc)
        self.time_embedding = _TimeEmbed(boc[0])
        self.conv_in = nn.Conv2d(cin, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            blk = _Resnets([(boc[i - 1] if i > 0 else boc[0], boc[i], temb), (boc[i], boc[i], temb)])
            if i != n - 1:
                blk.downsamplers = nn.ModuleList([_ConvHolder(boc[i])])
            self.down_blocks.append(blk)
        self.mid_block = _Resnets([(boc[-1], boc[-1], temb)] * 2)
        rboc = boc[::-1]
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            out_c, prev_c, in_c = rboc[i], boc[-1] if i == 0 else rboc[i - 1], rboc[min(i + 1, n - 1)]
            blk = _Resnets([((prev_c if j == 0 else out_c) + (in_c if j == 2 else out_c), out_c, temb) for j in range(3)])
            if i != n - 1:
                blk.upsamplers = nn.ModuleList([_ConvHolder(out_c)])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(GROUPS, boc[0])
        self.conv_out = nn.Conv2d(boc[0], cout, 3, padding=1)

    def forward(self, sample: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        temb = self.time_embedding(t)
        x = _conv(self.conv_in, sample)
        skips = [x]
        for blk in self.down_blocks:
            for r in blk.resnets:
                x = r(x, temb)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = _conv(blk.downsamplers[0].conv, x, stride=2)
                skips.append(x)
        for r in self.mid_block.resnets:
            x = r(x, temb)
        for blk in self.up_blocks:
            for r in blk.resnets:
                x = r(torch.cat([x, skips.pop()], 1), temb)
            if hasattr(blk, "upsamplers"):
                x = _conv(blk.upsamplers[0].conv, resize_by_scale(x, 2, mode="nearest"))
        return _conv(self.conv_out, _group_norm_silu(x, self.conv_norm_out))


def _convex_upsampling8(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RAFT-style x8 convex upsampling of the 4-channel flow (``unet.py:239-249``,
    JAX ``_convex_upsampling8_impl``), in f32, on NCHW tensors.

    The mask's channel ``f*576 + k*64 + p`` weighs tap ``k`` (of the 3x3
    neighbourhood, zero-padded) of flow pair ``f`` for sub-pixel ``p = ky*8 +
    kx``; the softmax runs over the 9 taps; output channel ``f*2 + c`` at
    ``(h*8 + ky, w*8 + kx)``, times 8. Row bands go to their own rule (a halo
    row from each neighbour, :func:`convex_upsampling8_rows`)."""
    if has_torch_function((flow, mask)):
        return handle_torch_function(_convex_upsampling8, (flow, mask), flow, mask)
    return convex_upsampling8_rows(F.pad(flow, (0, 0, 1, 1)), mask)


def convex_upsampling8_rows(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`_convex_upsampling8` of the rows of ``mask``: ``flow`` holds
    them and one more above and below (zeros beyond the frame)."""
    b, _, h, w = mask.shape
    m = torch.softmax(mask.permute(0, 2, 3, 1).float().reshape(b, h, w, 2, 9, 64), dim=4)
    padded = F.pad(flow.permute(0, 2, 3, 1).float(), (0, 0, 1, 1))
    taps = torch.stack([padded[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)], 3)
    up = torch.einsum("bhwfkp,bhwkfc->bhwfcp", m, taps.reshape(b, h, w, 9, 2, 2))
    up = up.reshape(b, h, w, 2, 2, 8, 8).permute(0, 1, 5, 2, 6, 3, 4).reshape(b, h * 8, w * 8, 4)
    return (up * 8.0).permute(0, 3, 1, 2)


class ConvexUpUNet(nn.Module):
    """``ConvexUpUNet2DModel`` (unet.py:87-330; JAX ``_convex_up_unet``):
    block widths ``dims``, 3 image channels, a 4-channel latent."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        d0 = dims[0]
        temb = 4 * d0
        hidden = -(-(4 + d0) // GROUPS) * GROUPS  # UpMaskBlock2D's hidden_dim (unet.py:325)
        self.dims = tuple(dims)
        self.time_embedding = _TimeEmbed(d0)
        self.down_patch = nn.ModuleList([nn.Conv2d(3, d0 // 2, 8, stride=8)])
        self.down_latent = nn.ModuleList([nn.Conv2d(4, d0, 8, stride=8)])
        self.proj_inputs = nn.Conv2d(2 * d0, d0, 1)
        self.first_block = _Resnets([(d0, d0, temb)] * 2)
        self.mid_model = _UNet2DCore(d0, 4, dims[1:])
        self.out_up = _Resnets([(hidden, d0, temb), (2 * d0, d0, temb), (2 * d0, d0, temb)])
        self.out_up.proj_out = nn.ModuleList([nn.GroupNorm(GROUPS, d0, eps=1e-6), nn.SiLU(), nn.Conv2d(d0, 2 * 9 * 64, 3, padding=1)])
        if hidden != 4 + d0:
            self.out_up.proj_in = nn.Conv2d(4 + d0, hidden, 3, padding=1)

    def encode_frames(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """The frames' 8x8 patch features side by side, ``[b, d0, h/8, w/8]``:
        the same at every denoising step, so :func:`apply` makes them once."""
        d = F.silu(_conv(self.down_patch[0], torch.cat([x0, x1], 0), stride=8, padding=0))
        b = x0.shape[0]
        return torch.cat([d[:b], d[b:]], 1)

    def denoise(self, latents: torch.Tensor, frame_feats: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """One denoising pass: the predicted latent (f32) from ``latents`` in
        the model dtype, the frames' patch features and the ``[b]`` timesteps."""
        temb = self.time_embedding(t)
        dl = F.silu(_conv(self.down_latent[0], latents, stride=8, padding=0))
        sample = _conv(self.proj_inputs, torch.cat([frame_feats, dl], 1), padding=0)
        skips = [sample]
        for r in self.first_block.resnets:
            sample = r(sample, temb)
            skips.append(sample)
        mid = self.mid_model(sample, t)
        up = self.out_up
        h = mid
        for i, r in enumerate(up.resnets):  # UpMaskBlock2D (unet.py:333-386)
            h = torch.cat([h, skips.pop()], 1)
            if i == 0 and hasattr(up, "proj_in"):
                h = _conv(up.proj_in, h)
            h = r(h, temb)
        mask = _conv(up.proj_out[2], _group_norm_silu(h, up.proj_out[0]))
        return _convex_upsampling8(mid, mask)

    def forward(self, latents: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.denoise(latents, self.encode_frames(x0, x1), t)


# ------------------------------------------------------------------ synthesis


def _backwarp(img: torch.Tensor, flow: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """``flow.py`` BackWarp as ``SynthesisNet`` sets it (bicubic, normalized
    by ``w``, ``align_corners=False``): bicubic sampling of NCHW ``img`` at
    ``x + u - 0.5``, zeros padding, the grid in f32 from an integer iota (JAX
    builds it in the flow's dtype). ``flow`` may hold only the rows from
    ``row0`` of ``img``'s frame (a band's). Row bands go to their own rule
    (``img`` gathered whole onto each band's device, the band's rows)."""
    if has_torch_function((img, flow)):
        return handle_torch_function(_backwarp, (img, flow), img, flow, row0)
    w, rows = img.shape[3], flow.shape[2]
    gx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    gy = torch.arange(row0, row0 + rows, dtype=torch.float32, device=img.device).view(1, rows, 1)
    sx = gx + flow[:, 0].float() - 0.5
    sy = gy + flow[:, 1].float() - 0.5
    return bicubic_sample(img.permute(0, 2, 3, 1), sx, sy, padding_mode="zeros").permute(0, 3, 1, 2)


class _Seq(nn.Module):
    """Convolutions at the indices of the reference's ``nn.Sequential``
    (activations between them hold no weights)."""

    def __init__(self, convs: Dict[int, tuple]):
        super().__init__()
        for i, (cin, cout) in convs.items():
            self.add_module(str(i), nn.Conv2d(cin, cout, 3, padding=1))

    def __getitem__(self, i: int) -> nn.Conv2d:
        return getattr(self, str(i))


class _DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = _Seq({0: (cin, cout), 2: (cout, cout)})


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.conv2 = nn.Conv2d(2 * cout, cout, 3, padding=1)


class _SynthUNet(nn.Module):
    """``synthesis.py`` UNet (two levels, GELU, replicate padding, bicubic
    upsampling; JAX ``_synth_unet``)."""

    def __init__(self, ld: int = LATENT_DIM):
        super().__init__()
        self.in_feats = _Seq({0: (4 + 3 + 2 * ld, 2 * ld), 2: (2 * ld, 2 * ld)})
        self.down_blocks = nn.ModuleList([_DownBlock(2 * ld, 4 * ld), _DownBlock(4 * ld, 8 * ld)])
        self.up_blocks = nn.ModuleList([_UpBlock(8 * ld, 4 * ld), _UpBlock(4 * ld, 2 * ld)])
        self.to_out = nn.Conv2d(2 * ld, 2 * ld, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(_conv_repl(self.in_feats[2], F.gelu(_conv_repl(self.in_feats[0], x))))
        mids = [h]
        for blk in self.down_blocks:
            h = F.gelu(_conv_repl(blk.block[0], mids[-1], stride=2))
            mids.append(F.gelu(_conv_repl(blk.block[2], h)))
        h = mids.pop()
        for blk in self.up_blocks:
            skip = mids.pop()
            h = F.gelu(_conv_repl(blk.conv1, resize_bicubic(h, tuple(skip.shape[-2:]))))
            h = F.gelu(_conv_repl(blk.conv2, torch.cat([h, skip], 1)))
        return _conv_repl(self.to_out, h)


class SynthesisNet(nn.Module):
    """``SynthesisNet(latent_dim=32)`` (synthesis.py:9-51): encoder, blender
    UNet, decoder."""

    def __init__(self, ld: int = LATENT_DIM):
        super().__init__()
        self.encoder = _Seq({0: (3, ld), 2: (ld, ld), 4: (ld, ld)})
        self.decoder = _Seq({1: (2 * ld, 2 * ld), 3: (2 * ld, 4)})
        self.blender = _SynthUNet(ld)


def _mean_std(frames6: torch.Tensor):
    """Per sample, the mean and the ``ddof=1`` std (plus 1e-8) of the
    flattened frames, f32, shaped ``[b, 1, 1, 1]``. Row bands go to their
    own rule (``std_mean`` over dimensions 1-3 from the bands' partial
    sums)."""
    if has_torch_function((frames6,)):
        return handle_torch_function(_mean_std, (frames6,), frames6)
    flat = frames6.float().reshape(frames6.shape[0], -1)
    std, mean = torch.std_mean(flat, dim=1, correction=1)
    return mean.view(-1, 1, 1, 1), (std + 1e-8).view(-1, 1, 1, 1)


def _synthesize(net: SynthesisNet, frames6: torch.Tensor, flows4: torch.Tensor) -> torch.Tensor:
    """``SynthesisNet.forward`` eval path (synthesis.py:89-129; JAX
    ``_synthesize``): ``frames6`` ``[b, 6, h, w]`` (frame 0, frame 1) in the
    model dtype, ``flows4`` ``[b, 4, h, w]`` f32; the frame, clipped to
    [0, 1], in f32."""
    b, _, h, w = frames6.shape
    dtype = frames6.dtype
    mean, std = _mean_std(frames6)
    xn = ((frames6.float() - mean) / std).to(dtype)
    x2 = torch.cat([xn[:, :3], xn[:, 3:]], 0)  # '(f b) c h w': frame-major batch
    fl2 = torch.cat([flows4[:, :2], flows4[:, 2:]], 0)
    n_lvls = int(np.ceil(np.log2(min(h, w) / 64))) + 1
    xt = None
    for i in range(n_lvls - 1, -1, -1):
        s = 1.0 / 2**i
        size = (int(h * s), int(w * s))
        x_lvl = resize_bicubic(x2, size, antialias=True)
        f_lvl = resize_bicubic(fl2, size, antialias=True) * s
        warped = _backwarp(x_lvl, f_lvl)
        w0, w1 = warped[:b], warped[b:]
        enc = _conv_repl(net.encoder[0], x_lvl)
        enc = _conv_repl(net.encoder[2], F.gelu(enc))
        enc = _conv_repl(net.encoder[4], F.gelu(enc))
        xt = (w0 + w1) / 2 if xt is None else resize_bicubic(xt, size, antialias=True)
        wf = _backwarp(enc, f_lvl)
        blend_in = torch.cat([xt, wf[:b], wf[b:], f_lvl[:b].to(dtype), f_lvl[b:].to(dtype)], 1)
        xt = net.blender(blend_in)
        dec = _conv_repl(net.decoder[1], F.gelu(xt))  # decode2rgb (synthesis.py:78-88)
        dec = _conv_repl(net.decoder[3], F.gelu(dec))
        blend = torch.sigmoid(dec[:, 3:4])
        xt = blend * w0 + (1 - blend) * w1 + dec[:, :3]
    return (xt.float() * std + mean).clamp(0.0, 1.0)


# ------------------------------------------------------------------ model


class MoMo(nn.Module):
    """The checkpoint's module tree: ``model.*`` (the denoiser) and
    ``synth_model.*``, as the reference ``MoMo(synth_model=...)`` holds them."""

    def __init__(self, ckpt_name: str = "momo-base.pth"):
        super().__init__()
        self.model = ConvexUpUNet(DIMS[ckpt_name])
        self.synth_model = SynthesisNet()


def _as_frame(noise: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """``noise`` (``[b, 4, h, w]``, drawn whole on ``frame``'s device) as
    ``frame`` holds its rows: itself for a plain frame; row bands go to
    their own rule, which cuts it into the frame's bands."""
    if has_torch_function((frame,)):
        return handle_torch_function(_as_frame, (frame,), noise, frame)
    return noise


def apply(
    net: MoMo,
    img0: torch.Tensor,
    img1: torch.Tensor,
    num_inference_steps: int = 8,
    generator: Optional[torch.Generator] = None,
    init_latents: Optional[torch.Tensor] = None,
    step_noises: Optional[List[torch.Tensor]] = None,
    batch_slice: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """``MoMo.forward`` eval path (momo.py:153-224; JAX ``apply``) on NCHW
    frames in the model dtype, padded to multiples of 64: the midpoint frame,
    f32 in [0, 1].

    The initial latent and each step's noise are f32 draws from
    ``generator`` (the device's default generator if None), in that order,
    unless ``init_latents`` / ``step_noises`` (NCHW, one per step) give
    them. Each draw is ``[total, 4, h, w]``, of which the frames are samples
    ``start`` to ``start + b`` (``batch_slice = (start, total)``; the whole
    draw, ``(0, b)``, by default): a data shard of a batch draws the whole
    batch's noise, as one device does."""
    b, _, h, w = img0.shape
    start, total = (0, b) if batch_slice is None else batch_slice
    if not 0 <= start <= total - b:
        raise ValueError(f"batch_slice {batch_slice} does not hold a batch of {b}")
    dtype = img0.dtype
    frames6 = torch.cat([img0, img1], 1)
    mean, std = _mean_std(frames6)
    xn = ((frames6.float() - mean) / std).to(dtype)

    def draw(given: Optional[torch.Tensor]) -> torch.Tensor:
        if given is None:
            given = torch.randn((total, 4, h, w), generator=generator, device=img0.device, dtype=torch.float32)[start : start + b]
        return _as_frame(given.to(device=img0.device, dtype=torch.float32).contiguous(memory_format=torch.channels_last), img0)

    scheduler = DDPM()
    latents = draw(init_latents)
    feats = net.model.encode_frames(xn[:, :3], xn[:, 3:])
    for i, t in enumerate(scheduler.timesteps(num_inference_steps)):
        t_vec = torch.full((b,), float(t), dtype=torch.float32, device=img0.device)
        pred = net.model.denoise(latents.to(dtype), feats, t_vec)
        noise = draw(None if step_noises is None else step_noises[i])
        latents = scheduler.step(pred, int(t), latents, num_inference_steps, noise)
    return _synthesize(net.synth_model, frames6, latents * FLOW_SCALER)


def _load(params: Dict[str, torch.Tensor], ckpt_name: str, dtype: torch.dtype, device) -> MoMo:
    with torch.device("meta"):
        net = MoMo(ckpt_name)
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(
    params: Dict[str, torch.Tensor], ckpt_name: str = "momo-base.pth", num_inference_steps: int = 8, seed: int = 0,
    dtype: torch.dtype = torch.float32, device="cuda",
):
    """The batched model callable for the plan executor: ``model_fn(f0, f1,
    t) -> mid`` (``t`` unused: MoMo makes the midpoint), NHWC frames in, cast
    to ``dtype``, edge-padded to multiples of 64, centred; each call draws
    its noise from ``torch.Generator(device).manual_seed(seed)``; the result
    cropped, clipped and float32 NHWC. ``batch_slice=(start, total)`` (given
    by ``parallel.make_sharded_model_fn`` to each data shard) says that the
    frames are samples ``start`` to ``start + b`` of a batch of ``total``:
    the noise is drawn for the whole batch and the shard keeps its own, so a
    seed gives one device's frames on any mesh."""
    net = _load(params, ckpt_name, dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor = None,
                 batch_slice: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        _, h, w, _ = f0.shape
        ph, pw = (-h) % PAD_MULTIPLE, (-w) % PAD_MULTIPLE
        top, left = ph // 2, pw // 2

        def pad(f):
            f = f.to(device=device, dtype=dtype).permute(0, 3, 1, 2)
            if ph or pw:
                f = F.pad(f, (left, pw - left, top, ph - top), mode="replicate")
            return f.contiguous(memory_format=torch.channels_last)

        generator = torch.Generator(device=device).manual_seed(seed)
        out = apply(net, pad(f0), pad(f1), num_inference_steps, generator=generator, batch_slice=batch_slice)
        return out[:, :, top : top + h, left : left + w].clamp(0.0, 1.0).permute(0, 2, 3, 1).float()

    return model_fn


def init_params(seed: int = 0, ckpt_name: str = "momo-base.pth") -> Dict[str, torch.Tensor]:
    """Random state dict with the shapes of JAX ``init_params(key,
    ckpt_name)`` (``momo-base.pth``: block widths 256, 256, 512;
    ``momo-lite.pth``: 96, 160; ``common.init_state_dict``: the GroupNorms at
    the identity). ``momo-*.pth`` has no manifest in the repo: the layout is
    the JAX tree's."""
    with torch.device("meta"):
        net = MoMo(ckpt_name)
    return init_state_dict(net, seed)
