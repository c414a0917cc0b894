"""ATM-VFI (base and lite), PyTorch port of the JAX package's ``models/atm.py``
(reference ``vfi_models/atm/{network_base,network_lite,attention}.py``).

A 4-level conv pyramid feeds a cross-scale feature fusion (dilated strided
convolutions, a 1x1 projection, a layer norm). Windowed attention-to-motion
blocks (``ATMFormer``: regular, then shifted by half a window) read both
flows out of their attention maps: the query is frame 0's window, key and
value the other frame's, and the motion is the attention-weighted relative
coordinates fed through a small head MLP. An optional coarse global-motion
pass (window 12 at 1/16; optionally run at three input scales and picked per
sample by a photometric loss) pre-aligns features and frames. Two Swin
``RefineBottleneck`` blocks enhance the features, a transposed-conv pyramid
takes motion and features to full resolution, and a U-Net head adds a
residual.

Tokens are NHWC tensors (``[B, H, W, C]``; a window batch ``[B * nW, N,
C]``), convolutions run on their NCHW views in ``channels_last`` memory. The
window masks and relative coordinates are numpy, built on the host once per
(shape, window, shift) and kept on the device. The attention scores, their
softmax, the motion contraction and the head MLP are f32 in every dtype,
cast once; the layer norms take their statistics in f32.

Warps (``ops.warp.warp``, zeros mode): under global motion, both frames'
fused features at 1/8 (C = 384 for base, 224 for lite: the wide kernel) and
the frames at 1, 1/2 and 1/4 (K1); the two feature halves of the enhanced
features, channel slices of one ``[B, h, w, 2C]`` tensor (wide); the frames
at each level of the upsampling pyramid (K1); the ensemble adds two
full-resolution frame warps per input scale (:func:`warps_per_forward`).
The JAX ``apply`` also warps the frames at 1/8 and blends them before the
pyramid; nothing reads that blend (XLA drops it), so the port skips it.

Inputs are edge-padded to multiples of 64, centred (:func:`make_model_fn`).
Lite's ``state_dict`` equals ``atm-vfi-lite.pt``'s manifest (236 tensors,
the ``attn_mask``/``HW`` buffers that the reference loader deletes left
out); base has the keys the JAX ``apply`` reads, at ``_CFG["base"]``'s
widths: the attention head MLP ``NUM_HEADS * local_hidden_frac`` wide, the
token MLPs ``mlp_ratio`` times their input, ``last_extra`` channels added by
``last_feat_extract``, the global motion MLP ``global_hidden`` wide (the
global token width when None) and the refinement U-Net ``dims[1]``, twice
and four times that (no manifest of base is in the repository).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ..ops.cuda.warp_kernel import route_counts
from ..ops.warp import warp
from .common import cast_params, channels_last_params, init_state_dict, resize_by_scale

__all__ = [
    "ATM", "ATMFormer", "CKPT_NAMES", "RefineBottleneck", "apply", "init_params", "make_model_fn", "variant_for_ckpt",
    "warps_per_forward",
]

CKPT_NAMES = ["atm-vfi-base.pt", "atm-vfi-lite.pt", "atm-vfi-base-pct.pt"]

_CFG = {
    "base": {"dims": [24, 48, 96, 192], "mlp_ratio": 4.0, "local_hidden_frac": 0.75,
             "last_extra": 96, "global_hidden": 768},
    "lite": {"dims": [16, 32, 64, 96], "mlp_ratio": 2.0, "local_hidden_frac": 0.5,
             "last_extra": 32, "global_hidden": None},
}

LOCAL_WINDOW = 8
GLOBAL_WINDOW = 12
NUM_HEADS = 8


def variant_for_ckpt(ckpt_name: str) -> str:
    return "lite" if "lite" in ckpt_name else "base"


def fused_dim(variant: str) -> int:
    """The fused feature width at 1/8: 384 for base, 224 for lite."""
    d = _CFG[variant]["dims"]
    return d[-1] + d[-2] + 2 * d[-3]


# ---- windows and masks (host-side numpy) -------------------------------------------


def _pad_sizes(h: int, w: int, ws: Tuple[int, int]) -> Tuple[int, int]:
    return math.ceil(h / ws[0]) * ws[0] - h, math.ceil(w / ws[1]) * ws[1] - w


def _region_mask(img: np.ndarray, ws: Tuple[int, int]) -> np.ndarray:
    """``[nW, N, N]``: -100 between two tokens of one window whose regions of
    ``img`` differ, 0 elsewhere."""
    hp, wp = img.shape
    win = img.reshape(hp // ws[0], ws[0], wp // ws[1], ws[1]).transpose(0, 2, 1, 3).reshape(-1, ws[0] * ws[1])
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _boundary_region_mask(h: int, w: int, ws: Tuple[int, int], ph: int, pw: int) -> np.ndarray:
    """``pad_if_needed``'s mask (attention.py:28-63): the centred padding's
    nine regions."""
    img = np.zeros((h + ph, w + pw), np.float32)
    cnt = 0
    for hs in (slice(0, ph // 2), slice(ph // 2, h + ph // 2), slice(h + ph // 2, None)):
        for wsl in (slice(0, pw // 2), slice(pw // 2, w + pw // 2), slice(w + pw // 2, None)):
            img[hs, wsl] = cnt
            cnt += 1
    return _region_mask(img, ws)


def _shift_mask_np(hp: int, wp: int, ws: Tuple[int, int], ss: Tuple[int, int]) -> np.ndarray:
    """The Swin shift mask: the rolled map's nine regions."""
    img = np.zeros((hp, wp), np.float32)
    cnt = 0
    for hs in (slice(0, -ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None)):
        for wsl in (slice(0, -ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None)):
            img[hs, wsl] = cnt
            cnt += 1
    return _region_mask(img, ws)


def _attn_masks(h: int, w: int, window: int, shift: int) -> Optional[np.ndarray]:
    """The padding mask and the shift mask of a ``h`` x ``w`` map, combined
    (``[nW, N, N]``, one image's windows in row-major order), or None."""
    ws = (window, window)
    ph, pw = _pad_sizes(h, w, ws)
    pad_mask = _boundary_region_mask(h, w, ws, ph, pw) if (ph or pw) else None
    if shift:
        sm = _shift_mask_np(h + ph, w + pw, ws, (shift, shift))
        return sm if pad_mask is None else np.where(pad_mask != 0, -100.0, sm).astype(np.float32)
    return pad_mask


def _relative_coord(ws: int) -> np.ndarray:
    """AttentionToMotion's relative coordinates ``[2, N, N]``
    (attention.py:152-166): for query ``q`` and key ``k``, the key's x and y
    offset from the query."""
    rc = np.zeros((2, ws * ws, ws * ws), np.float32)
    for y in range(ws):
        for x in range(ws):
            vx = np.linspace(-x, ws - (x + 1), ws, dtype=np.float32)
            vy = np.linspace(-y, ws - (y + 1), ws, dtype=np.float32)
            xx, yy = np.meshgrid(vx, vy)
            rc[0, y * ws + x] = xx.flatten()
            rc[1, y * ws + x] = yy.flatten()
    return rc


@functools.lru_cache(maxsize=None)
def _device_mask(h: int, w: int, window: int, shift: int, device: torch.device) -> Optional[torch.Tensor]:
    """:func:`_attn_masks` as an f32 tensor on ``device``, copied there once."""
    mask = _attn_masks(h, w, window, shift)
    if mask is None:
        return None
    with torch.inference_mode(False):
        return torch.from_numpy(mask).to(device)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> ``[B * nW, ws * ws, C]``, batch-major, the
    windows of one image in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    nwb, _, c = win.shape
    b = nwb // ((h // ws) * (w // ws))
    x = win.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _windowed(blk: nn.Module, x: torch.Tensor, shift: int) -> tuple:
    """``blk.attend`` on the windows of NHWC ``x`` (padded centred to whole
    windows, rolled by ``-shift``) and its outputs merged back: the tokens
    (and ``ATMFormer``'s motion). The whole frame is every window row
    (:func:`window_rows_of`, :func:`windowed_rows`). Row bands
    (``parallel.space``) go to their own rule: each band computes the
    windows that hold its rows, their rows read from its neighbours and,
    under the shift, from the frame's other end."""
    if has_torch_function((x,)):
        return handle_torch_function(_windowed, (x,), blk, x, shift)
    h = x.shape[1]
    wins, pad, rows, keep = _frame_rows(h, blk.window, shift, x.device)
    x = F.pad(x, (0, 0, 0, 0, *pad)) if any(pad) else x
    out = windowed_rows(blk, x if rows is None else x.index_select(1, rows), shift, h, x.shape[2], wins)
    return tuple(o[:, pad[0] : pad[0] + h] if keep is None else o.index_select(1, keep) for o in out)


@functools.lru_cache(maxsize=None)
def _frame_rows(h: int, window: int, shift: int, device: torch.device) -> tuple:
    """The whole frame's :func:`window_rows_of`: every window row, the
    centred pad (top, bottom), and under the shift the padded map's rows in
    window order and the place of each frame row among them (on
    ``device``, made once; without the shift the order is the padded map's
    own, and both are None)."""
    wins, src = window_rows_of(h, window, shift, 0, h)
    top = -min(src)
    if not shift:
        return wins, (top, len(src) - h - top), None, None
    with torch.inference_mode(False):
        rows = torch.tensor(src, device=device) + top
        return wins, (top, len(src) - h - top), rows, rows.argsort()[top : top + h]


def window_rows_of(h: int, window: int, shift: int, lo: int, hi: int) -> Tuple[List[int], List[int]]:
    """The window rows of the padded, rolled map of ``h``
    rows that hold the frame's rows ``lo`` to ``hi``, ascending, and the
    frame row each of their rows holds, in order (outside ``[0, h)`` for
    the centred pad's rows). Rolled row ``r`` holds padded row ``(r +
    shift) mod hp``, which holds frame row ``p - ph // 2``."""
    ph = -h % window
    top, hp = ph // 2, h + ph
    wins = sorted({((g + top - shift) % hp) // window for g in range(lo, hi)})
    return wins, [(wi * window + t + shift) % hp - top for wi in wins for t in range(window)]


def windowed_rows(blk: nn.Module, tall: torch.Tensor, shift: int, h: int, w: int, wins: List[int]) -> tuple:
    """:func:`_windowed` of the window rows ``wins`` of the padded, rolled
    map of an ``h`` x ``w`` frame only: ``tall`` (``[B, len(wins) * window,
    w, C]``) holds their rows in order (:func:`window_rows_of`; zeros for
    the pad), and the outputs come back in that order, with the masks of
    those windows."""
    ws = blk.window
    ph, pw = _pad_sizes(h, w, (ws, ws))
    x = F.pad(tall, (0, 0, pw // 2, pw - pw // 2)) if pw else tall
    if shift:
        x = torch.roll(x, -shift, 2)
    mask = _device_mask(h, w, ws, shift, tall.device)
    if mask is not None and len(wins) < (h + ph) // ws:
        n = mask.shape[-1]
        mask = mask.view(-1, (w + pw) // ws, n, n)[wins].flatten(0, 1)
    out = []
    for o in blk.attend(_window_partition(x, ws), mask):
        y = _window_reverse(o, ws, len(wins) * ws, w + pw)
        if shift:
            y = torch.roll(y, shift, 2)
        out.append(y[:, :, pw // 2 : pw // 2 + w] if pw else y)
    return tuple(out)


# ---- attention ------------------------------------------------------------------------


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor]):
    """Windowed multi-head attention over ``[B * nW, N, C]`` windows, returning
    the output and the f32 attention probabilities ``[B * nW, heads, N, N]``.
    ``mask`` (``[nW, N, N]``) follows the windows of one image. Scores and
    softmax are f32; the value product takes the probabilities cast once to
    the values' dtype."""
    b, n, c = q.shape
    hd = c // NUM_HEADS

    def heads(x):
        return x.reshape(b, n, NUM_HEADS, hd).transpose(1, 2)

    attn = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2)) * (hd**-0.5)
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b // nw, nw, NUM_HEADS, n, n) + mask[None, :, None]).view(b, NUM_HEADS, n, n)
    attn = attn.softmax(-1)
    out = torch.matmul(attn.to(v.dtype), heads(v)).transpose(1, 2).reshape(b, n, c)
    return out, attn


class AttentionToMotion(nn.Module):
    """attention.py:126-215: cross attention from frame 0's windows to the
    other frame's, and the motion read out of its probabilities."""

    def __init__(self, dim: int, window: int, hidden: int):
        super().__init__()
        self.q = nn.Linear(dim, dim, bias=False)
        self.kv = nn.Linear(dim, 2 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.mlp = nn.Sequential(nn.Linear(NUM_HEADS, hidden), nn.GELU(), nn.Linear(hidden, 1))
        n = window * window
        self.register_buffer("relative_coord", torch.zeros(1, 1, 2, n, n))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, mask: Optional[torch.Tensor]):
        b, n, c = x1.shape
        kv = self.kv(x2)
        out, attn = _mha(self.q(x1), kv[..., :c], kv[..., c:], mask)
        out = self.proj(out)
        motion = torch.einsum("bhqk,cqk->bhcq", attn, self.relative_coord[0, 0].float())  # [B, heads, 2, N]
        m = motion.permute(0, 2, 3, 1)  # [B, 2, N, heads]: the head MLP in f32, shared by x and y
        fc1, fc2 = self.mlp[0], self.mlp[2]
        m = F.linear(F.gelu(F.linear(m, fc1.weight.float(), fc1.bias.float())), fc2.weight.float(), fc2.bias.float())
        return out, m.reshape(b, 2, n).transpose(1, 2).to(x1.dtype)  # [B, N, 2]


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class MlpDW(nn.Module):
    """attention.py:90-125: fc1, a depthwise 3x3 on the token grid, exact
    GELU, fc2; on NHWC tokens."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc1(x).permute(0, 3, 1, 2)  # channels_last planes
        y = self.dwconv.dwconv(y).permute(0, 2, 3, 1)
        return self.fc2(F.gelu(y))


class ATMFormer(nn.Module):
    """attention.py:265-335 on NHWC ``[2B, H, W, C]`` (frame 0's batch first):
    returns the tokens and the motion ``[2B, H, W, 2]``."""

    def __init__(self, dim: int, window: int, mlp_ratio: float, head_hidden: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim)
        self.attn = AttentionToMotion(dim, window, head_hidden)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MlpDW(dim, int(dim * mlp_ratio))

    def attend(self, windows: torch.Tensor, mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The windows' tokens after the attention, and their motion."""
        xn = self.norm1(windows)
        half = xn.shape[0] // 2  # frame 0's windows, then frame 1's
        x_rev = torch.cat([xn[half:], xn[:half]])
        x_app, x_motion = self.attn(xn, x_rev, mask)
        return xn + x_app, x_motion

    def forward(self, x: torch.Tensor, shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
        xb, xm = _windowed(self, x, shift)
        return xb + self.mlp(self.norm2(xb)), xm


class _QKVAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class RefineBottleneck(nn.Module):
    """attention.py:433-497: a Swin block with the depthwise MLP, on NHWC
    ``[B, H, W, C]``."""

    def __init__(self, dim: int, window: int, mlp_ratio: float):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _QKVAttention(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MlpDW(dim, int(dim * mlp_ratio))

    def attend(self, windows: torch.Tensor, mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor]:
        """The windows' tokens after the attention."""
        c = windows.shape[-1]
        xn = self.norm1(windows)
        qkv = self.attn.qkv(xn)
        out, _ = _mha(qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :], mask)
        return (xn + self.attn.proj(out),)

    def forward(self, x: torch.Tensor, shift: int) -> torch.Tensor:
        (xb,) = _windowed(self, x, shift)
        return xb + self.mlp(self.norm2(xb))


# ---- the network ----------------------------------------------------------------------


def _conv_p(cin: int, cout: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, 1), nn.PReLU(cout))


def _deconv_p(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 2, 2, 0), nn.PReLU(cout))


class CrossScaleFeatureFusion(nn.Module):
    """network_base.py:74-87: each finer level brought to the coarsest by
    strided convolutions (level ``-2 - i`` by ``2 ** i`` of them, dilations 1
    to ``2 ** i``), concatenated with it, a 1x1 projection and a layer norm."""

    def __init__(self, widths: List[int]):
        super().__init__()
        layers = []
        for i in range(len(widths) - 1):
            c = widths[-2 - i]
            layers += [nn.Conv2d(c, c, 3, 2 ** (i + 1), 1 + j, 1 + j) for j in range(2**i)]
        self.layers = nn.ModuleList(layers)
        total = sum(widths) + sum(widths[-2 - i] * (2**i - 1) for i in range(len(widths) - 1))
        self.proj = nn.Conv2d(total, total, 1)
        self.norm = nn.LayerNorm(total)

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """NCHW levels in, NHWC tokens at the coarsest level out."""
        ys, k = [], 0
        for i in range(len(xs) - 1):
            for _ in range(2**i):
                ys.append(self.layers[k](xs[-2 - i]))
                k += 1
        x = self.proj(torch.cat([*ys, xs[-1]], 1))
        return self.norm(x.permute(0, 2, 3, 1))


class ATM(nn.Module):
    """``Network`` of network_base.py / network_lite.py: the parameter tree;
    :func:`apply` runs it."""

    def __init__(self, variant: str = "base"):
        super().__init__()
        cfg = _CFG[variant]
        d = cfg["dims"]
        fd = fused_dim(variant)
        self.variant = variant
        self.feat_extracts = nn.ModuleList(
            nn.Sequential(_conv_p(cin, c, 1 if i == 0 else 2), _conv_p(c, c)) for i, (cin, c) in enumerate(zip([3] + d, d))
        )
        self.cross_scale_feature_fusion = CrossScaleFeatureFusion(d[1:])
        last = d[-1] + cfg["last_extra"]
        self.last_feat_extract = nn.Sequential(_conv_p(d[-1], last, 2), _conv_p(last, last))
        self.global_feature_fusion = CrossScaleFeatureFusion([d[2], d[3], last])
        gd = self.global_feature_fusion.norm.normalized_shape[0]
        head = int(NUM_HEADS * cfg["local_hidden_frac"])
        ratio = cfg["mlp_ratio"]
        self.global_motion_atmformer = nn.ModuleList(ATMFormer(gd, GLOBAL_WINDOW, ratio, head) for _ in range(2))
        gh = cfg["global_hidden"] or gd
        self.global_motion_mlp = nn.Sequential(_conv_p(8 + 2 * gd, gh), _conv_p(gh, gh), nn.Conv2d(gh, 5, 1))
        self.local_motion_atmformer = nn.ModuleList(ATMFormer(fd, LOCAL_WINDOW, ratio, head) for _ in range(2))
        self.local_motion_mlp = nn.Sequential(_conv_p(8 + 2 * fd, fd), _conv_p(fd, fd), nn.Conv2d(fd, 5, 1))
        self.feat_enhance_transformer = nn.ModuleList(RefineBottleneck(fd, LOCAL_WINDOW, ratio) for _ in range(2))
        ups, cin = [], 2 * fd + 5
        for i in range(3):
            c = fd // 2**i + 5
            body = [_deconv_p(cin, c), _conv_p(c, c), nn.Conv2d(c, c, 3, 1, 1)]
            ups.append(nn.Sequential(*body) if i == 0 else nn.Sequential(nn.PReLU(cin), *body))
            cin = c
        self.upsample_pyramid = nn.ModuleList(ups)
        r = d[1]
        self.proj = _conv_p(cin + 15, r)
        self.down1 = nn.Sequential(_conv_p(r, r, 2))
        self.down2 = nn.Sequential(_conv_p(r + fd // 2, 2 * r, 2), _conv_p(2 * r, 2 * r))
        self.down3 = nn.Sequential(_conv_p(2 * r + fd, 4 * r, 2), _conv_p(4 * r, 4 * r), _conv_p(4 * r, 4 * r))
        self.up1 = nn.Sequential(_deconv_p(4 * r, 2 * r), _conv_p(2 * r, 2 * r))
        self.up2 = nn.Sequential(_deconv_p(4 * r, 2 * r), _conv_p(2 * r, r))
        self.up3 = nn.Sequential(_deconv_p(2 * r, r))
        self.refine_head = nn.Sequential(_conv_p(2 * r, r), _conv_p(r, 3))


def _planes(x: torch.Tensor) -> torch.Tensor:
    """NHWC tokens as NCHW planes (``channels_last`` when ``x`` is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """flow_warp.py: zeros padding, pixel offsets; NCHW ``x`` and flow."""
    return warp(x.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), "zeros").permute(0, 3, 1, 2)


def _upsample_flow(flow: torch.Tensor, factor: int) -> torch.Tensor:
    return resize_by_scale(flow, float(factor), align_corners=True) * factor


def _halves(x: torch.Tensor) -> torch.Tensor:
    """``[2B, ..., C]`` -> ``[B, ..., 2C]``: frame 0's batch and frame 1's
    side by side on the last axis."""
    b = x.shape[0] // 2
    return torch.cat([x[:b], x[b:]], -1)


def _feat_extract(net: ATM, x: torch.Tensor):
    feats = []
    for i, m in enumerate(net.feat_extracts):
        x = m(x)
        if i:
            feats.append(x)
    return x, feats


def _motion_head(blocks: nn.ModuleList, mlp: nn.Sequential, x: torch.Tensor, window: int):
    """The two ATMFormers (shift 0, then half a window) on NHWC ``[2B, h, w,
    C]`` and the motion MLP over both blocks' motion and both frames'
    tokens: the tokens, and the MLP's ``[B, 5, h, w]`` output."""
    motions = []
    for blk, shift in zip(blocks, (0, window // 2)):
        x, xm = blk(x, shift)
        motions.append(_halves(xm))
    out = mlp(_planes(torch.cat([*motions, _halves(x)], -1)))
    return x, out


def _estimate_global_motion(net: ATM, x: torch.Tensor, levels: List[torch.Tensor]):
    """estimate_global_motion (network_base.py:368-392): both flows at 1/16."""
    feat_last = net.last_feat_extract(x)
    tokens = net.global_feature_fusion([*levels[1:], feat_last])
    _, out = _motion_head(net.global_motion_atmformer, net.global_motion_mlp, tokens, GLOBAL_WINDOW)
    return out[:, :2], out[:, 2:4]


def _global_alignmentness(flow0, flow1, im0, im1) -> torch.Tensor:
    """The photometric loss per sample of flows at a coarse level: both
    frames warped at full resolution, their mean absolute difference (f32)."""
    factor = im0.shape[2] // flow0.shape[2]
    w0 = _flow_warp(im0, _upsample_flow(flow0, factor))
    w1 = _flow_warp(im1, _upsample_flow(flow1, factor))
    return (w0.float() - w1.float()).abs().mean((1, 2, 3))


def _multiscale_global_ensemble(net: ATM, im0: torch.Tensor, im1: torch.Tensor):
    """multiscale_global_motion_ensemble (network_base.py:547-580): the global
    estimator at 3 input scales, each flow brought to 1/16 of the input, and
    per sample the scale of least :func:`_global_alignmentness`. Returns the
    flows and the losses ``[3, B]``."""
    im = torch.cat([im0, im1])
    flows, losses = [], []
    for lvl in range(3):
        if lvl:
            im = resize_by_scale(im, 0.5, align_corners=True)
        feat_, levels = _feat_extract(net, im)
        f0, f1 = _estimate_global_motion(net, feat_, levels)
        losses.append(_global_alignmentness(f0, f1, im0, im1))
        flows.append((_upsample_flow(f0, 2**lvl), _upsample_flow(f1, 2**lvl)) if lvl else (f0, f1))
    loss = torch.stack(losses)
    best = loss.argmin(0).view(-1, 1, 1, 1)
    picked = []
    for i in (0, 1):  # per sample the flow of its best scale, selected, not computed
        f = flows[0][i]
        for lvl in (1, 2):
            f = torch.where(best != lvl, f, flows[lvl][i])
        picked.append(f)
    return tuple(picked), loss


def _residual_refinement(net: ATM, feat, im0, it0, im1, it1, it, dec_feats) -> torch.Tensor:
    """residual_refinement (network_base.py:394-410)."""
    f0 = net.proj(torch.cat([feat, im0, it0, im1, it1, it], 1))
    f1 = net.down1(f0)
    f2 = net.down2(torch.cat([f1, dec_feats.pop()], 1))
    f3 = net.down3(torch.cat([f2, dec_feats.pop()], 1))
    f2_ = net.up1(f3)
    f1_ = net.up2(torch.cat([f2_, f2], 1))
    f0_ = net.up3(torch.cat([f1_, f1], 1))
    res = net.refine_head(torch.cat([f0_, f0], 1))
    return 2.0 * torch.sigmoid(res) - 1.0


def apply(net: ATM, im0: torch.Tensor, im1: torch.Tensor, global_motion: bool = True,
          ensemble_global_motion: bool = False) -> torch.Tensor:
    """Network.forward (network_base.py:433-543; the ensemble 601-713), eval
    path, on NHWC frames ``[B, H, W, 3]`` padded to multiples of 64: the
    midpoint, NHWC, clamped to [0, 1]."""
    b = im0.shape[0]
    fd = fused_dim(net.variant)
    im0, im1 = _planes(im0), _planes(im1)
    ims0, ims1 = [im0], [im1]
    for _ in range(2):
        ims0.append(resize_by_scale(ims0[-1], 0.5, align_corners=True))
        ims1.append(resize_by_scale(ims1[-1], 0.5, align_corners=True))

    feat_, levels = _feat_extract(net, torch.cat([im0, im1]))
    feat = net.cross_scale_feature_fusion(levels)  # NHWC [2B, h, w, fd]
    if global_motion:
        if ensemble_global_motion:
            (g0, g1), _ = _multiscale_global_ensemble(net, im0, im1)
        else:
            g0, g1 = _estimate_global_motion(net, feat_, levels)
        g0, g1 = _upsample_flow(g0, 2), _upsample_flow(g1, 2)
        fmap = _planes(feat)
        feat = torch.cat([_flow_warp(fmap[:b], g0), _flow_warp(fmap[b:], g1)]).permute(0, 2, 3, 1)
        for i in (2, 1, 0):  # 1/4, 1/2, 1
            g0, g1 = _upsample_flow(g0, 2), _upsample_flow(g1, 2)
            ims0[i], ims1[i] = _flow_warp(ims0[i], g0), _flow_warp(ims1[i], g1)

    x, out = _motion_head(net.local_motion_atmformer, net.local_motion_mlp, feat, LOCAL_WINDOW)
    flow0, flow1 = out[:, :2], out[:, 2:4]
    for blk, shift in zip(net.feat_enhance_transformer, (0, LOCAL_WINDOW // 2)):
        x = blk(x, shift)
    feat_enh = _planes(_halves(x))  # [B, 2 fd, h, w]; its two halves warp as channel slices
    feat_cur = torch.cat([_flow_warp(feat_enh[:, :fd], flow0), _flow_warp(feat_enh[:, fd:], flow1), out], 1)

    dec_feats = []
    for i, scale in enumerate((2, 1, 0)):
        feat_cur = net.upsample_pyramid[i](feat_cur)
        flow0, flow1 = feat_cur[:, -5:-3], feat_cur[:, -3:-1]
        occ = torch.sigmoid(feat_cur[:, -1:])
        if scale:
            dec_feats.append(feat_cur[:, :-5])
        it0, it1 = _flow_warp(ims0[scale], flow0), _flow_warp(ims1[scale], flow1)
        it = occ * it0 + (1.0 - occ) * it1
    res = _residual_refinement(net, feat_cur, im0, it0, im1, it1, it, dec_feats)
    return (it + res).clamp(0.0, 1.0).permute(0, 2, 3, 1)


def warps_per_forward(variant: str = "base", global_motion: bool = True, ensemble: bool = False,
                      dtype: torch.dtype = torch.bfloat16) -> Dict[str, int]:
    """Warp launches of one :func:`apply` on the card by kernel, ``{"narrow":
    K1, "wide": the wide kernel}``, as ``warp_kernel.route`` sends them:
    under global motion both frames' fused features and the frames at 1/4,
    1/2 and 1 (the ensemble first warps both frames at full resolution per
    input scale); the enhanced features' two halves; the frames at each
    pyramid level."""
    fd = fused_dim(variant)
    channels = [fd, fd] + [3] * 6 if global_motion else []
    channels += [3] * 6 if global_motion and ensemble else []
    return route_counts(channels + [fd, fd] + [3] * 6, dtype)


def _load(params: Dict[str, torch.Tensor], variant: str, dtype: torch.dtype, device) -> ATM:
    with torch.device("meta"):
        net = ATM(variant)
    net.load_state_dict(cast_params(params, dtype), strict=True, assign=True)
    return channels_last_params(net.to(device=device)).eval()


def make_model_fn(params: Dict[str, torch.Tensor], variant: str = "base", global_motion: bool = True,
                  ensemble_global_motion: bool = False, dtype: torch.dtype = torch.float32, device="cuda"):
    """The batched model callable for the plan executor: ``model_fn(f0, f1,
    t) -> mid`` (``t`` unused: ATM makes the midpoint), NHWC frames in, each
    call edge-padded to multiples of 64, centred, then cropped and clamped;
    float32 NHWC out."""
    net = _load(params, variant, dtype, device)

    @torch.inference_mode()
    def model_fn(f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor = None) -> torch.Tensor:
        _, h, w, _ = f0.shape
        ph, pw = (-h) % 64, (-w) % 64
        top, left = ph // 2, pw // 2

        def pad(f):
            f = f.to(device=device, dtype=dtype).permute(0, 3, 1, 2)
            if ph or pw:
                f = F.pad(f, (left, pw - left, top, ph - top), mode="replicate")
            return f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)

        out = apply(net, pad(f0), pad(f1), global_motion, ensemble_global_motion)
        return out[:, top : top + h, left : left + w].float()

    return model_fn


def init_params(variant: str = "base", seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random state dict of ``variant`` (``common.init_state_dict``), with
    every ``relative_coord`` buffer holding the coordinates it holds in a
    checkpoint."""
    with torch.device("meta"):
        net = ATM(variant)
    params = init_state_dict(net, seed)
    for key in params:
        if key.endswith("relative_coord"):
            n = params[key].shape[-1]
            params[key] = torch.from_numpy(_relative_coord(math.isqrt(n)))[None, None]
    return params
