"""Layer primitives for the ported models: the subset of the JAX package's
``models/common.py`` that RIFE, M2M, FILM, GMFSS, EISAI, STMFNet, FLAVR,
IFRNet, IFUnet, AMT, ATM, XVFI, CAIN, Sepconv and MoMo use, as plain functions
on NCHW tensors
(``linear`` on the last axis of any tensor; ``conv3d``/``conv_transpose3d``
on NCDHW clips).

The JAX versions take NHWC arrays and parameter dicts in torch layout; here
the tensors are torch's own NCHW (held in ``channels_last`` memory by the
models, so a permute to NHWC is a view and cuDNN runs NHWC), and weights are
passed in torch layout directly: OIHW for convolutions, IOHW for transposed
convolutions, which ``F.conv_transpose2d`` takes as they are; OIDHW and
IODHW for the 3-D ones, on clips held in ``channels_last_3d`` memory.

``resize_bilinear`` is ``F.interpolate(mode="bilinear")`` with ``size=``:
the JAX version's integer-factor fast paths compute the same two taps (for an
even downscale factor s, rows ``s*k + s/2 - 1`` and ``s*k + s/2`` at 0.5
each), so one call reproduces all of its paths.

``resize_bicubic`` is ``F.interpolate(mode="bicubic")``, with or without
antialias, summed in f32: the JAX version's per-axis matrices were proven
against that call.

``reflect_pad`` is ``numpy.pad(mode="reflect")`` (and ``jnp.pad``'s), which
goes on reflecting where a pad is as long as the side or longer;
``F.pad(mode="reflect")`` raises there.

``conv2d(padding="same")`` is torch's own ``"same"``, the JAX
``"same_torch"``: for an even kernel the extra pad goes right and bottom.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "PRELU_INIT",
    "avg_pool2d",
    "batch_norm",
    "cast_params",
    "channels_last_params",
    "conv2d",
    "conv2d_concat",
    "conv2x2_up2x",
    "conv3d",
    "conv_transpose2d",
    "conv_transpose3d",
    "device_const",
    "init_state_dict",
    "instance_norm",
    "interpolate_like",
    "prelu",
    "leaky_relu",
    "reflect_pad",
    "linear",
    "max_pool2d",
    "sigmoid",
    "pixel_shuffle",
    "resize_bicubic",
    "resize_bilinear",
    "resize_by_scale",
    "resize_nearest",
]

IntPair = Union[int, Tuple[int, int]]
Padding = Union[IntPair, str]

PRELU_INIT = 0.25  # torch nn.PReLU's default; the models' init_params draw PReLU weights as it


def cast_params(params: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Cast every floating tensor of a state dict to ``dtype`` (the analog of
    the reference's ``model.half()``): bf16 activations against f32 weights
    would promote every convolution back to f32."""
    return {
        k: v.to(dtype) if torch.is_floating_point(v) else v for k, v in params.items()
    }


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, shape: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``values`` as a tensor of ``shape`` on ``device``, copied there once
    (a copy per call would make the host wait for the card each time)."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32).reshape(shape).to(device=device, dtype=dtype)


def channels_last_params(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with every 4-D parameter in ``channels_last`` memory and
    every 5-D one in ``channels_last_3d`` (``Module.to(memory_format=...)``
    takes one format for both ranks, which fails on a model that has both)."""
    for p in module.parameters():
        if p.dim() in (4, 5):
            fmt = torch.channels_last if p.dim() == 4 else torch.channels_last_3d
            p.data = p.data.contiguous(memory_format=fmt)
    return module


def conv2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: Padding = 0,
    dilation: IntPair = 1,
    groups: int = 1,
) -> torch.Tensor:
    """torch ``nn.Conv2d`` with an OIHW ``weight`` ``(O, I/groups, kh, kw)``;
    ``padding`` may be ``"same"`` (stride 1)."""
    return F.conv2d(x, weight, bias, stride=stride, padding=padding, dilation=dilation, groups=groups)


def conv2d_concat(
    parts: Sequence[torch.Tensor],
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 1,
    padding: Padding = 0,
    dilation: IntPair = 1,
) -> torch.Tensor:
    """:func:`conv2d` over the channel concatenation of ``parts`` without
    building it: the sum of each part's convolution with its slice of
    ``weight``'s input channels, the bias added once (the same sum as the
    concatenated convolution, in another order)."""
    out = None
    off = 0
    for x in parts:
        c = x.shape[1]
        y = F.conv2d(x, weight[:, off : off + c], None, stride=stride, padding=padding, dilation=dilation)
        out = y if out is None else out + y
        off += c
    if off != weight.shape[1]:
        raise ValueError(f"parts have {off} channels, weight takes {weight.shape[1]}")
    return out if bias is None else out + bias.view(1, -1, 1, 1)


def conv2x2_up2x(
    x: Union[torch.Tensor, Sequence[torch.Tensor]], weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Nearest 2x upsampling followed by a 2x2 ``padding="same"`` convolution,
    without building the upsampled tensor (JAX ``common.py:conv2x2_up2x``).

    Output pixel ``(2i+a, 2j+b)`` reads only ``x[i..i+a, j..j+b]``, so the pair
    splits into four phase convolutions of ``x`` (1x1, 1x2, 2x1 and 2x2 taps,
    the 2x2 kernel summed along the rows or columns that read one source
    pixel), each ``padding="same"``, interleaved into the full-size result:
    9 products per 4 output pixels instead of 16. ``x`` may be a list of
    channel parts, as in :func:`conv2d_concat`. The output is
    ``channels_last``."""
    if not isinstance(x, torch.Tensor):
        out = None
        off = 0
        for part in x:
            c = part.shape[1]
            y = conv2x2_up2x(part, weight[:, off : off + c])
            out = y if out is None else out + y
            off += c
        if off != weight.shape[1]:
            raise ValueError(f"parts have {off} channels, weight takes {weight.shape[1]}")
        return out if bias is None else out + bias.view(1, -1, 1, 1)
    phases = (
        weight.sum((2, 3), keepdim=True),  # even row, even column
        weight.sum(2, keepdim=True),  # even row, odd column
        weight.sum(3, keepdim=True),  # odd row, even column
        weight,  # odd row, odd column
    )
    outs = [F.conv2d(x, w, None, padding="same") for w in phases]
    n, o, h, w = outs[0].shape
    # interleave into a channels_last output, as the models keep every tensor
    out = torch.empty((n, o, 2 * h, 2 * w), dtype=outs[0].dtype, device=x.device, memory_format=torch.channels_last)
    for (a, b), y in zip(((0, 0), (0, 1), (1, 0), (1, 1)), outs):
        out[:, :, a::2, b::2] = y
    return out if bias is None else out.add_(bias.view(1, -1, 1, 1))


def conv_transpose2d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntPair = 2,
    padding: IntPair = 1,
    groups: int = 1,
) -> torch.Tensor:
    """torch ``nn.ConvTranspose2d`` (output_padding=0) with an IOHW ``weight``
    ``(I, O/groups, kh, kw)``."""
    return F.conv_transpose2d(x, weight, bias, stride=stride, padding=padding, groups=groups)


IntTriple = Union[int, Tuple[int, int, int]]


def conv3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntTriple = 1,
    padding: IntTriple = 0,
    dilation: IntTriple = 1,
) -> torch.Tensor:
    """torch ``nn.Conv3d`` on an NCDHW clip with an OIDHW ``weight``."""
    return F.conv3d(x, weight, bias, stride=stride, padding=padding, dilation=dilation)


def conv_transpose3d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: IntTriple = 1,
    padding: IntTriple = 0,
) -> torch.Tensor:
    """torch ``nn.ConvTranspose3d`` (output_padding=0) on an NCDHW clip with
    an IODHW ``weight``."""
    return F.conv_transpose3d(x, weight, bias, stride=stride, padding=padding)


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """torch ``nn.PReLU``; ``weight`` of shape (C,) over the channel axis, or
    of shape (1,), one slope for every channel (GMFSS's)."""
    return torch.where(x >= 0, x, x * weight.view(1, -1, 1, 1))


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``nn.Linear`` over the last axis: ``x @ weight.T + bias``."""
    return F.linear(x, weight, bias)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """torch ``nn.PixelShuffle``: out[n, c, h*r+i, w*r+j] = x[n, c*r*r + i*r + j, h, w]."""
    return F.pixel_shuffle(x, r)


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """torch ``F.interpolate(mode="bilinear")``, no antialias, either convention."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


def resize_bicubic(x: torch.Tensor, out_hw: Tuple[int, int], antialias: bool = False) -> torch.Tensor:
    """torch ``F.interpolate(mode="bicubic", align_corners=False)``, with or
    without ``antialias`` (JAX ``common.py:resize_bicubic``), summed in f32
    and rounded once to ``x``'s dtype; the result is ``channels_last``.
    The antialiased resize runs on an f32 copy (torch's CPU kernel takes no
    bf16); the plain one sums in f32 inside for any dtype (the same values as
    an f32 resize cast back, without the f32 copies)."""
    if tuple(out_hw) == tuple(x.shape[-2:]):
        return x
    if antialias:
        out = F.interpolate(x.float(), size=tuple(out_hw), mode="bicubic", align_corners=False, antialias=True)
    else:
        out = F.interpolate(x, size=tuple(out_hw), mode="bicubic", align_corners=False)
    return out.to(dtype=x.dtype, memory_format=torch.channels_last)


def interpolate_like(x: torch.Tensor, ref: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """:func:`resize_bilinear` to the height and width of ``ref``."""
    return resize_bilinear(x, tuple(ref.shape[-2:]), align_corners)


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``F.interpolate(mode="nearest")``: source index
    ``floor(dst * in / out)``, computed in float64 as the JAX version does
    (torch rounds the ratio to float32 first)."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    iy = torch.from_numpy(np.floor(np.arange(oh) * (h / oh)).astype(np.int64)).to(x.device)
    ix = torch.from_numpy(np.floor(np.arange(ow) * (w / ow)).astype(np.int64)).to(x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def resize_by_scale(
    x: torch.Tensor, scale: float, align_corners: bool = False, mode: str = "bilinear"
) -> torch.Tensor:
    """torch ``F.interpolate(scale_factor=scale)``: output = floor(in * scale),
    mapped with the realized in/out ratio (``size=``), as the JAX version does
    (the same whenever ``in * scale`` is integral); ``mode`` is
    ``"bilinear"`` or ``"nearest"``."""
    h, w = x.shape[-2:]
    out_hw = (int(math.floor(h * scale)), int(math.floor(w * scale)))
    if mode == "bilinear":
        return resize_bilinear(x, out_hw, align_corners)
    if mode == "nearest":
        if scale == int(scale) and scale >= 1:  # src = dst // scale exactly; one pass in channels_last
            return F.interpolate(x, scale_factor=int(scale), mode="nearest")
        return resize_nearest(x, out_hw)
    raise ValueError(f"unsupported resize mode {mode}")


def reflect_pad(x: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Reflect-pad NCHW ``x`` by ``pad`` = ``(left, right, top, bottom)`` (the
    ``F.pad`` order) as ``numpy.pad(..., mode="reflect")`` does, also where a
    pad is the side's length or longer: numpy's reflection is periodic, with
    a period of twice the side less one, so the pad goes on in steps of the
    side less one, each reflecting about an edge that is a reflection point
    of the original. A side of one pixel repeats, as in numpy."""
    left, right, top, bottom = pad
    h, w = x.shape[2] - 1, x.shape[3] - 1
    if h == 0 and (top or bottom):
        x, top, bottom = F.pad(x, (0, 0, top, bottom), mode="replicate"), 0, 0
    if w == 0 and (left or right):
        x, left, right = F.pad(x, (left, right, 0, 0), mode="replicate"), 0, 0
    while left or right or top or bottom:
        step = (min(left, w), min(right, w), min(top, h), min(bottom, h))
        x = F.pad(x, step, mode="reflect")
        left, right, top, bottom = left - step[0], right - step[1], top - step[2], bottom - step[3]
    return x


def avg_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None) -> torch.Tensor:
    """torch ``F.avg_pool2d`` without padding: VALID windows, each sum divided
    by ``kernel**2``."""
    return F.avg_pool2d(x, kernel, stride or kernel)


def max_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None, padding: int = 0) -> torch.Tensor:
    """torch ``F.max_pool2d``: VALID windows of the input padded with -inf
    (the JAX version takes no padding; EISAI's 3x3/s2 pool pads by 1)."""
    return F.max_pool2d(x, kernel, stride or kernel, padding)


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """torch ``nn.InstanceNorm2d`` without affine: per sample and channel over
    H and W, population variance, eps 1e-5."""
    var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def batch_norm(
    x: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """torch ``nn.BatchNorm2d`` (or ``BatchNorm3d``, on NCDHW input) in eval
    mode: ``(x - mean) / sqrt(var + eps) * weight + bias`` with the running
    statistics, over the channel axis."""
    return F.batch_norm(x, running_mean, running_var, weight, bias, training=False, eps=eps)


def init_state_dict(net: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Random state dict of ``net`` (built on the meta device), drawn from
    ``numpy.random.default_rng(seed)`` in ``state_dict`` key order: weights
    and biases uniform in ``+-1/sqrt(fan_in)`` (fan_in from every dim of the
    module's weight after the first, torch's default init; a lone parameter
    from its own shape), every PReLU weight :data:`PRELU_INIT`, batch norms
    (2-D and 3-D) at the identity (weight 1, bias 0, running mean 0, running
    variance 1, ``num_batches_tracked`` 0), and group norms too (weight 1,
    bias 0)."""
    rng = np.random.default_rng(seed)
    prelu = {f"{name}.weight" for name, m in net.named_modules() if isinstance(m, torch.nn.PReLU)}
    norm_types = (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d, torch.nn.GroupNorm)
    norms = {name for name, m in net.named_modules() if isinstance(m, norm_types)}
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    params = {}
    for key, shape in shapes.items():
        module, name = key.rsplit(".", 1) if "." in key else ("", key)
        if key in prelu:
            params[key] = torch.full(shape, PRELU_INIT)
        elif module in norms:
            if name == "num_batches_tracked":
                params[key] = torch.zeros(shape, dtype=torch.int64)
            else:
                params[key] = (torch.ones if name in ("weight", "running_var") else torch.zeros)(shape)
        else:
            fan_shape = shapes.get(f"{module}.weight", shape) if name in ("weight", "bias") else shape
            bound = 1.0 / np.sqrt(int(np.prod(fan_shape[1:])))
            params[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
    return params
