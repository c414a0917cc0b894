"""Forward bilinear splatting, PyTorch port of the JAX package's
``ops/softsplat.py``: ``softsplat_func`` (and its exact path
``_softsplat_xla``), the mode wrapper ``softsplat`` and the legacy
``function_softsplat``.

Semantics (reference ``cupy_ops/softsplat.py`` kernel ``softsplat_out``):
every source pixel ``(x, y)`` adds its value, times the bilinear weights, into
the four integer neighbours of ``(x + flow_x, y + flow_y)``, in the order
y0x0, y0x1, y1x0, y1x1; corners off the frame are dropped, and so is a source
whose target is not finite.

Layout: NHWC values, ``[N, H, W, 2]`` flows (channel 0 = x, 1 = y) and
``[N, H, W, 1]`` metrics, as in the JAX package.

:func:`softsplat` (reference ``softsplat``, ``cupy_ops/softsplat.py:382-436``)
splats in one of four modes: ``sum``; ``avg`` (a ones channel appended);
``linear`` (``in * metric`` and a metric channel); ``soft`` (``in *
exp(metric)`` and an ``exp(metric)`` channel). Every mode but ``sum`` divides
by the splatted last channel, with an eps variant after a dash: bare or
``-addeps`` adds 1e-7, ``-zeroeps`` maps exact zeros to 1, ``-clipeps`` clamps
to at least 1e-7. :func:`function_softsplat` is the legacy
``FunctionSoftsplat`` (``summation``/``average``/``linear``/``softmax``, and
the short aliases EISAI passes) with zeroeps. The prologue and the
normalisation are plain PyTorch, as the JAX package keeps them on XLA around
its kernel; the splat itself is :func:`softsplat_func`.

:func:`softsplat_func` dispatches on the tensor's device: a CUDA tensor goes
to the hand-written Hopper kernel (``ops.cuda.softsplat_kernel``), a CPU tensor
to the plain twin :func:`softsplat_torch`. A plain scatter is exact for any
displacement, so the JAX package's displacement bands, residual pass, size
gate and ``CFI_TPU_SPLAT`` switch have no counterpart here.

Differences from ``_softsplat_xla``, all deliberate: coordinates and weights
are f32 (from an integer iota) and the sums are f32 for every input dtype,
cast once to the input dtype at the end, where the JAX path builds its grid
and accumulates in the input dtype; coordinates are clamped to ``+-2w`` /
``+-2h`` before the float-to-int conversion, which moves no kept corner (both
corners of a clamped axis stay off the frame) and keeps the conversion
defined for huge finite flows; a dropped corner adds nothing, where the JAX
path adds ``value * 0`` at index 0 (NaN there for a non-finite value).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["function_softsplat", "softsplat", "softsplat_func", "softsplat_torch"]


def softsplat_torch(ten_in: torch.Tensor, ten_flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch forward splat (the kernel's twin): ``index_add_`` of the
    four corners into a flat f32 buffer with one spare row per image, which
    takes the dropped corners and is cut off at the end."""
    n, h, w, c = ten_in.shape
    dev = ten_in.device
    gx = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    gy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    fx = gx + ten_flow[..., 0].float()
    fy = gy + ten_flow[..., 1].float()
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    fx = torch.where(finite, fx, -2.0 * w).clamp(-2.0 * w, 2.0 * w)
    fy = torch.where(finite, fy, -2.0 * h).clamp(-2.0 * h, 2.0 * h)

    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0
    wy1 = fy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    x0i = x0.long()
    y0i = y0.long()

    hw = h * w
    vals = ten_in.reshape(n, hw, c).float()
    out = torch.zeros(n * (hw + 1), c, dtype=torch.float32, device=dev)
    base = (torch.arange(n, device=dev) * (hw + 1)).view(n, 1, 1)
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            xi = x0i + dx
            yi = y0i + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = base + torch.where(valid, yi * w + xi, hw)  # hw: the spare row
            wgt = (wx * wy).reshape(n, hw, 1)
            out.index_add_(0, idx.reshape(-1), (vals * wgt).reshape(-1, c))
    out = out.view(n, hw + 1, c)[:, :hw]
    return out.reshape(n, h, w, c).to(ten_in.dtype)


def softsplat_func(ten_in: torch.Tensor, ten_flow: torch.Tensor) -> torch.Tensor:
    """Forward-splat ``ten_in`` (NHWC) by ``ten_flow`` (``[N, H, W, 2]``);
    the result has ``ten_in``'s shape and dtype.

    CUDA tensors launch the Hopper kernel, CPU tensors take the plain twin;
    any other device raises. There is no fallback from the kernel to the
    twin."""
    if ten_in.device.type == "cuda":
        from .cuda.softsplat_kernel import softsplat_bilinear

        out = softsplat_bilinear(ten_in.permute(0, 3, 1, 2), ten_flow.permute(0, 3, 1, 2))
        return out.permute(0, 2, 3, 1).to(ten_in.dtype)
    if ten_in.device.type == "cpu" and ten_flow.device.type == "cpu":
        return softsplat_torch(ten_in, ten_flow)
    raise ValueError(
        f"softsplat_func runs on cuda or cpu tensors, got {ten_in.device} and {ten_flow.device}"
    )


def softsplat(
    ten_in: torch.Tensor, ten_flow: torch.Tensor, ten_metric: Optional[torch.Tensor], str_mode: str
) -> torch.Tensor:
    """Mode and eps-variant wrapper of :func:`softsplat_func` (JAX
    ``ops/softsplat.py:softsplat``); NHWC in and out."""
    parts = str_mode.split("-")
    base = parts[0]
    if base not in ("sum", "avg", "linear", "soft"):
        raise ValueError(f"unknown splat mode {str_mode}")
    if (ten_metric is None) != (base in ("sum", "avg")):
        raise ValueError(f"splat mode {base} takes {'no' if base in ('sum', 'avg') else 'a'} metric")
    eps_mode = parts[1] if len(parts) > 1 else "addeps"
    if base != "sum" and eps_mode not in ("addeps", "zeroeps", "clipeps"):
        raise ValueError(f"unknown eps mode in {str_mode}")

    if base == "avg":
        ten_in = torch.cat([ten_in, torch.ones_like(ten_in[..., :1])], -1)
    elif base == "linear":
        ten_in = torch.cat([ten_in * ten_metric, ten_metric], -1)
    elif base == "soft":
        m = torch.exp(ten_metric)
        ten_in = torch.cat([ten_in * m, m], -1)

    ten_out = softsplat_func(ten_in, ten_flow)
    if base == "sum":
        return ten_out
    norm = ten_out[..., -1:]
    if eps_mode == "addeps":
        norm = norm + 0.0000001
    elif eps_mode == "zeroeps":
        norm = torch.where(norm == 0.0, 1.0, norm)
    else:
        norm = norm.clamp(min=0.0000001)
    return ten_out[..., :-1] / norm


# legacy names and the short aliases EISAI's flow_forewarp passes (the JAX
# package accepts both; the reference FunctionSoftsplat asserts the long ones)
_LEGACY_MODES = {
    "summation": "sum",
    "average": "avg",
    "linear": "linear",
    "softmax": "soft",
    "sum": "sum",
    "avg": "avg",
    "soft": "soft",
}


def function_softsplat(
    ten_input: torch.Tensor, ten_flow: torch.Tensor, ten_metric: Optional[torch.Tensor], str_type: str
) -> torch.Tensor:
    """Legacy API (reference ``FunctionSoftsplat``): the modes under their
    long names or short aliases, normalised with zeroeps."""
    if str_type not in _LEGACY_MODES:
        raise ValueError(f"unknown splat type {str_type}")
    base = _LEGACY_MODES[str_type]
    if base == "sum":
        return softsplat(ten_input, ten_flow, None, "sum")
    return softsplat(ten_input, ten_flow, ten_metric if base in ("linear", "soft") else None, f"{base}-zeroeps")
